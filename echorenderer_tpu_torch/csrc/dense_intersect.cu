// Dense chunked closest-hit and any-hit ray/primitive kernels for Hopper.
//
// Replaces the Pallas TPU kernels `_trace_kernel` and `_occlude_kernel` of
// echorenderer_tpu/ops/pallas_intersect.py (lines 322 and 400), which the
// JAX package reaches through `intersect_pallas` / `occlude_pallas`.
//
// What it computes: for every ray, the closest hit (t, sorted prim slot,
// u, v) or an any-hit flag against every primitive of the scene, laid out
// as 10 rows of P floats in BVH-leaf order (a/b/c xyz, is_sphere; a sphere
// keeps its center in a and its radius in b.x). Prims are walked in
// 128-prim chunks in ascending order; a chunk is skipped when no ray of
// the block can reach its AABB before that ray's current best t, and a
// 32-chunk superchunk likewise. Triangles use Moller-Trumbore, spheres the
// findFar rule (an ignored sphere still reports its far root, an ignored
// triangle is skipped). A running best is replaced only on a strictly
// smaller t, so among equal t the lowest sorted slot wins, as on the TPU.
//
// What bounds it on the H100: per-ray prim tests (about 40 flops for a
// triangle) times the chunks that survive culling, and on bounce rays the
// culling branch itself, which keeps a chunk alive when any of the block's
// 128 rays touches its box. Design: one thread per ray in 128-thread
// blocks, so a block's rays come from one compact pixel tile (tile-major
// lane order) and cull together; each chunk's prim rows are staged once
// in shared memory and read by every thread as broadcasts; the cull votes
// are `__syncthreads_or` over the slab test. The file is built with
// -fmad=false so that every float op rounds as in the plain PyTorch
// version (`dense_trace_plain` / `dense_occlude_plain`), which lets the
// comparison on the card demand identical prim ids.
//
// C interface (loaded with ctypes): rays are 7 rows of n floats
// (ox oy oz dx dy dz t_max), ignore is n int32 sorted slots (-1 = none).
// Both functions return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;      // rays per block
constexpr int kChunk = 128;      // prims per chunk
constexpr int kSuper = 32;       // chunks per superchunk
constexpr float kEps = 2.4e-4f;  // RAY_EPSILON

// NaN-propagating min/max, as torch.minimum / torch.maximum
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) < 1e-12f ? (d < 0.0f ? -1e12f : 1e12f) : 1.0f / d;
}

// Slab test of one ray against box j of a (8, count) bounds table.
__device__ __forceinline__ bool box_hit(const float* __restrict__ tb, int count, int j,
                                        float ox, float oy, float oz,
                                        float ix, float iy, float iz, float limit) {
  float t0x = (tb[0 * count + j] - ox) * ix;
  float t1x = (tb[3 * count + j] - ox) * ix;
  float t0y = (tb[1 * count + j] - oy) * iy;
  float t1y = (tb[4 * count + j] - oy) * iy;
  float t0z = (tb[2 * count + j] - oz) * iz;
  float t1z = (tb[5 * count + j] - oz) * iz;
  float tn = pmax(pmax(pmin(t0x, t1x), pmin(t0y, t1y)), pmin(t0z, t1z));
  float tf = pmin(pmin(pmax(t0x, t1x), pmax(t0y, t1y)), pmax(t0z, t1z));
  return (tn <= tf) && (tf > 0.0f) && (tn < limit);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmax;
  int ignore;
};

// Rays past n are the padding rays of the JAX layout: they take part in
// the block votes (as on the TPU) but write nothing.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        const int* __restrict__ ignore, int n, int i) {
  Ray r;
  if (i < n) {
    r.ox = rays[0 * (size_t)n + i];
    r.oy = rays[1 * (size_t)n + i];
    r.oz = rays[2 * (size_t)n + i];
    r.dx = rays[3 * (size_t)n + i];
    r.dy = rays[4 * (size_t)n + i];
    r.dz = rays[5 * (size_t)n + i];
    r.tmax = rays[6 * (size_t)n + i];
    r.ignore = ignore[i];
  } else {
    r.ox = r.oy = r.oz = 0.0f;
    r.dx = r.dy = 0.0f;
    r.dz = 1.0f;
    r.tmax = -1.0f;
    r.ignore = -1;
  }
  return r;
}

// One prim against one ray; t is valid only where the return is true.
template <bool HAS_TRI, bool HAS_SPH>
__device__ __forceinline__ bool prim_hit(float (*sp)[kChunk], int k, int slot,
                                         const Ray& r, float& t, float& u, float& v) {
  const float ax = sp[0][k], ay = sp[1][k], az = sp[2][k];
  const float bx = sp[3][k], by = sp[4][k], bz = sp[5][k];
  const bool ignored = slot == r.ignore;
  const bool is_sph = HAS_SPH && (!HAS_TRI || sp[9][k] > 0.5f);
  u = 0.0f;
  v = 0.0f;
  if (HAS_SPH && is_sph) {
    float fx = r.ox - ax, fy = r.oy - ay, fz = r.oz - az;
    float bq = fx * r.dx + fy * r.dy + fz * r.dz;
    float cq = fx * fx + fy * fy + fz * fz - bx * bx;
    float disc = bq * bq - cq;
    float sq = sqrtf(fmaxf(disc, 0.0f));
    float t_near = -bq - sq;
    float t_far = -bq + sq;
    t = ignored ? t_far : (t_near > kEps ? t_near : t_far);
    return (disc >= 0.0f) && (t > kEps);
  }
  if (HAS_TRI) {
    const float cx = sp[6][k], cy = sp[7][k], cz = sp[8][k];
    float px = r.dy * cz - r.dz * cy;
    float py = r.dz * cx - r.dx * cz;
    float pz = r.dx * cy - r.dy * cx;
    float det = bx * px + by * py + bz * pz;
    bool det_ok = fabsf(det) > 1e-12f;
    float inv = det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
    float sx = r.ox - ax, sy = r.oy - ay, sz = r.oz - az;
    u = (sx * px + sy * py + sz * pz) * inv;
    float qx = sy * bz - sz * by;
    float qy = sz * bx - sx * bz;
    float qz = sx * by - sy * bx;
    v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
    t = (cx * qx + cy * qy + cz * qz) * inv;
    return det_ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > kEps) && !ignored;
  }
  return false;
}

// Stage chunk j's prim rows (chunk size cs) into shared memory.
__device__ __forceinline__ void stage(float (*sp)[kChunk], const float* __restrict__ prims,
                                      int padded, int j, int cs) {
  __syncthreads();  // the previous chunk's readers are done
  if (threadIdx.x < cs) {
    const int col = j * kChunk + threadIdx.x;
#pragma unroll
    for (int row = 0; row < 10; ++row) sp[row][threadIdx.x] = prims[(size_t)row * padded + col];
  }
  __syncthreads();
}

template <bool HAS_TRI, bool HAS_SPH>
__global__ void __launch_bounds__(kBlock)
trace_kernel(const float* __restrict__ rays, const int* __restrict__ ignore, int n,
             const float* __restrict__ prims, int padded,
             const float* __restrict__ cb, int n_chunks,
             const float* __restrict__ scb, int n_super,
             float* __restrict__ t_out, int* __restrict__ prim_out,
             float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float sp[10][kChunk];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const Ray r = load_ray(rays, ignore, n, i);
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const int cs = n_chunks > 1 ? kChunk : padded;

  float best_t = r.tmax, best_u = 0.0f, best_v = 0.0f;
  int best_p = -1;
  bool sc_ok = true;
  for (int j = 0; j < n_chunks; ++j) {
    if (n_chunks > 1) {
      if (n_super > 1 && j % kSuper == 0) {
        const int live = __syncthreads_or(best_t > 0.0f);
        const int hit = __syncthreads_or(
            box_hit(scb, n_super, j / kSuper, r.ox, r.oy, r.oz, ix, iy, iz, best_t));
        sc_ok = live && hit;
      }
      if (!sc_ok) continue;
      if (!__syncthreads_or(box_hit(cb, n_chunks, j, r.ox, r.oy, r.oz, ix, iy, iz, best_t)))
        continue;
    } else if (!__syncthreads_or(r.tmax > 0.0f)) {
      break;  // a dead block: no ray can record a hit
    }
    stage(sp, prims, padded, j, cs);
    const int base = j * kChunk;
    for (int k = 0; k < cs; ++k) {
      float t, u, v;
      if (prim_hit<HAS_TRI, HAS_SPH>(sp, k, base + k, r, t, u, v) && t < best_t) {
        best_t = t;
        best_p = base + k;
        best_u = u;
        best_v = v;
      }
    }
  }
  if (i < n) {
    t_out[i] = best_t;
    prim_out[i] = best_p;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

template <bool HAS_TRI, bool HAS_SPH>
__global__ void __launch_bounds__(kBlock)
occlude_kernel(const float* __restrict__ rays, const int* __restrict__ ignore, int n,
               const float* __restrict__ prims, int padded,
               const float* __restrict__ cb, int n_chunks,
               const float* __restrict__ scb, int n_super,
               uint8_t* __restrict__ blocked_out) {
  __shared__ float sp[10][kChunk];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const Ray r = load_ray(rays, ignore, n, i);
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const int cs = n_chunks > 1 ? kChunk : padded;

  bool blocked = false;
  bool sc_ok = true;
  for (int j = 0; j < n_chunks; ++j) {
    // a ray already blocked stops keeping chunks alive
    const float limit = blocked ? -1.0f : r.tmax;
    if (n_chunks > 1) {
      if (n_super > 1 && j % kSuper == 0) {
        const int live = __syncthreads_or(limit > 0.0f);
        const int hit = __syncthreads_or(
            box_hit(scb, n_super, j / kSuper, r.ox, r.oy, r.oz, ix, iy, iz, limit));
        sc_ok = live && hit;
      }
      if (!sc_ok) continue;
      if (!__syncthreads_or(box_hit(cb, n_chunks, j, r.ox, r.oy, r.oz, ix, iy, iz, limit)))
        continue;
    } else if (!__syncthreads_or(r.tmax > 0.0f)) {
      break;
    }
    stage(sp, prims, padded, j, cs);
    if (!blocked) {
      const int base = j * kChunk;
      for (int k = 0; k < cs; ++k) {
        float t, u, v;
        if (prim_hit<HAS_TRI, HAS_SPH>(sp, k, base + k, r, t, u, v) && t < r.tmax) {
          blocked = true;
          break;
        }
      }
    }
  }
  if (i < n) blocked_out[i] = blocked ? 1 : 0;
}

}  // namespace

extern "C" int dense_trace(const float* rays, const int* ignore, int n,
                           const float* prims, int padded,
                           const float* cb, int n_chunks, const float* scb, int n_super,
                           int has_tri, int has_sph,
                           float* t_out, int* prim_out, float* u_out, float* v_out,
                           void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_tri && has_sph)
    trace_kernel<true, true><<<grid, block, 0, s>>>(rays, ignore, n, prims, padded, cb,
        n_chunks, scb, n_super, t_out, prim_out, u_out, v_out);
  else if (has_tri)
    trace_kernel<true, false><<<grid, block, 0, s>>>(rays, ignore, n, prims, padded, cb,
        n_chunks, scb, n_super, t_out, prim_out, u_out, v_out);
  else
    trace_kernel<false, true><<<grid, block, 0, s>>>(rays, ignore, n, prims, padded, cb,
        n_chunks, scb, n_super, t_out, prim_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dense_occlude(const float* rays, const int* ignore, int n,
                             const float* prims, int padded,
                             const float* cb, int n_chunks, const float* scb, int n_super,
                             int has_tri, int has_sph, uint8_t* blocked_out, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_tri && has_sph)
    occlude_kernel<true, true><<<grid, block, 0, s>>>(rays, ignore, n, prims, padded, cb,
        n_chunks, scb, n_super, blocked_out);
  else if (has_tri)
    occlude_kernel<true, false><<<grid, block, 0, s>>>(rays, ignore, n, prims, padded, cb,
        n_chunks, scb, n_super, blocked_out);
  else
    occlude_kernel<false, true><<<grid, block, 0, s>>>(rays, ignore, n, prims, padded, cb,
        n_chunks, scb, n_super, blocked_out);
  return static_cast<int>(cudaGetLastError());
}
