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
// the block can reach its AABB before that ray's current best t (with the
// relative slack echo::kCullMargin), and a 32-chunk superchunk likewise. The ray-prim test (Moller-Trumbore, the
// findFar sphere rule) is `echo::prim_hit` of intersect.cuh, shared with
// the megakernel. A running best is replaced only on a strictly
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

#include "intersect.cuh"

namespace {

using echo::Ray;
using echo::safe_inv;

constexpr int kBlock = 128;  // rays per block
constexpr int kChunk = 128;  // prims per chunk
constexpr int kSuper = 32;   // chunks per superchunk

// Slab test of one ray against box j of a (8, count) bounds table.
__device__ __forceinline__ bool box_hit(const float* __restrict__ tb, int count, int j,
                                        float ox, float oy, float oz,
                                        float ix, float iy, float iz, float limit) {
  float tn, tf;
  echo::slab(tb[0 * count + j], tb[1 * count + j], tb[2 * count + j],
             tb[3 * count + j], tb[4 * count + j], tb[5 * count + j],
             ox, oy, oz, ix, iy, iz, tn, tf);
  return echo::reaches(tn, tf, limit);
}

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
      if (echo::prim_hit<HAS_TRI, HAS_SPH>(&sp[0][0], kChunk, k, base + k, r, t, u, v) &&
          t < best_t) {
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
        if (echo::prim_hit<HAS_TRI, HAS_SPH>(&sp[0][0], kChunk, k, base + k, r, t, u, v) &&
            t < r.tmax) {
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
