// Chunk-tree walk for large scenes: closest-hit and any-hit kernels for Hopper.
//
// Replaces the Pallas TPU kernel `_hier_kernel` of
// echorenderer_tpu/ops/pallas_hier.py (line 498), which the JAX package
// reaches through `intersect_hier` / `occlude_hier` (its non-instanced form).
//
// What it computes: for every ray, the closest hit (t, sorted prim slot, u,
// v) or an any-hit flag over the real prims of a binary SAH tree whose
// leaves are 256-prim chunks. The chunks are (C, 16, 256) floats (rows 0-9:
// a/b/c xyz, is_sphere; a sphere keeps its center in a and its radius in
// b.x); an interior node holds its two children's boxes (12 floats: child 0
// min xyz, max xyz, then child 1) and their codes (>= 0 node, < 0 leaf
// chunk -(1 + chunk)). The ray-prim test is `echo::prim_hit` and the box
// test `echo::slab`, both of intersect.cuh, shared with the dense kernels.
// A closest hit is the lexicographic least (t, sorted slot) over the hits
// with t < t_max: a hit replaces the best when `t < best_t`, or when
// `t == best_t` and its slot is lower. That result does not depend on the
// order in which the walk visits the chunks, so it is bit for bit what the
// dense kernels return (they visit slots in ascending order with strict-less
// updates) and what the plain version `hier_trace_plain` returns. A box is
// entered while its entry t is at most the best t (t_max for any hit)
// times echo::kCullMargin, so that a hit on a box's boundary, whose t may
// come out a rounding step before the box's computed entry, is not lost.
//
// What bounds it on the H100: the prim tests of the chunks a ray enters
// (about 45 flops a triangle), and the divergence of rays that walk
// different paths of the tree. Design: one thread per ray in 128-thread
// blocks; a per-thread stack of (code, entry t) in local memory, sized by
// kStack (the wrapper checks the tree's `stack_size` against it); an
// interior node pushes its far child first so the near one pops first, and
// an entry popped after the best t has moved below its entry t (with the
// same slack) is skipped;
// node boxes and codes (~220 KB at 1M prims, L2-resident) are read through
// the read-only cache, the chunk rows straight from global memory. A ray
// with t_max <= 0 returns at once; an any-hit ray stops at its first
// blocker. Warp-cooperative leaf loads into shared memory, cp.async double
// buffering of chunks and persistent threads are left for later work. The
// file is built with -fmad=false, so every float op rounds as in the plain
// PyTorch version.
//
// C interface (loaded with ctypes): rays are 7 rows of n floats
// (ox oy oz dx dy dz t_max), ignore is n int32 sorted slots (-1 = none).
// Both functions return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "intersect.cuh"

namespace {

using echo::Ray;

constexpr int kBlock = 128;  // rays per block
constexpr int kChunk = 256;  // prims per chunk (HCHUNK)
constexpr int kRows = 16;    // float rows per chunk record
constexpr int kStack = 64;   // per-thread stack entries (ops/pallas_hier.MAX_STACK)

// One child's 6 bounds (of an interior node's 12): entered before `limit`?
// (the entry t goes to tn)
__device__ __forceinline__ bool child_hit(const float* __restrict__ b, const Ray& r,
                                          float ix, float iy, float iz, float limit,
                                          float& tn) {
  float tf;
  echo::slab(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3), __ldg(b + 4),
             __ldg(b + 5), r.ox, r.oy, r.oz, ix, iy, iz, tn, tf);
  return echo::reaches(tn, tf, limit);
}

template <bool HAS_TRI, bool HAS_SPH, bool ANY_HIT>
__global__ void __launch_bounds__(kBlock)
hier_kernel(const float* __restrict__ rays, const int* __restrict__ ignore, int n,
            const float* __restrict__ chunks, const float* __restrict__ bounds,
            const int* __restrict__ codes, int root_code,
            float* __restrict__ t_out, int* __restrict__ prim_out,
            float* __restrict__ u_out, float* __restrict__ v_out,
            uint8_t* __restrict__ blocked_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  Ray r;
  r.ox = rays[0 * (size_t)n + i];
  r.oy = rays[1 * (size_t)n + i];
  r.oz = rays[2 * (size_t)n + i];
  r.dx = rays[3 * (size_t)n + i];
  r.dy = rays[4 * (size_t)n + i];
  r.dz = rays[5 * (size_t)n + i];
  r.tmax = rays[6 * (size_t)n + i];
  r.ignore = ignore[i];
  const float ix = echo::safe_inv(r.dx), iy = echo::safe_inv(r.dy), iz = echo::safe_inv(r.dz);

  float best_t = r.tmax, best_u = 0.0f, best_v = 0.0f;
  int best_p = -1;
  bool blocked = false;
  int stack_code[kStack];
  float stack_tn[kStack];
  int sp = 0;
  if (r.tmax > 0.0f) {  // dead rays (t_max <= 0) do no work
    stack_code[0] = root_code;
    stack_tn[0] = -INFINITY;
    sp = 1;
  }
  while (sp > 0) {
    --sp;
    const int code = stack_code[sp];
    // no longer reachable (`echo::reaches` with the best t as the limit)
    if (!ANY_HIT && stack_tn[sp] > best_t * echo::kCullMargin) continue;
    if (code >= 0) {
      const float* b = bounds + 12 * (size_t)code;
      const float limit = ANY_HIT ? r.tmax : best_t;
      float tn0, tn1;
      const bool h0 = child_hit(b, r, ix, iy, iz, limit, tn0);
      const bool h1 = child_hit(b + 6, r, ix, iy, iz, limit, tn1);
      const int c0 = __ldg(codes + 2 * (size_t)code);
      const int c1 = __ldg(codes + 2 * (size_t)code + 1);
      const bool near0 = tn0 <= tn1;
      if (near0 ? h1 : h0) {  // far child first: the near one pops first
        stack_code[sp] = near0 ? c1 : c0;
        stack_tn[sp] = near0 ? tn1 : tn0;
        ++sp;
      }
      if (near0 ? h0 : h1) {
        stack_code[sp] = near0 ? c0 : c1;
        stack_tn[sp] = near0 ? tn0 : tn1;
        ++sp;
      }
      continue;
    }
    const int chunk = -(code + 1);
    const float* rows = chunks + (size_t)chunk * kRows * kChunk;
    const int base = chunk * kChunk;
    for (int k = 0; k < kChunk; ++k) {
      float t, u, v;
      if (!echo::prim_hit<HAS_TRI, HAS_SPH>(rows, kChunk, k, base + k, r, t, u, v)) continue;
      if (ANY_HIT) {
        if (t < r.tmax) {
          blocked = true;
          break;
        }
      } else if (t < best_t || (t == best_t && best_p >= 0 && base + k < best_p)) {
        best_t = t;
        best_p = base + k;
        best_u = u;
        best_v = v;
      }
    }
    if (ANY_HIT && blocked) break;
  }
  if (ANY_HIT) {
    blocked_out[i] = blocked ? 1 : 0;
  } else {
    t_out[i] = best_t;
    prim_out[i] = best_p;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

template <bool ANY_HIT>
int launch(const float* rays, const int* ignore, int n, const float* chunks,
           const float* bounds, const int* codes, int root_code, int has_tri, int has_sph,
           float* t_out, int* prim_out, float* u_out, float* v_out, uint8_t* blocked_out,
           void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_tri && has_sph)
    hier_kernel<true, true, ANY_HIT><<<grid, block, 0, s>>>(
        rays, ignore, n, chunks, bounds, codes, root_code, t_out, prim_out, u_out, v_out,
        blocked_out);
  else if (has_tri)
    hier_kernel<true, false, ANY_HIT><<<grid, block, 0, s>>>(
        rays, ignore, n, chunks, bounds, codes, root_code, t_out, prim_out, u_out, v_out,
        blocked_out);
  else
    hier_kernel<false, true, ANY_HIT><<<grid, block, 0, s>>>(
        rays, ignore, n, chunks, bounds, codes, root_code, t_out, prim_out, u_out, v_out,
        blocked_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hier_trace(const float* rays, const int* ignore, int n, const float* chunks,
                          const float* bounds, const int* codes, int root_code, int has_tri,
                          int has_sph, float* t_out, int* prim_out, float* u_out, float* v_out,
                          void* stream) {
  return launch<false>(rays, ignore, n, chunks, bounds, codes, root_code, has_tri, has_sph,
                       t_out, prim_out, u_out, v_out, nullptr, stream);
}

extern "C" int hier_occlude(const float* rays, const int* ignore, int n, const float* chunks,
                            const float* bounds, const int* codes, int root_code, int has_tri,
                            int has_sph, uint8_t* blocked_out, void* stream) {
  return launch<true>(rays, ignore, n, chunks, bounds, codes, root_code, has_tri, has_sph,
                      nullptr, nullptr, nullptr, nullptr, blocked_out, stream);
}
