// Chunk-tree walk for large scenes: closest-hit and any-hit kernels for Hopper.
//
// Replaces the Pallas TPU kernel `_hier_kernel` of
// echorenderer_tpu/ops/pallas_hier.py (line 498), which the JAX package
// reaches through `intersect_hier` / `occlude_hier`, in both its forms: the
// chunk tree of one geometry, and (`instanced`) a TLAS over instances whose
// leaves descend a shared pack's subtree in the instance's space.
//
// What it computes: for every ray, the closest hit (t, sorted prim slot, u,
// v, and for instanced tables the instance) or an any-hit flag over the real
// prims of a binary SAH tree whose leaves are 256-prim chunks. The walk
// itself, its tables, its tie rule (the least (t, sorted slot, instance),
// independent of visit order, hence bit for bit what the dense kernels and
// the plain version `hier_trace_plain` return), its cull slack and its
// instance moves are `echo::hier_walk` of hier_walk.cuh, which the fused
// megakernel's large-scene form calls too.
//
// What bounds it on the H100: the prim tests of the chunks a ray enters
// (about 45 flops a triangle), and the divergence of rays that walk
// different paths of the tree. Design: one thread per ray in 128-thread
// blocks, each running `echo::hier_walk` (a per-thread stack in local
// memory; node boxes, codes and instance rows, ~220 KB at 1M prims and
// L2-resident, through the read-only cache; chunk rows straight from global
// memory). Warp-cooperative leaf loads into shared memory, cp.async double
// buffering of chunks and persistent threads are left for later work.
// The file is built with -fmad=false, so every float op rounds as in the
// plain PyTorch version.
//
// C interface (loaded with ctypes): rays are 7 rows of n floats
// (ox oy oz dx dy dz t_max), ignore is n int32 sorted slots (-1 = none),
// ign_inst n int32 instances of those ignores (instanced tables only).
// Both functions return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hier_walk.cuh"

namespace {

using echo::Ray;

constexpr int kBlock = 128;  // rays per block

template <bool HAS_TRI, bool HAS_SPH, bool ANY_HIT, bool INSTANCED>
__global__ void __launch_bounds__(kBlock)
hier_kernel(const float* __restrict__ rays, const int* __restrict__ ignore,
            const int* __restrict__ ign_inst, int n, echo::HierTables tb,
            float* __restrict__ t_out, int* __restrict__ prim_out,
            float* __restrict__ u_out, float* __restrict__ v_out, int* __restrict__ inst_out,
            uint8_t* __restrict__ blocked_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  Ray w;  // the world ray
  w.ox = rays[0 * (size_t)n + i];
  w.oy = rays[1 * (size_t)n + i];
  w.oz = rays[2 * (size_t)n + i];
  w.dx = rays[3 * (size_t)n + i];
  w.dy = rays[4 * (size_t)n + i];
  w.dz = rays[5 * (size_t)n + i];
  w.tmax = rays[6 * (size_t)n + i];
  w.ignore = ignore[i];
  const echo::HierHit h = echo::hier_walk<HAS_TRI, HAS_SPH, ANY_HIT, INSTANCED>(
      tb, w, INSTANCED ? ign_inst[i] : -1);
  if (ANY_HIT) {
    blocked_out[i] = h.blocked ? 1 : 0;
  } else {
    t_out[i] = h.t;
    prim_out[i] = h.prim;
    u_out[i] = h.u;
    v_out[i] = h.v;
    if (INSTANCED) inst_out[i] = h.inst;
  }
}

template <bool ANY_HIT, bool INSTANCED>
int launch(const float* rays, const int* ignore, const int* ign_inst, int n,
           const float* chunks, const float* bounds, const int* codes, int root_code,
           const float* inst_f32, const int* inst_codes, int has_tri, int has_sph,
           float* t_out, int* prim_out, float* u_out, float* v_out, int* inst_out,
           uint8_t* blocked_out, void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const echo::HierTables tb{chunks, bounds, codes, root_code, inst_f32, inst_codes};
#define ECHO_HIER_LAUNCH(TRI, SPH)                                                   \
  hier_kernel<TRI, SPH, ANY_HIT, INSTANCED><<<grid, block, 0, s>>>(                  \
      rays, ignore, ign_inst, n, tb, t_out, prim_out, u_out, v_out, inst_out, blocked_out)
  if (has_tri && has_sph)
    ECHO_HIER_LAUNCH(true, true);
  else if (has_tri)
    ECHO_HIER_LAUNCH(true, false);
  else
    ECHO_HIER_LAUNCH(false, true);
#undef ECHO_HIER_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hier_trace(const float* rays, const int* ignore, const int* ign_inst, int n,
                          const float* chunks, const float* bounds, const int* codes,
                          int root_code, const float* inst_f32, const int* inst_codes,
                          int has_tri, int has_sph, int instanced, float* t_out, int* prim_out,
                          float* u_out, float* v_out, int* inst_out, void* stream) {
  if (instanced)
    return launch<false, true>(rays, ignore, ign_inst, n, chunks, bounds, codes, root_code,
                               inst_f32, inst_codes, has_tri, has_sph, t_out, prim_out, u_out,
                               v_out, inst_out, nullptr, stream);
  return launch<false, false>(rays, ignore, nullptr, n, chunks, bounds, codes, root_code,
                              nullptr, nullptr, has_tri, has_sph, t_out, prim_out, u_out, v_out,
                              nullptr, nullptr, stream);
}

extern "C" int hier_occlude(const float* rays, const int* ignore, const int* ign_inst, int n,
                            const float* chunks, const float* bounds, const int* codes,
                            int root_code, const float* inst_f32, const int* inst_codes,
                            int has_tri, int has_sph, int instanced, uint8_t* blocked_out,
                            void* stream) {
  if (instanced)
    return launch<true, true>(rays, ignore, ign_inst, n, chunks, bounds, codes, root_code,
                              inst_f32, inst_codes, has_tri, has_sph, nullptr, nullptr, nullptr,
                              nullptr, nullptr, blocked_out, stream);
  return launch<true, false>(rays, ignore, nullptr, n, chunks, bounds, codes, root_code, nullptr,
                             nullptr, has_tri, has_sph, nullptr, nullptr, nullptr, nullptr,
                             nullptr, blocked_out, stream);
}
