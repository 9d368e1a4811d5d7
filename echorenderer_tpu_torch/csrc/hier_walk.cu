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
// (about 45 flops a triangle) over a chunk table that outgrows L2 (64 MB at
// 1M triangles), and the divergence of rays that walk different paths of
// the tree. Design: one thread per ray, every lane of a block's warps
// running `echo::hier_walk` together (a lane past the last ray walks a dead
// one): traversal per lane, chunk leaves postponed and tested by the whole
// warp from a stage in shared memory that a bulk asynchronous copy (TMA)
// fills, one stage a warp (hier_walk.cuh). The launch shape, 32 rays a
// block, was chosen on the H100 by measurement: the stage's 10 KiB a warp
// caps the resident warps at 20 a SM; a second stage a warp, to overlap the
// next chunk's copy with the current test, halved them and lost on every
// input, and larger blocks lost a few percent. What bounds the redesign:
// the walk's 64-entry stack in local memory, the node loads of traversal,
// and those 10 KiB a warp against the SM's 227 KiB of shared memory.
// The file is built with -fmad=false, so every float op rounds as in the
// plain PyTorch version.
//
// C interface (loaded with ctypes): rays are 7 rows of n floats
// (ox oy oz dx dy dz t_max), ignore is n int32 sorted slots (-1 = none),
// ign_inst n int32 instances of those ignores (instanced tables only),
// chunks 16-byte aligned. Both functions return cudaGetLastError() after
// the launch. `hier_occupancy(any_hit, instanced, has_tri, has_sph, out)`
// writes a form's resident blocks per SM, its block size and its dynamic
// shared memory per block to out[0..2] and returns the CUDA error code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hier_walk.cuh"

namespace {

using echo::Ray;

constexpr int kBlock = 32;  // rays per block
constexpr size_t kSmem = echo::hier_smem_bytes(kBlock / 32);
static_assert(kSmem <= 48 * 1024, "within the default dynamic shared memory");

template <bool HAS_TRI, bool HAS_SPH, bool ANY_HIT, bool INSTANCED>
__global__ void __launch_bounds__(kBlock)
hier_kernel(const float* __restrict__ rays, const int* __restrict__ ignore,
            const int* __restrict__ ign_inst, int n, echo::HierTables tb,
            float* __restrict__ t_out, int* __restrict__ prim_out,
            float* __restrict__ u_out, float* __restrict__ v_out, int* __restrict__ inst_out,
            uint8_t* __restrict__ blocked_out) {
  extern __shared__ __align__(16) float smem[];
  echo::HierStage st = echo::hier_stage_init(smem, kBlock / 32);
  const int i = blockIdx.x * kBlock + threadIdx.x;
  Ray w;  // the world ray; past the last ray a dead one, so the whole warp walks
  const bool live = i < n;
  w.ox = live ? rays[0 * (size_t)n + i] : 0.0f;
  w.oy = live ? rays[1 * (size_t)n + i] : 0.0f;
  w.oz = live ? rays[2 * (size_t)n + i] : 0.0f;
  w.dx = live ? rays[3 * (size_t)n + i] : 0.0f;
  w.dy = live ? rays[4 * (size_t)n + i] : 0.0f;
  w.dz = live ? rays[5 * (size_t)n + i] : 0.0f;
  w.tmax = live ? rays[6 * (size_t)n + i] : 0.0f;
  w.ignore = live ? ignore[i] : -1;
  const int w_ign_inst = INSTANCED && live ? ign_inst[i] : -1;
  const echo::HierHit h =
      echo::hier_walk<HAS_TRI, HAS_SPH, ANY_HIT, INSTANCED>(tb, w, w_ign_inst, st);
  if (!live) return;
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
  hier_kernel<TRI, SPH, ANY_HIT, INSTANCED><<<grid, block, kSmem, s>>>(              \
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

// One form's kernel, for the occupancy query.
template <bool ANY_HIT, bool INSTANCED>
const void* kernel_of(int has_tri, int has_sph) {
  if (has_tri && has_sph)
    return reinterpret_cast<const void*>(hier_kernel<true, true, ANY_HIT, INSTANCED>);
  if (has_tri) return reinterpret_cast<const void*>(hier_kernel<true, false, ANY_HIT, INSTANCED>);
  return reinterpret_cast<const void*>(hier_kernel<false, true, ANY_HIT, INSTANCED>);
}

}  // namespace

extern "C" int hier_occupancy(int any_hit, int instanced, int has_tri, int has_sph, int* out) {
  const void* fn = any_hit ? (instanced ? kernel_of<true, true>(has_tri, has_sph)
                                        : kernel_of<true, false>(has_tri, has_sph))
                           : (instanced ? kernel_of<false, true>(has_tri, has_sph)
                                        : kernel_of<false, false>(has_tri, has_sph));
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kBlock, kSmem);
  out[0] = blocks;
  out[1] = kBlock;
  out[2] = static_cast<int>(kSmem);
  return static_cast<int>(err);
}

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
