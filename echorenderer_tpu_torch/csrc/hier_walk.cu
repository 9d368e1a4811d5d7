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
// prims of a binary SAH tree whose leaves are 256-prim chunks. The chunks are
// (C, 16, 256) floats (rows 0-9: a/b/c xyz, is_sphere; a sphere keeps its
// center in a and its radius in b.x); an interior node holds its two
// children's boxes (12 floats: child 0 min xyz, max xyz, then child 1) and
// their codes (>= 0 node, < 0 leaf -(1 + e): a chunk for e < kInstBase, an
// instance e - kInstBase below kRestoreE, the RESTORE entry at kRestoreE).
// The ray-prim test is `echo::prim_hit` and the box test `echo::slab`, both
// of intersect.cuh, shared with the dense kernels.
// A closest hit is the lexicographic least (t, sorted slot, instance) over
// the hits with t < t_max: a hit replaces the best when `t < best_t`, or when
// `t == best_t` and its slot is lower, or its slot equal and its instance
// lower. That result does not depend on the order in which the walk visits
// the chunks, so it is bit for bit what the dense kernels return (they visit
// slots in ascending order with strict-less updates) and what the plain
// version `hier_trace_plain` returns. A box is entered while its entry t is
// at most the best t (t_max for any hit) times echo::kCullMargin, so that a
// hit on a box's boundary, whose t may come out a rounding step before the
// box's computed entry, is not lost.
//
// Instances: at an instance leaf the thread moves its world ray into the
// instance's space with the instance's 12 floats (A row-major, then b:
// o' = A o + b, d' = A d, each row summed left to right and then + b, as the
// plain version's `vec.affine`), so |d'| is 1/scale and t stays the world
// parameter: one best t culls boxes of every space, and spheres take the
// full quadratic (prim_hit's UNIT_DIR = false). It then pushes the RESTORE
// entry (entry t -inf: never skipped) and the pack's root code (with the
// instance box's entry t); popping RESTORE returns to the world ray. The
// ray's ignored prim is skipped only inside the instance `ign_inst` names.
//
// What bounds it on the H100: the prim tests of the chunks a ray enters
// (about 45 flops a triangle), and the divergence of rays that walk
// different paths of the tree. Design: one thread per ray in 128-thread
// blocks; a per-thread stack of (code, entry t) in local memory, sized by
// kStack (the wrapper checks the tree's `stack_size` against it); an
// interior node pushes its far child first so the near one pops first, and
// an entry popped after the best t has moved below its entry t (with the
// same slack) is skipped;
// node boxes, codes and instance rows (~220 KB at 1M prims, L2-resident) are
// read through the read-only cache, the chunk rows straight from global
// memory. A ray with t_max <= 0 returns at once; an any-hit ray stops at its
// first blocker. Warp-cooperative leaf loads into shared memory, cp.async
// double buffering of chunks and persistent threads are left for later work.
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

constexpr int kInstBase = 1 << 23;  // ops/pallas_hier.INST_BASE
constexpr int kRestoreE = 1 << 24;  // ops/pallas_hier.RESTORE_E
constexpr int kRestoreCode = -(1 + kRestoreE);

template <bool HAS_TRI, bool HAS_SPH, bool ANY_HIT, bool INSTANCED>
__global__ void __launch_bounds__(kBlock)
hier_kernel(const float* __restrict__ rays, const int* __restrict__ ignore,
            const int* __restrict__ ign_inst, int n, const float* __restrict__ chunks,
            const float* __restrict__ bounds, const int* __restrict__ codes, int root_code,
            const float* __restrict__ inst_f32, const int* __restrict__ inst_codes,
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
  const int w_ign_inst = INSTANCED ? ign_inst[i] : -1;
  const float wix = echo::safe_inv(w.dx), wiy = echo::safe_inv(w.dy), wiz = echo::safe_inv(w.dz);
  Ray r = w;  // the ray of the current space
  float ix = wix, iy = wiy, iz = wiz;
  int cur_inst = -1;

  float best_t = w.tmax, best_u = 0.0f, best_v = 0.0f;
  int best_p = -1, best_i = 0;
  bool blocked = false;
  int stack_code[kStack];
  float stack_tn[kStack];
  int sp = 0;
  if (w.tmax > 0.0f) {  // dead rays (t_max <= 0) do no work
    stack_code[0] = root_code;
    stack_tn[0] = -INFINITY;
    sp = 1;
  }
  while (sp > 0) {
    --sp;
    const int code = stack_code[sp];
    const float tn_entry = stack_tn[sp];
    // no longer reachable (`echo::reaches` with the best t as the limit)
    if (!ANY_HIT && tn_entry > best_t * echo::kCullMargin) continue;
    if (code >= 0) {
      const float* b = bounds + 12 * (size_t)code;
      const float limit = ANY_HIT ? w.tmax : best_t;
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
    const int e = -(code + 1);
    if (INSTANCED && e >= kInstBase) {
      if (e == kRestoreE) {  // back to the world ray
        r = w;
        ix = wix;
        iy = wiy;
        iz = wiz;
        cur_inst = -1;
        continue;
      }
      const int inst = e - kInstBase;
      const float* a = inst_f32 + 12 * (size_t)inst;
      const float a0 = __ldg(a + 0), a1 = __ldg(a + 1), a2 = __ldg(a + 2);
      const float a3 = __ldg(a + 3), a4 = __ldg(a + 4), a5 = __ldg(a + 5);
      const float a6 = __ldg(a + 6), a7 = __ldg(a + 7), a8 = __ldg(a + 8);
      r.ox = a0 * w.ox + a1 * w.oy + a2 * w.oz + __ldg(a + 9);
      r.oy = a3 * w.ox + a4 * w.oy + a5 * w.oz + __ldg(a + 10);
      r.oz = a6 * w.ox + a7 * w.oy + a8 * w.oz + __ldg(a + 11);
      r.dx = a0 * w.dx + a1 * w.dy + a2 * w.dz;
      r.dy = a3 * w.dx + a4 * w.dy + a5 * w.dz;
      r.dz = a6 * w.dx + a7 * w.dy + a8 * w.dz;
      r.ignore = w_ign_inst == inst ? w.ignore : -1;  // only inside its own instance
      ix = echo::safe_inv(r.dx);
      iy = echo::safe_inv(r.dy);
      iz = echo::safe_inv(r.dz);
      cur_inst = inst;
      stack_code[sp] = kRestoreCode;
      stack_tn[sp] = -INFINITY;
      ++sp;
      stack_code[sp] = __ldg(inst_codes + inst);
      stack_tn[sp] = tn_entry;
      ++sp;
      continue;
    }
    const int chunk = e;
    const float* rows = chunks + (size_t)chunk * kRows * kChunk;
    const int base = chunk * kChunk;
    for (int k = 0; k < kChunk; ++k) {
      float t, u, v;
      if (!echo::prim_hit<HAS_TRI, HAS_SPH, !INSTANCED>(rows, kChunk, k, base + k, r, t, u, v))
        continue;
      if (ANY_HIT) {
        if (t < w.tmax) {
          blocked = true;
          break;
        }
      } else if (t < best_t ||
                 (t == best_t && best_p >= 0 &&
                  (base + k < best_p || (INSTANCED && base + k == best_p && cur_inst < best_i)))) {
        best_t = t;
        best_p = base + k;
        best_u = u;
        best_v = v;
        best_i = cur_inst;
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
    if (INSTANCED) inst_out[i] = best_i;
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
#define ECHO_HIER_LAUNCH(TRI, SPH)                                                              \
  hier_kernel<TRI, SPH, ANY_HIT, INSTANCED><<<grid, block, 0, s>>>(                             \
      rays, ignore, ign_inst, n, chunks, bounds, codes, root_code, inst_f32, inst_codes, t_out, \
      prim_out, u_out, v_out, inst_out, blocked_out)
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
