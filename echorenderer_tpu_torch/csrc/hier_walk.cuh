// The chunk-tree walk: closest hit or any hit over the chunk tree of a
// large scene, in both its forms (the tree of one geometry, and a TLAS over
// instances whose leaves descend a shared pack's subtree in the instance's
// space), for the 32 rays of one warp at a time. One copy, shared by the
// walk kernels of hier_walk.cu and the fused megakernel's large-scene form
// (megakernel.cu), so that both report the same hits by construction.
//
// Tables: the chunks are (C, 16, 256) floats (rows 0-9: a/b/c xyz,
// is_sphere; a sphere keeps its center in a and its radius in b.x); an
// interior node holds its two children's boxes (12 floats: child 0 min xyz,
// max xyz, then child 1) and their codes (>= 0 node, < 0 leaf -(1 + e): a
// chunk for e < kInstBase, an instance e - kInstBase below kRestoreE, the
// RESTORE entry at kRestoreE). The ray-prim test is `echo::prim_hit` and
// the box test `echo::slab`, both of intersect.cuh.
//
// A closest hit is the lexicographic least (t, sorted slot, instance) over
// the hits with t < t_max: a hit replaces the best when `t < best_t`, or
// when `t == best_t` and its slot is lower, or its slot equal and its
// instance lower. That result does not depend on the order in which the
// walk visits the chunks, nor on how a chunk's prims are split between
// threads, so it is bit for bit what the dense kernels return (they visit
// slots in ascending order with strict-less updates). A box is entered
// while its entry t is at most the best t (t_max for any hit) times
// echo::kCullMargin, so that a hit on a box's boundary, whose t may come
// out a rounding step before the box's computed entry, is not lost.
//
// Instances: at an instance leaf the walk moves its world ray into the
// instance's space with the instance's 12 floats (A row-major, then b:
// o' = A o + b, d' = A d, each row summed left to right and then + b, as
// the plain version's `vec.affine`), so |d'| is 1/scale and t stays the
// world parameter: one best t culls boxes of every space, and spheres take
// the full quadratic (prim_hit's UNIT_DIR = false). It then pushes the
// RESTORE entry (entry t -inf: never skipped) and the pack's root code
// (with the instance box's entry t); popping RESTORE returns to the world
// ray. The ray's ignored prim is skipped only inside the instance
// `ign_inst` names.
//
// Design (what bounds the walk on the H100 is the prim tests of the chunks
// a ray enters, ~45 flops a triangle, fed from a chunk table larger than
// L2, by rays whose walks diverge):
//   - traversal is one thread per ray: each lane pops and box-tests
//     interior nodes from its own stack of kHierStack (code, entry t) pairs
//     in local memory (node boxes, codes and instance rows through the
//     read-only cache); the far child is pushed first so the near one pops
//     first, and an entry popped after the best t has moved below its entry
//     t (with the same slack) is skipped. Instance leaves and RESTORE are
//     traversal steps of their lane;
//   - leaves are postponed (Aila and Laine's while-while): a lane that pops
//     a chunk leaf holds it until every lane of the warp holds one or has
//     an empty stack. Each lane's pops, culls and tests are then exactly
//     those of a walk on its own;
//   - the leaf phase tests the held leaves with the whole warp: lanes are
//     grouped by chunk (`__match_any_sync`); for each distinct chunk one
//     lane issues a bulk asynchronous copy (TMA, `cp.async.bulk`, no tensor
//     map) of its rows 0-9, 10,240 contiguous bytes, into the warp's stage
//     in shared memory, completed on an mbarrier. The g rays of the group take g x 256 (member, prim) pairs: in step s lane
//     j tests prim 32 s + j against one member's ray (broadcast from its
//     lane by shuffles), so all 32 lanes are busy for any g and the shared
//     reads are conflict-free. A butterfly of `__shfl_xor_sync` reduces
//     the lexicographic least (t, slot) of the chunk (the member's instance
//     is the same for all its pairs), `__any_sync` the blocked flag; the
//     member's lane merges it into its best under the rule above. A traced
//     ray's new best t culls its next pops; a blocked shadow ray stops.
// Every lane of the warp must call the walk together (a lane with nothing
// to trace passes t_max <= 0, which does no work): the leaf phase uses the
// whole warp (kFullWarp) and the warp's stage. A ray with t_max <= 0 does
// no work; an any-hit walk stops at its first blocker.

#pragma once

#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "intersect.cuh"

namespace echo {

constexpr int kHierChunk = 256;     // prims per chunk (HCHUNK)
constexpr int kHierRows = 16;       // float rows per chunk record
constexpr int kHierStack = 64;      // stack entries (ops/pallas_hier.MAX_STACK)
constexpr int kInstBase = 1 << 23;  // ops/pallas_hier.INST_BASE
constexpr int kRestoreE = 1 << 24;  // ops/pallas_hier.RESTORE_E
constexpr int kRestoreCode = -(1 + kRestoreE);
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kStageFloats = 10 * kHierChunk;  // rows 0-9 of a chunk record
constexpr unsigned kStageBytes = kStageFloats * 4;
constexpr int kStageSteps = kHierChunk / 32;   // prims per lane of one member's test

struct HierTables {
  const float* chunks;    // (C, 16, 256)
  const float* bounds;    // (B * 12,)
  const int* codes;       // (B * 2,)
  int root_code;
  const float* inst_f32;  // (I * 12,) instanced tables only
  const int* inst_codes;  // (I,) instanced tables only
};

// The walk's result: the closest hit (t = t_max and prim -1 on a miss) or
// the any-hit flag.
struct HierHit {
  float t, u, v;
  int prim, inst;
  bool blocked;
};

// One warp's stage in shared memory: a (10, 256) float buffer and its
// mbarrier.
struct HierStage {
  float* rows;     // this warp's buffer
  uint32_t bar;    // shared-window address of this warp's mbarrier
  uint32_t phase;  // the parity the stage waits for next (the same in every lane)
};

// Dynamic shared memory of a block of `warps` warps: their buffers, then
// their barriers.
__host__ __device__ constexpr size_t hier_smem_bytes(int warps) {
  return (size_t)warps * (kStageBytes + 8);
}

// The calling warp's stage in a block's dynamic shared memory `smem` (16-
// byte aligned, hier_smem_bytes(warps) bytes), its barrier initialised.
// Every lane of the warp calls it.
__device__ __forceinline__ HierStage hier_stage_init(float* smem, int warps) {
  const int warp = threadIdx.x >> 5;
  HierStage st;
  st.rows = smem + (size_t)warp * kStageFloats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (size_t)warps * kStageFloats);
  st.bar = static_cast<uint32_t>(__cvta_generic_to_shared(bars + warp));
  st.phase = 0;
  if ((threadIdx.x & 31) == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(st.bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  return st;
}

// One lane: copy rows 0-9 of chunk record `src` (16-byte aligned) into the
// stage (the warp has finished reading it), completing on its barrier.
__device__ __forceinline__ void hier_stage_load(const HierStage& st, const float* src) {
  const uint32_t bar = st.bar;
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(st.rows));
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(kStageBytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];"
               :: "r"(dst), "l"(src), "r"(kStageBytes), "r"(bar) : "memory");
}

// Every lane: wait until the stage holds its copy.
__device__ __forceinline__ void hier_stage_wait(HierStage& st) {
  const uint32_t bar = st.bar;
  const uint32_t parity = st.phase;
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
  st.phase ^= 1u;
}

// One child's 6 bounds (of an interior node's 12): entered before `limit`?
// (the entry t goes to tn)
__device__ __forceinline__ bool hier_child_hit(const float* __restrict__ b, const Ray& r,
                                               float ix, float iy, float iz, float limit,
                                               float& tn) {
  float tf;
  slab(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3), __ldg(b + 4), __ldg(b + 5),
       r.ox, r.oy, r.oz, ix, iy, iz, tn, tf);
  return reaches(tn, tf, limit);
}

// Walk the world ray `w` (its ignore a sorted slot, valid inside instance
// `w_ign_inst` on instanced tables) over the tree of `tb`, together with
// the other 31 lanes of the warp, whose stage is `st`.
template <bool HAS_TRI, bool HAS_SPH, bool ANY_HIT, bool INSTANCED>
__device__ __forceinline__ HierHit hier_walk(const HierTables& tb, const Ray& w,
                                             int w_ign_inst, HierStage& st) {
  const float* __restrict__ bounds = tb.bounds;
  const int* __restrict__ codes = tb.codes;
  const int lane = threadIdx.x & 31;
  const float wix = safe_inv(w.dx), wiy = safe_inv(w.dy), wiz = safe_inv(w.dz);
  Ray r = w;  // the ray of the current space
  float ix = wix, iy = wiy, iz = wiz;
  int cur_inst = -1;

  HierHit h;
  h.t = w.tmax;
  h.u = h.v = 0.0f;
  h.prim = -1;
  h.inst = 0;
  h.blocked = false;
  int stack_code[kHierStack];
  float stack_tn[kHierStack];
  int sp = 0;
  if (w.tmax > 0.0f) {  // dead rays (t_max <= 0) do no work
    stack_code[0] = tb.root_code;
    stack_tn[0] = -INFINITY;
    sp = 1;
  }
  for (;;) {
    // --- traversal: pop until this lane holds a chunk leaf or has no stack ---
    int held = -1;
    while (held < 0 && sp > 0) {
      --sp;
      const int code = stack_code[sp];
      const float tn_entry = stack_tn[sp];
      // no longer reachable (`reaches` with the best t as the limit)
      if (!ANY_HIT && tn_entry > h.t * kCullMargin) continue;
      if (code >= 0) {
        const float* b = bounds + 12 * (size_t)code;
        const float limit = ANY_HIT ? w.tmax : h.t;
        float tn0, tn1;
        const bool h0 = hier_child_hit(b, r, ix, iy, iz, limit, tn0);
        const bool h1 = hier_child_hit(b + 6, r, ix, iy, iz, limit, tn1);
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
        const float* a = tb.inst_f32 + 12 * (size_t)inst;
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
        ix = safe_inv(r.dx);
        iy = safe_inv(r.dy);
        iz = safe_inv(r.dz);
        cur_inst = inst;
        stack_code[sp] = kRestoreCode;
        stack_tn[sp] = -INFINITY;
        ++sp;
        stack_code[sp] = __ldg(tb.inst_codes + inst);
        stack_tn[sp] = tn_entry;
        ++sp;
        continue;
      }
      held = e;  // a chunk: postponed to the leaf phase
    }

    // --- leaf phase: the warp tests every held chunk against its holders ---
    unsigned pending = __ballot_sync(kFullWarp, held >= 0);
    if (pending == 0) break;
    const unsigned peers = __match_any_sync(kFullWarp, held);
    int lead = __ffs(pending) - 1;
    {
      const int c = __shfl_sync(kFullWarp, held, lead);
      if (lane == 0) hier_stage_load(st, tb.chunks + (size_t)c * kHierRows * kHierChunk);
    }
    for (;;) {
      const unsigned group = __shfl_sync(kFullWarp, peers, lead);
      const int chunk = __shfl_sync(kFullWarp, held, lead);
      pending &= ~group;
      const int next = pending ? __ffs(pending) - 1 : -1;
      hier_stage_wait(st);
      const float* rows = st.rows;
      const int base = chunk * kHierChunk;
      unsigned members = group;
      while (members) {
        const int m = __ffs(members) - 1;
        members &= members - 1;
        Ray rm;  // member m's ray in its current space
        rm.ox = __shfl_sync(kFullWarp, r.ox, m);
        rm.oy = __shfl_sync(kFullWarp, r.oy, m);
        rm.oz = __shfl_sync(kFullWarp, r.oz, m);
        rm.dx = __shfl_sync(kFullWarp, r.dx, m);
        rm.dy = __shfl_sync(kFullWarp, r.dy, m);
        rm.dz = __shfl_sync(kFullWarp, r.dz, m);
        rm.tmax = __shfl_sync(kFullWarp, w.tmax, m);
        rm.ignore = __shfl_sync(kFullWarp, r.ignore, m);
        if (ANY_HIT) {
#pragma unroll 2
          for (int step = 0; step < kStageSteps; ++step) {
            const int k = 32 * step + lane;
            float t, u, v;
            const bool hit = prim_hit<HAS_TRI, HAS_SPH, !INSTANCED>(rows, kHierChunk, k, base + k,
                                                                    rm, t, u, v) &&
                             t < rm.tmax;
            if (__any_sync(kFullWarp, hit)) {  // blocked: the member is done
              if (lane == m) {
                h.blocked = true;
                sp = 0;
              }
              break;
            }
          }
        } else {
          // this lane's least (t, slot) of its 8 prims: slots ascend, so a
          // strict < keeps the lower slot of equal t
          float bt = INFINITY;
          int bs = INT_MAX;
          float bu = 0.0f, bv = 0.0f;
#pragma unroll 2
          for (int step = 0; step < kStageSteps; ++step) {
            const int k = 32 * step + lane;
            float t, u, v;
            if (prim_hit<HAS_TRI, HAS_SPH, !INSTANCED>(rows, kHierChunk, k, base + k, rm, t, u,
                                                        v) &&
                t < bt) {
              bt = t;
              bs = base + k;
              bu = u;
              bv = v;
            }
          }
          // the chunk's least (t, slot) in every lane
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float ot = __shfl_xor_sync(kFullWarp, bt, off);
            const int os = __shfl_xor_sync(kFullWarp, bs, off);
            if (ot < bt || (ot == bt && os < bs)) {
              bt = ot;
              bs = os;
            }
          }
          if (bs != INT_MAX) {  // u, v from the lane that tested the winner
            const int src = (bs - base) & 31;
            const float wu = __shfl_sync(kFullWarp, bu, src);
            const float wv = __shfl_sync(kFullWarp, bv, src);
            if (lane == m &&
                (bt < h.t ||
                 (bt == h.t && h.prim >= 0 &&
                  (bs < h.prim || (INSTANCED && bs == h.prim && cur_inst < h.inst))))) {
              h.t = bt;
              h.prim = bs;
              h.u = wu;
              h.v = wv;
              h.inst = cur_inst;
            }
          }
        }
      }
      __syncwarp();  // the stage is read: it may take the next copy
      if (next < 0) break;
      const int c = __shfl_sync(kFullWarp, held, next);
      if (lane == 0) hier_stage_load(st, tb.chunks + (size_t)c * kHierRows * kHierChunk);
      lead = next;
    }
  }
  return h;
}

}  // namespace echo
