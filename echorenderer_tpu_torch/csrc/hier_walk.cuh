// The chunk-tree walk of one ray: closest hit or any hit over the chunk
// tree of a large scene, in both its forms (the tree of one geometry, and
// a TLAS over instances whose leaves descend a shared pack's subtree in the
// instance's space). One copy, shared by the walk kernels of hier_walk.cu
// and the fused megakernel's large-scene form (megakernel.cu), so that both
// report the same hits by construction.
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
// walk visits the chunks, so it is bit for bit what the dense kernels
// return (they visit slots in ascending order with strict-less updates). A
// box is entered while its entry t is at most the best t (t_max for any
// hit) times echo::kCullMargin, so that a hit on a box's boundary, whose t
// may come out a rounding step before the box's computed entry, is not
// lost.
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
// Stack: kHierStack (code, entry t) pairs per thread, in local memory (the
// wrappers check the tree's `stack_size` against it); an interior node
// pushes its far child first so the near one pops first, and an entry
// popped after the best t has moved below its entry t (with the same
// slack) is skipped. Node boxes, codes and instance rows are read through
// the read-only cache, the chunk rows straight from global memory. A ray
// with t_max <= 0 does no work; an any-hit walk stops at its first blocker.

#pragma once

#include <math.h>

#include "intersect.cuh"

namespace echo {

constexpr int kHierChunk = 256;     // prims per chunk (HCHUNK)
constexpr int kHierRows = 16;       // float rows per chunk record
constexpr int kHierStack = 64;      // stack entries (ops/pallas_hier.MAX_STACK)
constexpr int kInstBase = 1 << 23;  // ops/pallas_hier.INST_BASE
constexpr int kRestoreE = 1 << 24;  // ops/pallas_hier.RESTORE_E
constexpr int kRestoreCode = -(1 + kRestoreE);

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
// `w_ign_inst` on instanced tables) over the tree of `tb`.
template <bool HAS_TRI, bool HAS_SPH, bool ANY_HIT, bool INSTANCED>
__device__ __forceinline__ HierHit hier_walk(const HierTables& tb, const Ray& w,
                                             int w_ign_inst) {
  const float* __restrict__ chunks = tb.chunks;
  const float* __restrict__ bounds = tb.bounds;
  const int* __restrict__ codes = tb.codes;
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
  while (sp > 0) {
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
    const int chunk = e;
    const float* rows = chunks + (size_t)chunk * kHierRows * kHierChunk;
    const int base = chunk * kHierChunk;
    for (int k = 0; k < kHierChunk; ++k) {
      float t, u, v;
      if (!prim_hit<HAS_TRI, HAS_SPH, !INSTANCED>(rows, kHierChunk, k, base + k, r, t, u, v))
        continue;
      if (ANY_HIT) {
        if (t < w.tmax) {
          h.blocked = true;
          break;
        }
      } else if (t < h.t ||
                 (t == h.t && h.prim >= 0 &&
                  (base + k < h.prim || (INSTANCED && base + k == h.prim && cur_inst < h.inst)))) {
        h.t = t;
        h.prim = base + k;
        h.u = u;
        h.v = v;
        h.inst = cur_inst;
      }
    }
    if (ANY_HIT && h.blocked) break;
  }
  return h;
}

}  // namespace echo
