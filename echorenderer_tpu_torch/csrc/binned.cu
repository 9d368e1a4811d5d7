// Binned traversal for large scenes: the four kernels of its setup and rounds, for Hopper.
//
// Replace the Pallas TPU kernels of echorenderer_tpu/ops/binned_trace.py,
// which the JAX package's `trace_binned` / `occlude_binned` reach through
// `_trace_binned_impl`:
//   setup_kernel, setup_group   <- `_setup_kernel`  (line 552, via `_setup_rank`)
//   select_group, select_kernel <- `_select_kernel` (line 402, via `_run_select`)
//   seg_kernel <- `_seg_kernel` (line 117, via `_run_rows`; keyed and exact, both forms)
// and, written by hand here where the JAX package leaves it to XLA ops:
//   refill_kernel <- `_trace_binned_impl`'s `refill` (line 1143)
// Each computes what its plain PyTorch version in ops/binned_trace.py computes
// (`setup_rank_plain`, `refill_plain`, `select_plain`, `seg_keys_plain`,
// `seg_hits_plain`), bit for bit.
//
// setup: per ray, the slab test of every super box (`echo::slab`'s op
// order, the JAX kernel's, NaN-propagating min/max, here one PTX min.NaN /
// max.NaN each; strict `tn < limit`, no cull slack), each eligible super
// packed as (bits(tn > 0 ? tn : 0) with the low sbits cleared) | super id,
// and the s_out smallest keys written ascending, _INT_INF after. Keys are
// unique, so this equals a sort of all of them. Rays enter few supers (2-4
// on average on the 1M and TLAS programs, at most ~54), so the slab tests
// (rays x supers) are the work; the full-width launch (up to 2M rays) is
// bound by issuing them, the cascade's narrower launches (s_out the padded
// super count, 64 KiB of columns a 64-ray block in a one-thread form) by
// latency. Two forms, by s_out (kSetupForms, chosen on the H100 by
// tools/hier_ab.py --sweep select-setup):
//  - setup_kernel, a thread a ray (s_out <= 32: the full-width launch,
//    capped at ORD_CAP): the super table through the read-only cache (every
//    thread reads the same super: a broadcast), the ray's s_out nearest keys
//    kept sorted by insertion in its own column of shared memory
//    ([slot][thread]). Every lane-group form took 1.7-2.4x its time.
//  - setup_group<G, THREADS> (the uncapped launches; 16 lanes a ray, 8 rays
//    a block): the super table goes into shared memory once a block,
//    component-major (lo_x[S], lo_y[S], ..., the JAX kernel's SMEM row),
//    and the block walks its share of the rays. Lane l tests supers l,
//    l + G, ...; the eligible keys are compacted by ballot and popcount into
//    the ray's row of shared memory; then each key's rank is counted against
//    the whole row (no serial chain, 16-byte broadcast loads), and the key
//    lands at its rank in an (s_out, rays) tile, which the block writes row
//    by row, rays consecutive. Taking the row's minima one by one (a group
//    reduction a key) instead was 0-10% slower on every shape.
//
// select: per ray, all integer: purge the candidate keys at or past the best
// t, then for a refilling ray take its k-1 smallest distinct keys (the TPU
// kernel's remove-by-equality passes drop every copy of a minimum) ahead of
// the new keys, then pop the k smallest distinct keys and clear every key
// at or below the last pop. The full-width launch (w 67) is bound by the
// bytes of the (w, N) buffer; the cascade's narrower, deeper launches (w 143
// and 287, up to 63 passes) by the passes' latency. Forms, by w
// (kSelectForms, chosen by the same sweep):
//  - select_group<G, R, THREADS>, a group of G lanes a ray, its w slots in
//    registers: slot j in lane j % G, register j / G (R a lane, unrolled).
//    No slot is rewritten by a pass: each step takes the lane's least key at
//    or above a bound, then the group's minimum (__reduce_min_sync for a
//    warp, else a xor butterfly), and raises the bound past it; the refill's
//    extracted keys and the pops wait in shared memory. A group's steps stop
//    at the first empty minimum. 4 lanes a ray up to w 160 (a warp's load of
//    one register is 4 rows of 8 consecutive rays: whole 32-byte sectors, so
//    the full-width launch needs no staging), 8 to w 320, 16 to w 512; a
//    warp a ray took 2x the time of 8 lanes at w 287, a thread a ray (72
//    registers) tied 4 lanes at w 67.
//  - select_kernel, one thread a ray over a shared-memory column, for
//    buffers wider than 512 slots: the passes of the TPU kernel (min scans
//    and removals) on the column, the buffer written back in place; a ray
//    that does not refill skips the extract passes.
// Dead rays (past n) run their group's reductions on empty keys: every lane
// of a group mask takes part.
//
// refill: per refilling ray, the keys at cursor .. cursor + ksup - 1 of its
// super order, each gated as the plain version gates it (inside the order,
// not _INT_INF, entry t below best_t); each passing super's 16 chunk boxes
// (the conservative bf16-rounded table `_Tables.base`) slab-tested as setup
// tests supers (`super_hit`, best_t the limit), each eligible chunk packed
// as (bits(tn > 0 ? tn : 0) with the low cbits cleared) | chunk id, the rest
// _INT_INF; then the cursor moved by ksup (parked at w_ord when the order is
// capped) and the key at cursor + ksup (past a capped order its last stored
// key, past an uncapped one _INT_INF) as the next unexamined super. A ray
// that does not refill writes _INT_INF keys and keeps its cursor and next
// super. One form at every shape (ksup 4, 8 or 16, 2M rays at full width
// down to ~16k in the final stage, capped or not): a thread a ray, 128 a
// block. The 16 ksup key writes of a ray are one row each, rays consecutive,
// so a warp writes 128 contiguous bytes a slot; the super table (~94 KB on
// the 1M scene, up to 65k supers on an instanced pack: not staged in
// shared memory) comes through the read-only cache, a float4 a component
// and 4 chunks. Bound by its bytes: ~0.3 KB a ray at ksup 4, mostly the key
// writes. It replaces ~70 PyTorch ops a super (a gather of the super's rows,
// the slab test on (16, N) tensors, the packing).
//
// seg_kernel: per (ray, chunk) pair of the chunk-sorted pair list, the least
// packed key (bits(t) & ~0xFF) | prim-in-chunk over the chunk's prims hit
// with t < t_max (`echo::prim_hit`, the test of every other kernel), else
// _INT_INF. The exact form (KEYED = false, `_seg_kernel(keyed=False)`) runs
// the same pairs and writes 4 floats a pair instead of a key: the least t
// below t_max, ties to the least sorted slot, that slot as a float (-1 where
// nothing is found), and its u and v; a pair without a hit keeps
// (t_max, -1, 0, 0). Instanced form (TLAS scenes): the pairs carry global
// chunks; each maps to its pack chunk (g2c) and instance (g2i), the pair's
// world ray moves into the instance's space with the instance's 12 floats
// (A row-major, then b; each row summed left to right and then + b, as
// `pallas_hier.to_instance`), so t stays the world parameter and spheres
// take the full quadratic, and the ray's ignored prim is skipped only where
// the record's ign_inst (column 8 of a 9-float record) names this instance.
// Bound by the prim tests (256 a pair, ~45 flops a triangle). Design: the
// pairs are sorted by chunk, so the list is a sequence of runs of one chunk
// (the TPU kernel's segments). A warp takes a tile of kSegTile consecutive
// pairs and walks its runs (a ballot over chunk_of[q] != c finds each run's
// end); pairs without a valid chunk (the dead tail) get their sentinels and
// nothing else. For each run one lane issues one bulk asynchronous copy
// (TMA, `cp.async.bulk` on an mbarrier: the stage helpers of hier_walk.cuh)
// of the chunk's rows 0-9 (the pack chunk's on an instanced scene; g2c, g2i
// and the instance's 12 floats are read once a run) into the warp's stage in
// shared memory. A run's pairs go in batches of 32: a full batch takes one
// pair a lane, each lane running all 256 tests against the staged rows in
// slot order, every lane on the same prims (16-byte broadcast loads, 4 prims
// a row); a short batch (a run of g < 32 pairs, or a long run's tail) takes
// the whole warp per member, lane i testing prims 4i .. 4i + 3 and
// 128 + 4i .. 131 + 4i of the member's ray (broadcast by shuffles), then
// `__reduce_min_sync` of the keys, or a xor butterfly of the least
// (t, slot) with u, v from the winner's lane. Both reductions are
// order-free, so every grouping gives the per-pair loop's answer bit for
// bit; the work per pair is the same in both (256 tests over 32 lanes), so
// a tile's cost follows its pair count. The shape was chosen on the H100 by
// a sweep (tools/hier_ab.py --sweep): 2 warps of 32 pairs a block, one
// stage a warp. The stage's 10 KiB cap the kernel at 20 resident warps/SM;
// a second stage a warp, to overlap the next run's copy with this run's
// tests, halved them and lost 15-28% on every input, as it did for the walk
// (hier_walk.cu); 16 pairs a warp won 6-7% on the instanced keyed inputs
// and lost 5-19% on the others, 64 lost on all.
// Built with -fmad=false, so every float op rounds as in the plain version.
// The forms of setup and select for each shape were chosen on the H100 by a
// sweep (tools/hier_ab.py --sweep) and are constants below.
// C interface (loaded with ctypes); each launch returns cudaGetLastError();
// binned_seg_occupancy, binned_setup_occupancy and binned_select_occupancy
// report a form's resident blocks for chip_smoke.py.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hier_walk.cuh"

namespace {

constexpr int kIntInf = 0x7FFFFFFF;
constexpr float kFarT = 3.4e38f;  // _INF
constexpr int kChunk = 256;       // prims per chunk (HCHUNK)
constexpr int kRows = 16;         // float rows per chunk record
constexpr int kPBits = 8;         // prim-in-chunk bits of a pair key
constexpr int kBlock = 64;        // rays per block of setup_kernel and select_kernel

// echo::slab with each NaN-propagating min / max one instruction (PTX
// min.NaN / max.NaN, sm_80 on) where echo::pmin / pmax take three: the same
// tn and tf but for the sign of a zero result, which no output of setup
// reads (its tests compare, and a key clamps t at +0).
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Does the ray (origin o, inverse direction i, limit) enter the box before
// limit? Its key t in tn (`echo::slab`'s op order).
__device__ __forceinline__ bool super_hit(float lox, float loy, float loz, float hix, float hiy,
                                          float hiz, float ox, float oy, float oz, float ix,
                                          float iy, float iz, float limit, float& tn) {
  const float t0x = (lox - ox) * ix;
  const float t1x = (hix - ox) * ix;
  const float t0y = (loy - oy) * iy;
  const float t1y = (hiy - oy) * iy;
  const float t0z = (loz - oz) * iz;
  const float t1z = (hiz - oz) * iz;
  tn = nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)), nan_min(t0z, t1z));
  const float tf = nan_min(nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)), nan_max(t0z, t1z));
  return (tn <= tf) && (tf > 0.0f) && (tn < limit);
}

__global__ void __launch_bounds__(kBlock)
setup_kernel(const float* __restrict__ rays, int n, const float* __restrict__ sup, int s_count,
             int sbits, int s_out, int* __restrict__ out) {
  extern __shared__ int smem[];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  int* col = smem + threadIdx.x;  // slot j at col[j * kBlock]
  const size_t sn = n;
  const float ox = rays[i], oy = rays[sn + i], oz = rays[2 * sn + i];
  const float ix = echo::safe_inv(rays[3 * sn + i]);
  const float iy = echo::safe_inv(rays[4 * sn + i]);
  const float iz = echo::safe_inv(rays[5 * sn + i]);
  const float limit = rays[6 * sn + i];
  const int idmask = -(1 << sbits);
  int len = 0;
  for (int s = 0; s < s_count; ++s) {
    const float* b = sup + 6 * (size_t)s;
    float tn;
    if (!super_hit(__ldg(b), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3), __ldg(b + 4),
                   __ldg(b + 5), ox, oy, oz, ix, iy, iz, limit, tn))
      continue;
    const int key = (__float_as_int(tn > 0.0f ? tn : 0.0f) & idmask) | s;
    int p;
    if (len < s_out) {
      p = len++;
    } else if (key < col[(s_out - 1) * kBlock]) {
      p = s_out - 1;  // drops the largest kept key
    } else {
      continue;
    }
    while (p > 0 && col[(p - 1) * kBlock] > key) {
      col[p * kBlock] = col[(p - 1) * kBlock];
      --p;
    }
    col[p * kBlock] = key;
  }
  for (int j = 0; j < s_out; ++j) out[(size_t)j * sn + i] = j < len ? col[j * kBlock] : kIntInf;
}

__device__ __forceinline__ int min_scan(const int* col, int w) {
  int mn = kIntInf;
  for (int j = 0; j < w; ++j) mn = min(mn, col[j * kBlock]);
  return mn;
}

__device__ __forceinline__ void remove_eq(int* col, int w, int v) {
  for (int j = 0; j < w; ++j)
    if (col[j * kBlock] == v) col[j * kBlock] = kIntInf;
}

__global__ void __launch_bounds__(kBlock)
select_kernel(int* __restrict__ cand, int w, int n, const int* __restrict__ nk,
              const float* __restrict__ best_t, const uint8_t* __restrict__ refill_flag, int k,
              int cbits, int* __restrict__ pop, int* __restrict__ live_out,
              int* __restrict__ mink_out) {
  extern __shared__ int smem[];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const size_t sn = n;
  int* col = smem + threadIdx.x;                        // w slots
  int* ext = smem + (size_t)w * kBlock + threadIdx.x;   // k - 1 slots
  const int tmask = -(1 << cbits);
  const int best_bits = __float_as_int(best_t[i]);
  for (int j = 0; j < w; ++j) {  // purge
    const int v = cand[j * sn + i];
    col[j * kBlock] = (v & tmask) < best_bits ? v : kIntInf;
  }
  if (refill_flag[i]) {
    for (int e = 0; e < k - 1; ++e) {  // the k-1 smallest: all a refilling ray holds
      const int mn = min_scan(col, w);
      ext[e * kBlock] = mn;
      remove_eq(col, w, mn);
    }
    for (int e = 0; e < k - 1; ++e) col[e * kBlock] = ext[e * kBlock];
    for (int j = k - 1; j < w; ++j) col[j * kBlock] = nk[(j - (k - 1)) * sn + i];
  }
  for (int p = 0; p < k; ++p) {  // pop the k nearest, ascending
    const int mn = min_scan(col, w);
    pop[p * sn + i] = mn;
    remove_eq(col, w, mn);
  }
  int live = 0, mink = kIntInf;
  for (int j = 0; j < w; ++j) {
    const int v = col[j * kBlock];
    live += v != kIntInf;
    mink = min(mink, v);
    cand[j * sn + i] = v;
  }
  live_out[i] = live;
  mink_out[i] = mink;
}

// ---------------------------------------------------------------------------
// setup and select: a group of G lanes a ray
// ---------------------------------------------------------------------------

// The lanes of this thread's group of G (a power of two up to 32) in its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) {
    return 0xffffffffu;
  } else {
    return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  }
}

template <int G>
__device__ __forceinline__ int group_min(int v, unsigned mask) {
  if constexpr (G == 32) {
    return __reduce_min_sync(mask, v);
  } else {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(mask, v, off));
    return v;
  }
}

template <int G>
__device__ __forceinline__ int group_sum(int v, unsigned mask) {
  if constexpr (G == 32) {
    return __reduce_add_sync(mask, v);
  } else {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off);
    return v;
  }
}

struct SelectArgs {
  int* cand;
  int w, n;
  const int* nk;
  const float* best_t;
  const uint8_t* refill;
  int k, cbits;
  int* pop;
  int* live;
  int* mink;
};

// The group's least key at or above lo, kIntInf if none.
template <int G, int R>
__device__ __forceinline__ int least_from(const int (&v)[R], int lo, unsigned mask) {
  int m = kIntInf;
#pragma unroll
  for (int r = 0; r < R; ++r) m = min(m, v[r] >= lo ? v[r] : kIntInf);
  return group_min<G>(m, mask);
}

// Up to `most` least distinct keys of the group, ascending, into keep[0..);
// returns their count and leaves `lo` just past the last (INT_MIN if none).
template <int G, int R>
__device__ __forceinline__ int take_least(const int (&v)[R], int most, int* keep, int lane,
                                          unsigned mask, int& lo) {
  int got = 0;
  lo = INT_MIN;
  while (got < most) {
    const int m = least_from<G, R>(v, lo, mask);
    if (m == kIntInf) break;  // the same in every lane of the group
    if (lane == 0) keep[got] = m;
    ++got;
    lo = m + 1;
  }
  return got;
}

template <int G, int R, int THREADS>
__global__ void __launch_bounds__(THREADS) select_group(SelectArgs a) {
  extern __shared__ int sel_keep[];  // k keys a ray: the refill's extracted keys, then the pops
  constexpr int kRays = THREADS / G;
  const int lane = threadIdx.x % G, ray = threadIdx.x / G;
  const int i = blockIdx.x * kRays + ray;
  const bool valid = i < a.n;
  const unsigned mask = group_mask<G>();
  const size_t sn = a.n;
  int* keep = sel_keep + ray * a.k;
  const int tmask = -(1 << a.cbits);
  const int best_bits = valid ? __float_as_int(a.best_t[i]) : 0;
  int v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {  // purge
    const int j = r * G + lane;
    const int x = valid && j < a.w ? a.cand[j * sn + i] : kIntInf;
    v[r] = (x & tmask) < best_bits ? x : kIntInf;
  }
  int lo;
  if (valid && a.refill[i]) {  // [its k - 1 least distinct keys | the new keys]
    const int got = take_least<G, R>(v, a.k - 1, keep, lane, mask, lo);
    __syncwarp(mask);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = r * G + lane;
      v[r] = j < got ? keep[j]
             : j < a.k - 1 || j >= a.w ? kIntInf
                                       : a.nk[(j - (a.k - 1)) * sn + i];
    }
    __syncwarp(mask);
  }
  const int got = take_least<G, R>(v, a.k, keep, lane, mask, lo);  // the pops
  __syncwarp(mask);
  if (valid)
    for (int p = lane; p < a.k; p += G) a.pop[p * sn + i] = p < got ? keep[p] : kIntInf;
  int live = 0, mink = kIntInf;
#pragma unroll
  for (int r = 0; r < R; ++r) {  // every key at or below the last pop goes
    const int j = r * G + lane;
    const int x = v[r] >= lo ? v[r] : kIntInf;
    if (valid && j < a.w) a.cand[j * sn + i] = x;
    live += x != kIntInf;
    mink = min(mink, x);
  }
  live = group_sum<G>(live, mask);
  mink = group_min<G>(mink, mask);
  if (valid && lane == 0) {
    a.live[i] = live;
    a.mink[i] = mink;
  }
}

struct SetupArgs {
  const float* rays;
  int n;
  const float* sup;
  int s_count, sbits, s_out;
  int* out;
};

// setup_group's shared memory in ints: the super table (6 rows of
// setup_table_stride), each ray's eligible keys (a row of setup_row_stride,
// 16-byte aligned, and rows of neighbouring rays on other banks), the output
// tile (s_out rows of the block's rays)
__host__ __device__ constexpr int setup_table_stride(int s_count) { return (s_count + 3) & ~3; }
__host__ __device__ constexpr int setup_row_stride(int s_count) {
  return ((s_count + 7) & ~7) + 4;
}
constexpr size_t setup_group_smem(int s_count, int s_out, int rays) {
  return sizeof(int) * (6 * (size_t)setup_table_stride(s_count) +
                        (size_t)rays * setup_row_stride(s_count) + (size_t)s_out * rays);
}

template <int G, int THREADS>
__global__ void __launch_bounds__(THREADS) setup_group(SetupArgs a) {
  extern __shared__ __align__(16) int set_smem[];
  constexpr int kRays = THREADS / G;
  const int ts = setup_table_stride(a.s_count), rs = setup_row_stride(a.s_count);
  float* tab = reinterpret_cast<float*>(set_smem);
  int* tile = set_smem + 6 * ts + kRays * rs;
  for (int t = threadIdx.x; t < 6 * a.s_count; t += THREADS)  // component-major
    tab[(t % 6) * ts + t / 6] = __ldg(a.sup + t);
  __syncthreads();
  const int lane = threadIdx.x % G, ray = threadIdx.x / G;
  const unsigned mask = group_mask<G>();
  const unsigned below = mask & ((1u << (threadIdx.x & 31)) - 1u);
  int* row = set_smem + 6 * ts + ray * rs;  // the ray's eligible keys
  const size_t sn = a.n;
  const int idmask = -(1 << a.sbits);
  const int blocks = (a.n + kRays - 1) / kRays;
  for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
    const int i = b * kRays + ray;
    const bool valid = i < a.n;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, ix = 0.0f, iy = 0.0f, iz = 0.0f, limit = 0.0f;
    if (valid) {
      ox = a.rays[i];
      oy = a.rays[sn + i];
      oz = a.rays[2 * sn + i];
      ix = echo::safe_inv(a.rays[3 * sn + i]);
      iy = echo::safe_inv(a.rays[4 * sn + i]);
      iz = echo::safe_inv(a.rays[5 * sn + i]);
      limit = a.rays[6 * sn + i];
    }
    int len = 0;
    for (int s0 = 0; s0 < a.s_count; s0 += G) {
      const int s = s0 + lane;
      bool ok = false;
      int key = 0;
      if (valid && s < a.s_count) {
        float tn;
        ok = super_hit(tab[s], tab[ts + s], tab[2 * ts + s], tab[3 * ts + s], tab[4 * ts + s],
                       tab[5 * ts + s], ox, oy, oz, ix, iy, iz, limit, tn);
        key = (__float_as_int(tn > 0.0f ? tn : 0.0f) & idmask) | s;
      }
      const unsigned got = __ballot_sync(mask, ok) & mask;
      if (ok) row[len + __popc(got & below)] = key;
      len += __popc(got);
    }
    __syncwarp(mask);
    int* col = tile + ray;  // the ray's column of the tile: key j at col[j * kRays]
    const int len4 = (len + 3) & ~3;
    for (int p = len + lane; p < len4; p += G) row[p] = kIntInf;  // above every key
    __syncwarp(mask);
    for (int p = lane; p < len; p += G) {  // keys are unique: their ranks, a permutation
      const int key = row[p];
      int rank = 0;
      for (int x = 0; x < len4; x += 4) {
        const int4 q = *reinterpret_cast<const int4*>(row + x);
        rank += (q.x < key) + (q.y < key) + (q.z < key) + (q.w < key);
      }
      if (rank < a.s_out) col[rank * kRays] = key;
    }
    for (int j = len + lane; j < a.s_out; j += G) col[j * kRays] = kIntInf;
    __syncthreads();
    for (int t = threadIdx.x; t < a.s_out * kRays; t += THREADS) {
      const int ii = b * kRays + t % kRays;
      if (ii < a.n) a.out[(t / kRays) * sn + ii] = tile[t];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// refill_kernel: a thread a ray
// ---------------------------------------------------------------------------

constexpr int kSup = 16;           // chunks a superchunk (SUP)
constexpr int kRefillBlock = 128;  // rays a block

struct RefillArgs {
  const float* rays;
  int n;
  const int* sup_ord;  // (w_ord, n): each ray's super keys, ascending
  int w_ord;
  const int* cursor;
  const float* best_t;
  const uint8_t* refill;
  const int* next_sup;
  const float4* base;  // (s_count, 6 kSup) floats: lo_x[16] lo_y lo_z hi_x hi_y hi_z
  int s_count, ksup, sbits, cbits;
  int* keys;  // (ksup kSup, n), slot-major
  int* cursor_out;
  int* next_out;
};

// The key at position p of ray i's order: past a capped order its last
// stored key (a lower bound of every unexamined super), past an uncapped
// one kIntInf.
__device__ __forceinline__ int order_key(const RefillArgs& a, size_t sn, int i, int p,
                                         bool capped) {
  if (p < a.w_ord) return __ldg(a.sup_ord + p * sn + i);
  return capped ? __ldg(a.sup_ord + (a.w_ord - 1) * sn + i) : kIntInf;
}

// A chunk's candidate key: (bits(tn > 0 ? tn : 0) with the low cbits
// cleared) | chunk id where the ray enters its box before best; else kIntInf.
__device__ __forceinline__ int chunk_key(float lox, float loy, float loz, float hix, float hiy,
                                         float hiz, float ox, float oy, float oz, float ix,
                                         float iy, float iz, float best, int cmask, int id) {
  float tn;
  if (!super_hit(lox, loy, loz, hix, hiy, hiz, ox, oy, oz, ix, iy, iz, best, tn) ||
      !(tn < kFarT))
    return kIntInf;
  return (__float_as_int(tn > 0.0f ? tn : 0.0f) & cmask) | id;
}

__global__ void __launch_bounds__(kRefillBlock) refill_kernel(RefillArgs a) {
  const int i = blockIdx.x * kRefillBlock + threadIdx.x;
  if (i >= a.n) return;
  const size_t sn = a.n;
  const bool capped = a.w_ord < a.s_count;
  const bool refill = a.refill[i] != 0;
  const int cur = a.cursor[i];
  int* out = a.keys + i;  // slot j kSup + c at out[(j kSup + c) sn]
  if (refill) {
    const float best = a.best_t[i];
    const float ox = a.rays[i], oy = a.rays[sn + i], oz = a.rays[2 * sn + i];
    const float ix = echo::safe_inv(a.rays[3 * sn + i]);
    const float iy = echo::safe_inv(a.rays[4 * sn + i]);
    const float iz = echo::safe_inv(a.rays[5 * sn + i]);
    const int smask = (1 << a.sbits) - 1, tmask = -(1 << a.sbits), cmask = -(1 << a.cbits);
    for (int j = 0; j < a.ksup; ++j, out += kSup * sn) {
      const int key = order_key(a, sn, i, cur + j, false);  // none past the order
      if (key == kIntInf || !(__int_as_float(key & tmask) < best)) {
        for (int c = 0; c < kSup; ++c) out[c * sn] = kIntInf;
        continue;
      }
      const int s = key & smask;
      const float4* row = a.base + (size_t)s * (6 * kSup / 4);
#pragma unroll
      for (int q = 0; q < kSup / 4; ++q) {  // chunks 4q .. 4q + 3: a float4 a component
        const float4 lx = __ldg(row + q), ly = __ldg(row + 4 + q), lz = __ldg(row + 8 + q);
        const float4 hx = __ldg(row + 12 + q), hy = __ldg(row + 16 + q), hz = __ldg(row + 20 + q);
        const int id = s * kSup + 4 * q;
        out[(4 * q) * sn] = chunk_key(lx.x, ly.x, lz.x, hx.x, hy.x, hz.x, ox, oy, oz, ix, iy, iz,
                                      best, cmask, id);
        out[(4 * q + 1) * sn] = chunk_key(lx.y, ly.y, lz.y, hx.y, hy.y, hz.y, ox, oy, oz, ix, iy,
                                          iz, best, cmask, id + 1);
        out[(4 * q + 2) * sn] = chunk_key(lx.z, ly.z, lz.z, hx.z, hy.z, hz.z, ox, oy, oz, ix, iy,
                                          iz, best, cmask, id + 2);
        out[(4 * q + 3) * sn] = chunk_key(lx.w, ly.w, lz.w, hx.w, hy.w, hz.w, ox, oy, oz, ix, iy,
                                          iz, best, cmask, id + 3);
      }
    }
  } else {
    for (int s = 0; s < a.ksup * kSup; ++s) out[s * sn] = kIntInf;
  }
  const int moved = cur + (refill ? a.ksup : 0);
  a.cursor_out[i] = capped ? min(moved, a.w_ord) : moved;  // the cursor parks at the cap
  a.next_out[i] = refill ? order_key(a, sn, i, cur + a.ksup, capped) : a.next_sup[i];
}

// ---------------------------------------------------------------------------
// seg_kernel: one warp a tile of kSegTile consecutive pairs, taken run by run
// ---------------------------------------------------------------------------

constexpr int kSegWarps = 2;   // warps a block
constexpr int kSegTile = 32;   // consecutive pairs a warp takes
constexpr int kSegUnroll = 2;  // 4-prim groups of a full batch's loop unrolled together
constexpr int kSegPairs = kSegWarps * kSegTile;  // pairs a block (binned_trace.ROW)
constexpr size_t kSegSmem = echo::hier_smem_bytes(kSegWarps);
using echo::kFullWarp;

// Pair q's record: flat, 8 floats read as two float4; instanced, 9 floats
// (column 8, the ignore's instance, into ign_inst).
template <bool INSTANCED>
__device__ __forceinline__ echo::Ray load_pair(const float* __restrict__ rec, int q,
                                               float& ign_inst) {
  echo::Ray r;
  if (INSTANCED) {
    const float* f = rec + 9 * (size_t)q;
    r.ox = f[0];
    r.oy = f[1];
    r.oz = f[2];
    r.dx = f[3];
    r.dy = f[4];
    r.dz = f[5];
    r.tmax = f[6];
    r.ignore = static_cast<int>(f[7]);
    ign_inst = f[8];
  } else {
    const float4 a = reinterpret_cast<const float4*>(rec)[2 * (size_t)q];
    const float4 b = reinterpret_cast<const float4*>(rec)[2 * (size_t)q + 1];
    r.ox = a.x;
    r.oy = a.y;
    r.oz = a.z;
    r.dx = a.w;
    r.dy = b.x;
    r.dz = b.y;
    r.tmax = b.z;
    r.ignore = static_cast<int>(b.w);
  }
  return r;
}

// The end of the run of chunk c that starts at pair s: the first pair of
// (s, end) with another chunk, else end. Every lane calls it.
__device__ __forceinline__ int run_end(const int* __restrict__ chunk_of, int s, int c, int end,
                                       int lane) {
  for (int b = s + 1; b < end; b += 32) {
    const int q = b + lane;
    const unsigned other = __ballot_sync(kFullWarp, q < end && __ldg(chunk_of + q) != c);
    if (other) return b + __ffs(other) - 1;
  }
  return end;
}

// Prims j0 .. j0 + 3 of the staged rows, in registers: q[4 f + i] is row f
// of prim j0 + i (one 16-byte shared-memory load a row; the rows the test
// of this form reads: 9 for triangles, 6 for spheres, 10 for both).
template <bool HAS_TRI, bool HAS_SPH>
__device__ __forceinline__ void load4(const float* rows, int j0, float (&q)[40]) {
  constexpr int kUsed = HAS_TRI ? (HAS_SPH ? 10 : 9) : 6;
#pragma unroll
  for (int f = 0; f < kUsed; ++f) {
    const float4 x = *reinterpret_cast<const float4*>(rows + f * kChunk + j0);
    q[4 * f] = x.x;
    q[4 * f + 1] = x.y;
    q[4 * f + 2] = x.z;
    q[4 * f + 3] = x.w;
  }
}

struct SegArgs {
  const float* rec;
  const int* chunk_of;
  int m;
  const float* chunks;
  const int* g2c;
  const int* g2i;
  const float* inst_f32;
  int n_chunks;
  void* out;
};

// The rows of pair chunk c (its pack chunk's on an instanced scene), or
// null when c is no valid chunk.
template <bool INSTANCED>
__device__ __forceinline__ const float* seg_rows(const SegArgs& a, int c) {
  if (c < 0 || c >= a.n_chunks) return nullptr;
  const int pc = INSTANCED ? __ldg(a.g2c + c) : c;
  return a.chunks + (size_t)pc * kRows * kChunk;
}

// Lane 0: copy rows 0-9 of pair chunk c into the warp's stage, if c is a
// valid chunk.
template <bool INSTANCED>
__device__ __forceinline__ void seg_stage(const SegArgs& a, const echo::HierStage& st, int c,
                                          int lane) {
  const float* src = seg_rows<INSTANCED>(a, c);
  if (lane == 0 && src != nullptr) echo::hier_stage_load(st, src);
}

// The warp's run [s, e) of chunk c, whose rows the stage holds (or is
// receiving); after its tests the stage takes the next run's copy. Returns
// true at the end of the warp's tile; else moves (s, c, e) to the next run.
template <bool HAS_TRI, bool HAS_SPH, bool INSTANCED, bool KEYED>
__device__ __forceinline__ bool seg_run(const SegArgs& a, int& s, int& c, int& e, int end,
                                        echo::HierStage& st, int lane) {
  const int m = a.m;
  int* keys = static_cast<int*>(a.out);
  float* o = static_cast<float*>(a.out);
  if (c < 0 || c >= a.n_chunks) {  // no chunk (dead pairs): sentinels only
    for (int q = s + lane; q < e; q += 32) {
      if (KEYED) {
        keys[q] = kIntInf;
      } else {
        o[q] = a.rec[(INSTANCED ? 9 : 8) * (size_t)q + 6];
        o[(size_t)m + q] = -1.0f;
        o[2 * (size_t)m + q] = 0.0f;
        o[3 * (size_t)m + q] = 0.0f;
      }
    }
  } else {
    // one instance a run: its pack chunk and 12 floats (A row-major, then b)
    int pc = c;
    float inst_f = 0.0f;
    float A[12];
    if (INSTANCED) {
      const int inst = __ldg(a.g2i + c);
      pc = __ldg(a.g2c + c);
      inst_f = static_cast<float>(inst);
#pragma unroll
      for (int i = 0; i < 12; ++i) A[i] = __ldg(a.inst_f32 + 12 * (size_t)inst + i);
    }
    const int base = pc * kChunk;
    echo::hier_stage_wait(st);
    const float* rows = st.rows;
    for (int b = s; b < e; b += 32) {  // batches of up to 32 pairs, lane i on pair b + i
      const int nb = min(32, e - b);
      const int q = b + lane;
      echo::Ray r{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1};
      float ign_inst = -1.0f;
      if (lane < nb) r = load_pair<INSTANCED>(a.rec, q, ign_inst);
      const bool live = lane < nb && r.tmax > 0.0f;
      if (INSTANCED) {  // the world ray into the instance's space (pallas_hier.to_instance)
        const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
        r.ox = A[0] * ox + A[1] * oy + A[2] * oz + A[9];
        r.oy = A[3] * ox + A[4] * oy + A[5] * oz + A[10];
        r.oz = A[6] * ox + A[7] * oy + A[8] * oz + A[11];
        r.dx = A[0] * dx + A[1] * dy + A[2] * dz;
        r.dy = A[3] * dx + A[4] * dy + A[5] * dz;
        r.dz = A[6] * dx + A[7] * dy + A[8] * dz;
        if (ign_inst != inst_f) r.ignore = -1;
      }
      int key = kIntInf;                         // keyed
      float bt = r.tmax, bu = 0.0f, bv = 0.0f;   // exact
      int bslot = -1;
      if (nb == 32) {
        // a full batch: each lane tests its own pair against all 256 staged
        // prims in slot order, every lane on the same prims (broadcasts)
        if (live) {
#pragma unroll kSegUnroll
          for (int j0 = 0; j0 < kChunk; j0 += 4) {
            float pr[40];
            load4<HAS_TRI, HAS_SPH>(rows, j0, pr);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = j0 + i;
              float t, u, v;
              if (!echo::prim_hit<HAS_TRI, HAS_SPH, !INSTANCED>(pr, 4, i, base + j, r, t, u, v))
                continue;
              if (KEYED) {
                if (t < r.tmax && t < kFarT)
                  key = min(key, (__float_as_int(t) & -(1 << kPBits)) | j);
              } else if (t < bt && t < kFarT) {  // strict: an equal t keeps the lower slot
                bt = t;
                bslot = base + j;
                bu = u;
                bv = v;
              }
            }
          }
        }
      } else {
        // a short batch: the whole warp on one member at a time, lane i on
        // prims 4i .. 4i + 3 and 128 + 4i .. 131 + 4i, the member's ray
        // broadcast by shuffles
        unsigned members = __ballot_sync(kFullWarp, live);
        while (members) {
          const int mm = __ffs(members) - 1;
          members &= members - 1;
          echo::Ray rm;
          rm.ox = __shfl_sync(kFullWarp, r.ox, mm);
          rm.oy = __shfl_sync(kFullWarp, r.oy, mm);
          rm.oz = __shfl_sync(kFullWarp, r.oz, mm);
          rm.dx = __shfl_sync(kFullWarp, r.dx, mm);
          rm.dy = __shfl_sync(kFullWarp, r.dy, mm);
          rm.dz = __shfl_sync(kFullWarp, r.dz, mm);
          rm.tmax = __shfl_sync(kFullWarp, r.tmax, mm);
          rm.ignore = __shfl_sync(kFullWarp, r.ignore, mm);
          int best = kIntInf;                              // keyed: min is order-free
          float lt = rm.tmax, lu = 0.0f, lv = 0.0f;        // exact: this lane's least
          int ls = INT_MAX;                                // (t, slot), slots ascending
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j0 = kChunk / 2 * half + 4 * lane;
            float pr[40];
            load4<HAS_TRI, HAS_SPH>(rows, j0, pr);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int k = j0 + i;
              float t, u, v;
              if (!echo::prim_hit<HAS_TRI, HAS_SPH, !INSTANCED>(pr, 4, i, base + k, rm, t, u, v))
                continue;
              if (KEYED) {
                if (t < rm.tmax && t < kFarT)
                  best = min(best, (__float_as_int(t) & -(1 << kPBits)) | k);
              } else if (t < lt && t < kFarT) {
                lt = t;
                ls = k;
                lu = u;
                lv = v;
              }
            }
          }
          if (KEYED) {
            best = __reduce_min_sync(kFullWarp, best);
            if (lane == mm) key = best;
          } else {  // the least (t, slot) by a butterfly; u, v from the lane that tested it
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              const float ot = __shfl_xor_sync(kFullWarp, lt, off);
              const int os = __shfl_xor_sync(kFullWarp, ls, off);
              if (ot < lt || (ot == lt && os < ls)) {
                lt = ot;
                ls = os;
              }
            }
            if (ls != INT_MAX) {
              const float wu = __shfl_sync(kFullWarp, lu, (ls >> 2) & 31);
              const float wv = __shfl_sync(kFullWarp, lv, (ls >> 2) & 31);
              if (lane == mm) {
                bt = lt;
                bslot = base + ls;
                bu = wu;
                bv = wv;
              }
            }
          }
        }
      }
      if (lane < nb) {
        if (KEYED) {
          keys[q] = key;
        } else {
          o[q] = bt;
          o[(size_t)m + q] = bslot >= 0 ? static_cast<float>(bslot) : -1.0f;
          o[2 * (size_t)m + q] = bu;
          o[3 * (size_t)m + q] = bv;
        }
      }
    }
    __syncwarp();  // the stage is read: it may take the next run's copy
  }
  if (e >= end) return true;
  s = e;
  c = __ldg(a.chunk_of + s);
  e = run_end(a.chunk_of, s, c, end, lane);
  seg_stage<INSTANCED>(a, st, c, lane);
  return false;
}

// KEYED: out is int (M,), the packed key of each pair; else float (4, M):
// rows t, prim (sorted slot as a float), u, v
template <bool HAS_TRI, bool HAS_SPH, bool INSTANCED, bool KEYED>
__global__ void __launch_bounds__(kSegWarps * 32)
seg_kernel(SegArgs a) {
  extern __shared__ __align__(16) float seg_smem[];
  const int lane = threadIdx.x & 31;
  const long long begin =
      ((long long)blockIdx.x * kSegWarps + (threadIdx.x >> 5)) * (long long)kSegTile;
  if (begin >= a.m) return;  // the whole warp
  const int end = static_cast<int>(min(begin + kSegTile, (long long)a.m));
  int s = static_cast<int>(begin);
  int c = __ldg(a.chunk_of + s);
  int e = run_end(a.chunk_of, s, c, end, lane);
  echo::HierStage st{};
  if (e < end || seg_rows<INSTANCED>(a, c) != nullptr) {  // not a tile of dead pairs alone
    st = echo::hier_stage_init(seg_smem, kSegWarps);
    seg_stage<INSTANCED>(a, st, c, lane);
  }
  while (!seg_run<HAS_TRI, HAS_SPH, INSTANCED, KEYED>(a, s, c, e, end, st, lane)) {
  }
}

// dynamic shared memory above the 48 KB default needs an opt-in per kernel
template <typename K>
int smem_opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

static_assert(kSegSmem <= 48 * 1024, "the seg kernel's stages fit the default dynamic smem");

// The form of setup or select a launch takes: its kernel, threads and rays a
// block, dynamic shared memory, lanes a ray (setup: 1 for setup_kernel;
// select: 0 for select_kernel) and keys a lane (select's register forms).
struct Launch {
  const void* fn;
  int threads, rays;
  size_t smem;
  int group, keys;
};

// setup's forms by s_out, the first whose max_out holds it: group 1 is
// setup_kernel (a thread a ray, 64 a block); else setup_group<group,
// threads>. Every s_out the wrapper passes (<= SETUP_MAX_PAD = 512) has a
// form.
struct SetupForm {
  int max_out, group, threads;
};
constexpr SetupForm kSetupForms[] = {{32, 1, 64}, {512, 16, 128}};
constexpr int kSetupFormCount = sizeof(kSetupForms) / sizeof(kSetupForms[0]);
constexpr int kSetupGridPerSm = 16;  // setup_group's blocks a SM; each walks its share of the rays
static_assert(kSetupForms[kSetupFormCount - 1].max_out >= 512, "every s_out has a setup form");

template <int F>
Launch setup_launch_form(int s_count, int s_out) {
  constexpr SetupForm f = kSetupForms[F];
  if constexpr (F + 1 < kSetupFormCount) {
    if (s_out > f.max_out) return setup_launch_form<F + 1>(s_count, s_out);
  }
  if constexpr (f.group == 1) {
    return Launch{reinterpret_cast<const void*>(setup_kernel), kBlock, kBlock,
                  (size_t)s_out * kBlock * sizeof(int), 1, 0};
  } else {
    constexpr int rays = f.threads / f.group;
    return Launch{reinterpret_cast<const void*>(setup_group<f.group, f.threads>),
                  f.threads, rays, setup_group_smem(s_count, s_out, rays), f.group, 0};
  }
}

Launch setup_launch(int s_count, int s_out) { return setup_launch_form<0>(s_count, s_out); }

// select's register forms by buffer width w, the first whose max_w holds
// it: select_group<group, ceil(max_w / group), threads>; a wider buffer
// takes select_kernel (its shared-memory column).
struct SelectForm {
  int max_w, group, threads;
};
constexpr SelectForm kSelectForms[] = {{72, 4, 256}, {160, 4, 256}, {320, 8, 128}, {512, 16, 128}};
constexpr int kSelectFormCount = sizeof(kSelectForms) / sizeof(kSelectForms[0]);

template <int F>
Launch select_launch_form(int w, int k) {
  if constexpr (F == kSelectFormCount) {
    return Launch{reinterpret_cast<const void*>(select_kernel), kBlock, kBlock,
                  (size_t)(w + k - 1) * kBlock * sizeof(int), 0, 0};
  } else {
    constexpr SelectForm f = kSelectForms[F];
    if (w > f.max_w) return select_launch_form<F + 1>(w, k);
    constexpr int keys = (f.max_w + f.group - 1) / f.group, rays = f.threads / f.group;
    return Launch{reinterpret_cast<const void*>(select_group<f.group, keys, f.threads>),
                  f.threads, rays, (size_t)rays * k * sizeof(int), f.group, keys};
  }
}

Launch select_launch(int w, int k) { return select_launch_form<0>(w, k); }

// The seg kernel's form for a scene's kinds of prims.
template <bool KEYED>
const void* seg_form(int instanced, int has_tri, int has_sph) {
#define ECHO_SEG_FORM(TRI, SPH, INST) \
  reinterpret_cast<const void*>(seg_kernel<TRI, SPH, INST, KEYED>)
  if (instanced) {
    if (has_tri && has_sph) return ECHO_SEG_FORM(true, true, true);
    if (has_tri) return ECHO_SEG_FORM(true, false, true);
    return ECHO_SEG_FORM(false, true, true);
  }
  if (has_tri && has_sph) return ECHO_SEG_FORM(true, true, false);
  if (has_tri) return ECHO_SEG_FORM(true, false, false);
  return ECHO_SEG_FORM(false, true, false);
#undef ECHO_SEG_FORM
}

template <bool KEYED>
int launch_seg(const float* rec, const int* chunk, int m, const float* chunks, int n_chunks,
               int has_tri, int has_sph, int block, const int* g2c, const int* g2i,
               const float* inst_f32, void* out, void* stream) {
  if (block != kSegPairs) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = seg_form<KEYED>(g2c != nullptr, has_tri, has_sph);
  SegArgs a{rec, chunk, m, chunks, g2c, g2i, inst_f32, n_chunks, out};
  void* args[] = {&a};
  const dim3 grid((m + kSegPairs - 1) / kSegPairs), threads(kSegWarps * 32);
  const cudaError_t err = cudaLaunchKernel(fn, grid, threads, args, kSegSmem,
                                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// A launch form's resident blocks per SM and layout, into out[0..5]: blocks,
// threads a block, dynamic shared memory a block, lanes a ray, keys a lane
// (select's register forms; else 0), SMs.
int form_occupancy(const Launch& l, int* out) {
  cudaError_t err = static_cast<cudaError_t>(smem_opt_in(l.fn, l.smem));
  int blocks = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.fn, l.threads, l.smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  out[0] = blocks;
  out[1] = l.threads;
  out[2] = static_cast<int>(l.smem);
  out[3] = l.group;
  out[4] = l.keys;
  out[5] = sms;
  return static_cast<int>(err);
}

}  // namespace

extern "C" int binned_setup(const float* rays, int n, const float* sup, int s_count, int sbits,
                            int s_out, int* out, void* stream) {
  const Launch l = setup_launch(s_count, s_out);
  if (int err = smem_opt_in(l.fn, l.smem)) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l.group == 1) {
    setup_kernel<<<(n + kBlock - 1) / kBlock, kBlock, l.smem, st>>>(rays, n, sup, s_count, sbits,
                                                                  s_out, out);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, sms = 0;
  if (cudaError_t err = cudaGetDevice(&dev)) return static_cast<int>(err);
  if (cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return static_cast<int>(err);
  const int blocks = (n + l.rays - 1) / l.rays;  // the grid walks them
  const int grid = blocks < sms * kSetupGridPerSm ? blocks : sms * kSetupGridPerSm;
  SetupArgs a{rays, n, sup, s_count, sbits, s_out, out};
  void* args[] = {&a};
  const cudaError_t err = cudaLaunchKernel(l.fn, dim3(grid), dim3(l.threads), args, l.smem, st);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int binned_select(int* cand, int w, int n, const int* nk, const float* best_t,
                             const uint8_t* refill, int k, int cbits, int* pop, int* live,
                             int* mink, void* stream) {
  const Launch l = select_launch(w, k);
  if (int err = smem_opt_in(l.fn, l.smem)) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l.group == 0) {
    select_kernel<<<(n + kBlock - 1) / kBlock, kBlock, l.smem, st>>>(
        cand, w, n, nk, best_t, refill, k, cbits, pop, live, mink);
    return static_cast<int>(cudaGetLastError());
  }
  SelectArgs a{cand, w, n, nk, best_t, refill, k, cbits, pop, live, mink};
  void* args[] = {&a};
  const cudaError_t err =
      cudaLaunchKernel(l.fn, dim3((n + l.rays - 1) / l.rays), dim3(l.threads), args, l.smem, st);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// base is the (s_count, 6 kSup) super-box table, 16-byte aligned (read as
// float4); keys is (ksup kSup, n) int32, slot-major
extern "C" int binned_refill(const float* rays, int n, const int* sup_ord, int w_ord,
                             const int* cursor, const float* best_t, const uint8_t* refill,
                             const int* next_sup, const float* base, int s_count, int ksup,
                             int sbits, int cbits, int* keys, int* cursor_out, int* next_out,
                             void* stream) {
  const RefillArgs a{rays, n, sup_ord, w_ord, cursor, best_t, refill, next_sup,
                     reinterpret_cast<const float4*>(base), s_count, ksup, sbits, cbits,
                     keys, cursor_out, next_out};
  refill_kernel<<<(n + kRefillBlock - 1) / kRefillBlock, kRefillBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// g2c, g2i and inst_f32 are null for a non-instanced scene; n_chunks is the
// count of valid pair chunks (the scene's chunks, or the global chunks);
// block is the pairs a block takes, kSegPairs (the launch refuses another);
// chunks must be 16-byte aligned (each run's rows arrive by a bulk copy)
extern "C" int binned_seg(const float* rec, const int* chunk, int m, const float* chunks,
                          int n_chunks, int has_tri, int has_sph, int block, const int* g2c,
                          const int* g2i, const float* inst_f32, int* out, void* stream) {
  return launch_seg<true>(rec, chunk, m, chunks, n_chunks, has_tri, has_sph, block, g2c, g2i,
                          inst_f32, out, stream);
}

// the exact form: out is (4, m) floats, rows t, prim, u, v
extern "C" int binned_seg_exact(const float* rec, const int* chunk, int m, const float* chunks,
                                int n_chunks, int has_tri, int has_sph, int block,
                                const int* g2c, const int* g2i, const float* inst_f32,
                                float* out, void* stream) {
  return launch_seg<false>(rec, chunk, m, chunks, n_chunks, has_tri, has_sph, block, g2c, g2i,
                           inst_f32, out, stream);
}

// One seg form's resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// its threads a block and its dynamic shared memory a block, into out[0..2].
extern "C" int binned_seg_occupancy(int keyed, int instanced, int has_tri, int has_sph,
                                    int* out) {
  const void* fn = keyed ? seg_form<true>(instanced, has_tri, has_sph)
                         : seg_form<false>(instanced, has_tri, has_sph);
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kSegWarps * 32, kSegSmem);
  out[0] = blocks;
  out[1] = kSegWarps * 32;
  out[2] = static_cast<int>(kSegSmem);
  return static_cast<int>(err);
}

// The form binned_setup launches for s_count supers and s_out keys a ray.
extern "C" int binned_setup_occupancy(int s_count, int s_out, int* out) {
  return form_occupancy(setup_launch(s_count, s_out), out);
}

// The form binned_select launches for a buffer of w slots and k pops.
extern "C" int binned_select_occupancy(int w, int k, int* out) {
  return form_occupancy(select_launch(w, k), out);
}
