// Dense chunked closest-hit and any-hit ray/primitive kernels for Hopper.
//
// Replaces the Pallas TPU kernels `_trace_kernel` and `_occlude_kernel` of
// echorenderer_tpu/ops/pallas_intersect.py (lines 322 and 400), which the
// JAX package reaches through `intersect_pallas` / `occlude_pallas`.
//
// What it computes: for every ray, the closest hit (t, sorted prim slot,
// u, v) or an any-hit flag against every primitive of the scene, laid out
// as 10 rows of P floats in BVH-leaf order (a/b/c xyz, is_sphere; a sphere
// keeps its center in a and its radius in b.x), in 128-prim chunks with a
// box each and a box for each 32-chunk superchunk. A ray tests a chunk only
// if it enters the chunk's box, and the box of the chunk's superchunk, before
// its own current best t (t_max for any hit; with the relative slack
// echo::kCullMargin), as the plain PyTorch version (`dense_trace_plain` /
// `dense_occlude_plain`) does. A closest hit is the least (t, sorted slot)
// over the hits with t < t_max; that does not depend on the order in which
// chunks are visited or on how a chunk's tests are split over lanes, so the
// kernels and the plain version agree bit for bit.
//
// What bounds it on the H100: the prim tests (about 45 flops a triangle, 21
// a sphere) of the chunks each ray enters, on rays that are incoherent after
// the first bounce. Design, per warp and with no block-wide barrier:
//   - cull per ray, take per warp: each lane slab-tests the superchunk box,
//     then each of its chunk boxes, against its own ray and its own best t;
//     the warp takes a chunk when `__ballot_sync` of those tests is not
//     zero, and skips a superchunk no lane enters in one step;
//   - a taken chunk is staged by the warp into its own buffer in shared
//     memory, as 3-word prim records (`echo::make_record` layout, read by
//     `echo::record_hit`: three 16-byte loads a test, a sphere out at a
//     negative discriminant);
//   - tests spread over the warp when the ballot is sparse: for g <=
//     kCoopMax rays in the ballot, the g x 128 (member, prim) pairs go to all
//     32 lanes (lane j tests prims j, 32 + j, 64 + j, 96 + j of a member's
//     ray, broadcast by shuffles), a butterfly of `__shfl_xor_sync` reduces
//     the member's least (t, slot), and the member's lane keeps it if it is
//     smaller than its best (an equal t only with a lower slot); for a denser
//     ballot each lane in it tests the whole chunk against its own ray;
//   - occlude: a blocked lane leaves the ballots, a member stops at the
//     first hit among its pairs, a warp whose lanes are all blocked or dead
//     returns.
// kCoopMax and the block size came from a sweep on the H100 (`tools/
// hier_ab.py --sweep dense`): spreading the tests of ballots of up to 24
// rays beat a lane a ray for every ballot by 2-7x, and spreading every
// ballot by 4% summed over the calls timed; 2 warps a block beat 4 and 8 by
// 3-7% on trace, occlude within 1%. What bounds the design: 40-64
// registers (32-36 resident warps a SM, capped by registers), the stage's
// round trip to global memory at each taken chunk, and the box test of every
// chunk of a superchunk some lane enters. The file is built with
// -fmad=false so that every float op rounds as in the plain version.
//
// C interface (loaded with ctypes): rays are 7 rows of n floats
// (ox oy oz dx dy dz t_max), ignore is n int32 sorted slots (-1 = none).
// Both functions return cudaGetLastError() after the launch.
// `dense_occupancy(any_hit, has_tri, has_sph, out)` writes a form's resident
// blocks per SM, its block size and its dynamic shared memory per block to
// out[0..2] and returns the CUDA error code.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "intersect.cuh"

namespace {

using echo::Ray;
using echo::safe_inv;

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kChunk = 128;  // prims per chunk
constexpr int kSuper = 32;   // chunks per superchunk
constexpr int kSteps = kChunk / 32;  // prims per lane of one member's chunk
constexpr int kDenseWarps = 2;  // warps per block
constexpr int kCoopMax = 24;  // ballots of at most this many rays spread their tests
constexpr int kBlock = 32 * kDenseWarps;
constexpr int kStageWords = kChunk * echo::kRecordWords;  // float4 words a warp's stage
constexpr size_t kSmem = sizeof(float4) * kStageWords * kDenseWarps;
static_assert(kSmem <= 48 * 1024, "within the default dynamic shared memory");

// Slab test of one ray against box j of a (8, count) bounds table.
__device__ __forceinline__ bool box_hit(const float* __restrict__ tb, int count, int j,
                                        const Ray& r, float ix, float iy, float iz,
                                        float limit) {
  float tn, tf;
  echo::slab(__ldg(tb + 0 * (size_t)count + j), __ldg(tb + 1 * (size_t)count + j),
             __ldg(tb + 2 * (size_t)count + j), __ldg(tb + 3 * (size_t)count + j),
             __ldg(tb + 4 * (size_t)count + j), __ldg(tb + 5 * (size_t)count + j),
             r.ox, r.oy, r.oz, ix, iy, iz, tn, tf);
  return echo::reaches(tn, tf, limit);
}

// Lanes past n walk a dead ray (t_max -1): they vote no and write nothing.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        const int* __restrict__ ignore, int n, int i) {
  Ray r;
  const bool live = i < n;
  r.ox = live ? rays[0 * (size_t)n + i] : 0.0f;
  r.oy = live ? rays[1 * (size_t)n + i] : 0.0f;
  r.oz = live ? rays[2 * (size_t)n + i] : 0.0f;
  r.dx = live ? rays[3 * (size_t)n + i] : 0.0f;
  r.dy = live ? rays[4 * (size_t)n + i] : 0.0f;
  r.dz = live ? rays[5 * (size_t)n + i] : 1.0f;
  r.tmax = live ? rays[6 * (size_t)n + i] : -1.0f;
  r.ignore = live ? ignore[i] : -1;
  return r;
}

// The warp stages prims [base, base + cs) of the (10, padded) rows as
// records: lane j builds those of prims j, 32 + j, 64 + j, 96 + j (each row
// read by the warp as 128 contiguous bytes; rows a form never reads are
// skipped and their record words left 0).
template <bool HAS_TRI, bool HAS_SPH>
__device__ __forceinline__ void stage_chunk(float4* st, const float* __restrict__ prims,
                                            int padded, int base, int cs) {
  const int lane = threadIdx.x & 31;
  const size_t p = padded;
  __syncwarp();  // every lane has finished reading the previous chunk
#pragma unroll
  for (int q = 0; q < kSteps; ++q) {
    const int k = 32 * q + lane;
    if (k < cs) {
      const float* c = prims + base + k;
      const float sph = HAS_TRI && HAS_SPH ? __ldg(c + 9 * p) : 0.0f;
      st[3 * k] = make_float4(__ldg(c), __ldg(c + p), __ldg(c + 2 * p), sph);
      if (HAS_TRI) {
        st[3 * k + 1] = make_float4(__ldg(c + 3 * p), __ldg(c + 4 * p), __ldg(c + 5 * p),
                                    __ldg(c + 6 * p));
        st[3 * k + 2] = make_float4(__ldg(c + 7 * p), __ldg(c + 8 * p),
                                    __int_as_float(base + k), 0.0f);
      } else {
        st[3 * k + 1] = make_float4(__ldg(c + 3 * p), 0.0f, 0.0f, 0.0f);
        st[3 * k + 2] = make_float4(0.0f, 0.0f, __int_as_float(base + k), 0.0f);
      }
    }
  }
  __syncwarp();
}

// The running result of one lane's ray.
struct Best {
  float t, u, v;
  int p;
  bool blocked;
};

// Member m's ray, broadcast from its lane.
__device__ __forceinline__ Ray member_ray(const Ray& r, int m) {
  Ray rm;
  rm.ox = __shfl_sync(kFullWarp, r.ox, m);
  rm.oy = __shfl_sync(kFullWarp, r.oy, m);
  rm.oz = __shfl_sync(kFullWarp, r.oz, m);
  rm.dx = __shfl_sync(kFullWarp, r.dx, m);
  rm.dy = __shfl_sync(kFullWarp, r.dy, m);
  rm.dz = __shfl_sync(kFullWarp, r.dz, m);
  rm.tmax = __shfl_sync(kFullWarp, r.tmax, m);
  rm.ignore = __shfl_sync(kFullWarp, r.ignore, m);
  return rm;
}

// The staged chunk (first slot base, cs prims) against the rays of `group`
// (the warp's ballot; `want`: this lane is in it). Every lane calls it.
template <bool HAS_TRI, bool HAS_SPH, bool ANY_HIT>
__device__ __forceinline__ void test_chunk(const float4* st, int base, int cs, unsigned group,
                                           bool want, const Ray& r, Best& b) {
  const int lane = threadIdx.x & 31;
  if (__popc(group) > kCoopMax) {  // dense ballot: a lane a ray, the whole chunk
    if (!want) return;
    for (int k = 0; k < cs; ++k) {
      float t, u, v;
      int slot;
      if (!echo::record_hit<HAS_TRI, HAS_SPH>(st + 3 * k, r, t, u, v, slot)) continue;
      if (ANY_HIT) {
        if (t < r.tmax) {
          b.blocked = true;
          return;
        }
      } else if (t < b.t) {  // slots ascend: a strict < keeps the lower slot of equal t
        b.t = t;
        b.p = slot;
        b.u = u;
        b.v = v;
      }
    }
    return;
  }
  // sparse ballot: the members' (member, prim) pairs over the whole warp
  unsigned members = group;
  while (members) {
    const int m = __ffs(members) - 1;
    members &= members - 1;
    const Ray rm = member_ray(r, m);
    if (ANY_HIT) {
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const int k = 32 * q + lane;
        float t, u, v;
        int slot;
        const bool hit = k < cs && echo::record_hit<HAS_TRI, HAS_SPH>(st + 3 * k, rm, t, u, v,
                                                                      slot) &&
                         t < rm.tmax;
        if (__any_sync(kFullWarp, hit)) {  // blocked: the member is done
          if (lane == m) b.blocked = true;
          break;
        }
      }
    } else {
      // this lane's least (t, slot) of its prims: slots ascend, so a strict <
      // keeps the lower slot of equal t
      float bt = INFINITY, bu = 0.0f, bv = 0.0f;
      int bs = INT_MAX;
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const int k = 32 * q + lane;
        float t, u, v;
        int slot;
        if (k < cs && echo::record_hit<HAS_TRI, HAS_SPH>(st + 3 * k, rm, t, u, v, slot) &&
            t < bt) {
          bt = t;
          bs = slot;
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
        if (lane == m && (bt < b.t || (bt == b.t && b.p >= 0 && bs < b.p))) {
          b.t = bt;
          b.p = bs;
          b.u = wu;
          b.v = wv;
        }
      }
    }
  }
}

// One warp's walk over every chunk for its 32 rays (every lane calls it).
template <bool HAS_TRI, bool HAS_SPH, bool ANY_HIT>
__device__ __forceinline__ Best dense_walk(const Ray& r, float4* st,
                                           const float* __restrict__ prims, int padded,
                                           const float* __restrict__ cb, int n_chunks,
                                           const float* __restrict__ scb, int n_super) {
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const int cs = n_chunks > 1 ? kChunk : padded;
  Best b{r.tmax, 0.0f, 0.0f, -1, false};
  // the limit of every cull test: the best t (t_max for any hit; -1, so no
  // box is entered, once blocked); a ray whose limit is <= 0 takes nothing
  auto limit = [&]() { return ANY_HIT ? (b.blocked ? -1.0f : r.tmax) : b.t; };
  const int supers = n_super > 1 ? n_super : 1;
  for (int s = 0; s < supers; ++s) {
    const float ls = limit();
    if (ANY_HIT && !__any_sync(kFullWarp, ls > 0.0f)) break;  // every lane blocked or dead
    const bool sc = ls > 0.0f && (n_super <= 1 || box_hit(scb, n_super, s, r, ix, iy, iz, ls));
    if (!__any_sync(kFullWarp, sc)) continue;  // no lane enters the superchunk
    const int j_end = min(n_chunks, (s + 1) * kSuper);
    for (int j = s * kSuper; j < j_end; ++j) {
      const float lj = limit();
      const bool want =
          sc && lj > 0.0f && (n_chunks <= 1 || box_hit(cb, n_chunks, j, r, ix, iy, iz, lj));
      const unsigned group = __ballot_sync(kFullWarp, want);
      if (group == 0) continue;
      stage_chunk<HAS_TRI, HAS_SPH>(st, prims, padded, j * kChunk, cs);
      test_chunk<HAS_TRI, HAS_SPH, ANY_HIT>(st, j * kChunk, cs, group, want, r, b);
      if (ANY_HIT && !__any_sync(kFullWarp, limit() > 0.0f)) return b;  // all blocked or dead
    }
  }
  return b;
}

template <bool HAS_TRI, bool HAS_SPH>
__global__ void __launch_bounds__(kBlock)
trace_kernel(const float* __restrict__ rays, const int* __restrict__ ignore, int n,
             const float* __restrict__ prims, int padded,
             const float* __restrict__ cb, int n_chunks,
             const float* __restrict__ scb, int n_super,
             float* __restrict__ t_out, int* __restrict__ prim_out,
             float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ float4 stage[];  // kDenseWarps stages of kStageWords
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const Ray r = load_ray(rays, ignore, n, i);
  float4* st = stage + (threadIdx.x >> 5) * kStageWords;  // this warp's
  const Best b = dense_walk<HAS_TRI, HAS_SPH, false>(r, st, prims, padded, cb, n_chunks, scb,
                                                     n_super);
  if (i < n) {
    t_out[i] = b.t;
    prim_out[i] = b.p;
    u_out[i] = b.u;
    v_out[i] = b.v;
  }
}

template <bool HAS_TRI, bool HAS_SPH>
__global__ void __launch_bounds__(kBlock)
occlude_kernel(const float* __restrict__ rays, const int* __restrict__ ignore, int n,
               const float* __restrict__ prims, int padded,
               const float* __restrict__ cb, int n_chunks,
               const float* __restrict__ scb, int n_super,
               uint8_t* __restrict__ blocked_out) {
  extern __shared__ float4 stage[];  // kDenseWarps stages of kStageWords
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const Ray r = load_ray(rays, ignore, n, i);
  float4* st = stage + (threadIdx.x >> 5) * kStageWords;  // this warp's
  const Best b = dense_walk<HAS_TRI, HAS_SPH, true>(r, st, prims, padded, cb, n_chunks, scb,
                                                    n_super);
  if (i < n) blocked_out[i] = b.blocked ? 1 : 0;
}

// One form's kernel, for the occupancy query.
const void* kernel_of(int any_hit, int has_tri, int has_sph) {
  if (any_hit) {
    if (has_tri && has_sph) return reinterpret_cast<const void*>(occlude_kernel<true, true>);
    if (has_tri) return reinterpret_cast<const void*>(occlude_kernel<true, false>);
    return reinterpret_cast<const void*>(occlude_kernel<false, true>);
  }
  if (has_tri && has_sph) return reinterpret_cast<const void*>(trace_kernel<true, true>);
  if (has_tri) return reinterpret_cast<const void*>(trace_kernel<true, false>);
  return reinterpret_cast<const void*>(trace_kernel<false, true>);
}

}  // namespace

extern "C" int dense_occupancy(int any_hit, int has_tri, int has_sph, int* out) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_of(any_hit, has_tri, has_sph), kBlock, kSmem);
  out[0] = blocks;
  out[1] = kBlock;
  out[2] = static_cast<int>(kSmem);
  return static_cast<int>(err);
}

extern "C" int dense_trace(const float* rays, const int* ignore, int n,
                           const float* prims, int padded,
                           const float* cb, int n_chunks, const float* scb, int n_super,
                           int has_tri, int has_sph,
                           float* t_out, int* prim_out, float* u_out, float* v_out,
                           void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock), block(kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_tri && has_sph)
    trace_kernel<true, true><<<grid, block, kSmem, s>>>(rays, ignore, n, prims, padded, cb,
        n_chunks, scb, n_super, t_out, prim_out, u_out, v_out);
  else if (has_tri)
    trace_kernel<true, false><<<grid, block, kSmem, s>>>(rays, ignore, n, prims, padded, cb,
        n_chunks, scb, n_super, t_out, prim_out, u_out, v_out);
  else
    trace_kernel<false, true><<<grid, block, kSmem, s>>>(rays, ignore, n, prims, padded, cb,
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
    occlude_kernel<true, true><<<grid, block, kSmem, s>>>(rays, ignore, n, prims, padded, cb,
        n_chunks, scb, n_super, blocked_out);
  else if (has_tri)
    occlude_kernel<true, false><<<grid, block, kSmem, s>>>(rays, ignore, n, prims, padded, cb,
        n_chunks, scb, n_super, blocked_out);
  else
    occlude_kernel<false, true><<<grid, block, kSmem, s>>>(rays, ignore, n, prims, padded, cb,
        n_chunks, scb, n_super, blocked_out);
  return static_cast<int>(cudaGetLastError());
}
