// The Plücker micro-benchmark's two keyed intersection kernels for Hopper.
//
// Replace the Pallas TPU kernels of benchmarks/plucker_micro.py, both reached
// through its `run` (line 152):
//   mt_kernel      <- `kern_mt` (line 79)
//   highest_kernel <- `kern` of `make_kern_plk` (line 142; body `_plk_keyed`,
//                     line 99) at HIGHEST precision
//   default_kernel <- the same at DEFAULT precision (the TPU's one bf16 pass)
// Each computes what its plain PyTorch version in
// echorenderer_tpu_torch/benchmarks/plucker_micro.py computes (`keys_mt_plain`,
// `keys_plk_plain`): mt_kernel and highest_kernel bit for bit, default_kernel
// within a stated contract (below).
//
// What they compute: per ray of 8 columns (ox oy oz dx dy dz t_max ignore, n
// floats each), the least packed key (bits(t) & ~0xFF) | prim over one
// resident chunk of 256 triangles, over the prims hit with t < t_max; _INT_INF
// where none is.
// - mt_kernel: the Moller-Trumbore test of every other kernel
//   (`echo::record_hit`, triangles only) on the (10, 256) prim rows.
// - highest_kernel / default_kernel: the Plücker form on the (16, 5*256) table
//   of `build_plk`: the three edge volumes w = [d, m] . column (6-term sums
//   over rows 0..5 of the column groups 0..2, m = o x d), the plane's n.d
//   (rows 0..2 of group 3) and nv0 - n.o (rows 6..9 of group 4 against
//   [o, 1]); inside when all three w are >= 0 or all <= 0; t = num / den; a
//   hit needs t > RAY_EPSILON, t < t_max and prim != ignore.
//
// What bounds them on the H100, and what the design does about it. All
// three are bound by instruction issue, not by the 36 bytes a ray moves: 2^28
// (ray, triangle) pairs of float work without FMAs (-fmad=false keeps every
// op rounding as in the plain versions), so about half of the 67 TFLOP/s the
// bounds assume is in reach. The old design (one ray a thread, one block per
// 128 rays, the table restaged by each of 8,192 blocks) spent a shared load
// per coefficient and pair. Now every kernel is persistent: a block stages
// its table once by bulk asynchronous copies (cp.async.bulk on an mbarrier),
// rearranges it in shared memory, and walks over ray tiles.
// - mt_kernel: the soup as 3-word records (`echo::make_record`); each thread
//   takes kMtRays rays, so the three 16-byte broadcast loads of a record serve
//   them all. The test's op order is prim_hit<true, false, true>'s, 1/det
//   included: no test moves before the reciprocal. What is left is the test
//   itself, about 78 SASS instructions a pair (27 FMUL, 19 FADD, the IEEE
//   reciprocal, 8 compares), so rays a thread (2 to 8) barely matter.
// - highest_kernel: f32 products cannot go to the tensor cores and stay
//   bitwise, so it runs on the CUDA cores in the plain version's order. The
//   coefficients are prim-major: five 16-byte broadcast loads of the 18 edge
//   coefficients serve the kHighRays rays of a thread; n.d, nv0 - n.o, the
//   division and the key run only under the sign test (about 0.1% of pairs),
//   reading the staged rows. The products against the two literal-zero
//   operands of the old 8-term sums are gone, here and in the plain version:
//   for a finite table they add +-0 to a w, which only the sign test reads,
//   and it treats +-0 alike. Left: 18 FMUL, 15 FADD and the sign test a
//   pair.
// - default_kernel: the DEFAULT form on the tensor cores. The edge groups
//   share the slots [d 0:3, m 3:6], so one bf16 product of depth K = 16,
//   A = [d, m, 0 x 10] a ray (rounded to bf16; m in f32 in the plain
//   version's order) against B = an edge group's columns (rounded to bf16,
//   the rows the plain version does not read zeroed), gives its w. A
//   warpgroup takes 64 rays (the wgmma M side) with A in registers; B is the
//   24 KiB of the three edge groups in bf16 in shared memory, in wgmma's
//   K-major no-swizzle layout. For each chunk of kPlkN prims it issues three
//   wgmma.mma_async m64nNk16 products (w0, w1, w2) over the same columns, so
//   each thread's accumulators hold all three w of its own (ray, prim)
//   entries. The epilogue runs in registers: the sign test; where inside
//   (about 0.1% of pairs), n.d and nv0 - n.o on the CUDA cores from the
//   bf16-rounded operands in the plain version's order, the IEEE division
//   and the key; a running minimum, and a quad's four lanes take the minimum
//   at the end. The products are nearly free; what bounds it is each chunk's
//   round trip (three products, the wait, the epilogue's ~10 instructions an
//   entry), warpgroups overlapping one another: 16 prims a product at 32
//   resident warps/SM beat 8 and 32 prims, and two accumulator sets (a
//   chunk's epilogue beside the next chunk's products) lost to the
//   residency their registers cost. The warpgroup index is broadcast and no
//   accumulator is read on a divergent path: otherwise ptxas serializes the
//   wgmmas.
//   n.d and nv0 - n.o stay off the tensor cores because a t summed there
//   broke the contract below where they cancel (a first form with five
//   products had keys 2 and 11 t bands off); here t is bitwise the plain
//   version's wherever the sign test agrees. Not bitwise: products of bf16
//   values are exact in f32, but a tensor core sums the w in its own order,
//   so a w within a few ulps of 0 can take the other sign. On the TPU,
//   DEFAULT is one pass of the matrix unit summed in that unit's order, so
//   the plain version's left-to-right order was the port's choice, not the
//   reference's. The contract (`default_within_contract` in the module):
//   over the rays, prim plus hit/miss flips on at most 1e-4 of them,
//   differing keys on at most 1e-3, and every other difference the same
//   prim one t band (|key difference| = 256) away.
//
// Built with -fmad=false, so every float op outside the tensor cores rounds
// as in the plain versions. C interface (loaded with ctypes); each function
// returns cudaGetLastError() or the error it met.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "intersect.cuh"

namespace {

constexpr int kH = 256;  // triangles in the resident chunk
constexpr int kW = 5 * kH;  // the Plücker table's row length
constexpr int kIntInf = 0x7FFFFFFF;
constexpr float kFarT = 3.4e38f;  // _INF
constexpr int kKeyMask = -(1 << 8);  // clears the prim bits of t
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// The forms (tools/hier_ab.py --plucker --sweep replaces these constants)
constexpr int kMtRays = 4;  // rays a thread, mt_kernel
constexpr int kHighRays = 4;  // rays a thread, highest_kernel
constexpr int kPlkN = 16;  // prims a wgmma product, default_kernel
constexpr int kBlock = 128;  // threads a block, mt_kernel and highest_kernel
constexpr int kDefWarpgroups = 2;  // warpgroups a block, default_kernel
constexpr int kDefMinBlocks = 4;  // default_kernel's __launch_bounds__ blocks a SM

constexpr int kWarpgroup = 128;
constexpr int kDefTile = 64;  // rays a warpgroup tile: the wgmma M side

// The Plücker rows the plain version reads, staged as f32 in shared memory:
// rows 0..5 of groups 0..2, rows 0..2 of group 3, rows 6..9 of group 4.
constexpr int kEdgeRows = 6;
constexpr int kStageDen = kEdgeRows * 3 * kH;  // float offset of the den rows
constexpr int kStageNum = kStageDen + 3 * kH;  // float offset of the num rows
constexpr int kStageFloats = kStageNum + 4 * kH;  // 6,400 floats = 25,600 bytes
// default_kernel's B operand: per edge group, 32 blocks of 8 prims; a block
// is two 8x8 core matrices (k 0..7, k 8..15) of 128 bytes, a prim's 8 values
// one 16-byte row
constexpr int kGroupBytes = kH * 16 * 2;  // 8,192
constexpr int kTableBytes = 3 * kGroupBytes;  // 24,576
// highest_kernel's edge records: 5 float4 of coefficients a prim (e0 k0..5,
// e1 k0..5, e2 k0..5, 0, 0)
constexpr int kEdgeWords = 5;

constexpr size_t kHighSmem = sizeof(float) * kStageFloats + sizeof(float4) * kEdgeWords * kH + 8;
constexpr size_t kDefSmem = kTableBytes + sizeof(float) * kStageFloats + 8;

// ---------------------------------------------------------------------------
// staging: bulk asynchronous copies completed on one mbarrier, once a block
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0: initialise the block's barrier and arm it for `bytes`.
__device__ __forceinline__ void stage_arm(uint64_t* bar, uint32_t bytes) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
               : "memory");
}

// Thread 0: copy `bytes` (a multiple of 16; both ends 16-byte aligned) from
// global `src` to shared `dst`, completing on `bar`.
__device__ __forceinline__ void stage_copy(void* dst, const void* src, uint32_t bytes,
                                           uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Every thread (after a __syncthreads that follows stage_arm): wait for the
// barrier's first phase. A copy that never lands traps (a launch error)
// instead of spinning forever.
__device__ __forceinline__ void stage_wait(uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// Stage the Plücker rows the plain version reads (kStageFloats floats, the
// layout of kStageDen / kStageNum) from the (16, kW) table `plk`.
__device__ __forceinline__ void stage_plk(float* stage, const float* plk, uint64_t* bar) {
  if (threadIdx.x == 0) {
    stage_arm(bar, sizeof(float) * kStageFloats);
    for (int k = 0; k < kEdgeRows; ++k)
      stage_copy(stage + k * 3 * kH, plk + k * kW, sizeof(float) * 3 * kH, bar);
    for (int k = 0; k < 3; ++k)
      stage_copy(stage + kStageDen + k * kH, plk + k * kW + 3 * kH, sizeof(float) * kH, bar);
    for (int k = 0; k < 4; ++k)
      stage_copy(stage + kStageNum + k * kH, plk + (6 + k) * kW + 4 * kH, sizeof(float) * kH,
                 bar);
  }
  __syncthreads();
  stage_wait(bar);
}

__device__ __forceinline__ void load_ray(const float* __restrict__ cols, size_t n, long long q,
                                         echo::Ray& r) {
  if (q < static_cast<long long>(n)) {
    r.ox = cols[q];
    r.oy = cols[n + q];
    r.oz = cols[2 * n + q];
    r.dx = cols[3 * n + q];
    r.dy = cols[4 * n + q];
    r.dz = cols[5 * n + q];
    r.tmax = cols[6 * n + q];
    r.ignore = static_cast<int>(cols[7 * n + q]);
  } else {  // past the end: a ray that hits nothing and is never stored
    r.ox = r.oy = r.oz = r.dx = r.dy = r.dz = 0.0f;
    r.tmax = -1.0f;
    r.ignore = -1;
  }
}

__device__ __forceinline__ int key_of(float t, int prim) {
  return (__float_as_int(t) & kKeyMask) | prim;
}

// inside when all three w are >= 0 or all <= 0 (any NaN: outside), as the
// plain version's NaN-propagating min / max
__device__ __forceinline__ bool inside3(float w0, float w1, float w2) {
  return (w0 >= 0.0f && w1 >= 0.0f && w2 >= 0.0f) || (w0 <= 0.0f && w1 <= 0.0f && w2 <= 0.0f);
}

template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// t = (nv0 - n.o) / n.d of prim p for a ray with direction d and origin o
// (rounded to bf16 already for the DEFAULT form), in the plain version's
// order: n.d over rows 0..2 of group 3, nv0 - n.o over rows 6..9 of group 4
// against [o, 1], read from the staged rows (under the sign test only, so
// about 0.1% of pairs read them)
template <bool BF16>
__device__ __forceinline__ float plane_t(const float* stage, int p, const float* d,
                                         const float* o) {
  const float* den = stage + kStageDen + p;
  const float* num = stage + kStageNum + p;
  const float nd = operand<BF16>(den[0]) * d[0] + operand<BF16>(den[kH]) * d[1] +
                   operand<BF16>(den[2 * kH]) * d[2];
  const float nvo = operand<BF16>(num[0]) * o[0] + operand<BF16>(num[kH]) * o[1] +
                    operand<BF16>(num[2 * kH]) * o[2] + operand<BF16>(num[3 * kH]) * 1.0f;
  return nvo / nd;
}

// ---------------------------------------------------------------------------
// mt_kernel
// ---------------------------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kBlock)
mt_kernel(const float* __restrict__ prims, const float* __restrict__ cols, int n,
          int* __restrict__ out) {
  __shared__ __align__(16) float rows[10 * kH];
  __shared__ float4 recs[echo::kRecordWords * kH];
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    stage_arm(&bar, sizeof(rows));
    stage_copy(rows, prims, sizeof(rows), &bar);
  }
  __syncthreads();
  stage_wait(&bar);
  for (int j = threadIdx.x; j < kH; j += kBlock)
    echo::make_record(rows, kH, j, j, recs + echo::kRecordWords * j);
  __syncthreads();
  const size_t sn = n;
  constexpr int kPer = kBlock * R;
  for (long long base = static_cast<long long>(blockIdx.x) * kPer; base < n;
       base += static_cast<long long>(gridDim.x) * kPer) {
    echo::Ray r[R];
    int best[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      load_ray(cols, sn, base + i * kBlock + threadIdx.x, r[i]);
      best[i] = kIntInf;
    }
#pragma unroll 2
    for (int j = 0; j < kH; ++j) {
      const float4 rec[echo::kRecordWords] = {recs[3 * j], recs[3 * j + 1], recs[3 * j + 2]};
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float t, u, v;
        int slot;
        if (echo::record_hit<true, false>(rec, r[i], t, u, v, slot) && t < r[i].tmax &&
            t < kFarT)
          best[i] = min(best[i], key_of(t, j));
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long q = base + i * kBlock + threadIdx.x;
      if (q < n) out[q] = best[i];
    }
  }
}

// ---------------------------------------------------------------------------
// highest_kernel
// ---------------------------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kBlock)
highest_kernel(const float* __restrict__ plk, const float* __restrict__ cols, int n,
               int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char high_smem[];
  float* stage = reinterpret_cast<float*>(high_smem);
  float4* edge = reinterpret_cast<float4*>(high_smem + sizeof(float) * kStageFloats);
  uint64_t* bar = reinterpret_cast<uint64_t*>(edge + kEdgeWords * kH);
  stage_plk(stage, plk, bar);
  for (int p = threadIdx.x; p < kH; p += kBlock) {
    float c[4 * kEdgeWords];
#pragma unroll
    for (int e = 0; e < 3; ++e)
#pragma unroll
      for (int k = 0; k < kEdgeRows; ++k) c[e * kEdgeRows + k] = stage[k * 3 * kH + e * kH + p];
    c[18] = c[19] = 0.0f;
#pragma unroll
    for (int i = 0; i < kEdgeWords; ++i)
      edge[kEdgeWords * p + i] = make_float4(c[4 * i], c[4 * i + 1], c[4 * i + 2], c[4 * i + 3]);
  }
  __syncthreads();
  const size_t sn = n;
  constexpr int kPer = kBlock * R;
  for (long long base = static_cast<long long>(blockIdx.x) * kPer; base < n;
       base += static_cast<long long>(gridDim.x) * kPer) {
    // per ray: [d, m] (m = o x d in the plain version's order), o, t_max,
    // ignore, the least key
    float ra[R][6], ro[R][3], tmax[R];
    int ignore[R], best[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      echo::Ray r;
      load_ray(cols, sn, base + i * kBlock + threadIdx.x, r);
      ra[i][0] = r.dx;
      ra[i][1] = r.dy;
      ra[i][2] = r.dz;
      ra[i][3] = r.oy * r.dz - r.oz * r.dy;
      ra[i][4] = r.oz * r.dx - r.ox * r.dz;
      ra[i][5] = r.ox * r.dy - r.oy * r.dx;
      ro[i][0] = r.ox;
      ro[i][1] = r.oy;
      ro[i][2] = r.oz;
      tmax[i] = r.tmax;
      ignore[i] = r.ignore;
      best[i] = kIntInf;
    }
#pragma unroll 2
    for (int p = 0; p < kH; ++p) {
      const float4 c0 = edge[kEdgeWords * p], c1 = edge[kEdgeWords * p + 1],
                   c2 = edge[kEdgeWords * p + 2], c3 = edge[kEdgeWords * p + 3],
                   c4 = edge[kEdgeWords * p + 4];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float* a = ra[i];
        const float w0 =
            c0.x * a[0] + c0.y * a[1] + c0.z * a[2] + c0.w * a[3] + c1.x * a[4] + c1.y * a[5];
        const float w1 =
            c1.z * a[0] + c1.w * a[1] + c2.x * a[2] + c2.y * a[3] + c2.z * a[4] + c2.w * a[5];
        const float w2 =
            c3.x * a[0] + c3.y * a[1] + c3.z * a[2] + c3.w * a[3] + c4.x * a[4] + c4.y * a[5];
        if (inside3(w0, w1, w2)) {
          const float t = plane_t<false>(stage, p, a, ro[i]);
          if (t > echo::kEps && t < tmax[i] && p != ignore[i])
            best[i] = min(best[i], key_of(t, p));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long q = base + i * kBlock + threadIdx.x;
      if (q < n) out[q] = best[i];
    }
  }
}

// ---------------------------------------------------------------------------
// default_kernel: wgmma
// ---------------------------------------------------------------------------

// wgmma.mma_async m64nNk16, bf16 inputs, f32 accumulators, A from registers,
// B from a shared-memory descriptor (K-major), D = A * B (scale-d false).
// N = 16 is the form default_kernel ships (kPlkN); 8 and 32 are the other
// forms of tools/hier_ab.py --sweep plucker, a supported tool that times
// kPlkN against the residency its accumulators cost.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
};

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator above the wait
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// The descriptor of a K-major, no-swizzle B operand at shared address
// `addr`: core matrices of 8 rows x 16 bytes; the two along K 128 bytes
// apart (leading byte offset), blocks of 8 rows 256 bytes apart (stride byte
// offset); all three fields in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // each rounded to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The byte offset of B's (k, prim column) value in the table.
__device__ __forceinline__ int table_offset(int col, int k) {
  const int e = col / kH, p = col % kH;
  return e * kGroupBytes + (p >> 3) * 256 + (k >> 3) * 128 + (p & 7) * 16 + (k & 7) * 2;
}

// The staged f32 value of an edge group's (k, col) that the plain version
// reads, else 0 (a structural zero of build_plk's table, not read by the
// plain version, so not read here either).
__device__ __forceinline__ float staged_value(const float* stage, int col, int k) {
  return k < kEdgeRows ? stage[k * 3 * kH + col] : 0.0f;
}

// Issue chunk c's three edge products (kPlkN prims from prim c N) into acc.
template <int N>
__device__ __forceinline__ void edge_products(float (&acc)[3][N / 2], const uint32_t (&a)[4],
                                              uint64_t desc0, int c) {
  wgmma_fence();  // no __syncwarp: its divergence check makes ptxas serialize the wgmmas
#pragma unroll
  for (int e = 0; e < 3; ++e)
    Wgmma<N>::mma(acc[e], a, desc0 + ((e * kGroupBytes + c * N * 32) >> 4));
  wgmma_commit();
}

// Chunk c's epilogue, once its products have landed in acc. Accumulator i
// holds row g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 tq + (i & 1). The
// accumulators are read before the branch only: one read on a divergent path
// makes ptxas serialize the wgmmas.
template <int N>
__device__ __forceinline__ void edge_epilogue(float (&acc)[3][N / 2], int c, int tq,
                                              const float* stage, const float (&rd)[2][3],
                                              const float (&ro)[2][3], const float (&tmax)[2],
                                              const int (&ignore)[2], int (&best)[2]) {
#pragma unroll
  for (int e = 0; e < 3; ++e)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_operand(acc[e][i]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int h = (i >> 1) & 1;
    if (inside3(acc[0][i], acc[1][i], acc[2][i])) {
      const int p = c * N + 8 * (i >> 2) + 2 * tq + (i & 1);
      const float t = plane_t<true>(stage, p, rd[h], ro[h]);
      if (t > echo::kEps && t < tmax[h] && p != ignore[h]) best[h] = min(best[h], key_of(t, p));
    }
  }
}

template <int N>
__global__ void __launch_bounds__(kWarpgroup * kDefWarpgroups, kDefMinBlocks)
default_kernel(const float* __restrict__ plk, const float* __restrict__ cols, int n,
               int* __restrict__ out) {
  static_assert(N % 8 == 0 && kH % N == 0, "N: a multiple of 8 that divides 256");
  extern __shared__ __align__(128) unsigned char def_smem[];
  unsigned char* table = def_smem;  // kTableBytes, wgmma's B layout
  float* stage = reinterpret_cast<float*>(def_smem + kTableBytes);
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + kStageFloats);
  stage_plk(stage, plk, bar);
  for (int i = threadIdx.x; i < 3 * kH * 8; i += blockDim.x) {  // pairs (k, k + 1)
    const int col = i >> 3, k = (i & 7) * 2;
    *reinterpret_cast<uint32_t*>(table + table_offset(col, k)) =
        pack_bf16(staged_value(stage, col, k), staged_value(stage, col, k + 1));
  }
  // the table's generic-proxy stores, made visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  // the warpgroup, broadcast so that ptxas sees a warp-uniform loop (a loop
  // it takes for divergent makes it serialize the wgmmas)
  const int wg = __shfl_sync(kFullWarp, static_cast<int>(threadIdx.x / kWarpgroup), 0);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x % kWarpgroup) >> 5;
  const int g = lane >> 2, tq = lane & 3;  // the quad's row and the lane in it
  const uint64_t desc0 = b_desc(smem_addr(table));
  const size_t sn = n;
  const int tiles = (n + kDefTile - 1) / kDefTile;  // n < 2^31
  float acc[3][N / 2];
#pragma unroll
  for (int e = 0; e < 3; ++e)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[e][i] = 0.0f;
  for (int tile = blockIdx.x * kDefWarpgroups + wg; tile < tiles;
       tile += gridDim.x * kDefWarpgroups) {
    // this thread's rows of A: rays g and g + 8 of its warp's 16; its k
    // slots 2tq, 2tq + 1 of [d, m, 0 x 10] (slots 2tq + 8, 2tq + 9: zeros)
    const long long q0 = static_cast<long long>(tile) * kDefTile + warp * 16 + g;
    float tmax[2], rd[2][3], ro[2][3];  // per ray: bf16-rounded d and o
    int ignore[2], best[2];
    uint32_t a[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      echo::Ray r;
      load_ray(cols, sn, q0 + 8 * h, r);
      const float mx = r.oy * r.dz - r.oz * r.dy;
      const float my = r.oz * r.dx - r.ox * r.dz;
      const float mz = r.ox * r.dy - r.oy * r.dx;
      const float lo = tq == 0 ? r.dx : tq == 1 ? r.dz : my;
      const float hi = tq == 0 ? r.dy : tq == 1 ? mx : mz;
      a[h] = tq == 3 ? 0u : pack_bf16(lo, hi);
      rd[h][0] = operand<true>(r.dx);
      rd[h][1] = operand<true>(r.dy);
      rd[h][2] = operand<true>(r.dz);
      ro[h][0] = operand<true>(r.ox);
      ro[h][1] = operand<true>(r.oy);
      ro[h][2] = operand<true>(r.oz);
      tmax[h] = r.tmax;
      ignore[h] = r.ignore;
      best[h] = kIntInf;
    }
#pragma unroll 1
    for (int c = 0; c < kH / N; ++c) {
      edge_products<N>(acc, a, desc0, c);
      wgmma_wait_all();
      edge_epilogue<N>(acc, c, tq, stage, rd, ro, tmax, ignore, best);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best[h] = min(best[h], __shfl_xor_sync(kFullWarp, best[h], 1));
      best[h] = min(best[h], __shfl_xor_sync(kFullWarp, best[h], 2));
      if (tq == 0 && q0 + 8 * h < n) out[q0 + 8 * h] = best[h];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Form {
  const void* fn;
  int threads;
  size_t smem;  // dynamic shared memory a block
  int rays;  // rays a block takes at a time
};

Form form_of(int kernel) {
  if (kernel == 0)
    return {reinterpret_cast<const void*>(mt_kernel<kMtRays>), kBlock, 0, kBlock * kMtRays};
  if (kernel == 1)
    return {reinterpret_cast<const void*>(highest_kernel<kHighRays>), kBlock, kHighSmem,
            kBlock * kHighRays};
  return {reinterpret_cast<const void*>(default_kernel<kPlkN>), kWarpgroup * kDefWarpgroups,
          kDefSmem, kDefTile * kDefWarpgroups};
}

// blocks a SM and SMs, by kernel and device, found at the first launch there
constexpr int kMaxDevices = 64;
int g_blocks[3][kMaxDevices], g_sms[3][kMaxDevices];

// Blocks a SM (the occupancy query, after raising the dynamic shared memory
// limit) and the SMs of the current device; the persistent grid is their
// product, or fewer where the rays need fewer blocks.
cudaError_t residency(int kernel, int* blocks, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev < kMaxDevices;
  if (cached && g_blocks[kernel][dev] > 0) {
    *blocks = g_blocks[kernel][dev];
    *sms = g_sms[kernel][dev];
    return cudaSuccess;
  }
  const Form f = form_of(kernel);
  if (f.smem)
    err = cudaFuncSetAttribute(f.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(f.smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f.fn, f.threads, f.smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && cached) {
    g_sms[kernel][dev] = *sms;
    g_blocks[kernel][dev] = *blocks;
  }
  return err;
}

int launch(int kernel, const float* table, const float* cols, int n, int* out, void* stream) {
  if ((reinterpret_cast<uintptr_t>(table) & 15) != 0) return cudaErrorMisalignedAddress;
  const Form f = form_of(kernel);
  int blocks = 0, sms = 0;
  const cudaError_t err = residency(kernel, &blocks, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  const long long need = (static_cast<long long>(n) + f.rays - 1) / f.rays;
  const int grid = static_cast<int>(need < static_cast<long long>(blocks) * sms
                                        ? need
                                        : static_cast<long long>(blocks) * sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 0)
    mt_kernel<kMtRays><<<grid, f.threads, 0, s>>>(table, cols, n, out);
  else if (kernel == 1)
    highest_kernel<kHighRays><<<grid, f.threads, f.smem, s>>>(table, cols, n, out);
  else
    default_kernel<kPlkN><<<grid, f.threads, f.smem, s>>>(table, cols, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// prims (10, 256) rows; cols (8, n); out (n,) int32
extern "C" int plucker_mt(const float* prims, const float* cols, int n, int* out, void* stream) {
  return launch(0, prims, cols, n, out, stream);
}

// plk (16, 5 * 256) table of build_plk; bf16: DEFAULT precision, else HIGHEST
extern "C" int plucker_plk(const float* plk, const float* cols, int n, int bf16, int* out,
                           void* stream) {
  return launch(bf16 ? 2 : 1, plk, cols, n, out, stream);
}

// The form of kernel 0 (mt_kernel), 1 (highest_kernel) or 2 (default_kernel):
// out = [resident blocks a SM, threads a block, dynamic shared memory a block,
// SMs, rays a thread (0, 1) or prims a wgmma product (2)]
extern "C" int plucker_form(int kernel, int* out) {
  if (kernel < 0 || kernel > 2) return cudaErrorInvalidValue;
  const Form f = form_of(kernel);
  int blocks = 0, sms = 0;
  const cudaError_t err = residency(kernel, &blocks, &sms);
  out[0] = blocks;
  out[1] = f.threads;
  out[2] = static_cast<int>(f.smem);
  out[3] = sms;
  out[4] = kernel == 0 ? kMtRays : kernel == 1 ? kHighRays : kPlkN;
  return static_cast<int>(err);
}
