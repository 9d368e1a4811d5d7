// The Plücker micro-benchmark's two keyed intersection kernels for Hopper.
//
// Replace the Pallas TPU kernels of benchmarks/plucker_micro.py, both reached
// through its `run` (line 152):
//   mt_kernel  <- `kern_mt` (line 79)
//   plk_kernel <- `kern` of `make_kern_plk` (line 142; body `_plk_keyed`, line 99),
//                 HIGHEST (BF16 = false) and DEFAULT (BF16 = true)
// Each computes what its plain PyTorch version in
// echorenderer_tpu_torch/benchmarks/plucker_micro.py computes (`keys_mt_plain`,
// `keys_plk_plain`), bit for bit.
//
// What they compute: per ray of 8 columns (ox oy oz dx dy dz t_max ignore, n
// floats each), the least packed key (bits(t) & ~0xFF) | prim over one
// resident chunk of 256 triangles, over the prims hit with t < t_max; _INT_INF
// where none is.
// - mt_kernel: the Moller-Trumbore test of every other kernel
//   (`echo::prim_hit`, triangles only) on the (10, 256) prim rows.
// - plk_kernel: the Plücker form on the (16, 5*256) table of `build_plk`: the
//   three edge volumes w = [d, m, o_pad] . column (8-term sums over rows 0..7 of
//   the column groups 0..2, m = o x d), the plane's n.d (3 terms, rows 0..2 of
//   group 3) and nv0 - n.o (4 terms, rows 6..9 of group 4 against [o, 1]), each
//   summed left to right from its first product; inside when all three w are
//   >= 0 or all <= 0; t = num / den; a hit needs t > RAY_EPSILON, t < t_max and
//   prim != ignore. On the TPU the sums are two shared-K products on the matrix
//   unit; DEFAULT precision is one bf16 pass of it (operands rounded to bf16,
//   products summed in f32), which the BF16 form reproduces: the table and the
//   per-ray operands are rounded to nearest even before the products.
//
// What bounds them on the H100: the float work of the tests (256 a ray;
// about 45 flops each), not the 36 bytes a ray moves. Design: one thread per
// ray, 128 a block; the table is staged once per block in shared memory (the
// TPU keeps it in VMEM): the MT rows 10 KiB, the Plücker rows the products
// read (group rows 0..7 of groups 0..2, 0..2 of group 3, 6..9 of group 4) 31
// KiB. Every thread of a warp reads the same prim at once, a broadcast. No
// tensor cores: the sums' fixed order is what makes the kernel bitwise equal
// to its plain version (a wgmma form is later speed work).
//
// Built with -fmad=false, so every float op rounds as in the plain versions.
// C interface (loaded with ctypes); each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "intersect.cuh"

namespace {

constexpr int kH = 256;  // triangles in the resident chunk
constexpr int kBlock = 128;
constexpr int kIntInf = 0x7FFFFFFF;
constexpr float kFarT = 3.4e38f;  // _INF
constexpr int kKeyMask = -(1 << 8);  // clears the prim bits of t

__global__ void __launch_bounds__(kBlock)
mt_kernel(const float* __restrict__ prims, const float* __restrict__ cols, int n,
          int* __restrict__ out) {
  __shared__ float rows[10 * kH];
  for (int i = threadIdx.x; i < 10 * kH; i += kBlock) rows[i] = prims[i];
  __syncthreads();
  const int q = blockIdx.x * kBlock + threadIdx.x;
  if (q >= n) return;
  const size_t sn = n;
  echo::Ray r;
  r.ox = cols[q];
  r.oy = cols[sn + q];
  r.oz = cols[2 * sn + q];
  r.dx = cols[3 * sn + q];
  r.dy = cols[4 * sn + q];
  r.dz = cols[5 * sn + q];
  r.tmax = cols[6 * sn + q];
  r.ignore = static_cast<int>(cols[7 * sn + q]);
  int best = kIntInf;
  for (int j = 0; j < kH; ++j) {
    float t, u, v;
    if (echo::prim_hit<true, false, true>(rows, kH, j, j, r, t, u, v) && t < r.tmax && t < kFarT)
      best = min(best, (__float_as_int(t) & kKeyMask) | j);
  }
  out[q] = best;
}

template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <bool BF16>
__global__ void __launch_bounds__(kBlock)
plk_kernel(const float* __restrict__ plk, const float* __restrict__ cols, int n,
           int* __restrict__ out) {
  constexpr int kW = 5 * kH;  // the table's row length
  __shared__ float edge[8 * 3 * kH];  // rows 0..7 of groups 0..2: [k][e * kH + p]
  __shared__ float den_rows[3 * kH];  // rows 0..2 of group 3
  __shared__ float num_rows[4 * kH];  // rows 6..9 of group 4
  for (int i = threadIdx.x; i < 8 * 3 * kH; i += kBlock)
    edge[i] = operand<BF16>(plk[(i / (3 * kH)) * kW + i % (3 * kH)]);
  for (int i = threadIdx.x; i < 3 * kH; i += kBlock)
    den_rows[i] = operand<BF16>(plk[(i / kH) * kW + 3 * kH + i % kH]);
  for (int i = threadIdx.x; i < 4 * kH; i += kBlock)
    num_rows[i] = operand<BF16>(plk[(6 + i / kH) * kW + 4 * kH + i % kH]);
  __syncthreads();
  const int q = blockIdx.x * kBlock + threadIdx.x;
  if (q >= n) return;
  const size_t sn = n;
  const float ox = cols[q], oy = cols[sn + q], oz = cols[2 * sn + q];
  const float dx = cols[3 * sn + q], dy = cols[4 * sn + q], dz = cols[5 * sn + q];
  const float tmax = cols[6 * sn + q];
  const int ignore = static_cast<int>(cols[7 * sn + q]);
  // the per-ray operands: [d, m, 0, 0] for the edges, d for n.d, [o, 1] for n.o
  const float ra[8] = {operand<BF16>(dx), operand<BF16>(dy), operand<BF16>(dz),
                       operand<BF16>(oy * dz - oz * dy), operand<BF16>(oz * dx - ox * dz),
                       operand<BF16>(ox * dy - oy * dx), 0.0f, 0.0f};
  const float rc[4] = {operand<BF16>(ox), operand<BF16>(oy), operand<BF16>(oz), 1.0f};
  int best = kIntInf;
  for (int p = 0; p < kH; ++p) {
    float w[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const float* col = edge + e * kH + p;
      float s = col[0] * ra[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) s = s + col[k * 3 * kH] * ra[k];
      w[e] = s;
    }
    const float den = den_rows[p] * ra[0] + den_rows[kH + p] * ra[1] + den_rows[2 * kH + p] * ra[2];
    const float num = num_rows[p] * rc[0] + num_rows[kH + p] * rc[1] +
                      num_rows[2 * kH + p] * rc[2] + num_rows[3 * kH + p] * rc[3];
    const bool inside = echo::pmin(echo::pmin(w[0], w[1]), w[2]) >= 0.0f ||
                        echo::pmax(echo::pmax(w[0], w[1]), w[2]) <= 0.0f;
    const float t = num / den;
    if (inside && t > echo::kEps && t < tmax && p != ignore)
      best = min(best, (__float_as_int(t) & kKeyMask) | p);
  }
  out[q] = best;
}

}  // namespace

// prims (10, 256) rows; cols (8, n); out (n,) int32
extern "C" int plucker_mt(const float* prims, const float* cols, int n, int* out, void* stream) {
  mt_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      prims, cols, n, out);
  return static_cast<int>(cudaGetLastError());
}

// plk (16, 5 * 256) table of build_plk; bf16: DEFAULT precision, else HIGHEST
extern "C" int plucker_plk(const float* plk, const float* cols, int n, int bf16, int* out,
                           void* stream) {
  const dim3 grid((n + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    plk_kernel<true><<<grid, kBlock, 0, s>>>(plk, cols, n, out);
  else
    plk_kernel<false><<<grid, kBlock, 0, s>>>(plk, cols, n, out);
  return static_cast<int>(cudaGetLastError());
}
