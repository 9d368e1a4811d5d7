// Binned traversal for large scenes: the three kernels of its rounds, for Hopper.
//
// Replace the Pallas TPU kernels of echorenderer_tpu/ops/binned_trace.py,
// which the JAX package's `trace_binned` / `occlude_binned` reach through
// `_trace_binned_impl`:
//   setup_kernel  <- `_setup_kernel`  (line 552, via `_setup_rank`)
//   select_kernel <- `_select_kernel` (line 402, via `_run_select`)
//   seg_kernel    <- `_seg_kernel`    (line 117, via `_run_rows`; keyed, non-instanced)
// Each computes what its plain PyTorch version in ops/binned_trace.py computes
// (`setup_rank_plain`, `select_plain`, `seg_keys_plain`), bit for bit.
//
// setup_kernel: per ray, the slab test of every super box (`echo::slab`, the
// JAX kernel's op order, NaN-propagating min/max; strict `tn < limit`, no
// cull slack), each eligible super packed as (bits(tn > 0 ? tn : 0) with
// the low sbits cleared) | super id, and the s_out smallest keys written
// ascending, _INT_INF after. Keys are unique, so this equals a sort of all
// of them. Bound on the H100 by the slab tests (rays x supers); design: one
// thread per ray, the super table read through the read-only cache (every
// thread reads the same super: a broadcast), the ray's s_out nearest keys
// kept sorted by insertion in its own column of shared memory
// ([slot][thread], no bank conflicts), so a ray that enters few supers does
// little sorting; no bitonic network over the padded super count.
//
// select_kernel: per ray, all integer: purge the candidate keys at or past
// the best t, then for a refilling ray take its k-1 smallest (remove-by-
// equality passes, as the TPU kernel) ahead of the new keys, then pop the k
// smallest and count what is left. Bound by the bytes of the (w, N)
// buffer; design: one thread per ray, its w slots loaded once into its
// shared-memory column, every pass run there, the buffer written back in
// place. A ray that does not refill skips the extract passes: on the TPU
// their removals are gated off and their results unused.
//
// seg_kernel: per (ray, chunk) pair of the chunk-sorted pair list, the least
// packed key (bits(t) & ~0xFF) | prim-in-chunk over the chunk's prims hit
// with t < t_max (`echo::prim_hit`, the test of every other kernel), else
// _INT_INF. Bound by the prim tests (256 a pair); design: one thread per
// pair, ROW pairs a block; the pairs are sorted by chunk, so a warp mostly
// reads one chunk's rows and each load is a broadcast through L1. The TPU's
// segment table and double-buffered DMA are its row machinery and have no
// counterpart; staging a chunk in shared memory is left for later work.
//
// Built with -fmad=false, so every float op rounds as in the plain version.
// C interface (loaded with ctypes); each function returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "intersect.cuh"

namespace {

constexpr int kIntInf = 0x7FFFFFFF;
constexpr float kFarT = 3.4e38f;  // _INF
constexpr int kChunk = 256;       // prims per chunk (HCHUNK)
constexpr int kRows = 16;         // float rows per chunk record
constexpr int kPBits = 8;         // prim-in-chunk bits of a pair key
constexpr int kBlock = 64;        // rays per block of setup and select

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
    float tn, tf;
    echo::slab(__ldg(b), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3), __ldg(b + 4), __ldg(b + 5),
               ox, oy, oz, ix, iy, iz, tn, tf);
    if (!((tn <= tf) && (tf > 0.0f) && (tn < limit))) continue;
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

template <bool HAS_TRI, bool HAS_SPH>
__global__ void seg_kernel(const float* __restrict__ rec, const int* __restrict__ chunk_of, int m,
                           const float* __restrict__ chunks, int n_chunks,
                           int* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= m) return;
  const float4 a = reinterpret_cast<const float4*>(rec)[2 * (size_t)q];
  const float4 b = reinterpret_cast<const float4*>(rec)[2 * (size_t)q + 1];
  echo::Ray r;
  r.ox = a.x;
  r.oy = a.y;
  r.oz = a.z;
  r.dx = a.w;
  r.dy = b.x;
  r.dz = b.y;
  r.tmax = b.z;
  r.ignore = static_cast<int>(b.w);
  const int c = chunk_of[q];
  int best = kIntInf;
  if (r.tmax > 0.0f && c >= 0 && c < n_chunks) {  // dead pairs read nothing
    const float* rows = chunks + (size_t)c * kRows * kChunk;
    const int base = c * kChunk;
    for (int j = 0; j < kChunk; ++j) {
      float t, u, v;
      if (!echo::prim_hit<HAS_TRI, HAS_SPH>(rows, kChunk, j, base + j, r, t, u, v)) continue;
      if (t < r.tmax && t < kFarT) best = min(best, (__float_as_int(t) & -(1 << kPBits)) | j);
    }
  }
  out[q] = best;
}

// dynamic shared memory above the 48 KB default needs an opt-in per kernel
template <typename K>
int smem_opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

extern "C" int binned_setup(const float* rays, int n, const float* sup, int s_count, int sbits,
                            int s_out, int* out, void* stream) {
  const size_t bytes = (size_t)s_out * kBlock * sizeof(int);
  if (int err = smem_opt_in(setup_kernel, bytes)) return err;
  setup_kernel<<<(n + kBlock - 1) / kBlock, kBlock, bytes, static_cast<cudaStream_t>(stream)>>>(
      rays, n, sup, s_count, sbits, s_out, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int binned_select(int* cand, int w, int n, const int* nk, const float* best_t,
                             const uint8_t* refill, int k, int cbits, int* pop, int* live,
                             int* mink, void* stream) {
  const size_t bytes = (size_t)(w + k - 1) * kBlock * sizeof(int);
  if (int err = smem_opt_in(select_kernel, bytes)) return err;
  select_kernel<<<(n + kBlock - 1) / kBlock, kBlock, bytes, static_cast<cudaStream_t>(stream)>>>(
      cand, w, n, nk, best_t, refill, k, cbits, pop, live, mink);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int binned_seg(const float* rec, const int* chunk, int m, const float* chunks,
                          int n_chunks, int has_tri, int has_sph, int block, int* out,
                          void* stream) {
  const dim3 grid((m + block - 1) / block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (has_tri && has_sph)
    seg_kernel<true, true><<<grid, block, 0, s>>>(rec, chunk, m, chunks, n_chunks, out);
  else if (has_tri)
    seg_kernel<true, false><<<grid, block, 0, s>>>(rec, chunk, m, chunks, n_chunks, out);
  else
    seg_kernel<false, true><<<grid, block, 0, s>>>(rec, chunk, m, chunks, n_chunks, out);
  return static_cast<int>(cudaGetLastError());
}
