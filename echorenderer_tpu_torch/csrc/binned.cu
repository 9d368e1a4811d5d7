// Binned traversal for large scenes: the three kernels of its rounds, for Hopper.
//
// Replace the Pallas TPU kernels of echorenderer_tpu/ops/binned_trace.py,
// which the JAX package's `trace_binned` / `occlude_binned` reach through
// `_trace_binned_impl`:
//   setup_kernel  <- `_setup_kernel`  (line 552, via `_setup_rank`)
//   select_kernel <- `_select_kernel` (line 402, via `_run_select`)
//   seg_kernel    <- `_seg_kernel`    (line 117, via `_run_rows`; keyed and exact, both forms)
// Each computes what its plain PyTorch version in ops/binned_trace.py computes
// (`setup_rank_plain`, `select_plain`, `seg_keys_plain`, `seg_hits_plain`), bit
// for bit.
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
// The exact form (KEYED = false, `_seg_kernel(keyed=False)`) runs the same
// pairs and writes 4 floats a pair instead of a key: the least t below t_max,
// ties to the least sorted slot (the strict < over the prims in slot order),
// that slot as a float (-1 where nothing is found), and its u and v; a pair
// without a hit keeps (t_max, -1, 0, 0). Same bound, same design.
// Instanced form (TLAS scenes): the pairs carry global chunks; the kernel
// maps each to its pack chunk (g2c) and instance (g2i), moves the pair's
// world ray into the instance's space with the instance's 12 floats (A
// row-major, then b; each row summed left to right and then + b, as
// `pallas_hier.to_instance`), so t stays the world parameter and spheres
// take the full quadratic, and skips the ray's ignored prim only where the
// record's ign_inst (column 8 of a 9-float record) names this instance. A
// warp's pairs mostly share one chunk and so one instance: the 12 floats are
// broadcast loads through the read-only cache.
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

// KEYED: out is int (M,), the packed key of each pair; else float (4, M):
// rows t, prim (sorted slot as a float), u, v
template <bool HAS_TRI, bool HAS_SPH, bool INSTANCED, bool KEYED>
__global__ void seg_kernel(const float* __restrict__ rec, const int* __restrict__ chunk_of, int m,
                           const float* __restrict__ chunks, const int* __restrict__ g2c,
                           const int* __restrict__ g2i, const float* __restrict__ inst_f32,
                           int n_chunks, void* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= m) return;
  echo::Ray r;
  float ign_inst = -1.0f;
  if (INSTANCED) {  // 9-float records
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
  int c = chunk_of[q];
  int best = kIntInf;                        // keyed
  float bt = r.tmax, bu = 0.0f, bv = 0.0f;   // exact
  int bslot = -1;
  if (r.tmax > 0.0f && c >= 0 && c < n_chunks) {  // dead pairs read nothing
    if (INSTANCED) {  // global chunk -> (pack chunk, instance); the ray into its space
      const int inst = __ldg(g2i + c);
      c = __ldg(g2c + c);
      const float* a = inst_f32 + 12 * (size_t)inst;
      const float a0 = __ldg(a + 0), a1 = __ldg(a + 1), a2 = __ldg(a + 2);
      const float a3 = __ldg(a + 3), a4 = __ldg(a + 4), a5 = __ldg(a + 5);
      const float a6 = __ldg(a + 6), a7 = __ldg(a + 7), a8 = __ldg(a + 8);
      const float ox = r.ox, oy = r.oy, oz = r.oz, dx = r.dx, dy = r.dy, dz = r.dz;
      r.ox = a0 * ox + a1 * oy + a2 * oz + __ldg(a + 9);
      r.oy = a3 * ox + a4 * oy + a5 * oz + __ldg(a + 10);
      r.oz = a6 * ox + a7 * oy + a8 * oz + __ldg(a + 11);
      r.dx = a0 * dx + a1 * dy + a2 * dz;
      r.dy = a3 * dx + a4 * dy + a5 * dz;
      r.dz = a6 * dx + a7 * dy + a8 * dz;
      if (ign_inst != static_cast<float>(inst)) r.ignore = -1;
    }
    const float* rows = chunks + (size_t)c * kRows * kChunk;
    const int base = c * kChunk;
    for (int j = 0; j < kChunk; ++j) {
      float t, u, v;
      if (!echo::prim_hit<HAS_TRI, HAS_SPH, !INSTANCED>(rows, kChunk, j, base + j, r, t, u, v))
        continue;
      if (KEYED) {
        if (t < r.tmax && t < kFarT) best = min(best, (__float_as_int(t) & -(1 << kPBits)) | j);
      } else if (t < bt && t < kFarT) {  // strict: an equal t keeps the lower slot
        bt = t;
        bslot = base + j;
        bu = u;
        bv = v;
      }
    }
  }
  if (KEYED) {
    static_cast<int*>(out)[q] = best;
  } else {
    float* o = static_cast<float*>(out);
    o[q] = bt;
    o[(size_t)m + q] = bslot >= 0 ? static_cast<float>(bslot) : -1.0f;
    o[2 * (size_t)m + q] = bu;
    o[3 * (size_t)m + q] = bv;
  }
}

// dynamic shared memory above the 48 KB default needs an opt-in per kernel
template <typename K>
int smem_opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <bool KEYED>
int launch_seg(const float* rec, const int* chunk, int m, const float* chunks, int n_chunks,
               int has_tri, int has_sph, int block, const int* g2c, const int* g2i,
               const float* inst_f32, void* out, void* stream) {
  const dim3 grid((m + block - 1) / block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ECHO_SEG_LAUNCH(TRI, SPH, INST)                                                    \
  seg_kernel<TRI, SPH, INST, KEYED><<<grid, block, 0, s>>>(rec, chunk, m, chunks, g2c, g2i, \
                                                           inst_f32, n_chunks, out)
  if (g2c != nullptr) {
    if (has_tri && has_sph)
      ECHO_SEG_LAUNCH(true, true, true);
    else if (has_tri)
      ECHO_SEG_LAUNCH(true, false, true);
    else
      ECHO_SEG_LAUNCH(false, true, true);
  } else if (has_tri && has_sph) {
    ECHO_SEG_LAUNCH(true, true, false);
  } else if (has_tri) {
    ECHO_SEG_LAUNCH(true, false, false);
  } else {
    ECHO_SEG_LAUNCH(false, true, false);
  }
#undef ECHO_SEG_LAUNCH
  return static_cast<int>(cudaGetLastError());
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

// g2c, g2i and inst_f32 are null for a non-instanced scene; n_chunks is the
// count of valid pair chunks (the scene's chunks, or the global chunks)
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
