// The fused path-tracing megakernel for Hopper.
//
// Replaces the Pallas TPU kernel `_mega_kernel` of
// echorenderer_tpu/ops/megakernel.py (line 1101), which the JAX package
// reaches through `sample_frame_mega`. It computes what the wavefront of
// evaluation/wavefront.py computes with `integrators.path_step`, for scenes
// of at most 2048 padded prims: for every pixel, `count` path samples
// (camera spawn with thin lens, closest hit, surface interaction, emission
// with MIS, constant ambient on a miss, BSDF sample, a flat power-CDF or
// light-tree light pick, NEE with a shadow ray and MIS, Russian roulette)
// summed into (sum, sum of squares). Textured scenes (at most 4 atlas
// textures) take the kernel's textured form, `mega_kernel<true>`: the TPU
// kernel's texture stage (megakernel.py:1295-1353), which gives each hit a
// uv (barycentric for a triangle, equirectangular for a sphere) and
// overrides the albedo, perturbs the shading normal (normal map) and
// overrides the roughness from repeat-wrapped bilinear samples of the
// atlas, in scene_ops._sample_atlas's arithmetic. The untextured form
// compiles none of it and keeps its registers.
//
// Large scenes take the kernel's chunk-tree form, `mega_kernel<false,
// true>`: the TPU kernel's fat-chunk variant (`_hier_walk`,
// megakernel.py:909, run when `hier=True`). Every traced and shadow ray
// walks the scene's chunk tree (`echo::hier_walk` of hier_walk.cuh, the one
// walk the chunk-tree kernels of hier_walk.cu run too) over the (C, 16, 256)
// chunk tensor in device memory, instead of testing every prim staged in
// shared memory; hits, ignores, shading rows and emitters' prim ids are
// sorted slots of the chunk tree. The TPU kernel carried the shading rows
// inside each chunk ("fat chunks", (C, 40, 256)) so that its hit merge could
// capture them without an O(P) one-hot gather; here the winning slot's rows
// are one indexed load from the per-slot shading table, the same values. The
// JAX package leaves textures out of that variant, and so does this form.
// Its walk is warp-cooperative (hier_walk.cuh: traversal per lane, chunk
// leaves postponed and tested by the whole warp from a shared-memory stage
// that a bulk asynchronous copy fills), so this form calls it at
// warp-uniform points: every lane of a warp stays in its loop until the
// warp's paths are all done (a finished lane traces rays with t_max = 0),
// and every lane walks its NEE shadow ray after the interaction, not inside
// the candidate branch (t_max = 0 where it has none). What bounds it then:
// the lanes of a warp that end their paths at different bounces idle in
// the loop, the walk's stack in local memory, and 128 registers a thread,
// which hold the resident warps to 16 a SM (4 blocks; the warps' stages,
// 40 KiB a block, would allow 5).
//
// What bounds it on the H100. Every traced and shadow ray tests every prim
// of the scene (the chunk-tree form: the prims of every chunk the walk
// enters; about 45 flops a triangle, 21 a sphere), and every bounce runs the
// shading (BSDF, light sample, RNG hashes), whose chains of dependent table
// loads and per-material branches cost more than its flops; the only
// device-memory traffic is the pixel identities in and the sums out, plus
// table rows that stay in L1/L2. A stage breakdown of the one-thread-a-pixel
// loop (tools/hier_ab.py --mega-stages, PERF.md §5) put the bench launch's
// warp cycles at 33% trace, 35% interaction, 13% NEE, 11% banking and
// regeneration, with 16 resident warps/SM at 116 registers. Design of the
// untextured and textured forms, against that:
//   - a block-resident path pool (run_pool below): a block keeps one path a
//     thread in shared memory and runs each bounce as stages over queues,
//     the hits sorted by material type so that a warp shades one material,
//     the shadow rays compacted into their own queue; each stage keeps only
//     its own values in registers (93 registers, 20 resident warps/SM,
//     against 116-117 and 16 for the loop);
//   - persistent blocks (as many as the card holds) take lanes, or in the
//     split form (a launch with fewer pixels than the card holds paths)
//     (pixel, sample) units, from a work counter; a pixel's samples are
//     banked in sample order either way, so the sums are bitwise the
//     one-thread-a-lane loop's;
//   - the prims are staged once per block as 16-byte records (three
//     broadcast loads a prim instead of up to ten), leaving out the slots
//     that no ray can hit, and read by every thread of a warp at once; a
//     sphere test stops at a negative discriminant, so a warp whose lanes
//     all miss the sphere skips its square root and roots;
//   - the shading tables (prim rows, materials, lights, emitters, light
//     tree) stay in device memory behind the read-only cache: an indexed
//     load replaces the TPU's one-hot matrix lookup, and is just as exact;
//   - the sample streams run in native 32-bit words (the counter-hash RNG
//     of utils/rng.py, bit for bit);
//   - a texel is an indexed __ldg of the (A, R, R, 4) f32 atlas (bf16
//     values): four per bilinear sample. The TPU fetched them through
//     one-hot matrix products over the whole texel table, and hardware
//     texture filtering would round its weights to 8 bits: neither is
//     needed or exact here;
//   - float ops run in the order of the plain PyTorch code (path_step,
//     bsdf.py, scene_ops.py, light_tree.py, utils/vec.py), built with
//     -fmad=false, IEEE division/sqrt and the libdevice sinf/cosf/rsqrtf
//     that PyTorch's CUDA kernels call: each op rounds as one PyTorch
//     launch of the plain version does, so the sums match it bit for bit.
// The chunk-tree form keeps the one-thread-a-lane loop (run_lane), its
// path state in registers. Its shading is run_lane's own copy of the pool's
// (shade_path): one shared function changed the chunk-tree form's register
// allocation (a 608-byte stack with 84 bytes of spills) and raised the
// textured form to 104 registers.
//
// C interface (loaded with ctypes): `megakernel(ptrs, ints, survivability,
// stream)`, with the table pointers and integer settings in the order of
// `Params` below (ptrs[14]: the pool's work counter; ptrs[15]: the split
// form's per-sample buffer or null), and `megakernel_hier(ptrs, ints,
// hier_ptrs, root_code, survivability, stream)` for the chunk-tree form
// (hier_ptrs: chunks, node bounds, node codes); each returns the CUDA error
// of its launch. `megakernel_occupancy` and `megakernel_hier_occupancy`
// report the forms' resident blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hier_walk.cuh"
#include "mega_stages.cuh"

namespace {

using echo::Ray;

constexpr int kBlock = 128;
constexpr float kInf = 3.4e38f;
constexpr double kPiD = 3.141592653589793;  // math.pi
constexpr float kPi = (float)kPiD;
constexpr float kTwoPi = (float)(2.0 * kPiD);
constexpr float kInvPi = (float)(1.0 / kPiD);
constexpr float kInvTau = (float)(0.5 / kPiD);
constexpr float kInv4Pi = (float)(1.0 / (4.0 * kPiD));
constexpr float kPiOver4 = (float)(kPiD / 4.0);
constexpr float kPiOver2 = (float)(kPiD / 2.0);
constexpr float kOrenNayarK = (float)(kPiD / 2.0 - 2.0 / 3.0);
constexpr float kBelowOne = (float)(1.0 - 1e-7);
constexpr float kShadowScale = (float)(1.0 - 1e-3);
constexpr float kAlphaThreshold = 1e-4f;
constexpr float kThird = (float)(1.0 / 3.0);

// material types (scene/materials.py) and light kinds (scene/prepare.py)
constexpr int INVISIBLE = 0, DIFFUSE = 1, DIELECTRIC = 2, CONDUCTOR = 3, EMISSIVE = 4,
              COATED_DIFFUSE = 5;
constexpr int LIGHT_POINT = 0, LIGHT_DIRECTIONAL = 1, LIGHT_AMBIENT = 2, LIGHT_EMISSIVE = 3;
// sample-stream dimensions (evaluation/integrators.py)
constexpr uint32_t CAMERA_DIMS = 2, BOUNCE_DIM_STRIDE = 8;
constexpr uint32_t DIM_BSDF = 0, DIM_LOBE = 1, DIM_LIGHT_PICK = 2, DIM_LIGHT_SAMPLE = 3,
                   DIM_RR = 4;
// table row widths (ops/megakernel.py): shade rows, material rows, light
// records, emitters, light-tree nodes, tree lights; a textured scene's shade
// rows add uv0 uv1 uv2 (17:23), its material rows the texture ids (12:16)
constexpr int SP = 17, MT = 12, LT = 13, EP = 18, TR = 24, TL = 3;
constexpr int SP_TEX = SP + 6, MT_TEX = MT + 4;
// camera/scalar row
constexpr int C_POS = 0, C_ROT = 3, C_FL = 12, C_LENS = 13, C_FOCAL = 14, C_AMB_ALL = 16,
              C_AMB_CAM = 19, C_AMB_PMF = 22, C_TOTAL_POWER = 23, C_P_INF = 24,
              C_SUM_INF = 25;

struct Params {
  const float* prims;  // (10, padded) sorted prim rows
  const float* sp;     // (padded, SP or SP_TEX)
  const float* mat;    // (m_pad, MT or MT_TEX)
  const float* light;  // (l_pad, LT)
  const float* epack;  // (e_pad, EP)
  const float* tree;   // (t_pad, TR) or null
  const float* tl;     // (f_pad, TL) or null
  const float* cam;    // (26,)
  const int* pid;      // (n,) pixel ids (32-bit words)
  const int* pxy;      // (n, 2) pixel coordinates
  const int* s0;       // (n,) first sample index (32-bit words)
  float* s_sum;        // (n, 3)
  float* s_sq;         // (n, 3)
  const float* atlas;  // (n_tex, tex_res, tex_res, 4) or null
  int n, n_lanes, k_slots, count, bounce_limit, width, height;
  uint32_t seed;
  int padded, has_tri, has_sph, present, n_lights, n_emissive, tree_depth;
  int n_tex, tex_res, has_ntex, has_rtex;
  float survivability;
  echo::HierTables hier;  // the chunk tree (the chunk-tree form only)
  int* work;              // the pool's work counter (one int, zeroed by the launch)
  float* samples;         // (n, count, 3) per-sample radiance: the split form, or null
};

// ---------------------------------------------------------------------------
// float helpers with PyTorch's NaN rules (clamp and maximum propagate NaN)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float lo_clamp(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float hi_clamp(float x, float hi) { return x > hi ? hi : x; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return hi_clamp(lo_clamp(x, lo), hi);
}
__device__ __forceinline__ float pmax(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ float pmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 mk(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 load3(const float* p) { return mk(ldg(p), ldg(p + 1), ldg(p + 2)); }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator-(V3 a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return mk(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return mk(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return mk(a.x / s, a.y / s, a.z / s); }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 negz(V3 w) { return mk(w.x, w.y, -w.z); }

// vec.normalize: zero vectors map to zero
__device__ __forceinline__ V3 normalize(V3 a) {
  float sq = dot(a, a);
  float inv = sq > 0.0f ? rsqrtf(lo_clamp(sq, 1e-38f)) : 0.0f;
  return a * inv;
}
// bsdf._sq_norm division
__device__ __forceinline__ V3 unit20(V3 a) { return a / sqrtf(lo_clamp(dot(a, a), 1e-20f)); }
// a / clamp(sqrt(sum(a*a)), min=1e-20)
__device__ __forceinline__ V3 unit_len20(V3 a) { return a / lo_clamp(sqrtf(dot(a, a)), 1e-20f); }

__device__ __forceinline__ float power_heuristic(float pdf0, float pdf1) {
  float sq = pdf0 * pdf0;
  return sq / lo_clamp(sq + pdf1 * pdf1, 1e-20f);
}

__device__ __forceinline__ V3 offset_origin(V3 point, V3 geo_n, V3 dir) {
  float side = signf(dot(geo_n, dir));
  return point + (geo_n * side) * 1e-4f;
}

// vec.orthonormal_frame (Duff et al. 2017) around a unit normal
__device__ __forceinline__ void frame(V3 n, V3& tangent, V3& bitangent) {
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float fa = -1.0f / (sign + n.z);
  const float fb = n.x * n.y * fa;
  tangent = mk(1.0f + sign * (n.x * n.x) * fa, sign * fb, -sign * n.x);
  bitangent = mk(fb, sign + (n.y * n.y) * fa, -n.y);
}

// ---------------------------------------------------------------------------
// the texture stage (scene_ops.interact's, ops/intersect.sphere_uv's)
// ---------------------------------------------------------------------------

// ops/intersect.poly_atan2: octant reduction and an odd minimax polynomial
// in Horner form; constants are the Python doubles rounded to float, as a
// tensor op rounds its Python scalar
__device__ __forceinline__ float poly_atan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = pmax(ax, ay);
  const float t = pmin(ax, ay) / lo_clamp(hi, (float)1e-30);
  const float z = t * t;
  float acc = z * (float)-0.01172120;
  acc = z * (acc + (float)0.05265332);
  acc = z * (acc + (float)-0.11643287);
  acc = z * (acc + (float)0.19354346);
  acc = z * (acc + (float)-0.33262347);
  float r = t * (acc + (float)0.99997726);
  if (ay > ax) r = kPiOver2 - r;
  if (x < 0.0f) r = kPi - r;
  return y < 0.0f ? -r : r;
}

// ops/intersect.sphere_uv of a hit at `point` on the sphere (center, radius)
__device__ __forceinline__ void sphere_uv(V3 point, V3 center, float radius, float& u,
                                          float& v) {
  const V3 lp = (point - center) / lo_clamp(radius, (float)1e-20);
  const float z = clampf(lp.y, -1.0f, 1.0f);
  const float theta = poly_atan2(sqrtf(lo_clamp(1.0f - z * z, 0.0f)), z);
  const float phi = poly_atan2(lp.x, lp.z);
  u = phi * kInvTau + 0.5f;
  v = 1.0f - theta * kInvPi;
}

// torch.remainder(a, 1.0): fmod, then + 1 where the result is negative
__device__ __forceinline__ float rem1(float a) {
  float m = fmodf(a, 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

// floor-mod into [0, r): C's % keeps the sign of a negative index
__device__ __forceinline__ int wrap(int i, int r) { return ((i % r) + r) % r; }

// scene_ops._sample_atlas: repeat-wrapped bilinear RGB of texture `tid`
__device__ V3 tex_sample(const Params& p, int tid, float su, float sv) {
  const int r = p.tex_res;
  tid = tid < 0 ? 0 : (tid > p.n_tex - 1 ? p.n_tex - 1 : tid);
  const float u = rem1(su) * (float)r - 0.5f;
  const float v = rem1(sv) * (float)r - 0.5f;
  const int u0 = (int)floorf(u), v0 = (int)floorf(v);
  const float fu = u - (float)u0, fv = v - (float)v0;
  const int u0w = wrap(u0, r), u1w = wrap(u0 + 1, r);
  const int v0w = wrap(v0, r), v1w = wrap(v0 + 1, r);
  const float* slice = p.atlas + (size_t)tid * r * r * 4;
  const float* t00 = slice + ((size_t)v0w * r + u0w) * 4;
  const float* t01 = slice + ((size_t)v0w * r + u1w) * 4;
  const float* t10 = slice + ((size_t)v1w * r + u0w) * 4;
  const float* t11 = slice + ((size_t)v1w * r + u1w) * 4;
  const float gu = 1.0f - fu, gv = 1.0f - fv;
  float out[3];
  for (int c = 0; c < 3; ++c) {
    const float top = ldg(t00 + c) * gu + ldg(t01 + c) * fu;
    const float bot = ldg(t10 + c) * gu + ldg(t11 + c) * fu;
    out[c] = top * gv + bot * fv;
  }
  return mk(out[0], out[1], out[2]);
}

// ---------------------------------------------------------------------------
// sample streams (utils/rng.py in native 32-bit words)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t owen(uint32_t bits, uint32_t key) {
  uint32_t x = __brev(bits);
  x ^= x * 0x3D20ADEAu;
  x += key;
  x *= (key >> 16) | 1u;
  x ^= x * 0x05526C56u;
  x ^= x * 0x53A22864u;
  return __brev(x);
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(int)(bits >> 8) * (1.0f / 16777216.0f);
}

// hash_u32(seed, pixel, dim * 4) = mix(dim * 4 + base * C) where base is
// the pixel's hash prefix mix(pixel + mix(seed + C0) * C)
__device__ __forceinline__ uint32_t pixel_base(uint32_t seed, uint32_t pid) {
  uint32_t h = mix32(seed + 0xC10EDA53u);  // 0x9E3779B9 * 0x85EBCA6B
  return mix32(pid + h * 0x85EBCA6Bu);
}

__device__ __forceinline__ float next_1d(uint32_t base, uint32_t sample, uint32_t dim) {
  uint32_t ks = mix32(dim * 4u + base * 0x85EBCA6Bu);
  uint32_t kv = mix32(ks ^ 0xA511E9B3u);
  uint32_t idx = owen(sample, ks);
  return to_unit(owen(idx * 0x9E3779B9u, kv));
}

__device__ __forceinline__ void next_2d(uint32_t base, uint32_t sample, uint32_t dim, float& ux,
                                        float& uy) {
  uint32_t ks = mix32(dim * 4u + base * 0x85EBCA6Bu);
  uint32_t kx = mix32(ks ^ 0xA511E9B3u);
  uint32_t ky = mix32(ks ^ 0x63D83595u);
  uint32_t idx = owen(sample, ks);
  ux = to_unit(owen(idx * 0xC13FA9A9u, kx));
  uy = to_unit(owen(idx * 0x91E10DA6u, ky));
}

// --- sample mappings ---

__device__ __forceinline__ V3 uniform_sphere(float u0, float u1) {
  float z = 1.0f - 2.0f * u0;
  float r = sqrtf(lo_clamp(1.0f - z * z, 0.0f));
  float phi = kTwoPi * u1;
  return mk(r * cosf(phi), r * sinf(phi), z);
}

__device__ __forceinline__ void concentric_disk(float u0, float u1, float& x, float& y) {
  float ox = 2.0f * u0 - 1.0f;
  float oy = 2.0f * u1 - 1.0f;
  bool r_big = fabsf(ox) > fabsf(oy);
  float r = r_big ? ox : oy;
  float ratio = r_big ? (ox != 0.0f ? oy / ox : 0.0f) : (oy != 0.0f ? ox / oy : 0.0f);
  float theta = r_big ? kPiOver4 * ratio : kPiOver2 - kPiOver4 * ratio;
  bool zero = (ox == 0.0f) && (oy == 0.0f);
  x = zero ? 0.0f : r * cosf(theta);
  y = zero ? 0.0f : r * sinf(theta);
}

__device__ __forceinline__ V3 cosine_hemisphere(float u0, float u1) {
  float dx, dy;
  concentric_disk(u0, u1, dx, dy);
  return mk(dx, dy, sqrtf(lo_clamp(1.0f - dx * dx - dy * dy, 0.0f)));
}

// ---------------------------------------------------------------------------
// BSDFs (evaluation/bsdf.py, local frame, z up)
// ---------------------------------------------------------------------------

struct Mat {
  V3 albedo, extra;
  float p0, p1;  // params[0] (roughness), params[1]
  int type;
};

struct BsdfSample {
  V3 wi, value;
  float pdf;
  bool spec;
};

__device__ __forceinline__ float roughness_to_alpha(float roughness) {
  float r = clampf(roughness * 0.75f, 0.0f, 1.0f);
  return lo_clamp(r * r, kAlphaThreshold);
}

__device__ __forceinline__ bool same_hemi(V3 a, V3 b) { return a.z * b.z > 0.0f; }

// fresnel_dielectric -> (f, tir)
__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta_i, float eta_t,
                                                    bool* tir_out = nullptr) {
  float ci = clampf(fabsf(cos_i), 0.0f, 1.0f);
  float ratio = eta_i / eta_t;
  float sin2_t = ratio * ratio * lo_clamp(1.0f - ci * ci, 0.0f);
  bool tir = sin2_t >= 1.0f;
  float cos_t = sqrtf(lo_clamp(1.0f - sin2_t, 0.0f));
  float r_par = (eta_t * ci - eta_i * cos_t) / lo_clamp(eta_t * ci + eta_i * cos_t, 1e-20f);
  float r_per = (eta_i * ci - eta_t * cos_t) / lo_clamp(eta_i * ci + eta_t * cos_t, 1e-20f);
  float f = 0.5f * (r_par * r_par + r_per * r_per);
  if (tir_out) *tir_out = tir;
  return tir ? 1.0f : f;
}

__device__ __forceinline__ float fresnel_conductor_chan(float c, float c2, float s2, float eta,
                                                        float k) {
  float e2 = eta * eta;
  float k2 = k * k;
  float t0 = e2 - k2 - s2;
  float a2b2 = sqrtf(lo_clamp(t0 * t0 + 4.0f * e2 * k2, 0.0f));
  float t1 = a2b2 + c2;
  float a = sqrtf(lo_clamp(0.5f * (a2b2 + t0), 0.0f));
  float t2 = 2.0f * a * c;
  float rs = (t1 - t2) / lo_clamp(t1 + t2, 1e-20f);
  float t3 = c2 * a2b2 + s2 * s2;
  float t4 = t2 * s2;
  float rp = rs * (t3 - t4) / lo_clamp(t3 + t4, 1e-20f);
  return 0.5f * (rs + rp);
}

__device__ __forceinline__ V3 fresnel_conductor(float cos_i, V3 eta, V3 k) {
  float c = clampf(fabsf(cos_i), 0.0f, 1.0f);
  float c2 = c * c;
  float s2 = 1.0f - c2;
  return mk(fresnel_conductor_chan(c, c2, s2, eta.x, k.x),
            fresnel_conductor_chan(c, c2, s2, eta.y, k.y),
            fresnel_conductor_chan(c, c2, s2, eta.z, k.z));
}

__device__ __forceinline__ void artistic_chan(float main, float edge, float& eta_out,
                                              float& k_out) {
  float r = clampf(main, 0.0f, (float)(1.0 - 1e-4));
  float sqrt_r = sqrtf(r);
  float eta = (1.0f + sqrt_r) / (1.0f - sqrt_r) * (1.0f - edge) + (1.0f - r) / (1.0f + r) * edge;
  float ep = eta + 1.0f, em = eta - 1.0f;
  float k2 = (r * (ep * ep) - em * em) / lo_clamp(1.0f - r, 1e-4f);
  eta_out = lo_clamp(eta, 1e-4f);
  k_out = sqrtf(lo_clamp(k2, 0.0f));
}

__device__ __forceinline__ float ggx_d(V3 m, float alpha) {
  float c2 = m.z * m.z;
  float t = c2 * (alpha * alpha - 1.0f) + 1.0f;
  return alpha * alpha / lo_clamp(kPi * t * t, 1e-20f);
}

__device__ __forceinline__ float ggx_lambda(V3 w, float alpha) {
  float c2 = w.z * w.z;
  float s2 = lo_clamp(1.0f - c2, 0.0f);
  float tan2 = s2 / lo_clamp(c2, 1e-12f);
  return 0.5f * (sqrtf(1.0f + alpha * alpha * tan2) - 1.0f);
}

__device__ __forceinline__ float ggx_g1(V3 w, float alpha) {
  return 1.0f / (1.0f + ggx_lambda(w, alpha));
}

__device__ __forceinline__ float ggx_g2(V3 wo, V3 wi, float alpha) {
  return 1.0f / (1.0f + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha));
}

__device__ __forceinline__ V3 ggx_sample_vndf(V3 wo, float alpha, float u0, float u1) {
  float sign = signf(wo.z == 0.0f ? 1.0f : wo.z);
  V3 v = wo * sign;
  V3 vh = unit_len20(mk(alpha * v.x, alpha * v.y, v.z));
  float lensq = vh.x * vh.x + vh.y * vh.y;
  float inv_len = rsqrtf(lo_clamp(lensq, 1e-20f));
  V3 t1 = lensq > 1e-12f ? mk(-vh.y * inv_len, vh.x * inv_len, 0.0f) : mk(1.0f, 0.0f, 0.0f);
  V3 t2 = cross(vh, t1);
  float r = sqrtf(u0);
  float phi = kTwoPi * u1;
  float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  float s = 0.5f * (1.0f + vh.z);
  p2 = (1.0f - s) * sqrtf(lo_clamp(1.0f - p1 * p1, 0.0f)) + s * p2;
  float p3 = sqrtf(lo_clamp(1.0f - p1 * p1 - p2 * p2, 0.0f));
  V3 nh = t1 * p1 + t2 * p2 + vh * p3;
  return unit_len20(mk(alpha * nh.x, alpha * nh.y, lo_clamp(nh.z, 1e-6f)));
}

__device__ __forceinline__ float ggx_pdf_reflect(V3 wo, V3 m, float alpha) {
  return ggx_g1(wo, alpha) * ggx_d(m, alpha) / lo_clamp(4.0f * fabsf(wo.z), 1e-8f);
}

// --- diffuse ---

__device__ __forceinline__ float oren_nayar(V3 wo, V3 wi, float roughness) {
  float a = 1.0f / (kOrenNayarK * roughness + kPi);
  float b = a * roughness;
  float cos_o = fabsf(wo.z);
  float cos_i = fabsf(wi.z);
  float s = dot(wo, wi) - cos_o * cos_i;
  s = s > 0.0f ? s / lo_clamp(pmax(cos_o, cos_i), 1e-8f) : s;
  return a + b * s;
}

__device__ __forceinline__ void diffuse_eval_pdf(const Mat& m, V3 wo, V3 wi, V3& value,
                                                 float& pdf) {
  bool transmissive = m.p1 > 0.5f;
  bool same = same_hemi(wo, wi);
  float lambert = m.p0 < 1e-6f ? kInvPi : oren_nayar(wo, wi, m.p0);
  float refl = same ? lambert : 0.0f;
  value = m.albedo * (transmissive ? kInvTau : refl);
  float refl_pdf = same ? fabsf(wi.z) * kInvPi : 0.0f;
  pdf = transmissive ? fabsf(wi.z) * kInvTau : refl_pdf;
}

__device__ __forceinline__ BsdfSample diffuse_sample(const Mat& m, V3 wo, float u0, float u1,
                                                     float u_lobe) {
  bool transmissive = m.p1 > 0.5f;
  V3 wi = cosine_hemisphere(u0, u1);
  V3 refl_wi = wo.z < 0.0f ? negz(wi) : wi;
  bool trans_flip = (u_lobe > 0.5f) != (wo.z > 0.0f);
  V3 trans_wi = trans_flip ? negz(wi) : wi;
  BsdfSample s;
  s.wi = transmissive ? trans_wi : refl_wi;
  diffuse_eval_pdf(m, wo, s.wi, s.value, s.pdf);
  s.spec = false;
  return s;
}

// --- dielectric ---

__device__ __forceinline__ void dielectric_setup(const Mat& m, V3 wo, float& eta_i, float& eta_t) {
  float ior = lo_clamp(m.p1, (float)(1.0 + 1e-4));
  bool entering = wo.z > 0.0f;
  eta_i = entering ? 1.0f : ior;
  eta_t = entering ? ior : 1.0f;
}

__device__ __forceinline__ V3 refract(V3 wo, V3 n, float eta_i, float eta_t, bool& ok) {
  float cos_i = dot(wo, n);
  float eta = eta_i / eta_t;
  float sin2_t = eta * eta * lo_clamp(1.0f - cos_i * cos_i, 0.0f);
  ok = sin2_t < 1.0f;
  float cos_t = sqrtf(lo_clamp(1.0f - sin2_t, 0.0f));
  V3 wi = (-wo) * eta + n * (eta * cos_i - cos_t);
  return unit20(wi);
}

__device__ __forceinline__ BsdfSample dielectric_smooth_sample(const Mat& m, V3 wo,
                                                               float u_lobe) {
  float eta_i, eta_t;
  dielectric_setup(m, wo, eta_i, eta_t);
  bool tir;
  float f = fresnel_dielectric(wo.z, eta_i, eta_t, &tir);
  bool reflect = (u_lobe < f) || tir;
  V3 wi_r = mk(-wo.x, -wo.y, wo.z);
  bool ok;
  V3 wi_t = refract(wo, mk(0.0f, 0.0f, wo.z > 0.0f ? 1.0f : -1.0f), eta_i, eta_t, ok);
  BsdfSample s;
  s.wi = reflect ? wi_r : wi_t;
  float ratio = eta_i / eta_t;
  float scale = reflect ? f : (1.0f - f) * (ratio * ratio);
  float pdf = reflect ? f : 1.0f - f;
  s.pdf = tir ? 1.0f : pdf;
  scale = tir ? 1.0f : scale;
  s.value = m.albedo * (scale / lo_clamp(fabsf(s.wi.z), 1e-8f));
  s.spec = true;
  return s;
}

__device__ void dielectric_rough_eval_pdf(const Mat& m, V3 wo, V3 wi, V3& value, float& pdf) {
  float alpha = roughness_to_alpha(m.p0);
  float eta_i, eta_t;
  dielectric_setup(m, wo, eta_i, eta_t);
  bool same = same_hemi(wo, wi);

  V3 m_r = unit20(wo + wi);
  m_r = m_r * signf(m_r.z);
  float f_r = fresnel_dielectric(dot(wo, m_r), eta_i, eta_t);
  float d_r = ggx_d(m_r, alpha);
  float g_r = ggx_g2(wo, wi, alpha);
  float denom = lo_clamp(4.0f * fabsf(wo.z) * fabsf(wi.z), 1e-8f);
  float refl_val = same ? d_r * g_r * f_r / denom : 0.0f;
  float pdf_r = same ? ggx_pdf_reflect(wo, m_r, alpha) : 0.0f;

  float eta = eta_t / eta_i;
  V3 m_t = unit_len20(wo + wi * eta);
  m_t = m_t * signf(m_t.z);
  float wo_m = dot(wo, m_t);
  float wi_m = dot(wi, m_t);
  bool valid_t = !same && (wo_m * wi_m < 0.0f);
  float f_t = fresnel_dielectric(wo_m, eta_i, eta_t);
  float d_t = ggx_d(m_t, alpha);
  float g_t = ggx_g2(wo, wi, alpha);
  float sqrt_denom = wo_m + eta * wi_m;
  float denom_t = lo_clamp(sqrt_denom * sqrt_denom, 1e-10f);
  float dwh_dwi = eta * eta * fabsf(wi_m) / denom_t;
  float trans_val =
      valid_t ? (1.0f - f_t) * d_t * g_t * fabsf(wo_m) * fabsf(wi_m) /
                    lo_clamp(fabsf(wo.z) * fabsf(wi.z) * denom_t, 1e-10f)
              : 0.0f;
  float pdf_m_t = ggx_g1(wo, alpha) * d_t * fabsf(wo_m) / lo_clamp(fabsf(wo.z), 1e-8f);
  float pdf_t = valid_t ? pdf_m_t * dwh_dwi : 0.0f;

  value = m.albedo * (refl_val + trans_val);
  pdf = pdf_r * f_r + pdf_t * (1.0f - f_t);
}

__device__ __forceinline__ BsdfSample dielectric_rough_sample(const Mat& m, V3 wo, float u0,
                                                              float u1, float u_lobe) {
  float alpha = roughness_to_alpha(m.p0);
  float eta_i, eta_t;
  dielectric_setup(m, wo, eta_i, eta_t);
  V3 mh = ggx_sample_vndf(wo, alpha, u0, u1);
  V3 m_signed = mh * signf(wo.z);
  V3 wi_r = m_signed * (2.0f * dot(wo, m_signed)) - wo;
  bool ok_t;
  V3 wi_t = refract(wo, m_signed, eta_i, eta_t, ok_t);
  float f = fresnel_dielectric(dot(wo, m_signed), eta_i, eta_t);
  bool pick_reflect = (u_lobe < f) || !ok_t;
  BsdfSample s;
  s.wi = pick_reflect ? wi_r : wi_t;
  dielectric_rough_eval_pdf(m, wo, s.wi, s.value, s.pdf);
  s.spec = false;
  return s;
}

// --- conductor ---

__device__ __forceinline__ V3 conductor_fresnel(const Mat& m, float wo_m) {
  V3 eta, k;
  if (m.p1 > 0.5f) {  // artistic main/edge colors
    artistic_chan(m.albedo.x, m.extra.x, eta.x, k.x);
    artistic_chan(m.albedo.y, m.extra.y, eta.y, k.y);
    artistic_chan(m.albedo.z, m.extra.z, eta.z, k.z);
  } else {
    eta = mk(lo_clamp(m.albedo.x, 1e-4f), lo_clamp(m.albedo.y, 1e-4f), lo_clamp(m.albedo.z, 1e-4f));
    k = m.extra;
  }
  return fresnel_conductor(wo_m, eta, k);
}

__device__ void conductor_eval_pdf(const Mat& m, V3 wo, V3 wi, V3& value, float& pdf) {
  float alpha = roughness_to_alpha(m.p0);
  bool same = same_hemi(wo, wi);
  V3 mh = unit_len20(wo + wi);
  mh = mh * signf(mh.z);
  V3 f = conductor_fresnel(m, dot(wo, mh));
  float d = ggx_d(mh, alpha);
  float g = ggx_g2(wo, wi, alpha);
  float denom = lo_clamp(4.0f * fabsf(wo.z) * fabsf(wi.z), 1e-8f);
  value = same ? f * (d * g / denom) : mk(0.0f, 0.0f, 0.0f);
  pdf = same ? ggx_pdf_reflect(wo, mh, alpha) : 0.0f;
}

__device__ __forceinline__ bool conductor_specular(const Mat& m) {
  float r = clampf(m.p0 * 0.75f, 0.0f, 1.0f);
  return r * r < kAlphaThreshold;
}

__device__ __forceinline__ BsdfSample conductor_sample(const Mat& m, V3 wo, float u0,
                                                       float u1) {
  BsdfSample s;
  s.spec = conductor_specular(m);
  if (s.spec) {
    s.wi = mk(-wo.x, -wo.y, wo.z);
    s.value = conductor_fresnel(m, wo.z) / lo_clamp(fabsf(s.wi.z), 1e-8f);
    s.pdf = 1.0f;
  } else {
    float alpha = roughness_to_alpha(m.p0);
    V3 mh = ggx_sample_vndf(wo, alpha, u0, u1);
    V3 m_signed = mh * signf(wo.z);
    s.wi = m_signed * (2.0f * dot(wo, m_signed)) - wo;
    conductor_eval_pdf(m, wo, s.wi, s.value, s.pdf);
  }
  return s;
}

// --- coated diffuse ---

__device__ void coated_eval_pdf(const Mat& m, V3 wo, V3 wi, V3& value, float& pdf) {
  float ior = lo_clamp(m.p1, (float)(1.0 + 1e-4));
  bool same = same_hemi(wo, wi);
  float f_o = fresnel_dielectric(wo.z, 1.0f, ior);
  float f_i = fresnel_dielectric(wi.z, 1.0f, ior);
  float f_avg = (ior - 1.0f) / (4.08567f + 1.00071f * ior);
  float s = (1.0f - f_o) * (1.0f - f_i);
  V3 a = m.albedo;
  V3 base = mk(a.x * kInvPi * s / lo_clamp(1.0f - f_avg * a.x, 1e-3f),
               a.y * kInvPi * s / lo_clamp(1.0f - f_avg * a.y, 1e-3f),
               a.z * kInvPi * s / lo_clamp(1.0f - f_avg * a.z, 1e-3f));
  value = same ? base : mk(0.0f, 0.0f, 0.0f);
  pdf = (same ? fabsf(wi.z) * kInvPi : 0.0f) * 0.5f;
}

__device__ __forceinline__ BsdfSample coated_sample(const Mat& m, V3 wo, float u0, float u1,
                                                    float u_lobe) {
  BsdfSample s;
  s.spec = u_lobe < 0.5f;
  if (s.spec) {
    float ior = lo_clamp(m.p1, (float)(1.0 + 1e-4));
    float f_o = fresnel_dielectric(wo.z, 1.0f, ior);
    s.wi = mk(-wo.x, -wo.y, wo.z);
    float vc = f_o / lo_clamp(fabsf(s.wi.z), 1e-8f);
    s.value = mk(vc, vc, vc);
    s.pdf = 0.5f;
  } else {
    V3 wi_b = cosine_hemisphere(u0, u1);
    s.wi = wo.z < 0.0f ? negz(wi_b) : wi_b;
    coated_eval_pdf(m, wo, s.wi, s.value, s.pdf);
  }
  return s;
}

// --- dispatch (bsdf.sample / bsdf.evaluate + bsdf.pdf) ---

__device__ BsdfSample bsdf_sample(const Mat& m, V3 wo, float u0, float u1, float u_lobe) {
  switch (m.type) {
    case DIFFUSE:
      return diffuse_sample(m, wo, u0, u1, u_lobe);
    case DIELECTRIC:
      if (roughness_to_alpha(m.p0) <= kAlphaThreshold) return dielectric_smooth_sample(m, wo, u_lobe);
      return dielectric_rough_sample(m, wo, u0, u1, u_lobe);
    case CONDUCTOR:
      return conductor_sample(m, wo, u0, u1);
    case COATED_DIFFUSE:
      return coated_sample(m, wo, u0, u1, u_lobe);
    case INVISIBLE: {
      BsdfSample s;
      s.wi = -wo;
      float v = 1.0f / lo_clamp(fabsf(s.wi.z), 1e-8f);
      s.value = mk(v, v, v);
      s.pdf = 1.0f;
      s.spec = true;
      return s;
    }
    default: {  // emissive: black
      BsdfSample s;
      s.wi = s.value = mk(0.0f, 0.0f, 0.0f);
      s.pdf = 0.0f;
      s.spec = false;
      return s;
    }
  }
}

// non-delta lobes only
__device__ void bsdf_eval_pdf(const Mat& m, V3 wo, V3 wi, V3& value, float& pdf) {
  value = mk(0.0f, 0.0f, 0.0f);
  pdf = 0.0f;
  switch (m.type) {
    case DIFFUSE:
      diffuse_eval_pdf(m, wo, wi, value, pdf);
      break;
    case DIELECTRIC:
      if (!(roughness_to_alpha(m.p0) <= kAlphaThreshold)) dielectric_rough_eval_pdf(m, wo, wi, value, pdf);
      break;
    case CONDUCTOR:
      if (!conductor_specular(m)) conductor_eval_pdf(m, wo, wi, value, pdf);
      break;
    case COATED_DIFFUSE:
      coated_eval_pdf(m, wo, wi, value, pdf);
      break;
    default:
      break;
  }
}

// ---------------------------------------------------------------------------
// light selection (scene_ops.pick_light / light_pmf, aggregation/light_tree)
// ---------------------------------------------------------------------------

// searchsorted(row `col` of the light table, u, right=True), clamped
__device__ __forceinline__ int upper_bound(const float* light, int col, int n, float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (ldg(light + mid * LT + col) <= u)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n - 1 ? lo : n - 1;
}

// importance of one packed child (offset b) of a tree node row, seen from x
__device__ __forceinline__ float child_importance(const float* row, int b, V3 x) {
  V3 c = load3(row + b);
  float r = ldg(row + b + 3);
  V3 ax = load3(row + b + 4);
  float cos_o = ldg(row + b + 7);
  float cos_e = ldg(row + b + 8);
  float pw = ldg(row + b + 9);
  V3 delta = c - x;
  float d2 = dot(delta, delta);
  float d = sqrtf(lo_clamp(d2, 1e-12f));
  V3 wi = delta / d;
  float cos_i = clampf(dot(ax, -wi), -1.0f, 1.0f);
  float sin_i = sqrtf(lo_clamp(1.0f - cos_i * cos_i, 0.0f));
  cos_o = clampf(cos_o, -1.0f, 1.0f);
  float sin_o = sqrtf(lo_clamp(1.0f - cos_o * cos_o, 0.0f));
  float sin_u = clampf(r / d, 0.0f, 1.0f);
  float cos_u = sqrtf(lo_clamp(1.0f - sin_u * sin_u, 0.0f));
  float cos_ou = cos_o * cos_u - sin_o * sin_u;
  float sin_ou = sin_o * cos_u + cos_o * sin_u;
  bool sum_ge_pi = cos_o <= -cos_u;
  float cos_p = cos_i * cos_ou + sin_i * sin_ou;
  bool inside = sum_ge_pi || (cos_i >= cos_ou);
  float cos_p_eff = inside ? 1.0f : cos_p;
  float falloff = cos_p_eff >= cos_e ? lo_clamp(cos_p_eff, 0.0f) : 0.0f;
  float hr = 0.5f * r;
  float d2c = pmax(d2, hr * hr);
  float imp = pw * falloff / d2c;
  return imp + pw * 1e-9f;
}

// probabilistic descent from x with u in [0, 1): tree light id, pmf
__device__ int tree_pick(const Params& p, V3 x, float u, float& pmf_out) {
  int node = 0;
  float pmf = 1.0f;
  float uu = u;
  for (int level = 0; level < p.tree_depth; ++level) {
    const float* row = p.tree + (size_t)node * TR;
    float imp0 = child_importance(row, 0, x);
    float imp1 = child_importance(row, 12, x);
    float total = lo_clamp(imp0 + imp1, 1e-30f);
    float p_left = imp0 / total;
    bool go_right = uu >= p_left;
    float p_pick = go_right ? 1.0f - p_left : p_left;
    float uu_next = go_right ? (uu - p_left) / lo_clamp(1.0f - p_left, 1e-12f)
                             : uu / lo_clamp(p_left, 1e-12f);
    uu_next = clampf(uu_next, 0.0f, kBelowOne);
    const float* child = row + (go_right ? 12 : 0);
    bool is_leaf = ldg(child + 10) > 0.5f;
    int next = (int)ldg(child + 11);
    pmf = pmf * p_pick;
    if (is_leaf) {
      pmf_out = pmf;
      return next;
    }
    node = next;
    uu = uu_next;
  }
  pmf_out = pmf;
  return 0;
}

// probability that tree_pick selects tree light `light` from x (replay of
// its root-to-leaf branch bitmask)
__device__ float tree_pmf(const Params& p, int light, V3 x) {
  if (light < 0) return 0.0f;
  uint32_t path = (uint32_t)ldg(p.tl + light * TL + 1);
  int depth = (int)ldg(p.tl + light * TL + 2);
  int node = 0;
  float pmf = 1.0f;
  for (int level = 0; level < depth && level < p.tree_depth; ++level) {
    const float* row = p.tree + (size_t)node * TR;
    float imp0 = child_importance(row, 0, x);
    float imp1 = child_importance(row, 12, x);
    float total = lo_clamp(imp0 + imp1, 1e-30f);
    bool go_right = (path >> level) & 1u;
    float pp = (go_right ? imp1 : imp0) / total;
    node = (int)ldg(row + (go_right ? 12 : 0) + 11);
    pmf = pmf * pp;
  }
  return pmf;
}

struct LightSample {
  V3 radiant, incident;
  float travel, pdf;
  bool use_mis;
};

// scene_ops.sample_light for record `rec` toward x
__device__ LightSample sample_light(const Params& p, const float* cam, int rec, V3 x, float u0,
                                    float u1) {
  const float* lr = p.light + (size_t)rec * LT;
  int kind = (int)ldg(lr);
  LightSample ls;
  ls.radiant = ls.incident = mk(0.0f, 0.0f, 0.0f);
  ls.travel = 0.0f;
  ls.pdf = 0.0f;
  ls.use_mis = kind == LIGHT_AMBIENT || kind == LIGHT_EMISSIVE;
  if (kind == LIGHT_POINT) {
    V3 delta = load3(lr + 3) - x;
    float dist2 = lo_clamp(dot(delta, delta), 1e-12f);
    float dist = sqrtf(dist2);
    ls.incident = delta / dist;
    ls.radiant = load3(lr + 6) / dist2;
    ls.travel = dist;
    ls.pdf = 1.0f;
  } else if (kind == LIGHT_DIRECTIONAL) {
    ls.incident = -load3(lr + 3);
    ls.radiant = load3(lr + 6);
    ls.travel = kInf;
    ls.pdf = 1.0f;
  } else if (kind == LIGHT_AMBIENT) {
    ls.incident = uniform_sphere(u0, u1);
    ls.radiant = load3(cam + C_AMB_ALL);
    ls.travel = kInf;
    ls.pdf = kInv4Pi;
  } else if (kind == LIGHT_EMISSIVE) {
    int ei = (int)ldg(lr + 9);
    ei = ei < 0 ? 0 : (ei > p.n_emissive - 1 ? p.n_emissive - 1 : ei);
    const float* er = p.epack + (size_t)ei * EP;
    V3 p_l, n_l;
    if (ldg(er + 16) > 0.5f) {  // sphere
      V3 sp_dir = uniform_sphere(u0, u1);
      p_l = load3(er) + sp_dir * ldg(er + 3);
      n_l = sp_dir;
    } else {
      float s = sqrtf(lo_clamp(u0, 0.0f));
      float b0 = 1.0f - s, b1 = u1 * s;
      p_l = load3(er) + load3(er + 3) * b0 + load3(er + 6) * b1;
      n_l = load3(er + 9);
    }
    V3 delta = p_l - x;
    float dist2 = lo_clamp(dot(delta, delta), 1e-12f);
    float dist = sqrtf(dist2);
    ls.incident = delta / dist;
    float cos_l = dot(n_l, -ls.incident);
    ls.radiant = cos_l > 0.0f ? load3(er + 12) : mk(0.0f, 0.0f, 0.0f);
    ls.pdf = dist2 / lo_clamp(fabsf(cos_l) * ldg(er + 15), 1e-12f);
    ls.travel = dist;
  }
  return ls;
}

constexpr int kPool = 128;  // threads a block of the path pool, one path each

// ---------------------------------------------------------------------------
// closest hit and any hit over the block's prim records (the untextured and
// textured forms)
// ---------------------------------------------------------------------------

// records in slot order: the least t wins, the first of equal ones
template <bool HAS_TRI, bool HAS_SPH>
__device__ __forceinline__ int trace_records(const float4* recs, int n_rec, const Ray& r,
                                             float& best_t, float& best_u, float& best_v) {
  best_t = r.tmax;
  best_u = best_v = 0.0f;
  int best_p = -1;
  for (int k = 0; k < n_rec; ++k) {
    float t, u, v;
    int slot;
    if (echo::record_hit<HAS_TRI, HAS_SPH>(recs + echo::kRecordWords * k, r, t, u, v, slot) &&
        t < best_t) {
      best_t = t;
      best_p = slot;
      best_u = u;
      best_v = v;
    }
  }
  return best_p;
}

template <bool HAS_TRI, bool HAS_SPH>
__device__ __forceinline__ bool occlude_records(const float4* recs, int n_rec, const Ray& r) {
  for (int k = 0; k < n_rec; ++k) {
    float t, u, v;
    int slot;
    if (echo::record_hit<HAS_TRI, HAS_SPH>(recs + echo::kRecordWords * k, r, t, u, v, slot) &&
        t < r.tmax)
      return true;
  }
  return false;
}

__device__ int trace(const Params& p, const float4* recs, int n_rec, const Ray& r, float& t,
                     float& u, float& v) {
  if (p.has_tri && p.has_sph) return trace_records<true, true>(recs, n_rec, r, t, u, v);
  if (p.has_tri) return trace_records<true, false>(recs, n_rec, r, t, u, v);
  return trace_records<false, true>(recs, n_rec, r, t, u, v);
}

__device__ bool occlude(const Params& p, const float4* recs, int n_rec, const Ray& r) {
  if (p.has_tri && p.has_sph) return occlude_records<true, true>(recs, n_rec, r);
  if (p.has_tri) return occlude_records<true, false>(recs, n_rec, r);
  return occlude_records<false, true>(recs, n_rec, r);
}
// closest hit and any hit over the chunk tree (the chunk-tree form)
template <bool HAS_TRI, bool HAS_SPH>
__device__ __forceinline__ int trace_tree(const Params& p, const Ray& r, float& best_t,
                                          float& best_u, float& best_v, echo::HierStage& st) {
  const echo::HierHit h = echo::hier_walk<HAS_TRI, HAS_SPH, false, false>(p.hier, r, -1, st);
  best_t = h.t;
  best_u = h.u;
  best_v = h.v;
  return h.prim;
}

template <bool HAS_TRI, bool HAS_SPH>
__device__ __forceinline__ bool occlude_tree(const Params& p, const Ray& r,
                                             echo::HierStage& st) {
  return echo::hier_walk<HAS_TRI, HAS_SPH, true, false>(p.hier, r, -1, st).blocked;
}

// the chunk-tree form's trace and occlude: every lane of the warp calls
// them together, with the warp's stage
__device__ __forceinline__ int trace_hier(const Params& p, const Ray& r, float& t, float& u,
                                          float& v, echo::HierStage& st) {
  if (p.has_tri && p.has_sph) return trace_tree<true, true>(p, r, t, u, v, st);
  if (p.has_tri) return trace_tree<true, false>(p, r, t, u, v, st);
  return trace_tree<false, true>(p, r, t, u, v, st);
}

__device__ __forceinline__ bool occlude_hier(const Params& p, const Ray& r, echo::HierStage& st) {
  if (p.has_tri && p.has_sph) return occlude_tree<true, true>(p, r, st);
  if (p.has_tri) return occlude_tree<true, false>(p, r, st);
  return occlude_tree<false, true>(p, r, st);
}

__device__ __forceinline__ Ray make_ray(V3 o, V3 d, float tmax, int ignore) {
  Ray r;
  r.ox = o.x;
  r.oy = o.y;
  r.oz = o.z;
  r.dx = d.x;
  r.dy = d.y;
  r.dz = d.z;
  r.tmax = tmax;
  r.ignore = ignore;
  return r;
}

// ---------------------------------------------------------------------------
// one lane: its pixel slots, sample after sample
// ---------------------------------------------------------------------------

struct Pixel {
  uint32_t base;  // hash prefix of (seed, pixel id)
  uint32_t s0;
  float px, py;
};

__device__ __forceinline__ Pixel load_pixel(const Params& p, int pix) {
  Pixel q;
  q.base = pixel_base(p.seed, (uint32_t)p.pid[pix]);
  q.s0 = (uint32_t)p.s0[pix];
  q.px = (float)p.pxy[2 * pix];
  q.py = (float)p.pxy[2 * pix + 1];
  return q;
}

// scene/cameras.spawn_rays, PERSPECTIVE (thin lens when lens and focus > 0)
__device__ void spawn(const Params& p, const float* cam, const Pixel& q, uint32_t sample, V3& o,
                      V3& d) {
  float sx, sy, lx, ly;
  next_2d(q.base, sample, 0, sx, sy);
  next_2d(q.base, sample, 1, lx, ly);
  float size_r = 1.0f / (float)p.width;
  float aspect_y = (float)p.height / (float)p.width;
  float x = (q.px + sx) * size_r - 0.5f;
  float y = (q.py + sy) * size_r - aspect_y * 0.5f;
  float fl = ldg(cam + C_FL);
  float lens_r = ldg(cam + C_LENS);
  float focal = ldg(cam + C_FOCAL);
  V3 lo = mk(0.0f, 0.0f, 0.0f);
  V3 ld = mk(x, y, fl);
  if (lens_r > 0.0f && focal > 0.0f) {
    float dx, dy;
    concentric_disk(lx, ly, dx, dy);
    lo = mk(dx * lens_r, dy * lens_r, 0.0f);
    float fs = focal / fl;
    ld = mk(x * fs, y * fs, focal) - lo;
  }
  const float* rot = cam + C_ROT;  // row-major local -> world
  for (int k = 0; k < 3; ++k) {
    float r0 = ldg(rot + 3 * k), r1 = ldg(rot + 3 * k + 1), r2 = ldg(rot + 3 * k + 2);
    float ok = r0 * lo.x + r1 * lo.y + r2 * lo.z + ldg(cam + C_POS + k);
    float dk = r0 * ld.x + r1 * ld.y + r2 * ld.z;
    if (k == 0) {
      o.x = ok;
      d.x = dk;
    } else if (k == 1) {
      o.y = ok;
      d.y = dk;
    } else {
      o.z = ok;
      d.z = dk;
    }
  }
  d = d / lo_clamp(sqrtf(dot(d, d)), 1e-20f);
}

// The chunk-tree form's loop. Every lane of the warp runs it until the warp
// is done, a lane whose slots are done (or that has none) tracing dead rays
// (t_max = 0), and the NEE shadow ray is walked after the interaction by
// every lane (t_max = 0 where there is none), so that the walk is called
// warp-wide. The draws are a pure function of (seed, pixel, sample,
// dimension), so no number changes. (TEX and HIER stay template arguments:
// the form is run_lane<false, true>.)
template <bool TEX, bool HIER>
__device__ void run_lane(const Params& p, const float* rows, int lane,
                         echo::HierStage* st = nullptr) {
  static_assert(HIER && !TEX, "the untextured and textured forms run the path pool");
  constexpr int SPW = TEX ? SP_TEX : SP, MTW = TEX ? MT_TEX : MT;
  const float* cam = p.cam;
  const V3 amb_all = load3(cam + C_AMB_ALL);
  const V3 amb_cam = load3(cam + C_AMB_CAM);
  const float inf_pdf = ldg(cam + C_AMB_PMF) * kInv4Pi;
  const float total_power = ldg(cam + C_TOTAL_POWER);
  const float p_inf = ldg(cam + C_P_INF);
  const float sum_inf = ldg(cam + C_SUM_INF);
  const bool has_tree = p.tree_depth > 0;
  const bool has_invisible = p.present & (1 << INVISIBLE);

  int slot = 0;
  int pix = lane;
  bool live = lane < p.n_lanes && pix < p.n;  // this lane still has samples to take
  Pixel q = load_pixel(p, live ? pix : 0);  // (a lane with nothing to do never uses it)
  uint32_t sample = 0;
  V3 s_sum = mk(0.0f, 0.0f, 0.0f), s_sq = s_sum;

  V3 o, d;
  spawn(p, cam, q, q.s0 + sample, o, d);
  V3 radiance = mk(0.0f, 0.0f, 0.0f), throughput = mk(1.0f, 1.0f, 1.0f);
  int depth = 0;
  float prev_pdf = 0.0f;
  bool prev_spec = true;
  V3 prev_point = o;
  int ignore = -1;

  for (;;) {
    if (!__any_sync(echo::kFullWarp, live)) return;
    const uint32_t sid = q.s0 + sample;
    float hit_t, hit_u, hit_v;
    int hit;
    hit = trace_hier(p, make_ray(o, d, live ? kInf : 0.0f, ignore), hit_t, hit_u, hit_v, *st);
    bool continues = false;
    Ray shadow = make_ray(o, d, 0.0f, -1);  // the NEE shadow ray (none: t_max = 0)
    V3 nee_term = mk(0.0f, 0.0f, 0.0f);     // its radiance unless shadowed
    bool nee_live = false;
    V3 new_tp, cont_o, wi_world, point;
    float bs_pdf = 0.0f;
    bool bs_spec = false;

    if (hit < 0) {
      // miss: constant ambient, MIS against ambient NEE
      float inf_w = prev_spec ? 1.0f : power_heuristic(prev_pdf, inf_pdf);
      radiance = radiance + throughput * (depth == 0 ? amb_cam : amb_all * inf_w);
    } else {
      // --- interaction ---
      const float* sr = p.sp + (size_t)hit * SPW;
      point = o + d * hit_t;
      const float w = 1.0f - hit_u - hit_v;
      V3 geo_n = load3(sr), shade_n;
      if (ldg(sr + 14) > 0.5f) {  // sphere: rows 0:3 hold the center
        geo_n = normalize(point - geo_n);
        shade_n = geo_n;
      } else {
        shade_n = normalize(load3(sr + 3) * w + load3(sr + 6) * hit_u + load3(sr + 9) * hit_v);
      }
      const float* mr = p.mat + (size_t)(int)ldg(sr + 12) * MTW;
      Mat m;
      m.albedo = load3(mr);
      m.p0 = ldg(mr + 3);
      m.p1 = ldg(mr + 4);
      m.extra = load3(mr + 7);
      m.type = (int)ldg(mr + 10);
      if (has_invisible && dot(geo_n, -d) < 0.0f && ldg(mr + 11) > 0.5f) m.type = INVISIBLE;

      // --- emission at the hit, MIS against NEE ---
      const V3 wo = -d;
      if (dot(geo_n, wo) > 0.0f && m.type == EMISSIVE) {
        const int rec = (int)ldg(sr + 15);
        float light_pm = 0.0f;
        if (rec >= 0) {
          if (!has_tree) {
            light_pm = ldg(sr + 16) / total_power;
          } else {
            const float* lr = p.light + (size_t)rec * LT;
            float w_inf = ldg(lr + 10);
            light_pm = w_inf > 0.0f ? w_inf / sum_inf * p_inf
                                    : tree_pmf(p, (int)ldg(lr + 12), prev_point) * (1.0f - p_inf);
          }
        }
        V3 delta = point - prev_point;
        float dist2 = lo_clamp(dot(delta, delta), 1e-12f);
        float cos_l = fabsf(dot(geo_n, d));
        float area_pdf = dist2 / lo_clamp(cos_l * ldg(sr + 13), 1e-12f);
        float em_w = prev_spec ? 1.0f : power_heuristic(prev_pdf, light_pm * area_pdf);
        radiance = radiance + throughput * m.albedo * em_w;
      }

      // --- shading frame and draws ---
      V3 tangent, bitangent;
      frame(shade_n, tangent, bitangent);
      const V3 wo_local = mk(dot(wo, tangent), dot(wo, bitangent), dot(wo, shade_n));
      const uint32_t dim = CAMERA_DIMS + BOUNCE_DIM_STRIDE * (uint32_t)depth;
      float ubx, uby, ulx, uly;
      next_2d(q.base, sid, dim + DIM_BSDF, ubx, uby);
      const float u_lobe = next_1d(q.base, sid, dim + DIM_LOBE);
      const float u_pick = next_1d(q.base, sid, dim + DIM_LIGHT_PICK);
      next_2d(q.base, sid, dim + DIM_LIGHT_SAMPLE, ulx, uly);
      const float u_rr = next_1d(q.base, sid, dim + DIM_RR);

      const BsdfSample bs = bsdf_sample(m, wo_local, ubx, uby, u_lobe);
      const bool has_bounce = bs.pdf > 0.0f && depth < p.bounce_limit;

      // --- NEE: pick a light, sample it, shadow ray, MIS ---
      if (!bs.spec) {
        int rec;
        float pick_pmf;
        if (!has_tree) {
          rec = upper_bound(p.light, 1, p.n_lights, u_pick);
          pick_pmf = ldg(p.light + (size_t)rec * LT + 2) / total_power;
        } else if (u_pick < p_inf) {
          float u_inf = clampf(u_pick / lo_clamp(p_inf, 1e-12f), 0.0f, kBelowOne);
          rec = upper_bound(p.light, 11, p.n_lights, u_inf);
          pick_pmf = ldg(p.light + (size_t)rec * LT + 10) / sum_inf * p_inf;
        } else {
          float u_fin = clampf((u_pick - p_inf) / lo_clamp(1.0f - p_inf, 1e-12f), 0.0f, kBelowOne);
          float pmf_tree;
          int leaf = tree_pick(p, point, u_fin, pmf_tree);
          rec = (int)ldg(p.tl + (size_t)leaf * TL);
          pick_pmf = pmf_tree * (1.0f - p_inf);
        }
        const LightSample ls = sample_light(p, cam, rec, point, ulx, uly);
        const V3 wi_l = mk(dot(ls.incident, tangent), dot(ls.incident, bitangent),
                           dot(ls.incident, shade_n));
        V3 f_l;
        float scatter_pdf;
        bsdf_eval_pdf(m, wo_local, wi_l, f_l, scatter_pdf);
        f_l = f_l * fabsf(dot(shade_n, ls.incident));
        const float nee_pdf = pick_pmf * ls.pdf;
        const bool candidate = nee_pdf > 1e-12f &&
                               (f_l.x * ls.radiant.x > 0.0f || f_l.y * ls.radiant.y > 0.0f ||
                                f_l.z * ls.radiant.z > 0.0f);
        if (candidate) {  // walked below, by the whole warp
          const V3 shadow_o = offset_origin(point, geo_n, ls.incident);
          const float shadow_t = ls.travel >= kInf ? kInf : ls.travel * kShadowScale;
          shadow = make_ray(shadow_o, ls.incident, shadow_t, hit);
          float mis_w = ls.use_mis ? power_heuristic(nee_pdf, scatter_pdf) : 1.0f;
          nee_term = ls.radiant * f_l * (mis_w / lo_clamp(nee_pdf, 1e-20f));
          nee_live = true;
        }
      }

      // --- Russian roulette and the bounce ---
      new_tp = has_bounce ? throughput * (bs.value * (fabsf(bs.wi.z) / lo_clamp(bs.pdf, 1e-20f)))
                          : throughput;
      const float lum = new_tp.x * 0.212671f + new_tp.y * 0.715160f + new_tp.z * 0.072169f;
      const float rr = clampf(p.survivability * lum, 0.0f, 1.0f);
      continues = has_bounce && (u_rr < rr);
      if (continues) {
        new_tp = new_tp / lo_clamp(rr, 1e-20f);
        wi_world = tangent * bs.wi.x + bitangent * bs.wi.y + shade_n * bs.wi.z;
        cont_o = offset_origin(point, geo_n, wi_world);
        bs_pdf = bs.pdf;
        bs_spec = bs.spec;
      }
    }

    const bool shadowed = occlude_hier(p, shadow, *st);
    if (nee_live && !shadowed) radiance = radiance + throughput * nee_term;
    if (!live) continue;

    if (continues) {
      throughput = new_tp;
      o = cont_o;
      d = wi_world;
      depth += 1;
      prev_pdf = bs_pdf;
      prev_spec = bs_spec;
      prev_point = point;
      ignore = hit;
      continue;
    }

    // --- the path ended: bank the sample, regenerate ---
    const float total = radiance.x + radiance.y + radiance.z;
    if (isfinite(total)) {
      s_sum = s_sum + radiance;
      s_sq = s_sq + radiance * radiance;
    }
    sample += 1;
    if (sample >= (uint32_t)p.count) {
      float* out = p.s_sum + 3 * (size_t)pix;
      out[0] = s_sum.x;
      out[1] = s_sum.y;
      out[2] = s_sum.z;
      out = p.s_sq + 3 * (size_t)pix;
      out[0] = s_sq.x;
      out[1] = s_sq.y;
      out[2] = s_sq.z;
      slot += 1;
      pix = slot * p.n_lanes + lane;
      if (slot >= p.k_slots || pix >= p.n) {
        live = false;  // on with dead rays until the warp is done
        continue;
      }
      q = load_pixel(p, pix);
      sample = 0;
      s_sum = s_sq = mk(0.0f, 0.0f, 0.0f);
    }
    spawn(p, cam, q, q.s0 + sample, o, d);
    radiance = mk(0.0f, 0.0f, 0.0f);
    throughput = mk(1.0f, 1.0f, 1.0f);
    depth = 0;
    prev_pdf = 0.0f;
    prev_spec = true;
    prev_point = o;
    ignore = -1;
  }
}

// ---------------------------------------------------------------------------
// the untextured and textured forms: a block-resident path pool
// ---------------------------------------------------------------------------
//
// A block keeps one path a thread in shared memory (struct Pool, columns of
// kPool entries) and runs the bounce as stages over queues, with a barrier
// between them (Laine, Karras and Aila, "Megakernels Considered Harmful",
// HPG 2013):
//   1. trace: every live path, one thread a path, over the block's prim
//      records; a miss adds the ambient term and ends its path; a hit
//      counts its material type;
//   2. the hits are placed by material type (a counting sort: the counts'
//      prefix plus each path's rank), so that a warp shades one material;
//   3. shade: interaction, the texture stage, emission, the draws, the BSDF
//      sample, the NEE light pick, sample and BSDF evaluation, Russian
//      roulette; a path with a shadow ray queues it;
//   4. shadow: the queued shadow rays, one thread a ray; an unblocked one
//      adds its radiance;
//   5. end: a thread's own entry banks its ended path and regenerates: its
//      pixel's next sample, its lane's next slot, or a new item from the
//      launch's work counter.
// Each path runs run_lane's arithmetic in its order, and a pixel's samples
// are banked in sample order on one entry, so the sums are bitwise the same
// whichever thread runs which path at which moment. An entry takes a lane
// (slot j of lane L is pixel j * n_lanes + L) and keeps it until its slots
// are done. The split form (`samples` set: a launch with fewer pixels than
// the card holds threads) takes (pixel, sample) units instead and writes each
// sample's radiance to `samples`; bank_kernel then sums each pixel's samples
// in sample order.

constexpr int kTypes = 8;  // sort buckets: the material types (0-5)
// an entry's flags
constexpr int F_PREV_SPEC = 1, F_ENDED = 2, F_SHADOW = 4, F_ALIVE = 8;

struct Pool {
  float ox[kPool], oy[kPool], oz[kPool], dx[kPool], dy[kPool], dz[kPool];
  float tx[kPool], ty[kPool], tz[kPool];  // throughput
  float rx[kPool], ry[kPool], rz[kPool];  // radiance
  float qx[kPool], qy[kPool], qz[kPool];  // previous point
  float prev_pdf[kPool];
  int depth[kPool], ignore[kPool], flags[kPool];
  uint32_t base[kPool], sid[kPool];  // the pixel's hash prefix, the sample's index
  int item[kPool], slot[kPool], sample[kPool], pix[kPool];
  float sum[3][kPool], sq[3][kPool];  // the pixel's banked samples
  int hit[kPool];  // the traced ray's hit
  float ht[kPool], hu[kPool], hv[kPool];
  float so[3][kPool], sd[3][kPool], stmax[kPool], sc[3][kPool];  // the shadow ray, its term
  int live[kPool], order[kPool], shadow[kPool];  // the stages' queues
  int bucket[kTypes];
  int n_live, n_shadow;
};

__device__ __forceinline__ V3 col3(const float* x, const float* y, const float* z, int e) {
  return mk(x[e], y[e], z[e]);
}
__device__ __forceinline__ void put3(float* x, float* y, float* z, int e, V3 v) {
  x[e] = v.x;
  y[e] = v.y;
  z[e] = v.z;
}

// the block's prims as records (echo::record_hit), in slot order, leaving out
// the slots that no ray can hit: a slot tested as a triangle whose b or c
// rows are zero has det = 0 (padding, zero-area triangles). Returns how many.
__device__ int stage_records(const Params& p, float4* recs, int* counts) {
  const int P = p.padded;
  const float* r = p.prims;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int n = 0;
  for (int b = 0; b < P; b += kPool) {
    const int k = b + threadIdx.x;
    bool keep = false;
    if (k < P) {
      const bool as_tri = p.has_tri && !(p.has_sph && r[9 * P + k] > 0.5f);
      const bool b_zero = r[3 * P + k] == 0.0f && r[4 * P + k] == 0.0f && r[5 * P + k] == 0.0f;
      const bool c_zero = r[6 * P + k] == 0.0f && r[7 * P + k] == 0.0f && r[8 * P + k] == 0.0f;
      keep = !as_tri || !(b_zero || c_zero);
    }
    const unsigned ballot = __ballot_sync(echo::kFullWarp, keep);
    if (lane == 0) counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kPool / 32; ++w) {
      before += w < warp ? counts[w] : 0;
      total += counts[w];
    }
    if (keep)
      echo::make_record(r, P, k, k,
                        recs + echo::kRecordWords * (n + before + __popc(ballot & ((1u << lane) - 1))));
    n += total;
    __syncthreads();
  }
  return n;
}

// a fresh camera ray for entry e's pixel and sample
__device__ void spawn_path(const Params& p, Pool& s, int e) {
  const int pix = s.pix[e];
  Pixel q;
  q.base = s.base[e];
  q.s0 = 0;
  q.px = (float)p.pxy[2 * pix];
  q.py = (float)p.pxy[2 * pix + 1];
  V3 o, d;
  spawn(p, p.cam, q, s.sid[e], o, d);
  put3(s.ox, s.oy, s.oz, e, o);
  put3(s.dx, s.dy, s.dz, e, d);
  put3(s.rx, s.ry, s.rz, e, mk(0.0f, 0.0f, 0.0f));
  put3(s.tx, s.ty, s.tz, e, mk(1.0f, 1.0f, 1.0f));
  put3(s.qx, s.qy, s.qz, e, o);
  s.prev_pdf[e] = 0.0f;
  s.depth[e] = 0;
  s.ignore[e] = -1;
  s.flags[e] = F_ALIVE | F_PREV_SPEC;
}

__device__ void start_pixel(const Params& p, Pool& s, int e, int pix, int sample) {
  s.pix[e] = pix;
  s.sample[e] = sample;
  s.base[e] = pixel_base(p.seed, (uint32_t)p.pid[pix]);
  s.sid[e] = (uint32_t)p.s0[pix] + (uint32_t)sample;
  for (int c = 0; c < 3; ++c) s.sum[c][e] = s.sq[c][e] = 0.0f;
}

// entry e's next item from the launch's work counter: a lane (its first
// slot), or in the split form a (pixel, sample) unit; false when none is left
__device__ bool take_item(const Params& p, Pool& s, int e) {
  const int item = atomicAdd(p.work, 1);
  if (p.samples) {
    if (item >= p.n * p.count) return false;
    start_pixel(p, s, e, item % p.n, item / p.n);
  } else {
    if (item >= p.n_lanes) return false;
    s.slot[e] = 0;
    start_pixel(p, s, e, item, 0);
  }
  s.item[e] = item;
  spawn_path(p, s, e);
  return true;
}

// entry e's path ended: bank it and regenerate (run_lane's banking)
__device__ void end_path(const Params& p, Pool& s, int e) {
  const V3 radiance = col3(s.rx, s.ry, s.rz, e);
  const int pix = s.pix[e];
  if (p.samples) {  // the split form: bank_kernel sums the samples in order
    float* out = p.samples + ((size_t)pix * p.count + s.sample[e]) * 3;
    out[0] = radiance.x;
    out[1] = radiance.y;
    out[2] = radiance.z;
    if (!take_item(p, s, e)) s.flags[e] = 0;
    return;
  }
  V3 s_sum = mk(s.sum[0][e], s.sum[1][e], s.sum[2][e]);
  V3 s_sq = mk(s.sq[0][e], s.sq[1][e], s.sq[2][e]);
  const float total = radiance.x + radiance.y + radiance.z;
  if (isfinite(total)) {
    s_sum = s_sum + radiance;
    s_sq = s_sq + radiance * radiance;
  }
  const int sample = s.sample[e] + 1;
  if (sample >= p.count) {
    float* out = p.s_sum + 3 * (size_t)pix;
    out[0] = s_sum.x;
    out[1] = s_sum.y;
    out[2] = s_sum.z;
    out = p.s_sq + 3 * (size_t)pix;
    out[0] = s_sq.x;
    out[1] = s_sq.y;
    out[2] = s_sq.z;
    const int slot = s.slot[e] + 1;
    const int next = slot * p.n_lanes + s.item[e];
    if (slot >= p.k_slots || next >= p.n) {
      if (!take_item(p, s, e)) s.flags[e] = 0;
      return;
    }
    s.slot[e] = slot;
    start_pixel(p, s, e, next, 0);
  } else {
    s.sample[e] = sample;
    s.sid[e] = s.sid[e] + 1u;
    s.sum[0][e] = s_sum.x;
    s.sum[1][e] = s_sum.y;
    s.sum[2][e] = s_sum.z;
    s.sq[0][e] = s_sq.x;
    s.sq[1][e] = s_sq.y;
    s.sq[2][e] = s_sq.z;
  }
  spawn_path(p, s, e);
}

// the trace stage of path e: its hit, or on a miss the ambient term (its
// path ends); returns the hit's material type, -1 on a miss
template <bool TEX>
__device__ int trace_path(const Params& p, Pool& s, const float4* recs, int n_rec, int e) {
  constexpr int SPW = TEX ? SP_TEX : SP, MTW = TEX ? MT_TEX : MT;
  const V3 d = col3(s.dx, s.dy, s.dz, e);
  float hit_t, hit_u, hit_v;
  const int hit = trace(p, recs, n_rec, make_ray(col3(s.ox, s.oy, s.oz, e), d, kInf, s.ignore[e]),
                        hit_t, hit_u, hit_v);
  s.hit[e] = hit;
  if (hit < 0) {
    // miss: constant ambient, MIS against ambient NEE
    const float* cam = p.cam;
    const float inf_pdf = ldg(cam + C_AMB_PMF) * kInv4Pi;
    const int f = s.flags[e];
    const bool prev_spec = f & F_PREV_SPEC;
    const float inf_w = prev_spec ? 1.0f : power_heuristic(s.prev_pdf[e], inf_pdf);
    const V3 throughput = col3(s.tx, s.ty, s.tz, e);
    V3 radiance = col3(s.rx, s.ry, s.rz, e);
    radiance = radiance + throughput * (s.depth[e] == 0 ? load3(cam + C_AMB_CAM)
                                                          : load3(cam + C_AMB_ALL) * inf_w);
    put3(s.rx, s.ry, s.rz, e, radiance);
    s.flags[e] = f | F_ENDED;
    return -1;
  }
  s.ht[e] = hit_t;
  s.hu[e] = hit_u;
  s.hv[e] = hit_v;
  const int type = (int)ldg(p.mat + (size_t)(int)ldg(p.sp + (size_t)hit * SPW + 12) * MTW + 10);
  return type < 0 ? 0 : (type >= kTypes ? kTypes - 1 : type);
}

// the shade stage of path e, which hit s.hit[e]: run_lane's interaction,
// texture stage, emission, draws, BSDF sample, NEE and Russian roulette; the
// shadow ray goes to the entry's shadow columns (F_SHADOW)
template <bool TEX>
__device__ void shade_path(const Params& p, Pool& s, int e ECHO_STAGE_PARAM) {
  ECHO_STAGE(ECHO_STAGE_INTERACT);
  constexpr int SPW = TEX ? SP_TEX : SP, MTW = TEX ? MT_TEX : MT;
  const float* cam = p.cam;
  const int hit = s.hit[e];
  const float hit_t = s.ht[e], hit_u = s.hu[e], hit_v = s.hv[e];
  const V3 d = col3(s.dx, s.dy, s.dz, e);
  const int depth = s.depth[e];
  int flags = s.flags[e];
  const bool prev_spec = flags & F_PREV_SPEC;
  const V3 throughput = col3(s.tx, s.ty, s.tz, e);
  V3 radiance = col3(s.rx, s.ry, s.rz, e);

  // --- interaction ---
  const float* sr = p.sp + (size_t)hit * SPW;
  const V3 point = col3(s.ox, s.oy, s.oz, e) + d * hit_t;
  const float w = 1.0f - hit_u - hit_v;
  V3 geo_n = load3(sr), shade_n;
  if (ldg(sr + 14) > 0.5f) {  // sphere: rows 0:3 hold the center
    geo_n = normalize(point - geo_n);
    shade_n = geo_n;
  } else {
    shade_n = normalize(load3(sr + 3) * w + load3(sr + 6) * hit_u + load3(sr + 9) * hit_v);
  }
  const float* mr = p.mat + (size_t)(int)ldg(sr + 12) * MTW;
  Mat m;
  m.albedo = load3(mr);
  m.p0 = ldg(mr + 3);
  m.p1 = ldg(mr + 4);
  m.extra = load3(mr + 7);
  m.type = (int)ldg(mr + 10);
  if ((p.present & (1 << INVISIBLE)) && dot(geo_n, -d) < 0.0f && ldg(mr + 11) > 0.5f)
    m.type = INVISIBLE;

  if constexpr (TEX) {
    // --- the texture stage: uv, then albedo, normal map, roughness ---
    ECHO_STAGE(ECHO_STAGE_TEXTURE);
    float su, sv;
    if (ldg(sr + 14) > 0.5f) {
      sphere_uv(point, load3(sr), ldg(sr + 3), su, sv);
    } else {
      su = w * ldg(sr + 17) + hit_u * ldg(sr + 19) + hit_v * ldg(sr + 21);
      sv = w * ldg(sr + 18) + hit_u * ldg(sr + 20) + hit_v * ldg(sr + 22);
    }
    const int tid = (int)ldg(mr + 12);
    if (tid >= 0) m.albedo = tex_sample(p, tid, su, sv);
    const int ntid = p.has_ntex ? (int)ldg(mr + 13) : -1;
    if (ntid >= 0) {
      const V3 t = tex_sample(p, ntid, su, sv);
      const V3 tn = mk(t.x * 2.0f - 1.0f, t.y * 2.0f - 1.0f, t.z * 2.0f - 1.0f);
      const float inten = ldg(mr + 14);
      const float nz = lo_clamp(tn.z, (float)0.1);
      V3 tg, bt;
      frame(shade_n, tg, bt);
      shade_n = normalize(mk(tg.x * tn.x * inten + bt.x * tn.y * inten + shade_n.x * nz,
                             tg.y * tn.x * inten + bt.y * tn.y * inten + shade_n.y * nz,
                             tg.z * tn.x * inten + bt.z * tn.y * inten + shade_n.z * nz));
    }
    const int rtid = p.has_rtex ? (int)ldg(mr + 15) : -1;
    if (rtid >= 0) {
      const V3 t = tex_sample(p, rtid, su, sv);
      m.p0 = (t.x + t.y + t.z) * kThird;
    }
    ECHO_STAGE(ECHO_STAGE_INTERACT);
  }

  // --- emission at the hit, MIS against NEE ---
  const V3 wo = -d;
  const float total_power = ldg(cam + C_TOTAL_POWER);
  const float p_inf = ldg(cam + C_P_INF);
  const float sum_inf = ldg(cam + C_SUM_INF);
  const bool has_tree = p.tree_depth > 0;
  if (dot(geo_n, wo) > 0.0f && m.type == EMISSIVE) {
    const V3 prev_point = col3(s.qx, s.qy, s.qz, e);
    const int rec = (int)ldg(sr + 15);
    float light_pm = 0.0f;
    if (rec >= 0) {
      if (!has_tree) {
        light_pm = ldg(sr + 16) / total_power;
      } else {
        const float* lr = p.light + (size_t)rec * LT;
        float w_inf = ldg(lr + 10);
        light_pm = w_inf > 0.0f ? w_inf / sum_inf * p_inf
                                : tree_pmf(p, (int)ldg(lr + 12), prev_point) * (1.0f - p_inf);
      }
    }
    V3 delta = point - prev_point;
    float dist2 = lo_clamp(dot(delta, delta), 1e-12f);
    float cos_l = fabsf(dot(geo_n, d));
    float area_pdf = dist2 / lo_clamp(cos_l * ldg(sr + 13), 1e-12f);
    float em_w = prev_spec ? 1.0f : power_heuristic(s.prev_pdf[e], light_pm * area_pdf);
    radiance = radiance + throughput * m.albedo * em_w;
  }

  // --- shading frame and draws ---
  ECHO_STAGE(ECHO_STAGE_BSDF);
  V3 tangent, bitangent;
  frame(shade_n, tangent, bitangent);
  const V3 wo_local = mk(dot(wo, tangent), dot(wo, bitangent), dot(wo, shade_n));
  const uint32_t base = s.base[e], sid = s.sid[e];
  const uint32_t dim = CAMERA_DIMS + BOUNCE_DIM_STRIDE * (uint32_t)depth;
  float ubx, uby, ulx, uly;
  next_2d(base, sid, dim + DIM_BSDF, ubx, uby);
  const float u_lobe = next_1d(base, sid, dim + DIM_LOBE);
  const float u_pick = next_1d(base, sid, dim + DIM_LIGHT_PICK);
  next_2d(base, sid, dim + DIM_LIGHT_SAMPLE, ulx, uly);
  const float u_rr = next_1d(base, sid, dim + DIM_RR);

  const BsdfSample bs = bsdf_sample(m, wo_local, ubx, uby, u_lobe);
  const bool has_bounce = bs.pdf > 0.0f && depth < p.bounce_limit;

  // --- NEE: pick a light, sample it, queue the shadow ray, MIS ---
  ECHO_STAGE(ECHO_STAGE_NEE);
  flags &= ~F_SHADOW;
  if (!bs.spec) {
    int rec;
    float pick_pmf;
    if (!has_tree) {
      rec = upper_bound(p.light, 1, p.n_lights, u_pick);
      pick_pmf = ldg(p.light + (size_t)rec * LT + 2) / total_power;
    } else if (u_pick < p_inf) {
      float u_inf = clampf(u_pick / lo_clamp(p_inf, 1e-12f), 0.0f, kBelowOne);
      rec = upper_bound(p.light, 11, p.n_lights, u_inf);
      pick_pmf = ldg(p.light + (size_t)rec * LT + 10) / sum_inf * p_inf;
    } else {
      float u_fin = clampf((u_pick - p_inf) / lo_clamp(1.0f - p_inf, 1e-12f), 0.0f, kBelowOne);
      float pmf_tree;
      int leaf = tree_pick(p, point, u_fin, pmf_tree);
      rec = (int)ldg(p.tl + (size_t)leaf * TL);
      pick_pmf = pmf_tree * (1.0f - p_inf);
    }
    const LightSample ls = sample_light(p, cam, rec, point, ulx, uly);
    const V3 wi_l = mk(dot(ls.incident, tangent), dot(ls.incident, bitangent),
                       dot(ls.incident, shade_n));
    V3 f_l;
    float scatter_pdf;
    bsdf_eval_pdf(m, wo_local, wi_l, f_l, scatter_pdf);
    f_l = f_l * fabsf(dot(shade_n, ls.incident));
    const float nee_pdf = pick_pmf * ls.pdf;
    const bool candidate = nee_pdf > 1e-12f &&
                           (f_l.x * ls.radiant.x > 0.0f || f_l.y * ls.radiant.y > 0.0f ||
                            f_l.z * ls.radiant.z > 0.0f);
    if (candidate) {  // traced in the shadow stage
      put3(s.so[0], s.so[1], s.so[2], e, offset_origin(point, geo_n, ls.incident));
      put3(s.sd[0], s.sd[1], s.sd[2], e, ls.incident);
      s.stmax[e] = ls.travel >= kInf ? kInf : ls.travel * kShadowScale;
      float mis_w = ls.use_mis ? power_heuristic(nee_pdf, scatter_pdf) : 1.0f;
      V3 nee = ls.radiant * f_l * (mis_w / lo_clamp(nee_pdf, 1e-20f));
      put3(s.sc[0], s.sc[1], s.sc[2], e, throughput * nee);
      flags |= F_SHADOW;
    }
  }

  // --- Russian roulette and the bounce ---
  ECHO_STAGE(ECHO_STAGE_END);
  put3(s.rx, s.ry, s.rz, e, radiance);
  V3 new_tp = has_bounce ? throughput * (bs.value * (fabsf(bs.wi.z) / lo_clamp(bs.pdf, 1e-20f)))
                         : throughput;
  const float lum = new_tp.x * 0.212671f + new_tp.y * 0.715160f + new_tp.z * 0.072169f;
  const float rr = clampf(p.survivability * lum, 0.0f, 1.0f);
  if (has_bounce && (u_rr < rr)) {
    new_tp = new_tp / lo_clamp(rr, 1e-20f);
    const V3 wi_world = tangent * bs.wi.x + bitangent * bs.wi.y + shade_n * bs.wi.z;
    put3(s.tx, s.ty, s.tz, e, new_tp);
    put3(s.ox, s.oy, s.oz, e, offset_origin(point, geo_n, wi_world));
    put3(s.dx, s.dy, s.dz, e, wi_world);
    put3(s.qx, s.qy, s.qz, e, point);
    s.depth[e] = depth + 1;
    s.prev_pdf[e] = bs.pdf;
    s.ignore[e] = hit;
    flags = bs.spec ? (flags | F_PREV_SPEC) : (flags & ~F_PREV_SPEC);
  } else {
    flags |= F_ENDED;
  }
  s.flags[e] = flags;
}

// path h's shadow ray: its NEE term unless blocked
__device__ __forceinline__ void shadow_ray(const Params& p, Pool& s, const float4* recs,
                                           int n_rec, int h) {
  const Ray r = make_ray(mk(s.so[0][h], s.so[1][h], s.so[2][h]),
                         mk(s.sd[0][h], s.sd[1][h], s.sd[2][h]), s.stmax[h], s.hit[h]);
  if (!occlude(p, recs, n_rec, r))
    put3(s.rx, s.ry, s.rz, h, col3(s.rx, s.ry, s.rz, h) + mk(s.sc[0][h], s.sc[1][h], s.sc[2][h]));
}

// a warp-aggregated push onto a shared-memory queue counter
__device__ __forceinline__ int push(int* counter) {
  const unsigned mask = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int at = 0;
  if (lane == leader) at = atomicAdd(counter, __popc(mask));
  return __shfl_sync(mask, at, leader) + __popc(mask & ((1u << lane) - 1));
}

template <bool TEX>
__device__ void run_pool(const Params& p) {
  extern __shared__ float4 prim_recs[];  // (dynamic shared memory starts 16-byte aligned)
  __shared__ Pool s;
  const int e = threadIdx.x;  // this thread's own entry (the end stage)
  ECHO_STAGE_CLOCK(ECHO_STAGE_POOL);
  const int n_rec = stage_records(p, prim_recs, s.live);
  if (e < kTypes) s.bucket[e] = 0;
  if (e == 0) s.n_live = s.n_shadow = 0;
  __syncthreads();
  if (take_item(p, s, e)) s.live[push(&s.n_live)] = e;
  else s.flags[e] = 0;
  __syncthreads();
  for (;;) {
    const int n_live = s.n_live;
    if (n_live == 0) break;
    // --- 1. trace every live path ---
    ECHO_STAGE(ECHO_STAGE_TRACE);
    int path = -1, type = -1, rank = 0;
    if (e < n_live) {
      path = s.live[e];
      type = trace_path<TEX>(p, s, prim_recs, n_rec, path);
      if (type >= 0) rank = atomicAdd(&s.bucket[type], 1);
    }
    ECHO_STAGE(ECHO_STAGE_POOL);  // (a barrier's wait is the pool's)
    __syncthreads();
    // --- 2. the hits in material order ---
    int n_hit = 0, at = 0;
    for (int b = 0; b < kTypes; ++b) {
      const int c = s.bucket[b];
      at += b < type ? c : 0;
      n_hit += c;
    }
    if (type >= 0) s.order[at + rank] = path;
    if (e == 0) s.n_live = 0;
    __syncthreads();
    // --- 3. shade every hit ---
    if (e < kTypes) s.bucket[e] = 0;
    if (e < n_hit) {
      const int h = s.order[e];
      shade_path<TEX>(p, s, h ECHO_STAGE_ARG);
      ECHO_STAGE(ECHO_STAGE_POOL);
      if (s.flags[h] & F_SHADOW) s.shadow[push(&s.n_shadow)] = h;
    }
    __syncthreads();
    // --- 4. the shadow rays ---
    if (e < s.n_shadow) {
      ECHO_STAGE(ECHO_STAGE_SHADOW);
      shadow_ray(p, s, prim_recs, n_rec, s.shadow[e]);
      ECHO_STAGE(ECHO_STAGE_POOL);
    }
    __syncthreads();
    // --- 5. bank ended paths, regenerate, queue the live ones ---
    if (e == 0) s.n_shadow = 0;
    const int f = s.flags[e];
    if ((f & F_ALIVE) && (f & F_ENDED)) {
      ECHO_STAGE(ECHO_STAGE_END);
      end_path(p, s, e);
      ECHO_STAGE(ECHO_STAGE_POOL);
    }
    if (s.flags[e] & F_ALIVE) s.live[push(&s.n_live)] = e;
    __syncthreads();
  }
}

// the split form's banking: each pixel's samples summed in sample order,
// non-finite ones left out (run_lane's banking, bit for bit)
__global__ void bank_kernel(const float* samples, int n, int count, float* s_sum, float* s_sq) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n) return;
  V3 sum = mk(0.0f, 0.0f, 0.0f), sq = sum;
  const float* r = samples + (size_t)pix * count * 3;
  for (int k = 0; k < count; ++k, r += 3) {
    const V3 radiance = mk(r[0], r[1], r[2]);
    const float total = radiance.x + radiance.y + radiance.z;
    if (isfinite(total)) {
      sum = sum + radiance;
      sq = sq + radiance * radiance;
    }
  }
  s_sum[3 * pix] = sum.x;
  s_sum[3 * pix + 1] = sum.y;
  s_sum[3 * pix + 2] = sum.z;
  s_sq[3 * pix] = sq.x;
  s_sq[3 * pix + 1] = sq.y;
  s_sq[3 * pix + 2] = sq.z;
}

// TEX: the texture stage; HIER: the chunk-tree form (run_lane), which stages
// no prims but gives each warp its walk's stage (used with TEX = false only);
// the untextured and textured forms run the path pool
template <bool TEX, bool HIER>
__global__ void __launch_bounds__(HIER ? kBlock : kPool) mega_kernel(Params p) {
  if constexpr (HIER) {  // every thread runs: the walk is called warp-wide
    extern __shared__ float rows[];
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    echo::HierStage st = echo::hier_stage_init(rows, kBlock / 32);
    run_lane<TEX, HIER>(p, rows, lane, &st);
  } else {
    run_pool<TEX>(p);
  }
}

// dynamic shared memory of a form: the chunk-tree form's walk stages, or the
// prim records (at most `padded` of them) beside the static pool
template <bool TEX, bool HIER>
size_t smem_bytes(int padded) {
  return HIER ? echo::hier_smem_bytes(kBlock / 32)
              : sizeof(float4) * echo::kRecordWords * (size_t)padded;
}

// the form's resident blocks a SM at `padded` prims (the occupancy query)
// and the SMs. The form's dynamic shared memory limit is raised to what the
// envelope's largest table needs (ops/megakernel.MEGA_PRIM_LIMIT padded
// prims), never lowered: a query for a small scene leaves room for a launch
// of a larger one.
constexpr int kMaxPadded = 2048;
template <bool TEX, bool HIER>
cudaError_t occupancy(int padded, int& blocks, int& sms) {
  const size_t smem = smem_bytes<TEX, HIER>(padded);
  const size_t room = smem_bytes<TEX, HIER>(padded > kMaxPadded ? padded : kMaxPadded);
  cudaError_t err = cudaFuncSetAttribute(mega_kernel<TEX, HIER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(room));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mega_kernel<TEX, HIER>,
                                                        HIER ? kBlock : kPool,
                                                        smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

template <bool TEX, bool HIER>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<TEX, HIER>(p.padded);
  if constexpr (HIER) {
    static_assert(echo::hier_smem_bytes(kBlock / 32) <= 48 * 1024, "default dynamic smem");
    const dim3 grid((p.n_lanes + kBlock - 1) / kBlock), block(kBlock);
    mega_kernel<TEX, HIER><<<grid, block, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  } else {
    // as many blocks as the card holds at once, each taking items from the
    // work counter until none is left
    int blocks = 0, sms = 0;
    cudaError_t err = occupancy<TEX, HIER>(p.padded, blocks, sms);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long items = p.samples ? (long long)p.n * p.count : p.n_lanes;
    const long long need = (items + kPool - 1) / kPool;
    const int grid = (int)(need < (long long)blocks * sms ? need : (long long)blocks * sms);
    err = cudaMemsetAsync(p.work, 0, sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    mega_kernel<TEX, HIER><<<grid, kPool, smem, stream>>>(p);
    err = cudaGetLastError();
    if (err == cudaSuccess && p.samples) {
      bank_kernel<<<(p.n + 255) / 256, 256, 0, stream>>>(p.samples, p.n, p.count, p.s_sum,
                                                          p.s_sq);
      err = cudaGetLastError();
    }
    return static_cast<int>(err);
  }
}

// ptrs: prims sp mat light epack tree tl cam pid pxy s0 s_sum s_sq atlas work
//       samples
// ints: n n_lanes k_slots count bounce_limit width height seed padded
//       has_tri has_sph present n_lights n_emissive tree_depth n_tex tex_res
//       has_ntex has_rtex
Params params(void* const* ptrs, const int* ints, float survivability) {
  Params p;
  p.prims = static_cast<const float*>(ptrs[0]);
  p.sp = static_cast<const float*>(ptrs[1]);
  p.mat = static_cast<const float*>(ptrs[2]);
  p.light = static_cast<const float*>(ptrs[3]);
  p.epack = static_cast<const float*>(ptrs[4]);
  p.tree = static_cast<const float*>(ptrs[5]);
  p.tl = static_cast<const float*>(ptrs[6]);
  p.cam = static_cast<const float*>(ptrs[7]);
  p.pid = static_cast<const int*>(ptrs[8]);
  p.pxy = static_cast<const int*>(ptrs[9]);
  p.s0 = static_cast<const int*>(ptrs[10]);
  p.s_sum = static_cast<float*>(ptrs[11]);
  p.s_sq = static_cast<float*>(ptrs[12]);
  p.atlas = static_cast<const float*>(ptrs[13]);
  p.work = static_cast<int*>(ptrs[14]);
  p.samples = static_cast<float*>(ptrs[15]);
  p.n = ints[0];
  p.n_lanes = ints[1];
  p.k_slots = ints[2];
  p.count = ints[3];
  p.bounce_limit = ints[4];
  p.width = ints[5];
  p.height = ints[6];
  p.seed = static_cast<uint32_t>(ints[7]);
  p.padded = ints[8];
  p.has_tri = ints[9];
  p.has_sph = ints[10];
  p.present = ints[11];
  p.n_lights = ints[12];
  p.n_emissive = ints[13];
  p.tree_depth = ints[14];
  p.n_tex = ints[15];
  p.tex_res = ints[16];
  p.has_ntex = ints[17];
  p.has_rtex = ints[18];
  p.survivability = survivability;
  p.hier = echo::HierTables{nullptr, nullptr, nullptr, 0, nullptr, nullptr};
  return p;
}

}  // namespace

// A scene with atlas textures (n_tex > 0) runs the textured form. With
// `samples` set (ptrs[15]) the launch runs the split form: (pixel, sample)
// units, then bank_kernel.
extern "C" int megakernel(void* const* ptrs, const int* ints, float survivability,
                          void* stream) {
  const Params p = params(ptrs, ints, survivability);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p.n_tex > 0 ? launch<true, false>(p, s) : launch<false, false>(p, s);
}

// The chunk-tree form: ptrs and ints as megakernel's (prims and atlas
// unused, the shading rows and emitters' prim ids in the tree's sorted
// slots), hier_ptrs the tree's chunks (C, 16, 256), node bounds and node
// codes. The wrapper checks the tree's stack size against echo::kHierStack.
extern "C" int megakernel_hier(void* const* ptrs, const int* ints, void* const* hier_ptrs,
                               int root_code, float survivability, void* stream) {
  Params p = params(ptrs, ints, survivability);
  p.hier = echo::HierTables{static_cast<const float*>(hier_ptrs[0]),
                            static_cast<const float*>(hier_ptrs[1]),
                            static_cast<const int*>(hier_ptrs[2]), root_code, nullptr, nullptr};
  return launch<false, true>(p, static_cast<cudaStream_t>(stream));
}

// The chunk-tree form's resident blocks per SM, its block size and its
// dynamic shared memory per block, in out[0..2]; returns the CUDA error.
extern "C" int megakernel_hier_occupancy(int* out) {
  const void* fn = reinterpret_cast<const void*>(mega_kernel<false, true>);
  constexpr size_t smem = echo::hier_smem_bytes(kBlock / 32);
  static_assert(smem <= 48 * 1024, "within the default dynamic shared memory");
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kBlock, smem);
  out[0] = blocks;
  out[1] = kBlock;
  out[2] = static_cast<int>(smem);
  return static_cast<int>(err);
}

// The untextured (textured = 0) or textured form's resident blocks per SM at
// `padded` prims, its block size (= pool entries), its dynamic shared memory
// per block and the SMs, in out[0..3]; returns the CUDA error.
extern "C" int megakernel_occupancy(int textured, int padded, int* out) {
  int blocks = 0, sms = 0;
  const cudaError_t err = textured ? occupancy<true, false>(padded, blocks, sms)
                                   : occupancy<false, false>(padded, blocks, sms);
  out[0] = blocks;
  out[1] = kPool;
  out[2] = static_cast<int>(smem_bytes<false, false>(padded));
  out[3] = sms;
  return static_cast<int>(err);
}
