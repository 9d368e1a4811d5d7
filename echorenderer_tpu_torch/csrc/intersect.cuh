// The one ray-primitive test of the port's CUDA kernels, shared by the dense
// trace/occlude kernels (dense_intersect.cu), the chunk-tree walk
// (hier_walk.cu) and the path-tracing megakernel's chunk-tree form
// (megakernel.cu), so that all report identical hits by construction; its
// twin over 16-byte prim records (record_hit, the megakernel's other forms),
// the same float ops on the same values; and the one ray-box slab test of
// the two trace/occlude files.
//
// Prims are 10 rows of floats (a xyz, b xyz, c xyz, is_sphere) with a row
// stride; a triangle keeps v0/e1/e2 in a/b/c, a sphere its center in a and
// its radius in b.x. Triangles use Moller-Trumbore; spheres the findFar rule
// (an ignored sphere still reports its far root, an ignored triangle is
// skipped). The float ops run in the order of the plain PyTorch version
// (`ops/pallas_intersect._chunk_hits`); the sources are built with
// -fmad=false so each of them rounds on its own.

#pragma once

namespace echo {

constexpr float kEps = 2.4e-4f;  // RAY_EPSILON

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmax;
  int ignore;  // sorted prim slot to skip (-1 = none)
};

// NaN-propagating min/max, as torch.minimum / torch.maximum
__device__ __forceinline__ float pmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float pmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// 1/d with the 1e12 clamp of `ops/pallas_intersect._safe_inv`
__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) < 1e-12f ? (d < 0.0f ? -1e12f : 1e12f) : 1.0f / d;
}

// Relative slack of every cull test: a box is entered while its entry t is
// at most limit * kCullMargin (`ops/pallas_intersect.CULL_MARGIN`). A hit
// on a box's boundary can come out a few rounding steps before the box's
// computed entry t; without the slack, kernels that cull by different boxes
// (dense chunks, the chunk tree) would each lose different near-ties.
constexpr float kCullMargin = 1.000244140625f;  // 1 + 2^-12

// Slab test of a ray (origin o, inverse direction i) against the box
// [lo, hi]: the entry and exit parameters tn, tf, in the plain version's op
// order (`ops/pallas_intersect._box_reach`).
__device__ __forceinline__ void slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     float ox, float oy, float oz,
                                     float ix, float iy, float iz, float& tn, float& tf) {
  const float t0x = (lox - ox) * ix;
  const float t1x = (hix - ox) * ix;
  const float t0y = (loy - oy) * iy;
  const float t1y = (hiy - oy) * iy;
  const float t0z = (loz - oz) * iz;
  const float t1z = (hiz - oz) * iz;
  tn = pmax(pmax(pmin(t0x, t1x), pmin(t0y, t1y)), pmin(t0z, t1z));
  tf = pmin(pmin(pmax(t0x, t1x), pmax(t0y, t1y)), pmax(t0z, t1z));
}

// Does a ray whose slab test gave (tn, tf) enter the box before `limit`?
__device__ __forceinline__ bool reaches(float tn, float tf, float limit) {
  return (tn <= tf) && (tf > 0.0f) && (tn <= limit * kCullMargin);
}

// Prim k (sorted slot `slot`) of `rows` (row stride `stride`) against one
// ray; t, u, v are valid only where the return is true. Spheres report
// u = v = 0. UNIT_DIR = false is for a ray moved into an instance's space,
// whose |d| is 1/scale: a sphere then solves the full quadratic
// a t^2 + 2 b t + c (`_chunk_hits(..., unit_dir=False)`), so t stays the
// world-space parameter.
template <bool HAS_TRI, bool HAS_SPH, bool UNIT_DIR = true>
__device__ __forceinline__ bool prim_hit(const float* rows, int stride, int k, int slot,
                                         const Ray& r, float& t, float& u, float& v) {
  const float ax = rows[0 * stride + k], ay = rows[1 * stride + k], az = rows[2 * stride + k];
  const float bx = rows[3 * stride + k], by = rows[4 * stride + k], bz = rows[5 * stride + k];
  const bool ignored = slot == r.ignore;
  const bool is_sph = HAS_SPH && (!HAS_TRI || rows[9 * stride + k] > 0.5f);
  u = 0.0f;
  v = 0.0f;
  if (HAS_SPH && is_sph) {
    float fx = r.ox - ax, fy = r.oy - ay, fz = r.oz - az;
    float bq = fx * r.dx + fy * r.dy + fz * r.dz;
    float cq = fx * fx + fy * fy + fz * fz - bx * bx;
    float disc, t_near, t_far;
    if (UNIT_DIR) {
      disc = bq * bq - cq;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      t_near = -bq - sq;
      t_far = -bq + sq;
    } else {
      const float aq = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
      disc = bq * bq - aq * cq;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float inv_a = 1.0f / aq;
      t_near = (-bq - sq) * inv_a;
      t_far = (-bq + sq) * inv_a;
    }
    t = ignored ? t_far : (t_near > kEps ? t_near : t_far);
    return (disc >= 0.0f) && (t > kEps);
  }
  if (HAS_TRI) {
    const float cx = rows[6 * stride + k], cy = rows[7 * stride + k], cz = rows[8 * stride + k];
    float px = r.dy * cz - r.dz * cy;
    float py = r.dz * cx - r.dx * cz;
    float pz = r.dx * cy - r.dy * cx;
    float det = bx * px + by * py + bz * pz;
    bool det_ok = fabsf(det) > 1e-12f;
    float inv = det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
    float sx = r.ox - ax, sy = r.oy - ay, sz = r.oz - az;
    u = (sx * px + sy * py + sz * pz) * inv;
    float qx = sy * bz - sz * by;
    float qy = sz * bx - sx * bz;
    float qz = sx * by - sy * bx;
    v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
    t = (cx * qx + cy * qy + cz * qz) * inv;
    return det_ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > kEps) && !ignored;
  }
  return false;
}

// A prim as one record of three 16-byte words, read by three 128-bit
// (broadcast) loads from shared memory instead of up to ten scalar ones:
// (ax ay az is_sphere) (bx by bz cx) (cy cz slot -), the slot as int bits.
constexpr int kRecordWords = 3;

__device__ __forceinline__ void make_record(const float* rows, int stride, int k, int slot,
                                            float4* rec) {
  rec[0] = make_float4(rows[0 * stride + k], rows[1 * stride + k], rows[2 * stride + k],
                       rows[9 * stride + k]);
  rec[1] = make_float4(rows[3 * stride + k], rows[4 * stride + k], rows[5 * stride + k],
                       rows[6 * stride + k]);
  rec[2] = make_float4(rows[7 * stride + k], rows[8 * stride + k], __int_as_float(slot), 0.0f);
}

// prim_hit's test of the record `rec` (UNIT_DIR only): the same values
// through the same float ops, so the same t, u, v and verdict; `slot`
// returns the record's sorted slot. A sphere whose discriminant is negative
// returns false at once, skipping the ops only a hit needs (a warp whose
// lanes all miss skips them too); a triangle runs all its ops, which won
// over early outs on triangle scenes.
template <bool HAS_TRI, bool HAS_SPH>
__device__ __forceinline__ bool record_hit(const float4* rec, const Ray& r, float& t, float& u,
                                           float& v, int& slot) {
  const float4 w0 = rec[0], w1 = rec[1], w2 = rec[2];
  const float ax = w0.x, ay = w0.y, az = w0.z;
  const float bx = w1.x, by = w1.y, bz = w1.z;
  slot = __float_as_int(w2.z);
  const bool ignored = slot == r.ignore;
  const bool is_sph = HAS_SPH && (!HAS_TRI || w0.w > 0.5f);
  u = 0.0f;
  v = 0.0f;
  if (HAS_SPH && is_sph) {
    float fx = r.ox - ax, fy = r.oy - ay, fz = r.oz - az;
    float bq = fx * r.dx + fy * r.dy + fz * r.dz;
    float cq = fx * fx + fy * fy + fz * fz - bx * bx;
    const float disc = bq * bq - cq;
    if (!(disc >= 0.0f)) return false;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float t_near = -bq - sq;
    const float t_far = -bq + sq;
    t = ignored ? t_far : (t_near > kEps ? t_near : t_far);
    return (disc >= 0.0f) && (t > kEps);
  }
  if (HAS_TRI) {
    const float cx = w1.w, cy = w2.x, cz = w2.y;
    float px = r.dy * cz - r.dz * cy;
    float py = r.dz * cx - r.dx * cz;
    float pz = r.dx * cy - r.dy * cx;
    float det = bx * px + by * py + bz * pz;
    bool det_ok = fabsf(det) > 1e-12f;
    float inv = det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
    float sx = r.ox - ax, sy = r.oy - ay, sz = r.oz - az;
    u = (sx * px + sy * py + sz * pz) * inv;
    float qx = sy * bz - sz * by;
    float qy = sz * bx - sx * bz;
    float qz = sx * by - sy * bx;
    v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv;
    t = (cx * qx + cy * qy + cz * qz) * inv;
    return det_ok && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) && (t > kEps) && !ignored;
  }
  return false;
}

}  // namespace echo
