// Native SAH BVH builder — the host-side scene-preparation hot path.
//
// Plays the role the reference's compiled SweepBuilder plays
// (Aggregation/Acceleration/SweepBuilder.cs:14-80: sort primitive indices
// by centroid on the major axis, prefix/suffix surface-area sweep, split
// at the minimum cost). The Python/numpy build in aggregation/bvh.py is
// recursion-bound for large meshes; this C++ version builds multi-million
// primitive trees at native speed and emits the exact same flattened
// layout (interior node stores BOTH child bounds; leaves encode
// -(1 + (start << 4) + count)).
//
// Build: g++ -O3 -march=native -ffp-contract=off -shared -fPIC -o libechonative.so bvh_builder.cpp
// (echorenderer_tpu_torch/native builds it at first use). -ffp-contract=off
// keeps the SAH half-area sums and costs unfused, so they round as the
// numpy build's do and the two builders choose the same splits.
// ABI: plain C, called through ctypes (echorenderer_tpu_torch/native).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Builder {
    const float* aabb_min;  // (n, 3)
    const float* aabb_max;  // (n, 3)
    std::vector<float> cx, cy, cz;  // centroids
    int leaf_max;

    // outputs
    float* child_min;    // (cap, 2, 3)
    float* child_max;    // (cap, 2, 3)
    int32_t* child_code; // (cap, 2)
    int32_t* prim_order; // (n)
    int32_t node_count = 0;
    int32_t order_count = 0;

    std::vector<int32_t> idx;
    std::vector<float> sweep_area;  // suffix areas scratch

    inline const float* mn(int i) const { return aabb_min + 3 * i; }
    inline const float* mx(int i) const { return aabb_max + 3 * i; }

    static inline float half_area(const float lo[3], const float hi[3]) {
        float ex = hi[0] - lo[0], ey = hi[1] - lo[1], ez = hi[2] - lo[2];
        if (ex < 0) ex = 0; if (ey < 0) ey = 0; if (ez < 0) ez = 0;
        return ex * ey + ey * ez + ez * ex;
    }

    int32_t make_leaf(int32_t* ids, int count) {
        int start = order_count;
        std::memcpy(prim_order + start, ids, count * sizeof(int32_t));
        order_count += count;
        return -(1 + (start << 4) + count);
    }

    void bounds_of(const int32_t* ids, int count, float lo[3], float hi[3]) {
        lo[0] = lo[1] = lo[2] = 3.4e38f;
        hi[0] = hi[1] = hi[2] = -3.4e38f;
        for (int k = 0; k < count; ++k) {
            const float* a = mn(ids[k]);
            const float* b = mx(ids[k]);
            for (int c = 0; c < 3; ++c) {
                if (a[c] < lo[c]) lo[c] = a[c];
                if (b[c] > hi[c]) hi[c] = b[c];
            }
        }
    }

    // returns code; fills subtree bounds
    int32_t recurse(int32_t* ids, int count, float lo[3], float hi[3]) {
        bounds_of(ids, count, lo, hi);
        if (count <= leaf_max) return make_leaf(ids, count);

        // centroid bounds -> major axis
        float clo[3] = {3.4e38f, 3.4e38f, 3.4e38f};
        float chi[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
        const float* cs[3] = {cx.data(), cy.data(), cz.data()};
        for (int k = 0; k < count; ++k) {
            for (int c = 0; c < 3; ++c) {
                float v = cs[c][ids[k]];
                if (v < clo[c]) clo[c] = v;
                if (v > chi[c]) chi[c] = v;
            }
        }
        int axis = 0;
        float best_e = chi[0] - clo[0];
        for (int c = 1; c < 3; ++c) {
            float e = chi[c] - clo[c];
            if (e > best_e) { best_e = e; axis = c; }
        }
        const float* cax = cs[axis];
        std::stable_sort(ids, ids + count,
                         [cax](int32_t a, int32_t b) { return cax[a] < cax[b]; });

        // suffix half-areas
        sweep_area.resize(count);
        {
            float lo2[3] = {3.4e38f, 3.4e38f, 3.4e38f};
            float hi2[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
            for (int k = count - 1; k >= 1; --k) {
                const float* a = mn(ids[k]);
                const float* b = mx(ids[k]);
                for (int c = 0; c < 3; ++c) {
                    if (a[c] < lo2[c]) lo2[c] = a[c];
                    if (b[c] > hi2[c]) hi2[c] = b[c];
                }
                sweep_area[k] = half_area(lo2, hi2);
            }
        }
        // prefix sweep to find the min-cost split
        int best_split = count / 2;
        float best_cost = 3.4e38f;
        {
            float lo2[3] = {3.4e38f, 3.4e38f, 3.4e38f};
            float hi2[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
            for (int k = 0; k < count - 1; ++k) {
                const float* a = mn(ids[k]);
                const float* b = mx(ids[k]);
                for (int c = 0; c < 3; ++c) {
                    if (a[c] < lo2[c]) lo2[c] = a[c];
                    if (b[c] > hi2[c]) hi2[c] = b[c];
                }
                float cost = half_area(lo2, hi2) * (k + 1) +
                             sweep_area[k + 1] * (count - 1 - k);
                if (cost < best_cost) { best_cost = cost; best_split = k + 1; }
            }
        }

        int32_t node = node_count++;
        float llo[3], lhi[3], rlo[3], rhi[3];
        int32_t lcode = recurse(ids, best_split, llo, lhi);
        int32_t rcode = recurse(ids + best_split, count - best_split, rlo, rhi);
        float* cmin = child_min + node * 6;
        float* cmax = child_max + node * 6;
        std::memcpy(cmin, llo, 12);
        std::memcpy(cmin + 3, rlo, 12);
        std::memcpy(cmax, lhi, 12);
        std::memcpy(cmax + 3, rhi, 12);
        child_code[node * 2] = lcode;
        child_code[node * 2 + 1] = rcode;
        return node;
    }
};

}  // namespace

extern "C" {

// Returns the root code; node/prim buffers must be preallocated with
// capacity n (nodes) and n (prim_order). node_count_out receives the
// number of interior nodes written.
int32_t build_bvh_sah(
    int32_t n,
    const float* aabb_min,
    const float* aabb_max,
    int32_t leaf_max,
    float* child_min,
    float* child_max,
    int32_t* child_code,
    int32_t* prim_order,
    int32_t* node_count_out) {
    Builder b;
    b.aabb_min = aabb_min;
    b.aabb_max = aabb_max;
    b.leaf_max = leaf_max < 1 ? 1 : (leaf_max > 15 ? 15 : leaf_max);
    b.child_min = child_min;
    b.child_max = child_max;
    b.child_code = child_code;
    b.prim_order = prim_order;
    b.cx.resize(n);
    b.cy.resize(n);
    b.cz.resize(n);
    for (int i = 0; i < n; ++i) {
        b.cx[i] = 0.5f * (aabb_min[3 * i] + aabb_max[3 * i]);
        b.cy[i] = 0.5f * (aabb_min[3 * i + 1] + aabb_max[3 * i + 1]);
        b.cz[i] = 0.5f * (aabb_min[3 * i + 2] + aabb_max[3 * i + 2]);
    }
    b.idx.resize(n);
    for (int i = 0; i < n; ++i) b.idx[i] = i;
    float lo[3], hi[3];
    int32_t root = b.recurse(b.idx.data(), n, lo, hi);
    *node_count_out = b.node_count;
    return root;
}

}  // extern "C"
