"""Host-side SAH BVH build (counterpart of the numpy build in
echorenderer_tpu/aggregation/bvh.py). The port traces through the dense
chunk kernels, which only need the BVH's leaf order of the prims, so the
tree is built here and its `prim_order` packs spatially tight chunks.

Leaf encoding in a child slot (int32):
  >= 0 : interior node index
  <  0 : leaf; bits = -(1 + (start << 4) + count), count <= 15
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np

LEAF_MAX = 4  # max primitives per leaf


def _encode_leaf(start: int, count: int) -> int:
    assert 0 < count <= 15
    return -(1 + (start << 4) + count)


class FlatBVH(NamedTuple):
    """Flattened binary BVH (numpy). Interior node i stores its children's
    bounds."""

    child_min: np.ndarray  # (B, 2, 3)
    child_max: np.ndarray  # (B, 2, 3)
    child_code: np.ndarray  # (B, 2) int32 (interior index or leaf code)
    prim_order: np.ndarray  # (P,) int32 leaf-contiguous primitive ids
    root_code: int


def build_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray,
              leaf_max: int = LEAF_MAX) -> FlatBVH:
    """Full-sweep SAH build over primitive AABBs: sort by centroid on the
    major axis of the centroid bounds, scan prefix/suffix surface areas,
    split at the minimum SAH cost (reference SweepBuilder.cs)."""
    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    n = aabb_min.shape[0]
    assert n > 0
    centroids = (aabb_min + aabb_max) * 0.5

    child_min, child_max, child_code = [], [], []
    prim_order: list[int] = []

    def half_area(bmin, bmax):
        e = np.maximum(bmax - bmin, 0.0)
        return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]

    def make_leaf(idx: np.ndarray) -> int:
        start = len(prim_order)
        prim_order.extend(int(i) for i in idx)
        return _encode_leaf(start, len(idx))

    def recurse(idx: np.ndarray) -> tuple[int, np.ndarray, np.ndarray]:
        """Returns (code, bounds_min, bounds_max) for the subtree over idx."""
        bmin, bmax = aabb_min[idx].min(0), aabb_max[idx].max(0)
        if len(idx) <= leaf_max:
            return make_leaf(idx), bmin, bmax

        cmin = centroids[idx].min(0)
        cmax = centroids[idx].max(0)
        axis = int(np.argmax(cmax - cmin))
        order = idx[np.argsort(centroids[idx, axis], kind="stable")]

        mins, maxs = aabb_min[order], aabb_max[order]
        pre_min = np.minimum.accumulate(mins, 0)
        pre_max = np.maximum.accumulate(maxs, 0)
        suf_min = np.minimum.accumulate(mins[::-1], 0)[::-1]
        suf_max = np.maximum.accumulate(maxs[::-1], 0)[::-1]
        counts = np.arange(1, len(order), dtype=np.float32)
        cost = half_area(pre_min[:-1], pre_max[:-1]) * counts + half_area(
            suf_min[1:], suf_max[1:]
        ) * counts[::-1]
        split = int(np.argmin(cost)) + 1

        node = len(child_code)
        child_min.append(np.zeros((2, 3), np.float32))
        child_max.append(np.zeros((2, 3), np.float32))
        child_code.append(np.zeros(2, np.int32))

        lcode, lmin, lmax = recurse(order[:split])
        rcode, rmin, rmax = recurse(order[split:])
        child_min[node][0], child_max[node][0] = lmin, lmax
        child_min[node][1], child_max[node][1] = rmin, rmax
        child_code[node][0], child_code[node][1] = lcode, rcode
        return node, bmin, bmax

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * n))
    try:
        root_code, _, _ = recurse(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    if not child_code:  # single leaf scene
        child_min.append(np.zeros((2, 3), np.float32))
        child_max.append(np.zeros((2, 3), np.float32))
        child_code.append(np.asarray([root_code, root_code], np.int32))

    return FlatBVH(
        child_min=np.stack(child_min),
        child_max=np.stack(child_max),
        child_code=np.stack(child_code),
        prim_order=np.asarray(prim_order, np.int32),
        root_code=int(root_code),
    )


def geometry_bounds(geom_np: dict) -> tuple[np.ndarray, np.ndarray]:
    """AABBs over the combined prim index space of a geometry given as
    numpy arrays (triangles first, then spheres)."""
    mins, maxs = [], []
    t = geom_np["tri_v0"].shape[0]
    if t:
        v0 = geom_np["tri_v0"]
        v1 = v0 + geom_np["tri_e1"]
        v2 = v0 + geom_np["tri_e2"]
        mins.append(np.minimum(np.minimum(v0, v1), v2))
        maxs.append(np.maximum(np.maximum(v0, v1), v2))
    s = geom_np["sph_center"].shape[0]
    if s:
        r = geom_np["sph_radius"][:, None]
        mins.append(geom_np["sph_center"] - r)
        maxs.append(geom_np["sph_center"] + r)
    return np.concatenate(mins, 0), np.concatenate(maxs, 0)
