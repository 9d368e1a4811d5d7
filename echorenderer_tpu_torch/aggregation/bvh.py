"""SAH BVH (counterpart of echorenderer_tpu/aggregation/bvh.py): the host
build, C++ with its numpy plain version, and the lockstep stack walk over
the tree. The port traces through the dense chunk kernels, which only need
the BVH's leaf order of the prims, so the tree is built here and its
`prim_order` packs spatially tight chunks. A prepared scene keeps the tree
on its device (`on_device`) for `trace_cost`, the traversal-cost AOV's
walk, and for `intersect_bvh` / `occlude_bvh`: the JAX package's
"bvh-lockstep" accelerator in plain PyTorch, an oracle of the hits over the
binary tree that no render dispatches to.

Leaf encoding in a child slot (int32):
  >= 0 : interior node index
  <  0 : leaf; bits = -(1 + (start << 4) + count), count <= 15
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..ops.intersect import (
    INF,
    RAY_EPSILON,
    FlatGeometry,
    Hit,
    ray_sphere_roots,
    ray_triangle,
    sphere_pick_root,
)

LEAF_MAX = 4  # max primitives per leaf
STACK_DEPTH = 48  # the walks' traversal stack (the JAX package's)


def _encode_leaf(start: int, count: int) -> int:
    assert 0 < count <= 15
    return -(1 + (start << 4) + count)


def _decode_leaf(code):
    """(start, count) of leaf codes."""
    bits = -code - 1
    return bits >> 4, bits & 15


class FlatBVH(NamedTuple):
    """Flattened binary BVH (numpy arrays; tensors on a prepared scene,
    `on_device`). Interior node i stores its children's bounds."""

    child_min: np.ndarray  # (B, 2, 3)
    child_max: np.ndarray  # (B, 2, 3)
    child_code: np.ndarray  # (B, 2) int32 (interior index or leaf code)
    prim_order: np.ndarray  # (P,) int32 leaf-contiguous primitive ids
    root_code: int

    @property
    def num_nodes(self) -> int:
        return self.child_min.shape[0]


def build_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray,
              leaf_max: int = LEAF_MAX) -> FlatBVH:
    """Full-sweep SAH build over primitive AABBs: sort by centroid on the
    major axis of the centroid bounds, scan prefix/suffix surface areas,
    split at the minimum SAH cost (reference SweepBuilder.cs). Runs the C++
    builder (native/, csrc/bvh_builder.cpp), or `build_bvh_numpy`, its
    plain version, when no g++ is on PATH; the two give the same arrays
    bit for bit. `build_bvh.native_calls` and `build_bvh.numpy_calls`
    count the builds each took."""
    from ..native import build_bvh_native

    aabb_min = np.asarray(aabb_min, np.float32)
    aabb_max = np.asarray(aabb_max, np.float32)
    assert aabb_min.shape[0] > 0
    out = build_bvh_native(aabb_min, aabb_max, leaf_max)
    if out is None:
        build_bvh.numpy_calls += 1
        return build_bvh_numpy(aabb_min, aabb_max, leaf_max)
    build_bvh.native_calls += 1
    cmin, cmax, ccode, order, root = out
    return FlatBVH(child_min=cmin, child_max=cmax, child_code=ccode, prim_order=order,
                   root_code=root)


build_bvh.native_calls = 0
build_bvh.numpy_calls = 0


def build_bvh_numpy(aabb_min: np.ndarray, aabb_max: np.ndarray,
                    leaf_max: int = LEAF_MAX) -> FlatBVH:
    """`build_bvh` in numpy: the C++ builder's plain version."""
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


def on_device(bvh: FlatBVH, device) -> FlatBVH:
    """The same tree with its arrays as tensors on `device` (root_code
    stays an int): what a prepared scene keeps."""
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return FlatBVH(child_min=put(bvh.child_min), child_max=put(bvh.child_max),
                   child_code=put(bvh.child_code), prim_order=put(bvh.prim_order),
                   root_code=int(bvh.root_code))


def join(parts: list, bounds: list) -> FlatBVH:
    """One tree over several built trees (numpy FlatBVHs whose prim_order
    already holds global prim ids, with their root boxes): a chain of join
    nodes, node j holding part j and the join of the rest, then each
    part's nodes with their codes moved past those before them."""
    k = len(parts)
    if k == 1:
        return parts[0]
    n_join = k - 1
    node_off, prim_off = [], []
    nodes = n_join
    prims = 0
    for b in parts:
        node_off.append(nodes)
        prim_off.append(prims)
        nodes += b.child_code.shape[0]
        prims += b.prim_order.shape[0]

    def moved(code, i):
        code = np.asarray(code, np.int64)
        start, count = _decode_leaf(code)
        leaf = -(1 + ((start + prim_off[i]) << 4) + count)
        return np.where(code >= 0, code + node_off[i], leaf).astype(np.int32)

    cmin = np.zeros((nodes, 2, 3), np.float32)
    cmax = np.zeros((nodes, 2, 3), np.float32)
    ccode = np.zeros((nodes, 2), np.int32)
    for i, b in enumerate(parts):
        sl = slice(node_off[i], node_off[i] + b.child_code.shape[0])
        cmin[sl], cmax[sl], ccode[sl] = b.child_min, b.child_max, moved(b.child_code, i)
    lo = [np.asarray(bmin, np.float32) for bmin, _ in bounds]
    hi = [np.asarray(bmax, np.float32) for _, bmax in bounds]
    for j in range(n_join):
        rest = range(j + 1, k)
        cmin[j, 0], cmax[j, 0] = lo[j], hi[j]
        cmin[j, 1] = np.min([lo[i] for i in rest], 0)
        cmax[j, 1] = np.max([hi[i] for i in rest], 0)
        ccode[j, 0] = moved(parts[j].root_code, j)
        ccode[j, 1] = j + 1 if j + 1 < n_join else moved(parts[k - 1].root_code, k - 1)
    return FlatBVH(child_min=cmin, child_max=cmax, child_code=ccode,
                   prim_order=np.concatenate([b.prim_order for b in parts]).astype(np.int32),
                   root_code=0)


def _inv_dir(d):
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    return 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)


def _slab_test(o, inv_d, bmin, bmax, t_max):
    """Batched ray/AABB slab test. o, inv_d: (..., 3); returns (hit, t_near)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (t_near <= t_far) & (t_far > 0.0) & (t_near < t_max)
    return hit, torch.clamp(t_near, min=0.0)


def _new_stack(bvh: FlatBVH, n: int, dev):
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int32, device=dev)
    stack[:, 0] = bvh.root_code
    return stack, torch.ones(n, dtype=torch.int64, device=dev)


def _pop(stack, sp, active):
    """The top code of each active lane's stack (0, the root's index, past
    the stack's last slot, as the JAX package's one-hot read gives) and
    the popped stack pointers."""
    top = STACK_DEPTH - 1
    sp_idx = torch.clamp(sp - 1, min=0)
    code = torch.gather(stack, 1, torch.clamp(sp_idx, max=top)[:, None])[:, 0]
    code = torch.where(active & (sp_idx <= top), code, 0)
    return code, torch.where(active, sp - 1, sp)


def _push(stack, sp, child, child_hit):
    """Push `child` where `child_hit`; pushes past the top land on the last
    slot."""
    idx = torch.clamp(sp, max=STACK_DEPTH - 1)[:, None]
    cur = torch.gather(stack, 1, idx)
    stack.scatter_(1, idx, torch.where(child_hit[:, None], child[:, None], cur))
    return sp + child_hit.to(torch.int64)


def _leaf_intersect(geom: FlatGeometry, bvh: FlatBVH, o, d, code, best, any_hit_tmax=None):
    """Intersect the (masked) leaf `code` of every ray lane, slot by slot.
    best = (t, prim, uv, ignore), the running closest hit. Returns the
    updated best, or the lanes blocked before `any_hit_tmax` when given.
    An ignored sphere is tested for its far root (findFar); an ignored
    triangle is skipped."""
    n = o.shape[0]
    dev = o.device
    num_tri, num_sph = geom.num_triangles, geom.num_spheres
    start, count = _decode_leaf(code)
    is_leaf = code < 0
    best_t, best_prim, best_uv, ignore = best
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(LEAF_MAX):
        live = is_leaf & (i < count)
        slot = torch.clamp(start + i, 0, bvh.prim_order.shape[0] - 1).long()
        pid = bvh.prim_order[slot]
        is_tri = pid < num_tri
        if num_tri:
            ti = torch.clamp(pid, 0, num_tri - 1).long()
            t_t, u, v, tv = ray_triangle(o, d, geom.tri_v0[ti], geom.tri_e1[ti], geom.tri_e2[ti])
        else:
            t_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
            u = v = torch.zeros(n, dtype=torch.float32, device=dev)
            tv = torch.zeros(n, dtype=torch.bool, device=dev)
        if num_sph:
            si = torch.clamp(pid - num_tri, 0, num_sph - 1).long()
            t_n, t_f, sok = ray_sphere_roots(o, d, geom.sph_center[si], geom.sph_radius[si])
            t_s, sv = sphere_pick_root(t_n, t_f, sok, pid == ignore)
        else:
            t_s = torch.full((n,), INF, dtype=torch.float32, device=dev)
            sv = torch.zeros(n, dtype=torch.bool, device=dev)
        t = torch.where(is_tri, t_t, t_s)
        valid = live & torch.where(is_tri, tv & (pid != ignore), sv) & (t > RAY_EPSILON)
        if any_hit_tmax is not None:
            blocked |= valid & (t < any_hit_tmax)
        else:
            closer = valid & (t < best_t)  # strictly: the first of equal t stays
            best_t = torch.where(closer, t, best_t)
            best_prim = torch.where(closer, pid, best_prim)
            best_uv = torch.where(closer[:, None], torch.stack([u, v], dim=-1), best_uv)
    if any_hit_tmax is not None:
        return blocked
    return best_t, best_prim, best_uv, ignore


def _traverse(geom: FlatGeometry, bvh: FlatBVH, o, d, t_max, ignore, any_hit: bool):
    """The lockstep stack walk shared by trace (closest) and occlude (any):
    every lane pops a code a step; an interior node pushes the children
    its ray enters before the lane's best t, the farther first, so the
    nearer is popped first; a leaf tests its LEAF_MAX slots. An any-hit
    lane stops at its first blocker. The loop reads whether any lane is
    alive once a step."""
    n = o.shape[0]
    dev = o.device
    inv_d = _inv_dir(d)
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(n)
    ignore = torch.as_tensor(ignore, device=dev).to(torch.int32)
    stack, sp = _new_stack(bvh, n, dev)
    best_t = t_max.clone()
    best_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    while True:
        active = (sp > 0) & ~blocked if any_hit else sp > 0
        if not bool(active.any()):
            break
        code, sp = _pop(stack, sp, active)
        is_interior = active & (code >= 0)
        node = torch.clamp(code, 0, bvh.num_nodes - 1).long()
        limit = torch.where(blocked, -INF, best_t) if any_hit else best_t
        hit, t_near = _slab_test(o[:, None, :], inv_d[:, None, :], bvh.child_min[node],
                                 bvh.child_max[node], limit[:, None])
        hit &= is_interior[:, None]
        ccode = bvh.child_code[node]
        near_first = t_near[:, 0] <= t_near[:, 1]
        first = torch.where(near_first, ccode[:, 1], ccode[:, 0])
        first_hit = torch.where(near_first, hit[:, 1], hit[:, 0])
        second = torch.where(near_first, ccode[:, 0], ccode[:, 1])
        second_hit = torch.where(near_first, hit[:, 0], hit[:, 1])
        sp = _push(stack, sp, first, first_hit)
        sp = _push(stack, sp, second, second_hit)
        leaf_code = torch.where(active & (code < 0), code, 0)
        best = (best_t, best_prim, best_uv, ignore)
        if any_hit:
            blocked |= _leaf_intersect(geom, bvh, o, d, leaf_code, best, best_t)
        else:
            best_t, best_prim, best_uv, _ = _leaf_intersect(geom, bvh, o, d, leaf_code, best)
    if any_hit:
        return blocked
    return Hit(t=torch.where(best_prim >= 0, best_t, INF), prim=best_prim, uv=best_uv)


def intersect_bvh(geom: FlatGeometry, bvh: FlatBVH, o, d, t_max, ignore) -> Hit:
    """Closest hit over a tree on the rays' device (`on_device`; reference
    Accelerator.Trace): prim ids original, t strictly below t_max and above
    RAY_EPSILON, INF on a miss."""
    return _traverse(geom, bvh, o, d, t_max, ignore, any_hit=False)


def occlude_bvh(geom: FlatGeometry, bvh: FlatBVH, o, d, t_max, ignore) -> torch.Tensor:
    """Any hit in (RAY_EPSILON, t_max) over the tree, each lane stopping at
    its first blocker (reference Accelerator.Occlude)."""
    return _traverse(geom, bvh, o, d, t_max, ignore, any_hit=True)


def trace_cost(bvh: FlatBVH, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Per-ray traversal cost of a tree on the rays' device (`on_device`):
    1 per interior node visited and LEAF_MAX per leaf, every box the ray
    enters at any t > 0 (counterpart of the JAX package's `trace_cost`,
    step for step: a STACK_DEPTH stack whose pushes past the top land on
    its last slot, both children of a node pushed in slot order). The loop
    reads whether any ray's stack holds a node once a level."""
    n = o.shape[0]
    dev = o.device
    inv_d = _inv_dir(d)
    stack, sp = _new_stack(bvh, n, dev)
    cost = torch.zeros(n, dtype=torch.float32, device=dev)
    while bool((sp > 0).any()):
        active = sp > 0
        code, sp = _pop(stack, sp, active)
        is_interior = active & (code >= 0)
        node = torch.clamp(code, 0, bvh.num_nodes - 1).long()
        hit, _ = _slab_test(o[:, None, :], inv_d[:, None, :], bvh.child_min[node],
                            bvh.child_max[node], INF)
        hit &= is_interior[:, None]
        ccode = bvh.child_code[node]
        for side in range(2):
            sp = _push(stack, sp, ccode[:, side], hit[:, side])
        cost = cost + torch.where(is_interior, 1.0, 0.0)
        cost = cost + torch.where(active & (code < 0), float(LEAF_MAX), 0.0)
    return cost
