"""Chunk-tree walk for large scenes and TLAS-instanced scenes
(counterpart of echorenderer_tpu/ops/pallas_hier.py).

The prims sit in BVH-leaf order, cut into HCHUNK-prim chunks; a binary SAH
tree over the chunk boxes (`aggregation/bvh.build_bvh` with one chunk per
leaf) is flattened into two tables: 12 floats of child bounds and 2 child
codes per interior node (a leaf code is -(1 + chunk)). `HierSoA` holds them
with the chunk rows, as the JAX package lays them out, table for table.

Instanced tables (`build_hier_soa_instanced`): every pack's prims, in pack
space, are chunked on their own (a pack's chunks padded to HCHUNK) and get
their own subtree; a TLAS over the instances' world boxes sits on top,
its leaves -(1 + INST_BASE + instance). At an instance leaf the walk moves
the world ray into the instance's space with its 12-float inverse affine
(x_local = A x + b, A row-major, summed left to right, then + b), pushes
a RESTORE entry and the pack's root; popping RESTORE returns to the world
ray. Directions are not normalised, so t stays the world parameter in
every space and one best t culls across spaces; spheres take the full
quadratic (`_chunk_hits(..., unit_dir=False)`). A ray's ignored prim is
skipped only inside its own instance, and a hit reports its instance.

Two kernels walk the tree for a batch of rays: `hier_trace` (closest hit)
and `hier_occlude` (any hit). On a CUDA tensor each launches the
hand-written kernel in csrc/hier_walk.cu (one thread per ray and a stack
per thread for the traversal; each chunk leaf tested by the whole warp
from shared memory), built with nvcc on first use (ops/cuda_build.py); on
a CPU tensor it runs the plain PyTorch version beside it, a lockstep walk in which
every unfinished ray pops one entry of its own stack per step. Both apply
the same rules: the box test of `pallas_intersect._box_reach` (with its
CULL_MARGIN slack), the far child pushed first, an entry skipped once the
best t has moved below its entry t, the ray-prim test of
`pallas_intersect._chunk_hits`, and the lexicographic least (t, sorted
slot, instance) as the closest hit. That result does not depend on the
visit order, so it equals the dense kernels' bit for bit.
The TPU kernel walks 1024-ray packets and keeps, among equal t in two
chunks (or two instances), the one it visited first; the two differ only
on such exact ties.

`intersect_hier` / `occlude_hier` keep the JAX package's public contract:
original prim ids in and out (the sorted<->original maps), `Hit.inst`
(zeros without instancing), t = INF and prim = -1 on a miss. The kernels
replace the TPU's `_hier_kernel` (echorenderer_tpu/ops/pallas_hier.py:498),
both its forms.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..aggregation.bvh import build_bvh
from ..utils import diagnostics, vec
from . import cuda_build
from .intersect import INF, FlatGeometry, Hit
from .pallas_intersect import (CULL_MARGIN, _chunk_hits, _safe_inv, pack_sorted_prims,
                               ray_columns)

HCHUNK = 256  # prims per leaf chunk
# the JAX package builds the chunk tree from this many prims on
HIER_BUILD_MIN = 16384
# leaf-code sub-encoding of the instanced tables (e = -(code + 1)):
#   e < INST_BASE: chunk leaf; INST_BASE <= e < RESTORE_E: instance leaf;
#   e == RESTORE_E: restore-world sentinel
INST_BASE = 1 << 23
RESTORE_E = 1 << 24
RESTORE_CODE = -(1 + RESTORE_E)
# chunks per superchunk of the binned traversal (ops/binned_trace.SUP): an
# instance's chunk range in the binned tables is padded to a multiple
BINNED_SUP = 16
# global chunk count above which the binned tables stay empty (the chunk id
# field of a candidate key holds 20 bits)
BINNED_MAX_CHUNKS = 1 << 20
MAX_STACK = 64  # per-thread stack entries of csrc/hier_walk.cuh (kHierStack)
SLOT_LIMIT = 2 ** 24  # the TPU kernel carries sorted slots as f32: exact below
PLAIN_SLICE = 2 ** 16  # rays per pass of the plain version


class HierSoA(NamedTuple):
    """Tables of the chunk-tree walk, on one device."""

    prim_chunks: torch.Tensor  # (C, 16, HCHUNK) f32: rows 0-9 a/b/c xyz, is_sphere
    chunk_bounds: torch.Tensor  # (C, 6) f32 per-chunk AABB (lo xyz, hi xyz)
    bounds: torch.Tensor  # (B*12,) f32: per node, per child: min xyz / max xyz
    codes: torch.Tensor  # (B*2,) int32: child codes (>= 0 node, < 0 -(1+e))
    order: torch.Tensor  # (P,) int32 sorted slot -> original prim id
    inv_order: torch.Tensor  # (P,) int32 original prim id -> sorted slot
    inst_f32: torch.Tensor  # (I*12,) f32 per-instance inverse affine (A row-major, b)
    inst_codes: torch.Tensor  # (I,) int32 per-instance pack root code
    # instanced binned tables (empty when not instanced, or past
    # BINNED_MAX_CHUNKS): the scene unrolled into G global chunks, each
    # instance's pack chunk range padded to BINNED_SUP
    binned_g2c: torch.Tensor  # (G,) int32 global chunk -> pack chunk
    binned_g2i: torch.Tensor  # (G,) int32 global chunk -> instance
    binned_wcb: torch.Tensor  # (G, 6) f32 world box per global chunk
    root_code: int  # root node code (an interior node; instanced: may be a leaf)
    stack_size: int  # tree depth + margin
    num_tris: int
    num_prims: int
    instanced: bool = False

    @property
    def num_chunks(self) -> int:
        return self.prim_chunks.shape[0]

    @property
    def padded(self) -> int:
        return self.num_chunks * HCHUNK


def _pack_chunk_rows(a, b, c, is_sph, *, pad, n_chunks) -> np.ndarray:
    """The (C, 16, HCHUNK) chunk records: padded slots have v0 far away and
    e1 = e2 = 0, so det = 0 and they never hit."""
    p = a.shape[0]
    rows = np.zeros((16, pad), np.float32)
    rows[0:3, p:] = 1e30
    rows[0:3, :p] = a.T
    rows[3:6, :p] = b.T
    rows[6:9, :p] = c.T
    rows[9, :p] = is_sph
    return np.ascontiguousarray(rows.reshape(16, n_chunks, HCHUNK).transpose(1, 0, 2))


def _pack_chunks(geom_np: dict, order: np.ndarray, packed=None):
    """Prims permuted into `order`, packed into chunk records, plus each
    chunk's AABB: (chunks, clo, chi) as numpy arrays. `packed` =
    pack_sorted_prims(geom_np, order), when the caller has it."""
    p = len(order)
    a, b, c, is_sph, lo, hi = packed if packed is not None else pack_sorted_prims(geom_np, order)
    pad = -(-max(p, 1) // HCHUNK) * HCHUNK
    n_chunks = pad // HCHUNK
    chunks = _pack_chunk_rows(np.ascontiguousarray(a), np.ascontiguousarray(b),
                              np.ascontiguousarray(c), is_sph, pad=pad, n_chunks=n_chunks)
    nfull = p // HCHUNK
    clo = np.full((n_chunks, 3), 1e30, np.float32)
    chi = np.full((n_chunks, 3), -1e30, np.float32)
    if nfull:
        clo[:nfull] = lo[: nfull * HCHUNK].reshape(nfull, HCHUNK, 3).min(1)
        chi[:nfull] = hi[: nfull * HCHUNK].reshape(nfull, HCHUNK, 3).max(1)
    if p > nfull * HCHUNK:
        clo[nfull] = lo[nfull * HCHUNK:].min(0)
        chi[nfull] = hi[nfull * HCHUNK:].max(0)
    return chunks, clo, chi


def _tree_depth(child_code: np.ndarray, root: int, node_base: int = 0) -> int:
    """Depth (levels, leaves included) of the flattened tree at `root`,
    whose nodes are stored from `node_base` on."""
    depth = 0
    stack = [(root, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        if node >= 0:
            stack.append((int(child_code[node - node_base, 0]), d + 1))
            stack.append((int(child_code[node - node_base, 1]), d + 1))
    return depth


def _leaf_tree(lo: np.ndarray, hi: np.ndarray, leaf_base: int, node_base: int = 0):
    """Binary SAH tree over boxes, one box per leaf, its nodes numbered
    from `node_base`: (bounds (B, 2, 6), codes (B, 2) with leaf code
    -(1 + leaf_base + box), root code, depth). The root is a node."""
    bvh = build_bvh(lo, hi, leaf_max=1)
    child_code = bvh.child_code.copy()
    root = int(bvh.root_code)
    leaf = child_code < 0
    start = (-(child_code + 1)) >> 4
    child_code[leaf] = -(1 + leaf_base + bvh.prim_order[start[leaf]])
    child_code[~leaf] += node_base
    bounds = np.concatenate([bvh.child_min, bvh.child_max], axis=2).astype(np.float32)
    return bounds, child_code, root + node_base, _tree_depth(child_code, root + node_base,
                                                             node_base)


def _chunk_tree(clo: np.ndarray, chi: np.ndarray, chunk_base: int = 0, node_base: int = 0):
    """Binary SAH tree over chunk AABBs, one chunk per leaf: (bounds
    (B, 2, 6), codes (B, 2) with leaf code -(1 + chunk_base + chunk),
    root_code, depth). A single chunk is a leaf root with no nodes."""
    if clo.shape[0] == 1:
        return (np.zeros((0, 2, 6), np.float32), np.zeros((0, 2), np.int32),
                -(1 + chunk_base), 1)
    return _leaf_tree(clo, chi, chunk_base, node_base)


def build_hier_soa(geom_np: dict, order: np.ndarray, packed=None, device=None) -> HierSoA:
    """Chunk records and the SAH tree over their boxes for one
    (non-instanced) numpy geometry, on `device`. `order` is the BVH leaf
    order of the prims; `packed` = pack_sorted_prims(geom_np, order)."""
    t = geom_np["tri_v0"].shape[0]
    p = t + geom_np["sph_center"].shape[0]
    order = np.asarray(order, np.int32)
    inv_order = np.empty_like(order)
    inv_order[order] = np.arange(p, dtype=np.int32)

    chunks, clo, chi = _pack_chunks(geom_np, order, packed=packed)
    bounds, codes, root, depth = _chunk_tree(clo, chi)
    if root < 0:
        raise ValueError("the chunk tree needs at least two chunks")

    put = lambda x, dt=None: torch.as_tensor(np.asarray(x, dt), device=device)
    return HierSoA(
        prim_chunks=put(chunks),
        chunk_bounds=put(np.concatenate([clo, chi], axis=1)),
        bounds=put(bounds.reshape(-1)),
        codes=put(codes.reshape(-1), np.int32),
        order=put(order),
        inv_order=put(inv_order),
        inst_f32=put(np.zeros(0, np.float32)),
        inst_codes=put(np.zeros(0, np.int32)),
        binned_g2c=put(np.zeros(0, np.int32)),
        binned_g2i=put(np.zeros(0, np.int32)),
        binned_wcb=put(np.zeros((0, 6), np.float32)),
        root_code=root,
        stack_size=depth + 8,
        num_tris=t,
        num_prims=p,
        instanced=False,
    )


def _sub_geometry(geom_np: dict, ids: np.ndarray):
    """The geometry of storage prims `ids` alone (only the fields
    `pack_sorted_prims` reads), and the order that lists them as `ids` does
    (triangles come before spheres in a geometry)."""
    t = geom_np["tri_v0"].shape[0]
    ids = np.asarray(ids, np.int64)
    tri_ids = ids[ids < t]
    sph_ids = ids[ids >= t] - t
    sel = lambda key, idx, w: (np.asarray(geom_np[key])[idx] if len(idx)
                               else np.zeros((0,) + ((w,) if w else ()), np.float32))
    sub = dict(tri_v0=sel("tri_v0", tri_ids, 3), tri_e1=sel("tri_e1", tri_ids, 3),
               tri_e2=sel("tri_e2", tri_ids, 3), sph_center=sel("sph_center", sph_ids, 3),
               sph_radius=sel("sph_radius", sph_ids, 0))
    pos = np.empty(len(ids), np.int64)
    pos[ids < t] = np.arange(len(tri_ids))
    pos[ids >= t] = len(tri_ids) + np.arange(len(sph_ids))
    return sub, pos.astype(np.int32)


def build_hier_soa_instanced(geom_np: dict, pack_orders, inst_pack, inst_inv_a, inst_inv_b,
                             inst_lo, inst_hi, device=None) -> HierSoA:
    """Instanced tables on `device`, laid out as the JAX package lays them
    out. `geom_np` holds every pack's prims in pack space under one storage
    id space; `pack_orders[k]` lists pack k's storage ids in its BVH leaf
    order. Per instance i: its pack `inst_pack[i]`, the world -> pack
    affine x_local = inst_inv_a[i] @ x + inst_inv_b[i], and its world box
    [inst_lo[i], inst_hi[i]] (the TLAS's leaves).

    Chunks are packed pack by pack (a pack's last chunk padded, so no chunk
    spans two packs); nodes are [TLAS nodes] ++ [each pack's subtree], all
    codes absolute. The binned tables unroll the instances into global
    chunks with world boxes (`binned_g2c`, `binned_g2i`, `binned_wcb`)."""
    t = geom_np["tri_v0"].shape[0]
    p = t + geom_np["sph_center"].shape[0]
    n_inst = len(inst_pack)
    if n_inst >= 2:
        tlas_bounds, tlas_codes, root, tlas_depth = _leaf_tree(
            np.asarray(inst_lo, np.float32), np.asarray(inst_hi, np.float32), INST_BASE)
        if root < 0:
            raise ValueError("the TLAS root must be an interior node")
    else:
        tlas_bounds = np.zeros((0, 2, 6), np.float32)
        tlas_codes = np.zeros((0, 2), np.int32)
        root, tlas_depth = -(1 + INST_BASE), 1

    node_base = tlas_bounds.shape[0]
    chunk_base = 0
    chunk_parts, cb_parts, bounds_parts, codes_parts = [], [], [], []
    pack_roots, pack_depths, pack_ranges = [], [], []
    for order_k in pack_orders:
        sub, pos = _sub_geometry(geom_np, order_k)
        chunks_k, clo_k, chi_k = _pack_chunks(sub, pos)
        b_k, c_k, root_k, depth_k = _chunk_tree(clo_k, chi_k, chunk_base, node_base)
        chunk_parts.append(chunks_k)
        cb_parts.append(np.concatenate([clo_k, chi_k], axis=1))
        bounds_parts.append(b_k)
        codes_parts.append(c_k)
        pack_roots.append(root_k)
        pack_depths.append(depth_k)
        pack_ranges.append((chunk_base, chunks_k.shape[0]))
        chunk_base += chunks_k.shape[0]
        node_base += b_k.shape[0]

    # sorted slots are chunk-aligned: each pack's prims start a fresh chunk
    sorted_ids = np.full(chunk_base * HCHUNK, -1, np.int64)
    for (first, _), order_k in zip(pack_ranges, pack_orders):
        sorted_ids[first * HCHUNK: first * HCHUNK + len(order_k)] = np.asarray(order_k, np.int64)
    valid = sorted_ids >= 0
    slot_of = np.full(p, -1, np.int64)
    slot_of[sorted_ids[valid]] = np.nonzero(valid)[0]
    order_slots = np.where(valid, sorted_ids, 0).astype(np.int32)

    bounds = np.concatenate([tlas_bounds] + bounds_parts, 0)
    codes = np.concatenate([tlas_codes] + codes_parts, 0)
    if bounds.shape[0] == 0:  # one instance of a one-chunk pack: keep node 0 readable
        bounds = np.zeros((1, 2, 6), np.float32)
        codes = np.zeros((1, 2), np.int32)
    inv_a = np.asarray(inst_inv_a, np.float32).reshape(n_inst, 9)
    inv_b = np.asarray(inst_inv_b, np.float32).reshape(n_inst, 3)
    inst_f32 = np.concatenate([inv_a, inv_b], axis=1).reshape(-1)
    inst_codes = np.asarray([pack_roots[k] for k in inst_pack], np.int32)

    # the binned tables: each instance's pack chunks, padded to BINNED_SUP
    # (a superchunk never spans two instances; pad rows get an empty box),
    # with world boxes by the closed-form affine box transform
    cb_np = np.concatenate(cb_parts, axis=0)
    g2c_parts, g2i_parts, wcb_parts = [], [], []
    for i in range(n_inst):
        base, cnt = pack_ranges[int(inst_pack[i])]
        cpad = -(-cnt // BINNED_SUP) * BINNED_SUP
        ids = np.arange(cpad, dtype=np.int32)
        g2c_parts.append(np.where(ids < cnt, base + ids, base).astype(np.int32))
        g2i_parts.append(np.full(cpad, i, np.int32))
        a = np.asarray(inst_inv_a[i], np.float32)
        bvec = np.asarray(inst_inv_b[i], np.float32)
        f = np.linalg.inv(np.asarray(a, np.float64)).astype(np.float32)  # pack -> world
        off = (-f @ bvec).astype(np.float32)
        lo = cb_np[base: base + cnt, 0:3]
        hi = cb_np[base: base + cnt, 3:6]
        p1 = f[None, :, :] * lo[:, None, :]
        p2 = f[None, :, :] * hi[:, None, :]
        w = np.full((cpad, 6), np.float32(3.4e38), np.float32)
        w[:, 3:6] = -3.4e38
        w[:cnt, 0:3] = off[None] + np.minimum(p1, p2).sum(-1)
        w[:cnt, 3:6] = off[None] + np.maximum(p1, p2).sum(-1)
        wcb_parts.append(w)
    if n_inst and sum(g.shape[0] for g in g2c_parts) <= BINNED_MAX_CHUNKS:
        g2c, g2i = np.concatenate(g2c_parts), np.concatenate(g2i_parts)
        wcb = np.concatenate(wcb_parts, axis=0)
    else:
        g2c, g2i = np.zeros(0, np.int32), np.zeros(0, np.int32)
        wcb = np.zeros((0, 6), np.float32)

    put = lambda x, dt=None: torch.as_tensor(np.asarray(x, dt), device=device)
    return HierSoA(
        prim_chunks=put(np.concatenate(chunk_parts, 0)),
        chunk_bounds=put(cb_np),
        bounds=put(bounds.reshape(-1)),
        codes=put(codes.reshape(-1), np.int32),
        order=put(order_slots),
        inv_order=put(slot_of, np.int32),
        inst_f32=put(inst_f32),
        inst_codes=put(inst_codes),
        binned_g2c=put(g2c),
        binned_g2i=put(g2i),
        binned_wcb=put(wcb),
        root_code=root,
        # the TLAS, then RESTORE and the pack root, then a pack's subtree
        stack_size=tlas_depth + max(pack_depths) + 2 + 8,
        num_tris=t,
        num_prims=p,
        instanced=True,
    )


# ----------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the card's reference)
# ----------------------------------------------------------------------------


def _child_reach(box, ray, inv, limit):
    """Per ray: entry t of its child box (K, 6) and whether the walk enters
    it (the kernel's `child_hit`)."""
    t0x = (box[:, 0] - ray[0]) * inv[0]
    t1x = (box[:, 3] - ray[0]) * inv[0]
    t0y = (box[:, 1] - ray[1]) * inv[1]
    t1y = (box[:, 4] - ray[1]) * inv[1]
    t0z = (box[:, 2] - ray[2]) * inv[2]
    t1z = (box[:, 5] - ray[2]) * inv[2]
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                       torch.minimum(t0z, t1z))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    return tn, (tn <= tf) & (tf > 0.0) & (tn <= limit * CULL_MARGIN)


def to_instance(inst_f32, inst, o, d):
    """World rays o, d (3, M) moved into the spaces of instances `inst`
    (M,): (A o + b, A d) as (3, M) each, summed in the kernels' order."""
    aff = inst_f32.view(-1, 12)[inst.long()]
    a = aff[:, :9].view(-1, 3, 3)
    return vec.affine(o.T, a, aff[:, 9:12]).T, vec.affine(d.T, a).T


def _walk(rays, ignore, soa: HierSoA, any_hit, ign_inst=None, visits=None):
    """The kernel's walk over one ray slice, in lockstep: each step, every
    ray with a non-empty stack pops one entry. Instanced tables take each
    ray's ignored prim's instance `ign_inst` (-1: none). A `visits` list
    receives, each step, the (rays, chunks, instances) of the chunk leaves
    tested (instance -1 outside any)."""
    dev = rays.device
    m = rays.shape[1]
    has_tri, has_sph = soa.num_tris > 0, soa.num_prims > soa.num_tris
    inst_on = soa.instanced
    # the ray of the current space: the world ray, or an instance's
    cur = rays[0:6].clone() if inst_on else rays[0:6]
    inv = torch.stack([_safe_inv(rays[k]) for k in (3, 4, 5)])
    world_inv = inv.clone() if inst_on else inv
    cur_inst = torch.full((m,), -1, dtype=torch.int32, device=dev)
    tmax = rays[6]
    node_box = soa.bounds.view(-1, 12)
    node_code = soa.codes.view(-1, 2)
    stack_code = torch.zeros((m, soa.stack_size), dtype=torch.int32, device=dev)
    stack_tn = torch.zeros((m, soa.stack_size), dtype=torch.float32, device=dev)
    stack_code[:, 0] = soa.root_code
    stack_tn[:, 0] = -float("inf")
    sp = (tmax > 0.0).to(torch.int64)  # dead rays do no work
    best_t = tmax.clone()
    best_p = torch.full((m,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(m, dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    best_i = torch.zeros(m, dtype=torch.int32, device=dev)
    blocked = torch.zeros(m, dtype=torch.bool, device=dev)
    lanes = torch.arange(m, device=dev)
    while True:
        act = lanes[sp > 0]
        if act.numel() == 0:
            break
        sp[act] -= 1
        top = sp[act]
        code = stack_code[act, top]
        tn_pop = stack_tn[act, top]
        if not any_hit:  # skip entries the best t has moved below
            keep = ~(tn_pop > best_t[act] * CULL_MARGIN)
            act, code, tn_pop = act[keep], code[keep], tn_pop[keep]

        inner = code >= 0
        ni, node = act[inner], code[inner].long()
        if ni.numel():
            box, child = node_box[node], node_code[node]
            ray = cur[:, ni]
            inv_n = inv[:, ni]
            limit = tmax[ni] if any_hit else best_t[ni]
            tn0, h0 = _child_reach(box[:, 0:6], ray, inv_n, limit)
            tn1, h1 = _child_reach(box[:, 6:12], ray, inv_n, limit)
            near0 = tn0 <= tn1
            s = sp[ni]
            for hit, c, tn in ((torch.where(near0, h1, h0), torch.where(near0, child[:, 1], child[:, 0]),
                                torch.where(near0, tn1, tn0)),
                               (torch.where(near0, h0, h1), torch.where(near0, child[:, 0], child[:, 1]),
                                torch.where(near0, tn0, tn1))):
                stack_code[ni[hit], s[hit]] = c[hit]
                stack_tn[ni[hit], s[hit]] = tn[hit]
                s = s + hit.to(torch.int64)
            sp[ni] = s

        leaf, e, tn_leaf = act[~inner], -(code[~inner] + 1), tn_pop[~inner]
        if inst_on and leaf.numel():
            back = e == RESTORE_E  # return to the world ray
            ri = leaf[back]
            cur[:, ri] = rays[0:6, ri]
            inv[:, ri] = world_inv[:, ri]
            cur_inst[ri] = -1
            enter = (e >= INST_BASE) & ~back  # an instance leaf: move into its space
            ii, inst = leaf[enter], (e[enter] - INST_BASE).to(torch.int32)
            if ii.numel():
                o_l, d_l = to_instance(soa.inst_f32, inst, rays[0:3, ii], rays[3:6, ii])
                cur[:, ii] = torch.cat([o_l, d_l])
                inv[:, ii] = _safe_inv(d_l)
                cur_inst[ii] = inst
                s = sp[ii]
                stack_code[ii, s] = RESTORE_CODE
                stack_tn[ii, s] = -float("inf")
                stack_code[ii, s + 1] = soa.inst_codes[inst.long()]
                stack_tn[ii, s + 1] = tn_leaf[enter]
                sp[ii] = s + 2
            is_chunk = e < INST_BASE
            leaf, e = leaf[is_chunk], e[is_chunk]
        li = leaf
        if li.numel():
            chunk = e
            if visits is not None:
                visits.append((li.clone(), chunk.clone(), cur_inst[li].clone()))
            rows = soa.prim_chunks[chunk.long(), :10, :].permute(1, 0, 2)  # (10, K, HCHUNK)
            base = chunk * HCHUNK
            ig = ignore[li]
            if inst_on:  # an ignored prim is skipped only inside its own instance
                ig = torch.where(ign_inst[li] == cur_inst[li], ig, -1)
            t, u, v, ok = _chunk_hits(rows, base, cur[:, li], ig, has_tri, has_sph,
                                      unit_dir=not inst_on)
            if any_hit:
                hit = (ok & (t < tmax[li][:, None])).any(dim=1)
                blocked[li] |= hit
                sp[li[hit]] = 0  # stop at the first blocker
                continue
            t = torch.where(ok, t, INF)
            tm = torch.amin(t, dim=1)
            first = torch.argmax((ok & (t == tm[:, None])).to(torch.int8), dim=1)
            slot = base + first.to(torch.int32)
            cur_t, cur_p = best_t[li], best_p[li]
            lower = slot < cur_p
            if inst_on:  # one slot in two instances: the lower instance
                lower |= (slot == cur_p) & (cur_inst[li] < best_i[li])
            better = (tm < cur_t) | ((tm == cur_t) & (cur_p >= 0) & lower)
            pick = lambda x: torch.gather(x, 1, first[:, None])[:, 0]
            best_p[li] = torch.where(better, slot, cur_p)
            best_u[li] = torch.where(better, pick(u), best_u[li])
            best_v[li] = torch.where(better, pick(v), best_v[li])
            best_t[li] = torch.where(better, tm, cur_t)
            if inst_on:
                best_i[li] = torch.where(better, cur_inst[li], best_i[li])
    if any_hit:
        return blocked
    if inst_on:
        return best_t, best_p, best_u, best_v, best_i
    return best_t, best_p, best_u, best_v


def _slices(*cols):
    """PLAIN_SLICE passes (at least one) over rays (7, N) and per-ray
    columns, so the stacks stay bounded."""
    for s in range(0, max(cols[0].shape[1], 1), PLAIN_SLICE):
        yield tuple(None if c is None else c[..., s: s + PLAIN_SLICE] for c in cols)


def hier_trace_plain(rays, ignore, soa: HierSoA, ign_inst=None):
    """Plain PyTorch closest hit: (t, sorted slot int32 or -1, u, v), and
    the hit's instance (int32) for instanced tables."""
    outs = [_walk(r, i, soa, False, ii) for r, i, ii in _slices(rays, ignore, ign_inst)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def hier_occlude_plain(rays, ignore, soa: HierSoA, ign_inst=None):
    """Plain PyTorch any hit: blocked (bool)."""
    return torch.cat([_walk(r, i, soa, True, ii) for r, i, ii in _slices(rays, ignore, ign_inst)])


# ----------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# ----------------------------------------------------------------------------

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("hier_walk")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # rays, ignore, ign_inst, n, chunks, bounds, codes, root, inst_f32,
        # inst_codes, has_tri, has_sph, instanced
        common = [ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, ptr, ptr, i32, i32, i32]
        lib.hier_trace.argtypes = common + [ptr, ptr, ptr, ptr, ptr, ptr]
        lib.hier_trace.restype = i32
        lib.hier_occlude.argtypes = common + [ptr, ptr]
        lib.hier_occlude.restype = i32
        lib.hier_occupancy.argtypes = [i32, i32, i32, i32, ptr]
        lib.hier_occupancy.restype = i32
        _lib = lib
    return _lib


def occupancy(any_hit: bool, instanced: bool, has_tri: bool = True,
              has_sph: bool = False) -> dict:
    """One kernel form's resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), its block size,
    dynamic shared memory per block and resident warps per SM."""
    out = (ctypes.c_int * 3)()
    err = _load().hier_occupancy(int(any_hit), int(instanced), int(has_tri), int(has_sph), out)
    if err:
        raise RuntimeError(f"hier_occupancy failed: cudaError {err}")
    return dict(blocks=out[0], block=out[1], smem=out[2], warps=out[0] * out[1] // 32)


def check_tables(soa: HierSoA):
    """Raise unless the walk of csrc/hier_walk.cuh takes these tables as
    they are (the walk kernels and the megakernel's chunk-tree form)."""
    if not all(x.is_contiguous() for x in (soa.prim_chunks, soa.bounds, soa.codes)):
        raise ValueError("the hier kernels need contiguous inputs")
    if soa.prim_chunks.dtype != torch.float32 or soa.prim_chunks.shape[1:] != (16, HCHUNK):
        raise ValueError(f"prim_chunks must be (C, 16, {HCHUNK}) float32")
    if soa.prim_chunks.data_ptr() % 16:
        raise ValueError("the walk copies each chunk record by a bulk asynchronous copy: "
                         "prim_chunks must be 16-byte aligned")
    if soa.bounds.dtype != torch.float32 or soa.codes.dtype != torch.int32:
        raise ValueError("node bounds must be float32 and codes int32")
    if soa.root_code < 0 and not soa.instanced:
        raise ValueError("the chunk tree's root must be an interior node")
    if soa.stack_size > MAX_STACK:
        raise ValueError(f"the chunk tree needs a stack of {soa.stack_size} entries; the "
                         f"kernel holds {MAX_STACK}")
    if soa.padded >= SLOT_LIMIT:
        raise ValueError(f"{soa.padded} padded prims: sorted slots must stay below 2**24")


def _check_inputs(rays, ignore, soa: HierSoA, ign_inst):
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7:
        raise ValueError(f"rays must be (7, N) float32, got {tuple(rays.shape)} {rays.dtype}")
    if ignore.dtype != torch.int32 or ignore.shape != (rays.shape[1],):
        raise ValueError(f"ignore must be ({rays.shape[1]},) int32")
    tensors = [rays, ignore, soa.prim_chunks, soa.bounds, soa.codes]
    if soa.instanced:
        if ign_inst is None or ign_inst.dtype != torch.int32 or ign_inst.shape != ignore.shape:
            raise ValueError(f"instanced tables need ign_inst ({rays.shape[1]},) int32")
        if soa.inst_f32.dtype != torch.float32 or soa.inst_codes.dtype != torch.int32:
            raise ValueError("inst_f32 must be float32 and inst_codes int32")
        if soa.inst_f32.numel() != 12 * soa.inst_codes.numel():
            raise ValueError("inst_f32 must hold 12 floats per instance")
        tensors += [ign_inst, soa.inst_f32, soa.inst_codes]
    elif ign_inst is not None:
        raise ValueError("ign_inst is for instanced tables only")
    if any(x.device != rays.device for x in tensors):
        raise ValueError("rays, ignore and the hier tables must share one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the hier kernels need contiguous inputs")
    check_tables(soa)
    if rays.shape[1] >= 2 ** 31:
        raise ValueError("too many rays for int32 indexing")


def _kernel_args(rays, ignore, soa: HierSoA, ign_inst):
    inst = soa.instanced
    return (rays.data_ptr(), ignore.data_ptr(), ign_inst.data_ptr() if inst else None,
            rays.shape[1], soa.prim_chunks.data_ptr(), soa.bounds.data_ptr(),
            soa.codes.data_ptr(), soa.root_code, soa.inst_f32.data_ptr() if inst else None,
            soa.inst_codes.data_ptr() if inst else None, int(soa.num_tris > 0),
            int(soa.num_prims > soa.num_tris), int(inst))


def _count(name: str, soa: HierSoA):
    """Count a launch of the walk in `launches.<name>` (`_instanced` on
    instanced tables)."""
    diagnostics.count(f"launches.{name}_instanced" if soa.instanced else f"launches.{name}")


def hier_trace(rays, ignore, soa: HierSoA, ign_inst=None):
    """Closest hit of rays (7, N) [ox oy oz dx dy dz t_max] with sorted-slot
    ignores (N,) int32 over the chunk tree: (t, slot int32, u, v), and for
    instanced tables, which take each ignore's instance `ign_inst` (N,)
    int32 (-1: none), the hit's instance. CUDA tensors launch the kernel;
    CPU tensors take the plain version."""
    _check_inputs(rays, ignore, soa, ign_inst)
    if rays.device.type == "cpu":
        return hier_trace_plain(rays, ignore, soa, ign_inst)
    if rays.device.type != "cuda":
        raise ValueError(f"hier_trace runs on CUDA or CPU tensors, not {rays.device}")
    lib = _load()
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    prim = torch.empty(n, dtype=torch.int32, device=rays.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    inst = torch.empty_like(prim) if soa.instanced else None
    if n:
        err = lib.hier_trace(*_kernel_args(rays, ignore, soa, ign_inst), t.data_ptr(),
                             prim.data_ptr(), u.data_ptr(), v.data_ptr(),
                             inst.data_ptr() if soa.instanced else None,
                             torch.cuda.current_stream(rays.device).cuda_stream)
        if err:
            raise RuntimeError(f"hier_trace launch failed: cudaError {err}")
        _count("walk_trace", soa)
    return (t, prim, u, v, inst) if soa.instanced else (t, prim, u, v)


def hier_occlude(rays, ignore, soa: HierSoA, ign_inst=None):
    """Any hit with t < t_max over the chunk tree: blocked (N,) bool (see
    hier_trace for `ign_inst`). CUDA tensors launch the kernel; CPU tensors
    take the plain version."""
    _check_inputs(rays, ignore, soa, ign_inst)
    if rays.device.type == "cpu":
        return hier_occlude_plain(rays, ignore, soa, ign_inst)
    if rays.device.type != "cuda":
        raise ValueError(f"hier_occlude runs on CUDA or CPU tensors, not {rays.device}")
    lib = _load()
    n = rays.shape[1]
    blocked = torch.empty(n, dtype=torch.bool, device=rays.device)
    if n:
        err = lib.hier_occlude(*_kernel_args(rays, ignore, soa, ign_inst), blocked.data_ptr(),
                               torch.cuda.current_stream(rays.device).cuda_stream)
        if err:
            raise RuntimeError(f"hier_occlude launch failed: cudaError {err}")
        _count("walk_occlude", soa)
    return blocked



# ----------------------------------------------------------------------------
# public contract (original prim ids)
# ----------------------------------------------------------------------------


def _sorted_ignore(soa: HierSoA, ignore):
    ignore = ignore.to(torch.int32)
    ig = soa.inv_order[torch.clamp(ignore, min=0)]
    return torch.where(ignore >= 0, ig, -1).to(torch.int32).contiguous()


def _ignore_inst(soa: HierSoA, ignore, ignore_inst, missing: int = -1):
    """Instanced tables: each ray's ignored prim's instance (`missing` when
    none is given: the JAX package's walk takes -1, its binned traversal
    0), -1 where the ray ignores nothing; None otherwise."""
    if not soa.instanced:
        return None
    ii = torch.full_like(ignore, missing) if ignore_inst is None else ignore_inst
    return torch.where(ignore >= 0, ii.to(torch.int32), -1).to(torch.int32).contiguous()


def intersect_hier(geom: FlatGeometry, soa: HierSoA, o, d, t_max, ignore,
                   ignore_inst=None) -> Hit:
    """Closest hit over all prims through the hier trace kernel; instanced
    tables take the ignored prims' instances and report `Hit.inst`."""
    out = hier_trace(ray_columns(o, d, t_max), _sorted_ignore(soa, ignore), soa,
                     _ignore_inst(soa, ignore, ignore_inst))
    t, p, u, v = out[:4]
    prim = torch.where(p >= 0, soa.order[torch.clamp(p, min=0)], -1).to(torch.int32)
    found = prim >= 0
    inst = torch.where(found, out[4], 0) if soa.instanced else torch.zeros_like(prim)
    return Hit(t=torch.where(found, t, INF), prim=prim, uv=torch.stack([u, v], dim=-1),
               inst=inst)


def occlude_hier(geom: FlatGeometry, soa: HierSoA, o, d, t_max, ignore,
                 ignore_inst=None) -> torch.Tensor:
    """Any hit in [eps, t_max) through the hier occlude kernel."""
    return hier_occlude(ray_columns(o, d, t_max), _sorted_ignore(soa, ignore), soa,
                        _ignore_inst(soa, ignore, ignore_inst))
