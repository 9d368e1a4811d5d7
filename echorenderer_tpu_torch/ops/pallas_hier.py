"""Chunk-tree walk for large scenes (counterpart of
echorenderer_tpu/ops/pallas_hier.py, non-instanced).

The prims sit in BVH-leaf order, cut into HCHUNK-prim chunks; a binary SAH
tree over the chunk boxes (`aggregation/bvh.build_bvh` with one chunk per
leaf) is flattened into two tables: 12 floats of child bounds and 2 child
codes per interior node (a leaf code is -(1 + chunk)). `HierSoA` holds them
with the chunk rows, as the JAX package lays them out, table for table.

Two kernels walk the tree for a batch of rays: `hier_trace` (closest hit)
and `hier_occlude` (any hit). On a CUDA tensor each launches the
hand-written kernel in csrc/hier_walk.cu (one thread per ray, a stack per
thread), built with nvcc on first use (ops/cuda_build.py); on a CPU tensor
it runs the plain PyTorch version beside it, a lockstep walk in which
every unfinished ray pops one entry of its own stack per step. Both apply
the same rules: the box test of `pallas_intersect._box_reach` (with its
CULL_MARGIN slack), the far child pushed first, an entry skipped once the
best t has moved below its entry t, the ray-prim test of
`pallas_intersect._chunk_hits`, and the lexicographic least (t, sorted
slot) as the closest hit. That result does not depend on the visit order,
so it equals the dense kernels' bit for bit.
The TPU kernel walks 1024-ray packets and keeps, among equal t in two
chunks, the chunk it visited first; the two differ only on such exact ties.

`intersect_hier` / `occlude_hier` keep the JAX package's public contract:
original prim ids in and out (the sorted<->original maps), `Hit.inst`
zeros, t = INF and prim = -1 on a miss. The kernels replace the TPU's
`_hier_kernel` (echorenderer_tpu/ops/pallas_hier.py:498).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..aggregation.bvh import build_bvh
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
MAX_STACK = 64  # per-thread stack entries of csrc/hier_walk.cu (kStack)
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
    inst_f32: torch.Tensor  # (I*12,) f32 per-instance inverse affine (empty)
    inst_codes: torch.Tensor  # (I,) int32 per-instance subtree root (empty)
    binned_g2c: torch.Tensor  # instanced binned tables (empty)
    binned_g2i: torch.Tensor
    binned_wcb: torch.Tensor
    root_code: int  # root node code (an interior node)
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


def _tree_depth(child_code: np.ndarray, root: int) -> int:
    """Depth (levels, leaves included) of the flattened tree at `root`."""
    depth = 0
    stack = [(root, 1)]
    while stack:
        node, d = stack.pop()
        depth = max(depth, d)
        if node >= 0:
            stack.append((int(child_code[node, 0]), d + 1))
            stack.append((int(child_code[node, 1]), d + 1))
    return depth


def _chunk_tree(clo: np.ndarray, chi: np.ndarray):
    """Binary SAH tree over chunk AABBs, one chunk per leaf: (bounds
    (B, 2, 6), codes (B, 2) with leaf code -(1 + chunk), root_code, depth).
    A single chunk is a leaf root with no nodes."""
    if clo.shape[0] == 1:
        return np.zeros((0, 2, 6), np.float32), np.zeros((0, 2), np.int32), -1, 1
    bvh = build_bvh(clo, chi, leaf_max=1)
    child_code = bvh.child_code.copy()
    root = int(bvh.root_code)
    leaf = child_code < 0
    start = (-(child_code + 1)) >> 4
    child_code[leaf] = -(1 + bvh.prim_order[start[leaf]])
    bounds = np.concatenate([bvh.child_min, bvh.child_max], axis=2).astype(np.float32)
    return bounds, child_code, root, _tree_depth(child_code, root)


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


def _walk(rays, ignore, soa: HierSoA, any_hit):
    """The kernel's walk over one ray slice, in lockstep: each step, every
    ray with a non-empty stack pops one entry."""
    dev = rays.device
    m = rays.shape[1]
    has_tri, has_sph = soa.num_tris > 0, soa.num_prims > soa.num_tris
    inv = [_safe_inv(rays[k]) for k in (3, 4, 5)]
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
    blocked = torch.zeros(m, dtype=torch.bool, device=dev)
    lanes = torch.arange(m, device=dev)
    while True:
        act = lanes[sp > 0]
        if act.numel() == 0:
            break
        sp[act] -= 1
        top = sp[act]
        code = stack_code[act, top]
        if not any_hit:  # skip entries the best t has moved below
            keep = ~(stack_tn[act, top] > best_t[act] * CULL_MARGIN)
            act, code = act[keep], code[keep]

        inner = code >= 0
        ni, node = act[inner], code[inner].long()
        if ni.numel():
            box, child = node_box[node], node_code[node]
            ray = rays[:, ni]
            inv_n = [x[ni] for x in inv]
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

        li = act[~inner]
        if li.numel():
            chunk = -(code[~inner] + 1)
            rows = soa.prim_chunks[chunk.long(), :10, :].permute(1, 0, 2)  # (10, K, HCHUNK)
            base = chunk * HCHUNK
            t, u, v, ok = _chunk_hits(rows, base, rays[:, li], ignore[li], has_tri, has_sph)
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
            better = (tm < cur_t) | ((tm == cur_t) & (cur_p >= 0) & (slot < cur_p))
            pick = lambda x: torch.gather(x, 1, first[:, None])[:, 0]
            best_p[li] = torch.where(better, slot, cur_p)
            best_u[li] = torch.where(better, pick(u), best_u[li])
            best_v[li] = torch.where(better, pick(v), best_v[li])
            best_t[li] = torch.where(better, tm, cur_t)
    if any_hit:
        return blocked
    return best_t, best_p, best_u, best_v


def _slices(rays, ignore):
    """PLAIN_SLICE passes (at least one), so the stacks stay bounded."""
    for s in range(0, max(rays.shape[1], 1), PLAIN_SLICE):
        yield rays[:, s: s + PLAIN_SLICE], ignore[s: s + PLAIN_SLICE]


def hier_trace_plain(rays, ignore, soa: HierSoA):
    """Plain PyTorch closest hit: (t, sorted slot int32 or -1, u, v)."""
    outs = [_walk(r, i, soa, any_hit=False) for r, i in _slices(rays, ignore)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def hier_occlude_plain(rays, ignore, soa: HierSoA):
    """Plain PyTorch any hit: blocked (bool)."""
    return torch.cat([_walk(r, i, soa, any_hit=True) for r, i in _slices(rays, ignore)])


# ----------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# ----------------------------------------------------------------------------

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("hier_walk")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        common = [ptr, ptr, i32, ptr, ptr, ptr, i32, i32, i32]
        lib.hier_trace.argtypes = common + [ptr, ptr, ptr, ptr, ptr]
        lib.hier_trace.restype = i32
        lib.hier_occlude.argtypes = common + [ptr, ptr]
        lib.hier_occlude.restype = i32
        _lib = lib
    return _lib


def _check_inputs(rays, ignore, soa: HierSoA):
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7:
        raise ValueError(f"rays must be (7, N) float32, got {tuple(rays.shape)} {rays.dtype}")
    if ignore.dtype != torch.int32 or ignore.shape != (rays.shape[1],):
        raise ValueError(f"ignore must be ({rays.shape[1]},) int32")
    tensors = (rays, ignore, soa.prim_chunks, soa.bounds, soa.codes)
    if any(x.device != rays.device for x in tensors):
        raise ValueError("rays, ignore and the hier tables must share one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("the hier kernels need contiguous inputs")
    if soa.prim_chunks.dtype != torch.float32 or soa.prim_chunks.shape[1:] != (16, HCHUNK):
        raise ValueError(f"prim_chunks must be (C, 16, {HCHUNK}) float32")
    if soa.bounds.dtype != torch.float32 or soa.codes.dtype != torch.int32:
        raise ValueError("node bounds must be float32 and codes int32")
    if soa.instanced:
        raise NotImplementedError(
            "instanced hier tables are not in the PyTorch port yet (ROADMAP.md: queue 1, "
            "instancing)")
    if soa.root_code < 0:
        raise ValueError("the chunk tree's root must be an interior node")
    if soa.stack_size > MAX_STACK:
        raise ValueError(f"the chunk tree needs a stack of {soa.stack_size} entries; the "
                         f"kernel holds {MAX_STACK}")
    if soa.padded >= SLOT_LIMIT:
        raise ValueError(f"{soa.padded} padded prims: sorted slots must stay below 2**24")
    if rays.shape[1] >= 2 ** 31:
        raise ValueError("too many rays for int32 indexing")


def _kernel_args(rays, ignore, soa: HierSoA):
    return (rays.data_ptr(), ignore.data_ptr(), rays.shape[1], soa.prim_chunks.data_ptr(),
            soa.bounds.data_ptr(), soa.codes.data_ptr(), soa.root_code,
            int(soa.num_tris > 0), int(soa.num_prims > soa.num_tris))


def hier_trace(rays, ignore, soa: HierSoA):
    """Closest hit of rays (7, N) [ox oy oz dx dy dz t_max] with sorted-slot
    ignores (N,) int32 over the chunk tree: (t, slot int32, u, v). CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    _check_inputs(rays, ignore, soa)
    if rays.device.type == "cpu":
        return hier_trace_plain(rays, ignore, soa)
    if rays.device.type != "cuda":
        raise ValueError(f"hier_trace runs on CUDA or CPU tensors, not {rays.device}")
    lib = _load()
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    prim = torch.empty(n, dtype=torch.int32, device=rays.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        err = lib.hier_trace(*_kernel_args(rays, ignore, soa), t.data_ptr(), prim.data_ptr(),
                             u.data_ptr(), v.data_ptr(),
                             torch.cuda.current_stream(rays.device).cuda_stream)
        if err:
            raise RuntimeError(f"hier_trace launch failed: cudaError {err}")
        hier_trace.launches += 1
    return t, prim, u, v


def hier_occlude(rays, ignore, soa: HierSoA):
    """Any hit with t < t_max over the chunk tree: blocked (N,) bool. CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    _check_inputs(rays, ignore, soa)
    if rays.device.type == "cpu":
        return hier_occlude_plain(rays, ignore, soa)
    if rays.device.type != "cuda":
        raise ValueError(f"hier_occlude runs on CUDA or CPU tensors, not {rays.device}")
    lib = _load()
    n = rays.shape[1]
    blocked = torch.empty(n, dtype=torch.bool, device=rays.device)
    if n:
        err = lib.hier_occlude(*_kernel_args(rays, ignore, soa), blocked.data_ptr(),
                               torch.cuda.current_stream(rays.device).cuda_stream)
        if err:
            raise RuntimeError(f"hier_occlude launch failed: cudaError {err}")
        hier_occlude.launches += 1
    return blocked


hier_trace.launches = 0
hier_occlude.launches = 0


# ----------------------------------------------------------------------------
# public contract (original prim ids)
# ----------------------------------------------------------------------------


def _sorted_ignore(soa: HierSoA, ignore):
    ignore = ignore.to(torch.int32)
    ig = soa.inv_order[torch.clamp(ignore, min=0)]
    return torch.where(ignore >= 0, ig, -1).to(torch.int32).contiguous()


def intersect_hier(geom: FlatGeometry, soa: HierSoA, o, d, t_max, ignore) -> Hit:
    """Closest hit over all prims through the hier trace kernel."""
    t, p, u, v = hier_trace(ray_columns(o, d, t_max), _sorted_ignore(soa, ignore), soa)
    prim = torch.where(p >= 0, soa.order[torch.clamp(p, min=0)], -1).to(torch.int32)
    found = prim >= 0
    return Hit(t=torch.where(found, t, INF), prim=prim, uv=torch.stack([u, v], dim=-1),
               inst=torch.zeros_like(prim))


def occlude_hier(geom: FlatGeometry, soa: HierSoA, o, d, t_max, ignore) -> torch.Tensor:
    """Any hit in [eps, t_max) through the hier occlude kernel."""
    return hier_occlude(ray_columns(o, d, t_max), _sorted_ignore(soa, ignore), soa)
