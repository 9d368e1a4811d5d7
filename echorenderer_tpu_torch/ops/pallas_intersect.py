"""Dense chunked ray/primitive intersection (counterpart of
echorenderer_tpu/ops/pallas_intersect.py).

The scene's prims sit in BVH-leaf order as 10 rows of floats (`PrimSoA`),
in chunks of PRIM_BLOCK with an AABB per chunk and per SC_FACTOR-chunk
superchunk. Two kernels walk them for a batch of rays: `dense_trace`
(closest hit) and `dense_occlude` (any hit). On a CUDA tensor each launches
the hand-written kernel in csrc/dense_intersect.cu (its ray-prim test in
csrc/intersect.cuh, shared with the megakernel), built with nvcc on first
use (ops/cuda_build.py); on a CPU tensor it runs the plain PyTorch version
beside it, which applies the same rules op for op: a ray tests a chunk
only if it enters the chunk's box and its superchunk's before its own best
t (t_max for any hit), strict-less updates in ascending slot order (the
lowest sorted slot wins a tie), the findFar sphere rule.

`intersect_pallas` / `occlude_pallas` keep the JAX package's public
contract: original prim ids in and out (the sorted<->original maps), and
t_max clamped to 3.4e38 so an infinite t_max records no phantom hit.

The kernels replace the TPU's `_trace_kernel` and `_occlude_kernel`
(echorenderer_tpu/ops/pallas_intersect.py:322 and :400), which cull by
1,024-ray blocks; the result, the least (t, sorted slot) over the hits
before t_max, does not depend on the cull unit. On the H100 they are bound
by the prim tests of the chunks each ray enters: each warp takes a chunk
when a ballot of its lanes' own box tests is not zero, stages it in shared
memory, and spreads the tests of a sparse ballot's rays over all 32 lanes
(csrc/dense_intersect.cu has the details).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils import diagnostics
from . import cuda_build
from .intersect import INF, FlatGeometry, Hit

_EPS = 2.4e-4  # RAY_EPSILON

WARP = 32  # rays per ballot of the kernels; the plain version pads to whole warps
PRIM_BLOCK = 128  # primitives per chunk
SC_FACTOR = 32  # chunks per superchunk (second culling level)
PLAIN_SLICE = 2 ** 18  # rays per pass of the plain version on the card
# relative slack of every cull test (csrc/intersect.cuh kCullMargin): a box
# is entered while its entry t is at most limit * CULL_MARGIN, because a hit
# on a box's boundary can come out a few rounding steps before the box's
# computed entry t, and kernels that cull by different boxes would each lose
# different near-ties
CULL_MARGIN = 1.0 + 2.0 ** -12


class PrimSoA(NamedTuple):
    """Kernel layout of the scene's prims, REORDERED into BVH-leaf order.

    rows (10, P): a xyz, b xyz, c xyz, is_sphere per sorted slot. A
    triangle stores v0/e1/e2; a sphere its center in a and radius in b.x.
    Padded slots have a = 1e30 and b = c = 0 (det = 0: never hit).
    chunk_bounds (8, C) / super_bounds (8, SC): box rows min xyz, max xyz,
    pad."""

    rows: torch.Tensor
    chunk_bounds: torch.Tensor
    super_bounds: torch.Tensor
    order: torch.Tensor  # (P_orig,) int32 sorted slot -> original prim id
    inv_order: torch.Tensor  # (P_orig,) int32 original id -> sorted slot
    num_tris: int
    num_prims: int

    @property
    def padded(self) -> int:
        return self.rows.shape[1]

    @property
    def n_chunks(self) -> int:
        return max(1, self.padded // PRIM_BLOCK)

    @property
    def n_super(self) -> int:
        """Superchunks the kernels test: 1 (no second level) unless the
        scene has more than SC_FACTOR chunks."""
        return self.super_bounds.shape[1] if self.n_chunks > SC_FACTOR else 1


def pack_sorted_prims(geom_np: dict, order: np.ndarray, bounds=None):
    """Host-side packing: primitive components permuted into `order`,
    plus per-prim AABBs. Returns (a, b, c, is_sph, lo, hi) numpy arrays.
    `bounds` = precomputed (bmin, bmax) per-prim AABBs in original order."""
    t = geom_np["tri_v0"].shape[0]
    s = geom_np["sph_center"].shape[0]
    v0 = np.asarray(geom_np["tri_v0"], np.float32).reshape(t, 3)
    e1 = np.asarray(geom_np["tri_e1"], np.float32).reshape(t, 3)
    e2 = np.asarray(geom_np["tri_e2"], np.float32).reshape(t, 3)
    sc = np.asarray(geom_np["sph_center"], np.float32).reshape(s, 3)
    sr = np.asarray(geom_np["sph_radius"], np.float32).reshape(s)

    a = np.concatenate([v0, sc], 0)
    b = np.concatenate([e1, np.stack([sr, np.zeros_like(sr), np.zeros_like(sr)], -1)], 0)
    c = np.concatenate([e2, np.zeros((s, 3), np.float32)], 0)
    is_sph = np.concatenate([np.zeros(t, np.float32), np.ones(s, np.float32)])
    a, b, c, is_sph = a[order], b[order], c[order], is_sph[order]
    if bounds is not None:
        lo = np.ascontiguousarray(bounds[0][order], np.float32)
        hi = np.ascontiguousarray(bounds[1][order], np.float32)
    else:
        lo = np.where(is_sph[:, None] > 0.5, a - b[:, :1], np.minimum(np.minimum(a, a + b), a + c))
        hi = np.where(is_sph[:, None] > 0.5, a + b[:, :1], np.maximum(np.maximum(a, a + b), a + c))
    # a zero-area triangle (e.g. two vertices at a UV sphere's pole) keeps a
    # rounding residue in its Moller-Trumbore determinant above the 1e-12
    # threshold and reports hits far outside itself, which kernels that cull
    # by other boxes find or not: zero its edges, so that the determinant is
    # exactly 0 and it never hits (its box stays)
    flat = (is_sph < 0.5) & (np.cross(b, c) == 0.0).all(-1)
    b[flat] = 0.0
    c[flat] = 0.0
    return a, b, c, is_sph, lo, hi


def build_prim_soa(geom_np: dict, order: np.ndarray | None = None, packed=None,
                   device=None) -> PrimSoA:
    """Host-side packing of a numpy geometry into the kernel layout on
    `device`. `order` is a spatially coherent permutation (BVH leaf order);
    a single-chunk scene keeps the identity order (culling never fires)."""
    t = geom_np["tri_v0"].shape[0]
    p = t + geom_np["sph_center"].shape[0]
    if p <= PRIM_BLOCK:  # single chunk: 8-aligned
        pad = -(-max(p, 1) // 8) * 8
    else:
        pad = -(-p // PRIM_BLOCK) * PRIM_BLOCK
    if order is None or len(order) != p or pad <= PRIM_BLOCK:
        order = np.arange(p, dtype=np.int32)
        packed = None
    order = np.asarray(order, np.int32)
    inv_order = np.empty_like(order)
    inv_order[order] = np.arange(p, dtype=np.int32)

    a, b, c, is_sph, lo, hi = packed if packed is not None else pack_sorted_prims(geom_np, order)

    rows = np.zeros((10, pad), np.float32)
    rows[0:3, :] = 1e30
    rows[0:3, :p] = a.T
    rows[3:6, :p] = b.T
    rows[6:9, :p] = c.T
    rows[9, :p] = is_sph

    n_chunks = max(1, pad // PRIM_BLOCK)
    cb = np.zeros((8, n_chunks), np.float32)
    cb[0:3] = 1e30
    cb[3:6] = -1e30
    for ci in range(n_chunks):
        seg = slice(ci * PRIM_BLOCK, min((ci + 1) * PRIM_BLOCK, p))
        if seg.start < p:
            cb[0:3, ci] = lo[seg].min(0)
            cb[3:6, ci] = hi[seg].max(0)
    n_super = -(-n_chunks // SC_FACTOR)
    scb = np.zeros((8, n_super), np.float32)
    scb[0:3] = 1e30
    scb[3:6] = -1e30
    for si in range(n_super):
        seg = slice(si * SC_FACTOR, min((si + 1) * SC_FACTOR, n_chunks))
        scb[0:3, si] = cb[0:3, seg].min(1)
        scb[3:6, si] = cb[3:6, seg].max(1)

    put = lambda x: torch.as_tensor(x, device=device)
    return PrimSoA(
        rows=put(rows), chunk_bounds=put(cb), super_bounds=put(scb),
        order=put(order), inv_order=put(inv_order), num_tris=t, num_prims=p,
    )


# ----------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's reference)
# ----------------------------------------------------------------------------


def _safe_inv(d):
    big = torch.where(d < 0, -1e12, 1e12).to(d.dtype)
    return torch.where(torch.abs(d) < 1e-12, big, 1.0 / d)


def _box_reach(table, j, ray, inv, limit):
    """Per ray: does the ray enter box j of `table` before its `limit`
    (with the CULL_MARGIN slack)?"""
    ox, oy, oz = ray[0], ray[1], ray[2]
    ix, iy, iz = inv
    t0x = (table[0, j] - ox) * ix
    t1x = (table[3, j] - ox) * ix
    t0y = (table[1, j] - oy) * iy
    t1y = (table[4, j] - oy) * iy
    t0z = (table[2, j] - oz) * iz
    t1z = (table[5, j] - oz) * iz
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                       torch.minimum(t0z, t1z))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    return (tn <= tf) & (tf > 0.0) & (tn <= limit * CULL_MARGIN)


def _chunk_hits(chunk, base, ray, ignore, has_tri, has_sph, unit_dir=True):
    """Rays (M,) against prim rows: (t, u, v, ok) as (M, CS), in the
    kernel's float order. `chunk` is one chunk's rows (10, CS) shared by
    every ray, with first sorted slot `base` (an int), or one chunk per
    ray (10, M, CS) with first slots `base` (M,). `unit_dir=False` is for
    rays moved into an instance's space, whose |d| is 1/scale: spheres then
    solve the full quadratic a t^2 + 2 b t + c, so t stays the world-space
    parameter (triangles need no change)."""
    col = lambda r: r[:, None]
    ox, oy, oz, dx, dy, dz = (col(ray[k]) for k in range(6))
    per_ray = chunk.dim() == 3
    ax, ay, az, bx, by, bz, cx, cy, cz, sph = (
        chunk[k] if per_ray else chunk[k][None, :] for k in range(10))
    slot = torch.arange(chunk.shape[-1], dtype=torch.int32, device=chunk.device)[None, :]
    ignored = slot + (col(base) if per_ray else base) == col(ignore)

    if has_tri:
        px = dy * cz - dz * cy
        py = dz * cx - dx * cz
        pz = dx * cy - dy * cx
        det = bx * px + by * py + bz * pz
        det_ok = torch.abs(det) > 1e-12
        inv = torch.where(det_ok, 1.0 / torch.where(det == 0.0, 1.0, det), 0.0)
        sx = ox - ax
        sy = oy - ay
        sz = oz - az
        u = (sx * px + sy * py + sz * pz) * inv
        qx = sy * bz - sz * by
        qy = sz * bx - sx * bz
        qz = sx * by - sy * bx
        v = (dx * qx + dy * qy + dz * qz) * inv
        t_tri = (cx * qx + cy * qy + cz * qz) * inv
        tri_ok = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t_tri > _EPS) & ~ignored
    if has_sph:
        fx = ox - ax
        fy = oy - ay
        fz = oz - az
        bq = fx * dx + fy * dy + fz * dz
        cq = fx * fx + fy * fy + fz * fz - bx * bx
        if unit_dir:
            disc = bq * bq - cq
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            t_near = -bq - sq
            t_far = -bq + sq
        else:
            aq = dx * dx + dy * dy + dz * dz
            disc = bq * bq - aq * cq
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            inv_a = 1.0 / aq
            t_near = (-bq - sq) * inv_a
            t_far = (-bq + sq) * inv_a
        t_sph = torch.where(ignored, t_far, torch.where(t_near > _EPS, t_near, t_far))
        sph_ok = (disc >= 0.0) & (t_sph > _EPS)

    if has_tri and has_sph:
        is_sph = sph > 0.5
        t = torch.where(is_sph, t_sph, t_tri)
        ok = (is_sph & sph_ok) | (~is_sph & tri_ok)
        # spheres carry no barycentrics (the kernel writes 0)
        u = torch.where(is_sph, 0.0, u)
        v = torch.where(is_sph, 0.0, v)
    elif has_tri:
        t, ok = t_tri, tri_ok
    else:
        t, ok = t_sph, sph_ok
        u = v = torch.zeros_like(t)
    return t, u, v, ok


def _walk(rays, ignore, soa, any_hit, visits=None):
    """The kernels' chunk walk over one ray slice, culled per ray: ray i
    tests chunk j when its limit (its best t; for any hit t_max, or -1 once
    blocked) is positive and it reaches chunk j's box and, with more than
    SC_FACTOR chunks, the box of j's superchunk (tested at the superchunk's
    first chunk) before that limit. A `visits` list gets (ray indices,
    chunk) of each chunk's tests, in walk order."""
    n_chunks, n_super = soa.n_chunks, soa.n_super
    cs = PRIM_BLOCK if n_chunks > 1 else soa.padded
    has_tri = soa.num_tris > 0
    has_sph = soa.num_prims > soa.num_tris
    m = rays.shape[1]
    inv = [_safe_inv(rays[k]) for k in (3, 4, 5)]
    tmax = rays[6]
    best_t = tmax.clone()
    best_p = torch.full((m,), -1, dtype=torch.int32, device=rays.device)
    best_u = torch.zeros(m, dtype=torch.float32, device=rays.device)
    best_v = torch.zeros_like(best_u)
    blocked = torch.zeros(m, dtype=torch.bool, device=rays.device)
    sc_ok = None
    for j in range(n_chunks):
        limit = torch.where(blocked, -1.0, tmax) if any_hit else best_t
        take = limit > 0.0
        if n_chunks > 1:
            if n_super > 1 and j % SC_FACTOR == 0:
                sc_ok = take & _box_reach(soa.super_bounds, j // SC_FACTOR, rays, inv, limit)
            take = take & _box_reach(soa.chunk_bounds, j, rays, inv, limit)
            if sc_ok is not None:
                take &= sc_ok
        idx = torch.nonzero(take).squeeze(1)
        if idx.numel() == 0:
            continue
        if visits is not None:
            visits.append((idx, j))
        chunk = soa.rows[:, j * PRIM_BLOCK: j * PRIM_BLOCK + cs]
        t, u, v, ok = _chunk_hits(chunk, j * PRIM_BLOCK, rays[:, idx], ignore[idx],
                                  has_tri, has_sph)
        if any_hit:
            blocked[idx] |= (ok & (t < tmax[idx][:, None])).any(dim=1)
            continue
        t = torch.where(ok, t, INF)
        tm = torch.amin(t, dim=1)
        first = torch.argmax((ok & (t == tm[:, None])).to(torch.int8), dim=1)
        closer = tm < best_t[idx]
        pick = lambda x: torch.gather(x, 1, first[:, None])[:, 0]
        best_p[idx] = torch.where(closer, first.to(torch.int32) + j * PRIM_BLOCK, best_p[idx])
        best_u[idx] = torch.where(closer, pick(u), best_u[idx])
        best_v[idx] = torch.where(closer, pick(v), best_v[idx])
        best_t[idx] = torch.where(closer, tm, best_t[idx])
    if any_hit:
        return blocked
    return best_t, best_p, best_u, best_v


def _slices(rays, ignore):
    """Pad to whole warps with the JAX layout's dead rays (o = 0, d = +z,
    t_max = -1, ignore = -1), as the kernels' last warp is, and cut into
    PLAIN_SLICE passes so the (rays, chunk) temporaries stay bounded."""
    n = rays.shape[1]
    n_pad = -(-max(n, 1) // WARP) * WARP
    if n_pad != n:
        fill = torch.tensor([0, 0, 0, 0, 0, 1, -1], dtype=torch.float32, device=rays.device)
        rays = torch.cat([rays, fill[:, None].expand(7, n_pad - n)], dim=1)
        ignore = torch.cat([ignore, ignore.new_full((n_pad - n,), -1)])
    for s in range(0, n_pad, PLAIN_SLICE):
        yield rays[:, s: s + PLAIN_SLICE], ignore[s: s + PLAIN_SLICE]


def dense_trace_plain(rays, ignore, soa: PrimSoA):
    """Plain PyTorch closest hit: (t, sorted slot int32 or -1, u, v)."""
    n = rays.shape[1]
    outs = [_walk(r, i, soa, any_hit=False) for r, i in _slices(rays, ignore)]
    return tuple(torch.cat(parts)[:n] for parts in zip(*outs))


def dense_occlude_plain(rays, ignore, soa: PrimSoA):
    """Plain PyTorch any hit: blocked (bool)."""
    n = rays.shape[1]
    return torch.cat([_walk(r, i, soa, any_hit=True) for r, i in _slices(rays, ignore)])[:n]


# ----------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# ----------------------------------------------------------------------------

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("dense_intersect")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.dense_trace.argtypes = [ptr, ptr, i32, ptr, i32, ptr, i32, ptr, i32,
                                    i32, i32, ptr, ptr, ptr, ptr, ptr]
        lib.dense_trace.restype = i32
        lib.dense_occlude.argtypes = [ptr, ptr, i32, ptr, i32, ptr, i32, ptr, i32,
                                      i32, i32, ptr, ptr]
        lib.dense_occlude.restype = i32
        lib.dense_occupancy.argtypes = [i32, i32, i32, ptr]
        lib.dense_occupancy.restype = i32
        _lib = lib
    return _lib


def occupancy(any_hit: bool, has_tri: bool = True, has_sph: bool = False) -> dict:
    """One kernel form's resident blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), its block size,
    dynamic shared memory per block (the warps' stages) and resident warps
    per SM."""
    out = (ctypes.c_int * 3)()
    err = _load().dense_occupancy(int(any_hit), int(has_tri), int(has_sph), out)
    if err:
        raise RuntimeError(f"dense_occupancy failed: cudaError {err}")
    return dict(blocks=out[0], block=out[1], smem=out[2], warps=out[0] * out[1] // 32)


def _check_inputs(rays, ignore, soa):
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != 7:
        raise ValueError(f"rays must be (7, N) float32, got {tuple(rays.shape)} {rays.dtype}")
    if ignore.dtype != torch.int32 or ignore.shape != (rays.shape[1],):
        raise ValueError(f"ignore must be ({rays.shape[1]},) int32")
    tensors = (rays, ignore, soa.rows, soa.chunk_bounds, soa.super_bounds)
    if any(x.device != rays.device for x in tensors):
        raise ValueError("rays, ignore and the prim tables must share one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("dense kernels need contiguous inputs")
    if rays.shape[1] >= 2 ** 31:
        raise ValueError("too many rays for int32 indexing")


def _kernel_args(rays, ignore, soa):
    return (rays.data_ptr(), ignore.data_ptr(), rays.shape[1],
            soa.rows.data_ptr(), soa.padded,
            soa.chunk_bounds.data_ptr(), soa.n_chunks,
            soa.super_bounds.data_ptr(), soa.n_super,
            int(soa.num_tris > 0), int(soa.num_prims > soa.num_tris))


def dense_trace(rays, ignore, soa: PrimSoA):
    """Closest hit of rays (7, N) [ox oy oz dx dy dz t_max] with sorted-slot
    ignores (N,) int32 against the prim table: (t, slot int32, u, v).
    CUDA tensors launch the kernel; CPU tensors take the plain version."""
    _check_inputs(rays, ignore, soa)
    if rays.device.type == "cpu":
        return dense_trace_plain(rays, ignore, soa)
    if rays.device.type != "cuda":
        raise ValueError(f"dense_trace runs on CUDA or CPU tensors, not {rays.device}")
    lib = _load()
    n = rays.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=rays.device)
    prim = torch.empty(n, dtype=torch.int32, device=rays.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        err = lib.dense_trace(*_kernel_args(rays, ignore, soa), t.data_ptr(), prim.data_ptr(),
                              u.data_ptr(), v.data_ptr(),
                              torch.cuda.current_stream(rays.device).cuda_stream)
        if err:
            raise RuntimeError(f"dense_trace launch failed: cudaError {err}")
        diagnostics.count("launches.dense_trace")
    return t, prim, u, v


def dense_occlude(rays, ignore, soa: PrimSoA):
    """Any hit with t < t_max: blocked (N,) bool. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    _check_inputs(rays, ignore, soa)
    if rays.device.type == "cpu":
        return dense_occlude_plain(rays, ignore, soa)
    if rays.device.type != "cuda":
        raise ValueError(f"dense_occlude runs on CUDA or CPU tensors, not {rays.device}")
    lib = _load()
    n = rays.shape[1]
    blocked = torch.empty(n, dtype=torch.bool, device=rays.device)
    if n:
        err = lib.dense_occlude(*_kernel_args(rays, ignore, soa), blocked.data_ptr(),
                                torch.cuda.current_stream(rays.device).cuda_stream)
        if err:
            raise RuntimeError(f"dense_occlude launch failed: cudaError {err}")
        diagnostics.count("launches.dense_occlude")
    return blocked



# ----------------------------------------------------------------------------
# public contract (original prim ids)
# ----------------------------------------------------------------------------


def _has_reorder(soa: PrimSoA) -> bool:
    return soa.padded > PRIM_BLOCK  # identity order otherwise


def ray_columns(o, d, t_max):
    """(N,3) origins/directions and t_max -> the kernels' (7, N) rows, with
    t_max clamped to the INF sentinel (an infinite t_max would otherwise
    record phantom hits at t = INF)."""
    n = o.shape[0]
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    tm = torch.clamp(tm, max=INF).expand(n)
    return torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], tm]).contiguous()


def _sorted_ignore(soa: PrimSoA, ignore):
    ignore = ignore.to(torch.int32)
    if not _has_reorder(soa):
        return ignore.contiguous()
    ig = soa.inv_order[torch.clamp(ignore, min=0)]
    return torch.where(ignore >= 0, ig, -1).to(torch.int32).contiguous()


def intersect_pallas(geom: FlatGeometry, soa: PrimSoA, o, d, t_max, ignore) -> Hit:
    """Closest hit over all prims through the dense trace kernel."""
    t, p, u, v = dense_trace(ray_columns(o, d, t_max), _sorted_ignore(soa, ignore), soa)
    if _has_reorder(soa):
        prim = torch.where(p >= 0, soa.order[torch.clamp(p, min=0)], -1)  # original ids
    else:
        prim = p
    found = prim >= 0
    return Hit(t=torch.where(found, t, INF), prim=prim.to(torch.int32),
               uv=torch.stack([u, v], dim=-1))


def occlude_pallas(geom: FlatGeometry, soa: PrimSoA, o, d, t_max, ignore) -> torch.Tensor:
    """Any hit in [eps, t_max) through the dense occlude kernel."""
    return dense_occlude(ray_columns(o, d, t_max), _sorted_ignore(soa, ignore), soa)
