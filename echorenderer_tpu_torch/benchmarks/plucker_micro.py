"""Micro-benchmark: keyed triangle intersection in the Plücker form against
Möller-Trumbore over one resident chunk of 256 triangles (counterpart of
benchmarks/plucker_micro.py, the JAX package's script).

The binned traversal's pair kernel tests every prim of a chunk with
Möller-Trumbore. The Plücker form precomputes per triangle its edge moments,
so that the three edge volumes w_i = d.(P x Q) + m.(Q - P) (m = o x d), the
plane's n.d and n.v0 - n.o are dot products of a (16, 5*256) table
(`build_plk`) with per-ray columns [d, m, o, 1], leaving a short epilogue:
inside when all three w have one sign, t = num / den, a hit when EPS < t <
t_max and the prim is not ignored. Both kernels return per ray the least
packed key (bits(t) & ~0xFF) | prim, _INT_INF without a hit.

    python -m echorenderer_tpu_torch.benchmarks.plucker_micro [--n-log2 20] [--device cpu]

It draws the JAX script's random soup and rays (RandomState(7), rays in
[0, 4)^3 with unit directions) and prints, for the scene frame and for the
chunk-local frame (the table and the origins shifted by the prims' mean
v0), the agreement of the Plücker keys with the Möller-Trumbore keys: the
share of equal keys, prim flips and hit/miss flips among all rays, and the
largest relative t gap where both hit; then, on the card, ms and ns per
(ray, chunk) pair of each kernel beside the card's name and power limit.
It runs on the card unless `--device cpu` is given (then the plain
versions, numerics only); without a card it fails, it never falls back.

Kernels (csrc/plucker.cu, built with nvcc on first use): `keys_mt` replaces
`kern_mt` (benchmarks/plucker_micro.py:79), `keys_plk` the kernel of
`make_kern_plk` (:141-149, body `_plk_keyed` :99) at both precisions:
"highest" sums the f32 products, "default" rounds the table and the
per-ray operands to bf16 first (the TPU's one-pass bf16 product with f32
sums). Each has a plain PyTorch version beside it, which CPU tensors take.
The MT and HIGHEST kernels sum in the plain versions' fixed left-to-right
order and are bitwise equal to them. The DEFAULT kernel computes its
products on the tensor cores (wgmma), which sum in their own order, as the
TPU's matrix unit does: it is held to its plain version by
`default_within_contract`, not bitwise.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_build
from ..ops.binned_trace import _route as _device_route
from ..ops.pallas_intersect import _EPS, _chunk_hits
from ..utils import diagnostics

_INF = 3.4e38
_INT_INF = 2**31 - 1
H = 256  # triangles in the resident chunk
_PBITS = 8
PRECISIONS = ("highest", "default")
FRAMES = ("scene-frame", "chunk-local")
PLAIN_SLICE = 2**14  # rays per pass of the plain versions


def _bits(x):
    return x.contiguous().view(torch.int32)


def _bf16(x):
    """Round to bf16 (nearest even), values back as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def build_plk(prims, center=None):
    """prims (10, H) rows [v0 xyz, e1 xyz, e2 xyz, is_sphere] -> the (16, 5H)
    f32 table: column groups [w0 | w1 | w2 | den | num] of H each, rows
    [d slots 0:3, m slots 3:6, o slots 6:9, one slot 9, zeros 10:16].
    `center` (3,) moves the working frame to chunk-local coordinates (the
    rays' origins must be moved by the same center)."""
    v0 = prims[0:3] if center is None else prims[0:3] - center[:, None]
    e1, e2 = prims[3:6], prims[6:9]
    c0 = _cross(v0, e1)
    c1 = _cross(v0, e2) - _cross(v0, e1) + _cross(e1, e2)
    c2 = -_cross(v0, e2)
    n = _cross(e1, e2)
    nv0 = n[0] * v0[0] + n[1] * v0[1] + n[2] * v0[2]
    z, z1, pad = torch.zeros_like(v0), torch.zeros_like(nv0), torch.zeros_like(prims[0:6])

    def col16(dm, mm, om, onev):
        return torch.cat([dm, mm, om, onev[None], pad])

    return torch.cat([col16(c0, e1, z, z1), col16(c1, e2 - e1, z, z1), col16(c2, -e2, z, z1),
                      col16(n, z, z, z1), col16(z, z, -n, nv0)], dim=1).contiguous()


def micro_scene(n, seed=7, device="cpu"):
    """The JAX script's random soup and rays, drawn in its order: prims
    (10, H) and cols (8, n) [o xyz, d xyz, t_max = _INF, ignore = -1], f32
    on `device`. cols[a].view(n // 1024, 8, 128) is the script's a-th
    column."""
    rs = np.random.RandomState(seed)
    v0 = rs.uniform(0, 4, (3, H)).astype(np.float32)
    e1 = rs.normal(0, 0.25, (3, H)).astype(np.float32)
    e2 = rs.normal(0, 0.25, (3, H)).astype(np.float32)
    prims = np.concatenate([v0, e1, e2, np.zeros((1, H), np.float32)], 0)
    o = rs.uniform(0, 4, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cols = np.concatenate([o.T, d.T, np.full((1, n), _INF, np.float32),
                           np.full((1, n), -1.0, np.float32)], 0)
    return (torch.as_tensor(prims, device=device),
            torch.as_tensor(np.ascontiguousarray(cols), device=device))


def local_frame(prims, cols, center=None):
    """(cols with the origins moved by `center`, center): the chunk-local
    frame, the center by default the prims' mean v0."""
    if center is None:
        center = prims[0:3].mean(1)
    local = cols.clone()
    local[0:3] -= center[:, None]
    return local, center


# ----------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card's reference)
# ----------------------------------------------------------------------------


def keys_mt_plain(prims, cols):
    """Plain PyTorch keyed Möller-Trumbore: per ray the least (bits(t) &
    ~0xFF) | prim over the triangles hit with t < t_max (`_chunk_hits`,
    triangles only; the ignore compared as an int)."""
    n = cols.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=cols.device)
    local = torch.arange(H, dtype=torch.int32, device=cols.device)[None]
    for s in range(0, n, PLAIN_SLICE):
        c = cols[:, s: s + PLAIN_SLICE]
        t, _, _, ok = _chunk_hits(prims, 0, c, c[7].to(torch.int32), True, False)
        valid = ok & (t < c[6][:, None]) & (t < _INF)
        out[s: s + PLAIN_SLICE] = torch.where(valid, (_bits(t) & -(1 << _PBITS)) | local,
                                              _INT_INF).amin(1)
    return out


def _dot(lhs, rhs):
    """(P, S) sums over k of lhs[k] (P,) x rhs[k] (S,), left to right from
    the first product: the CUDA-core kernels' order."""
    acc = lhs[0][:, None] * rhs[0][None]
    for k in range(1, len(rhs)):
        acc = acc + lhs[k][:, None] * rhs[k][None]
    return acc


def _plk_table(plk, prec):
    """(the operand rounding of `prec`, the table rounded by it)."""
    if prec not in PRECISIONS:
        raise ValueError(f"prec must be one of {PRECISIONS}, got {prec!r}")
    rnd = _bf16 if prec == "default" else (lambda x: x)
    return rnd, rnd(plk)


def _plk_inside(lhs, cols, rnd):
    """(the per-ray operands [d, m] rounded by `rnd`, the (H, S) sign test
    of the edge volumes w = rows 0:6 of groups 0..2 against them) of the
    rays cols (8, S)."""
    ox, oy, oz, dx, dy, dz = cols[0:6]
    ra = [rnd(x) for x in (dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)]
    w = _dot(lhs[0:6, 0:3 * H], ra)
    w0, w1, w2 = w[0:H], w[H:2 * H], w[2 * H:3 * H]
    inside = ((torch.minimum(torch.minimum(w0, w1), w2) >= 0.0)
              | (torch.maximum(torch.maximum(w0, w1), w2) <= 0.0))
    return ra, inside


def inside_pairs(plk, cols, prec):
    """The (ray, triangle) pairs of cols (8, N) against the (16, 5H) table
    that pass the sign test at `prec`, as the plain version computes it:
    the pairs on which the Plücker kernels compute the plane, the division
    and the key (a Python int)."""
    rnd, lhs = _plk_table(plk, prec)
    return sum(int(_plk_inside(lhs, cols[:, s: s + PLAIN_SLICE], rnd)[1].sum())
               for s in range(0, cols.shape[1], PLAIN_SLICE))


def keys_plk_plain(plk, cols, prec):
    """Plain PyTorch keys through the Plücker form of the (16, 5H) table:
    w = 6-term sums of rows 0:6 of groups 0..2 against [d, m], den = rows
    0:3 of group 3 against d, num = rows 6:10 of group 4 against [o, 1];
    inside when min(w) >= 0 or max(w) <= 0; t = num / den; a hit when t >
    EPS, t < t_max and prim != ignore. prec "default" rounds the table and
    the per-ray operands to bf16 before the products. (The JAX kernel's
    edge product also has rows 6:8 against two literal zeros; for a finite
    table those products add +-0 to a w, which only the sign test reads,
    and it treats +-0 alike, so the keys are the same without them.)"""
    rnd, lhs = _plk_table(plk, prec)
    den_l, num_l = lhs[0:3, 3 * H:4 * H], lhs[6:10, 4 * H:5 * H]
    n = cols.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=cols.device)
    pid = torch.arange(H, dtype=torch.int32, device=cols.device)[:, None]
    for s in range(0, n, PLAIN_SLICE):
        c = cols[:, s: s + PLAIN_SLICE]
        ox, oy, oz, tm, ig = c[0], c[1], c[2], c[6], c[7]
        ra, inside = _plk_inside(lhs, c, rnd)
        rc = [rnd(ox), rnd(oy), rnd(oz), torch.ones_like(ox)]
        t = _dot(num_l, rc) / _dot(den_l, ra[:3])
        valid = inside & (t > _EPS) & (t < tm[None]) & (pid != ig.to(torch.int32)[None])
        out[s: s + PLAIN_SLICE] = torch.where(valid, (_bits(t) & -(1 << _PBITS)) | pid,
                                              _INT_INF).amin(0)
    return out


# the DEFAULT kernel's contract with its plain version, as shares of the rays
DEFAULT_FLIPS_MAX = 1e-4  # prim flips plus hit/miss flips
DEFAULT_DIFFER_MAX = 1e-3  # keys that differ at all
BAND = 1 << _PBITS  # one t band of a key: |key difference| of a same-prim key one band away


def default_within_contract(keys, plain):
    """Whether DEFAULT keys (N,) hold to the plain version's (N,) keys by
    the contract that replaces bitwise equality for the tensor-core form
    (its products summed in the tensor cores' order, as on the TPU's
    matrix unit): prim flips plus hit/miss flips on at most
    DEFAULT_FLIPS_MAX of the rays, differing keys on at most
    DEFAULT_DIFFER_MAX, and every other differing key the same prim one t
    band away (|key difference| = 256). Returns (ok, counts) with counts
    rays, differ, prim_flips, hit_flips, off_band (same prim, not one band
    away) and max_abs (the largest |key difference| over the rays without
    a prim or hit/miss flip, whose key difference is a t gap), Python
    ints."""
    keys, plain = torch.as_tensor(keys), torch.as_tensor(plain)
    if keys.shape != plain.shape or keys.dim() != 1:
        raise ValueError(f"two (N,) key arrays expected, got {tuple(keys.shape)} and "
                         f"{tuple(plain.shape)}")
    plain = plain.to(keys.device)
    n = keys.shape[0]
    hit_a, hit_b = keys != _INT_INF, plain != _INT_INF
    differ = keys != plain
    prim_flip = hit_a & hit_b & ((keys & 0xFF) != (plain & 0xFF))
    hit_flip = hit_a != hit_b
    delta = (keys.long() - plain.long()).abs()
    off_band = differ & ~prim_flip & ~hit_flip & (delta != BAND)
    counts = dict(rays=n, differ=int(differ.sum()), prim_flips=int(prim_flip.sum()),
                  hit_flips=int(hit_flip.sum()), off_band=int(off_band.sum()),
                  max_abs=int(torch.where(prim_flip | hit_flip, 0, delta).max()) if n else 0)
    ok = (counts["prim_flips"] + counts["hit_flips"] <= DEFAULT_FLIPS_MAX * n
          and counts["differ"] <= DEFAULT_DIFFER_MAX * n and counts["off_band"] == 0)
    return ok, counts


# ----------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# ----------------------------------------------------------------------------

_lib = None


def _bind(lib):
    """Set the argument and return types of a built plucker.cu's C
    functions on its ctypes handle `lib` (plucker_form where the library
    has it: older builds lack it); returns lib."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.plucker_mt.argtypes = [ptr, ptr, i32, ptr, ptr]
    lib.plucker_plk.argtypes = [ptr, ptr, i32, i32, ptr, ptr]
    lib.plucker_mt.restype = lib.plucker_plk.restype = i32
    if hasattr(lib, "plucker_form"):
        lib.plucker_form.argtypes, lib.plucker_form.restype = [i32, ptr], i32
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = _bind(cuda_build.load("plucker"))
    return _lib


def _route(name, table, rows, cols):
    """'plain' for CPU tensors, 'cuda' for CUDA tensors; raises on anything
    the kernels do not take."""
    if table.dtype != torch.float32 or tuple(table.shape) != rows:
        raise ValueError(f"{name}: the table must be {rows} float32, got {tuple(table.shape)} "
                         f"{table.dtype}")
    if cols.dtype != torch.float32 or cols.dim() != 2 or cols.shape[0] != 8:
        raise ValueError(f"{name}: cols must be (8, N) float32, got {tuple(cols.shape)} "
                         f"{cols.dtype}")
    if cols.shape[1] >= 2**31:
        raise ValueError(f"{name}: too many rays for int32 indexing")
    route = _device_route(name, cols, (table, cols))
    if route == "cuda" and table.data_ptr() % 16:
        raise ValueError(f"{name}: the table must start on a 16-byte boundary (bulk copies)")
    return route


def _launch(fn, name, table, cols, *extra):
    n = cols.shape[1]
    out = torch.empty(n, dtype=torch.int32, device=cols.device)
    if n:
        err = fn(table.data_ptr(), cols.data_ptr(), n, *extra, out.data_ptr(),
                 torch.cuda.current_stream(cols.device).cuda_stream)
        if err:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        diagnostics.count(f"launches.plucker_{name}")  # CUDA tensors only
    return out


KERNELS = ("mt", "plk_highest", "plk_default")  # plucker_form's kernel index order


def forms() -> dict:
    """{kernel: the form it launches}: resident blocks a SM, threads a
    block, dynamic shared memory a block, SMs, and rays a thread (mt,
    plk_highest) or prims a wgmma product (plk_default). Needs a card."""
    lib = _load()
    out = (ctypes.c_int * 5)()
    got = {}
    for i, name in enumerate(KERNELS):
        err = lib.plucker_form(i, out)
        if err:
            raise RuntimeError(f"plucker_form({name}) failed: cudaError {err}")
        got[name] = dict(blocks=out[0], threads=out[1], smem=out[2], sms=out[3],
                         warps=out[0] * out[1] // 32,
                         **({"prims": out[4]} if name == "plk_default" else {"rays": out[4]}))
    return got


def keys_mt(prims, cols):
    """Keyed Möller-Trumbore of every ray of cols (8, N) against the
    triangles of prims (10, H): (N,) int32 keys. CUDA tensors launch the
    kernel; CPU tensors take the plain version."""
    if _route("keys_mt", prims, (10, H), cols) == "plain":
        return keys_mt_plain(prims, cols)
    return _launch(_load().plucker_mt, "mt", prims, cols)


def keys_plk(plk, cols, prec):
    """The same keys through the Plücker form of the (16, 5H) table of
    `build_plk`, at precision "highest" or "default": (N,) int32. CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    if prec not in PRECISIONS:
        raise ValueError(f"prec must be one of {PRECISIONS}, got {prec!r}")
    if _route("keys_plk", plk, (16, 5 * H), cols) == "plain":
        return keys_plk_plain(plk, cols, prec)
    return _launch(_load().plucker_plk, f"plk_{prec}", plk, cols, int(prec == "default"))


# ----------------------------------------------------------------------------
# the benchmark
# ----------------------------------------------------------------------------


def run_keys(prims, cols):
    """The keys main() compares, through the wrappers: Möller-Trumbore in
    the scene frame ("mt"), and the Plücker form in both frames at both
    precisions ("<frame> <prec>"). Returns (keys, {frame: (table, cols)})."""
    local, center = local_frame(prims, cols)
    inputs = {"scene-frame": (build_plk(prims), cols),
              "chunk-local": (build_plk(prims, center), local)}
    keys = {"mt": keys_mt(prims, cols)}
    for frame, (plk, cc) in inputs.items():
        for prec in PRECISIONS:
            keys[f"{frame} {prec}"] = keys_plk(plk, cc, prec)
    return keys, inputs


def agreement(mt, other):
    """The JAX script's statistics of two key arrays: the share of equal
    keys, of rays where both hit different prims, of rays where one hits
    and the other misses, and the largest relative t gap where both hit."""
    mt, other = np.asarray(mt, np.int32), np.asarray(other, np.int32)
    both = (mt != _INT_INF) & (other != _INT_INF)
    t_mt = np.where(both, (mt & ~0xFF).view(np.float32), 0)
    t_ot = np.where(both, (other & ~0xFF).view(np.float32), 0)
    rel = np.abs(t_mt - t_ot) / np.maximum(np.abs(t_mt), 1e-6)
    return dict(key_agree=float((mt == other).mean()),
                prim_flips=float((both & ((mt & 0xFF) != (other & 0xFF))).mean()),
                hit_flips=float(((mt != _INT_INF) != (other != _INT_INF)).mean()),
                t_rel_max=float(rel.max()), hits=int((mt != _INT_INF).sum()))


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]


def _median_ms(fn, runs=10):
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-log2", type=int, default=20, help="rays: 2**N (default 20)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the plain versions, numerics only")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("plucker_micro: no CUDA device (--device cpu runs the numerics alone)",
              file=sys.stderr)
        return 1
    n = 2 ** args.n_log2
    prims, cols = micro_scene(n, device=args.device)
    keys, inputs = run_keys(prims, cols)
    for frame in FRAMES:
        for prec in PRECISIONS:
            a = agreement(keys["mt"].cpu(), keys[f"{frame} {prec}"].cpu())
            print(f"{frame} {prec.upper()}: key agree {a['key_agree']:.7f}  prim flips "
                  f"{a['prim_flips']:.2e}  hit/miss flips {a['hit_flips']:.2e}  t rel max "
                  f"{a['t_rel_max']:.3e}  ({a['hits']} of {n} rays hit)")
    if args.device == "cpu":
        print("(CPU: numerics only)")
        return 0
    smi = card_line()
    plk, local = inputs["chunk-local"]
    for name, fn in (("MT keyed", lambda: keys_mt(prims, local)),
                     ("Plücker HIGHEST", lambda: keys_plk(plk, local, "highest")),
                     ("Plücker DEFAULT", lambda: keys_plk(plk, local, "default"))):
        ms = _median_ms(fn)
        print(f"  {name:28s} {ms:9.4f} ms  {ms * 1e6 / n:7.3f} ns/pair | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
