#!/usr/bin/env python3
"""Time the chunk-tree walk's kernels, the binned traversal's seg kernel and
the render paths on one NVIDIA GPU: this tree's against another checkout's
(the parent commit, unpacked with `git archive`), on the same inputs in one
process, in turns (other, this, this, other).

    python3 tools/hier_ab.py --other DIR
    python3 tools/hier_ab.py --sweep   # the seg kernel's shapes, no other checkout

Inputs, made on the card from fixed seeds:
  - sphere_grid(1_000_000) (bench.py's large scene) at 1920x1080, 1 spp,
    bounce 6: the trace and occlude calls of the first wave of one program
    (first sample 1, recorded as chip_smoke.py records them), and 2^20
    random rays (chip_smoke.random_rays) traced and occluded;
  - instanced_sphere_grids() prepared with instancing="tlas": the first
    wave's calls of one program;
  - the megakernel's chunk-tree form on the 1M frame (one launch, first
    sample 1), and its untextured and textured forms' launches of the
    bench scene (sphere_field(80)) and the showcase at 960x540, 64 spp,
    bounce 16, whose code shares megakernel.cu;
  - the seg kernel (csrc/binned.cu), keyed and exact, on the pair lists of
    every seg_keys launch recorded from the 1M program's binned waves
    (first sample 1), from the TLAS program's, and from one trace and one
    occlude call of 2^20 random rays through the binned traversal on
    sphere_grid(1M) and on the TLAS scene (per-instance ignores).
Each kernel item is the median of 10 runs (CUDA events, after a warm-up;
a seg item runs all its recorded launches back to back, and its ms a
launch is that over their count), and every output is held bitwise to
this tree's. The
render paths the change could touch are timed too, each the
median of 5 runs by the host clock around a synchronised run: the bench
scene (sphere_field(80), 960x540, 64 spp through render_layer: the
megakernel), the showcase (its textured form), the 1M program through the
main dispatch (walk first wave, binned after), the TLAS program and the 1M
program under ECHO_MEGA_HIER. The other checkout's csrc/hier_walk.cu,
csrc/megakernel.cu and csrc/binned.cu are built with this tree's nvcc
flags into DIR/echorenderer_tpu_torch/_build/ab/ and bound in place of
this tree's libraries (their C interfaces are the same; the seg launches
pass each checkout's own `binned_trace.ROW`). Prints the card's name and
power limit beside every table.

--sweep builds this tree's binned.cu once for each seg kernel shape of
SWEEP (kSegWarps warps a block, kSegTile pairs a warp, kSegUnroll), times
the seg items on each in two passes (the list, then reversed), holds
every output bitwise to this tree's, and prints each shape's resident
warps/SM; the walk, the megakernel and the render paths are not timed.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

RES = (1920, 1080)
# the seg kernel's shapes --sweep times: values of csrc/binned.cu's
# kSegWarps (warps a block), kSegTile (pairs a warp) and kSegUnroll (a full
# batch's 4-prim groups unrolled together)
SWEEP = [dict(kSegWarps=w, kSegTile=t, kSegUnroll=u)
         for w in (1, 2, 4) for t in (16, 32, 64) for u in (1, 2)]


def bind_binned(lib) -> None:
    """The argument types of a binned.cu library's C functions."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.binned_setup.argtypes = [ptr, i32, ptr, i32, i32, i32, ptr, ptr]
    lib.binned_select.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, ptr]
    lib.binned_seg.argtypes = lib.binned_seg_exact.argtypes = [
        ptr, ptr, i32, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
    for fn in (lib.binned_setup, lib.binned_select, lib.binned_seg, lib.binned_seg_exact):
        fn.restype = i32


def nvcc(src: Path, lib: Path):
    """An nvcc process building `src` into `lib` with this tree's flags."""
    from echorenderer_tpu_torch.ops import cuda_build

    return subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
                             str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def build_other(root: Path) -> dict:
    """The other checkout's walk, megakernel and binned libraries, built
    with this tree's flags, with their C functions' argument types, and its
    seg kernel's pairs a block (`row`)."""
    out = root / "echorenderer_tpu_torch" / "_build" / "ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = {stem: nvcc(root / "echorenderer_tpu_torch" / "csrc" / f"{stem}.cu",
                        out / f"lib{stem}.so") for stem in ("hier_walk", "megakernel", "binned")}
    libs = {}
    for stem, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the other checkout's {stem}.cu:\n{err}")
        libs[stem] = ctypes.CDLL(str(out / f"lib{stem}.so"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    common = [ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, ptr, ptr, i32, i32, i32]
    h = libs["hier_walk"]
    h.hier_trace.argtypes, h.hier_trace.restype = common + [ptr] * 6, i32
    h.hier_occlude.argtypes, h.hier_occlude.restype = common + [ptr, ptr], i32
    m = libs["megakernel"]
    m.megakernel.argtypes, m.megakernel.restype = [ptr, ptr, ctypes.c_float, ptr], i32
    m.megakernel_hier.argtypes = [ptr, ptr, ptr, i32, ctypes.c_float, ptr]
    m.megakernel_hier.restype = i32
    bind_binned(libs["binned"])
    row = re.search(r"^ROW = (\d+)", (root / "echorenderer_tpu_torch" / "ops" /
                                      "binned_trace.py").read_text(), re.M)
    libs["row"] = int(row.group(1))
    return libs


def build_shapes(dest: Path) -> dict:
    """This tree's binned.cu built once for each shape of SWEEP (its
    constants replaced) under `dest`: {name: libs}."""
    csrc = REPO / "echorenderer_tpu_torch" / "csrc"
    text = (csrc / "binned.cu").read_text()
    procs = {}
    for shape in SWEEP:
        name = "w{kSegWarps}t{kSegTile}u{kSegUnroll}".format(**shape)
        d = dest / name
        d.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, d)
        src = text
        for const, value in shape.items():
            src, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                             src)
            if n != 1:
                raise RuntimeError(f"binned.cu has no single {const}")
        (d / "binned.cu").write_text(src)
        procs[name] = (nvcc(d / "binned.cu", d / "libbinned.so"), shape)
    shapes = {}
    for name, (proc, shape) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the seg shape {name}:\n{err}")
        lib = ctypes.CDLL(str(dest / name / "libbinned.so"))
        bind_binned(lib)
        lib.binned_seg_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        shapes[name] = dict(binned=lib, row=shape["kSegWarps"] * shape["kSegTile"])
    return shapes


def use(libs: dict):
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.ops import megakernel as mk
    from echorenderer_tpu_torch.ops import pallas_hier as ph

    ph._lib = libs.get("hier_walk", ph._lib)
    mk._lib = libs.get("megakernel", mk._lib)
    bt._lib, bt.ROW = libs["binned"], libs["row"]


def median_ms(fn, runs: int = 10) -> float:
    from chip_smoke import run_ms

    return statistics.median(run_ms(fn, runs))


def first_wave(scene, seed_start: int = 1):
    """The walk's calls of one program's first wave ({"trace": [...],
    "occlude": [...]}, each (rays, sorted ignores[, ignores' instances]))."""
    from chip_smoke import RayWork
    from echorenderer_tpu_torch.processes.render import _sample_frame

    with RayWork(cull=True, record=True) as rec:
        _sample_frame(scene, "path", RES, 0, seed_start, 1, 6, 2.5)
    return rec.calls


def seg_launches(run) -> list:
    """The inputs of every seg_keys launch of `run()`, copied:
    [(rec, chunk, prim_chunks, has_tri, has_sph, inst)]."""
    from echorenderer_tpu_torch.ops import binned_trace as bt

    got, real = [], bt.seg_keys

    def recorded(rec, chunk, prim_chunks, has_tri, has_sph, inst=None):
        got.append((rec.clone(), chunk.clone(), prim_chunks, has_tri, has_sph, inst))
        return real(rec, chunk, prim_chunks, has_tri, has_sph, inst=inst)

    bt.seg_keys = recorded
    try:
        run()
    finally:
        bt.seg_keys = real
    return got


def seg_items(dev, grid, tlas, rnd, rs) -> tuple:
    """({name: fn}, {name: launches}) of the seg kernel, keyed and exact, on
    the recorded launches of the 1M and TLAS programs and of 2^20 random
    rays, flat and instanced."""
    import numpy as np
    import torch

    from chip_smoke import random_rays
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.ops import pallas_intersect as pi
    from echorenderer_tpu_torch.processes.render import _sample_frame

    soa, isoa = grid.hier_soa, tlas.hier_soa
    real = (isoa.binned_wcb[:, 0] <= isoa.binned_wcb[:, 3]) & (isoa.binned_wcb[:, 3] < 1e6)
    o, d, t_max, ignore = random_rays(rs, 2 ** 20, isoa.binned_wcb[real, 0:3].amin(0).tolist(),
                                      isoa.binned_wcb[real, 3:6].amax(0).tolist(),
                                      isoa.num_prims)
    ii = rs.randint(0, tlas.instances.num_instances, len(o)).astype(np.int32)
    o, d, t_max, ignore, ii = (torch.as_tensor(np.ascontiguousarray(a), device=dev)
                               for a in (o, d, t_max, ignore, ii))
    irnd = (pi.ray_columns(o, d, t_max), ph._sorted_ignore(isoa, ignore),
            ph._ignore_inst(isoa, ignore, ii))

    def both(table, call):
        return lambda: [bt._Walk(*call[:2], table, occ, *call[2:]).traverse()
                        for occ in (False, True)]

    recorded = {
        "1M program": seg_launches(lambda: _sample_frame(grid, "path", RES, 0, 1, 1, 6, 2.5)),
        "TLAS program": seg_launches(lambda: _sample_frame(tlas, "path", RES, 0, 1, 1, 6, 2.5)),
        "random rays": seg_launches(both(soa, rnd)),
        "instanced random rays": seg_launches(both(isoa, irnd)),
    }
    items, counts = {}, {}
    for label, launches in recorded.items():
        for form, fn in (("keyed", "seg_keys"), ("exact", "seg_hits")):
            name = f"seg {form}, {label}"
            items[name] = lambda ls=launches, fn=fn: [
                getattr(bt, fn)(rec, c, pcs, tri, sph, inst=inst)
                for rec, c, pcs, tri, sph, inst in ls]
            counts[name] = len(launches)
    return items, counts


def inputs(dev):
    """(kernel items {name: fn}, launches or calls per item, scenes) on this
    tree's kernels."""
    import numpy as np
    import torch

    from chip_smoke import random_rays, showcase_scene, tile_lanes
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.ops import megakernel as mk
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.ops import pallas_intersect as pi
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    grid = prepare_scene(scenes.sphere_grid(1_000_000), device=dev)
    tlas = prepare_scene(scenes.instanced_sphere_grids(), instancing="tlas", device=dev)
    soa, isoa = grid.hier_soa, tlas.hier_soa
    rs = np.random.RandomState(2024)
    lo = soa.chunk_bounds[:, 0:3].amin(0).tolist()
    hi = soa.chunk_bounds[:, 3:6].amax(0).tolist()
    o, d, t_max, ignore = (torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in
                           random_rays(rs, 2 ** 20, [lo[0], 0.05, lo[2]],
                                       [hi[0], hi[1] + 1.0, hi[2]],
                                       grid.geometry.num_primitives))
    rnd = (pi.ray_columns(o, d, t_max), ph._sorted_ignore(soa, ignore))
    flat, inst = first_wave(grid), first_wave(tlas)
    pid, pxy = tile_lanes(RES, dev)
    bench = prepare_scene(scenes.sphere_field(80), device=dev)
    show = prepare_scene(showcase_scene(), device=dev)
    spid, spxy = tile_lanes((960, 540), dev)

    def calls(kernel, table, cs):
        return lambda: [kernel(c[0], c[1], table, *c[2:]) for c in cs]

    items = {
        "first-wave trace": calls(ph.hier_trace, soa, flat["trace"]),
        "first-wave occlude": calls(ph.hier_occlude, soa, flat["occlude"]),
        "random trace": calls(ph.hier_trace, soa, [rnd]),
        "random occlude": calls(ph.hier_occlude, soa, [rnd]),
        "instanced first-wave trace": calls(ph.hier_trace, isoa, inst["trace"]),
        "instanced first-wave occlude": calls(ph.hier_occlude, isoa, inst["occlude"]),
        "chunk-tree megakernel 1M launch": lambda: mk.sample_frame_mega(
            grid, pid, pxy, RES, 0, 1, 1, hier=True, bounce_limit=6, survivability=2.5),
        "untextured megakernel bench launch": lambda: mk.sample_frame_mega(
            bench, spid, spxy, (960, 540), 0, 0, 64, bounce_limit=16, survivability=2.5),
        "textured megakernel showcase launch": lambda: mk.sample_frame_mega(
            show, spid, spxy, (960, 540), 0, 0, 64, bounce_limit=16, survivability=2.5),
    }
    counts = {"first-wave trace": len(flat["trace"]), "first-wave occlude": len(flat["occlude"]),
              "instanced first-wave trace": len(inst["trace"]),
              "instanced first-wave occlude": len(inst["occlude"])}
    seg, seg_counts = seg_items(dev, grid, tlas, rnd, rs)
    items.update(seg)
    counts.update(seg_counts)
    return items, counts, dict(grid=grid, tlas=tlas, bench=bench, show=show)


def same(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if a is None or b is None:
        return a is b
    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))


def kernel_turn(items, want, runs: int = 10) -> dict:
    """Each item's median ms of `runs` runs; its output held to `want`."""
    import torch

    out = {}
    for name, fn in items.items():
        got = fn()
        torch.cuda.synchronize()
        if not same(got, want[name]):
            raise AssertionError(f"{name}: output differs from this tree's")
        del got
        out[name] = median_ms(fn, runs)
    return out


def sweep(items, want, counts, smi) -> None:
    """The seg items on each shape of SWEEP, two passes."""
    from echorenderer_tpu_torch.ops import binned_trace as bt

    shapes = build_shapes(REPO / "echorenderer_tpu_torch" / "_build" / "sweep")
    for name, libs in shapes.items():
        occ = (ctypes.c_int * 3)()
        libs["binned"].binned_seg_occupancy(1, 0, 1, 0, occ)
        print(f"[sweep] {smi} | {name} ({libs['row']} pairs a block): {occ[2]} bytes dynamic "
              f"smem, {occ[0] * occ[1] // 32} resident warps/SM (flat keyed triangle-only form)")
    times = {key: [] for key in shapes}
    for order in (list(shapes), list(shapes)[::-1]):
        for key in order:
            use(shapes[key])
            times[key].append(kernel_turn(items, want, runs=5))
    use(dict(binned=bt._load(), row=bt.ROW))
    for name in items:
        n = max(counts[name], 1)
        print(f"[sweep] {smi} | {name} ({n} launches), ms a launch (median of 5 runs, two "
              f"passes): " + "; ".join(f"{key} {a[name] / n:.4f}, {b[name] / n:.4f}"
                                       for key, (a, b) in times.items()))


def render_paths(scenes_):
    """{path: (fn, samples)} of the render paths the change could touch."""
    from echorenderer_tpu_torch.processes.render import (EvaluationProfile, _sample_frame,
                                                         render_layer)

    bench, show = scenes_["bench"], scenes_["show"]
    prof = EvaluationProfile(samples_per_epoch=64, max_epoch=1, bounce_limit=16,
                             survivability=2.5, adaptive=False)
    grid, tlas = scenes_["grid"], scenes_["tlas"]
    n_px = RES[0] * RES[1]

    @contextlib.contextmanager
    def mega_hier():
        os.environ["ECHO_MEGA_HIER"] = "1"
        try:
            yield
        finally:
            del os.environ["ECHO_MEGA_HIER"]

    def program(scene, gate=contextlib.nullcontext):
        def run():
            with gate():
                _sample_frame(scene, "path", RES, 0, 1, 1, 6, 2.5)
        return run

    return {
        "bench sphere_field(80) 960x540 64 spp": (lambda: render_layer(bench, prof, (960, 540)),
                                                  960 * 540 * 64),
        "showcase 960x540 64 spp": (lambda: render_layer(show, prof, (960, 540)),
                                    960 * 540 * 64),
        "1M main dispatch program": (program(grid), n_px),
        "TLAS program": (program(tlas), n_px),
        "1M ECHO_MEGA_HIER program": (program(grid, mega_hier), n_px),
    }


def path_turn(paths) -> dict:
    """Each path's Mspps: the median of 5 synchronised runs after a warm-up."""
    import torch

    out = {}
    for name, (fn, samples) in paths.items():
        fn()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = samples / statistics.median(walls) / 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, help="a checkout to time against (the parent)")
    ap.add_argument("--sweep", action="store_true",
                    help="time the seg kernel's shapes of SWEEP instead")
    a = ap.parse_args()
    if (a.other is not None) == a.sweep:
        ap.error("give --other DIR or --sweep")
    import torch

    if not torch.cuda.is_available():
        print("hier_ab: no CUDA device", file=sys.stderr)
        return 1
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.ops import megakernel as mk
    from echorenderer_tpu_torch.ops import pallas_hier as ph

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    this = dict(hier_walk=ph._load(), megakernel=mk._load(), binned=bt._load(), row=bt.ROW)
    t0 = time.perf_counter()
    items, counts, scenes_ = inputs(dev)
    if a.sweep:
        items = {k: v for k, v in items.items() if k.startswith("seg ")}
    want = {name: fn() for name, fn in items.items()}
    torch.cuda.synchronize()
    print(f"[ab] {smi} | inputs in {time.perf_counter() - t0:.1f} s; calls or launches per "
          f"item: {counts}")
    if a.sweep:
        sweep(items, want, counts, smi)
        return 0
    other = build_other(a.other.resolve())
    paths = render_paths(scenes_)
    kturns, pturns = [], []
    for label, libs in (("other", other), ("this", this), ("this", this), ("other", other)):
        use(libs)
        kturns.append((label, kernel_turn(items, want)))
        pturns.append((label, path_turn(paths)))
        print(f"[ab] {smi} | turn {len(kturns)} ({label}): kernel ms (median of 10): "
              + ", ".join(f"{k} {v:.4f}" for k, v in kturns[-1][1].items()))
        print(f"[ab] {smi} | turn {len(pturns)} ({label}): Mspps (median of 5): "
              + ", ".join(f"{k} {v:.4f}" for k, v in pturns[-1][1].items()))
    use(this)
    for name in items:
        o = [t[name] for lab, t in kturns if lab == "other"]
        s = [t[name] for lab, t in kturns if lab == "this"]
        each = ""
        if name.startswith("seg "):  # the recorded launches, back to back
            n = max(counts[name], 1)
            each = (f" ({n} launches: other {o[0] / n:.4f}, {o[1] / n:.4f}; this {s[0] / n:.4f}, "
                    f"{s[1] / n:.4f} ms a launch)")
        print(f"[ab] {smi} | {name}: other {o[0]:.4f}, {o[1]:.4f} ms; this {s[0]:.4f}, "
              f"{s[1]:.4f} ms{each}; this / other {statistics.fmean(s) / statistics.fmean(o):.3f}")
    for name in paths:
        o = [t[name] for lab, t in pturns if lab == "other"]
        s = [t[name] for lab, t in pturns if lab == "this"]
        print(f"[ab] {smi} | {name}: other {o[0]:.4f}, {o[1]:.4f} Mspps; this {s[0]:.4f}, "
              f"{s[1]:.4f} Mspps; this / other {statistics.fmean(s) / statistics.fmean(o):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
