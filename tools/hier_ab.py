#!/usr/bin/env python3
"""Time the chunk-tree walk's kernels, the binned traversal's setup, select
and seg kernels and the render paths on one NVIDIA GPU: this tree's against
another checkout's (the parent commit, unpacked with `git archive`), on the
same inputs in one process, in turns (other, this, this, other).

    python3 tools/hier_ab.py --other DIR
    python3 tools/hier_ab.py --shapes [--other DIR]  # setup/select shape table only
    python3 tools/hier_ab.py --sweep   # the seg kernel's shapes, no other checkout
    python3 tools/hier_ab.py --sweep select-setup   # setup's and select's forms
    python3 tools/hier_ab.py --mega-stages [--other DIR] [--dump DIR]
    python3 tools/hier_ab.py --dense --other DIR  # the dense kernels' A/B only
    python3 tools/hier_ab.py --sweep dense   # the dense kernels' crossover and block size
    python3 tools/hier_ab.py --plucker [--other DIR]  # the Plücker micro-benchmark's kernels
    python3 tools/hier_ab.py --sweep plucker   # their forms (prims a wgmma product, rays a thread)
    python3 tools/hier_ab.py --refill   # the refill kernel against the plain refill

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
    bounce 16, whose code shares megakernel.cu, and of the Cornell box at
    128x128, material_ball and sphere_grid(1900) (2048 padded prims, the
    top of the envelope) at 320x180, 8 spp, bounce 16;
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
pass each checkout's own `binned_trace.ROW`; a megakernel.cu from before
the path pool, without the occupancy query, gets PARENT_OCCUPANCY). The dense kernels', hier_kernel's,
the seg kernel's and the chunk-tree megakernel's SASS (cuobjdump -sass) is
held against the other checkout's, kernel by kernel. Prints the card's name and power limit
beside every table.

Setup and select (csrc/binned.cu binned_setup / binned_select) are timed on
every launch of the same four binned runs (the 1M and TLAS programs, the
random rays flat and instanced), as it happens (ShapeTimer): the wrapper's
launch as chip_smoke.py times it (CUDA events around the Python call on an
idle card), then each checkout's C entry in turns on fresh copies of the
inputs, the card kept busy while the host makes the call, every output held
bitwise to the wrapper's. The shape table groups the launches by program
and shape (select: w and k; setup: supers and s_out) and prints rays,
refilling rays or eligible supers a ray, ms a launch, bound, % of bound and
launches x (ms - bound). --shapes prints only that table (this tree's C
entries, or with --other both checkouts').

--refill times every refill of the same four binned runs: the plain
refill (the PyTorch ops a round issued before the refill kernel) and the
kernel on the same inputs in turns (plain, kernel, kernel, plain), every
output held bitwise; by run, ksup and capped or uncapped order: launches,
rays, refilling rays, ms a launch, bound and % of bound (refill_turns).
A checkout bound by `use` whose binned library has no refill kernel
refills by `refill_plain`, as that checkout did.

--sweep select-setup builds this tree's binned.cu once for each form of
SHAPE_SWEEP (its kSelectForms and kSetupForms replaced by one form at every
shape) and prints the shape table with every form's C entry beside this
tree's, each held bitwise.

--sweep builds this tree's binned.cu once for each seg kernel shape of
SWEEP (kSegWarps warps a block, kSegTile pairs a warp, kSegUnroll), times
the seg items on each in two passes (the list, then reversed), holds
every output bitwise to this tree's, and prints each shape's resident
warps/SM; the walk, the megakernel and the render paths are not timed.

--dense times the dense trace and occlude kernels (csrc/dense_intersect.cu)
of both checkouts in turns (other, this, this, other) on three sets of
calls: every call of the wavefront path's sphere_field(2400) render
(320x180, 8 spp, bounce 16) and of a mid-size mesh's, sphere_grid(50_000)
(51,200 triangles; 320x180, 8 spp, bounce 6), both recorded as
chip_smoke.py records them, and one call each of chip_smoke.py's 42k-prim
soup at 2^20 rays: the C entry alone (chip_smoke.entry_ms: a set's launches
back to back, the card kept busy while the host makes the first call) and
a call of the wrapper, each output held bitwise to this tree's wrapper,
beside the bound, the % of bound and launches x (ms - bound); each form's
resident warps/SM. As a yardstick it times the walk (ops/pallas_hier.py) on
the sphere_grid(50_000) calls, its hits held to the dense kernels', and
renders that frame on the dense kernels and on the walk alone
(`scene_ops.walk_only()`) in turns; and the two render paths the dense
kernels run, in turns with the other checkout. The SASS of every other
kernel is held to the other checkout's.

--sweep dense builds this tree's dense_intersect.cu once for each form of
DENSE_SWEEP (its kCoopMax and kDenseWarps replaced) and times every form's
C entry on the same three sets in two passes (the list, then reversed),
each output held bitwise to this tree's, with each form's registers and
resident warps/SM.

--plucker times the Plücker micro-benchmark's three kernels (csrc/plucker.cu:
mt_kernel, the Plücker form at HIGHEST and at DEFAULT) through their C
entries on its inputs at 2^20 rays in the chunk-local frame (as its main()
times them): this tree's and, with --other DIR, that checkout's plucker.cu
built with this tree's flags, in turns (other, this, this, other), each
the median of 10 runs (chip_smoke.entry_ms). Every output is held to this
tree's plain versions: MT and HIGHEST bitwise, DEFAULT bitwise or within
plucker_micro.default_within_contract (counts printed). Beside them, in
the same call: the plain versions' ms, the bound (chip_smoke.plucker_bounds)
and % of bound, and the library yardstick, torch.matmul of the Plücker
form's two products alone in f32 (TF32 off) and bf16.

--sweep plucker builds this tree's plucker.cu once for each form of
PLUCKER_SWEEP (its kPlkN, kDefWarpgroups, kDefMinBlocks, kHighRays and kMtRays
replaced)
and times every form's three kernels in two passes (the list, then
reversed), each output held as above, with each form's registers, spills
and resident warps/SM.

--mega-stages breaks the megakernel's untextured and textured forms down by
stage on the bench, showcase, Cornell, material_ball and sphere_grid(1900)
launches: this tree's megakernel.cu, or with --other DIR that checkout's
(which must hold the stage marks of csrc/mega_stages.cuh). It builds the source twice with this tree's flags: with
-lineinfo alone, the same code as the library the port loads, for ptxas's
registers and stack frame, the occupancy query, the launch's ms and the
static SASS instructions of each stage (cuobjdump -xelf, then nvdisasm's
line information mapped to the stage marks that precede each source line);
and with -DECHO_MEGA_STAGES, whose threads sum clock() cycles a stage
(csrc/mega_stages.cuh), read after one launch. --dump DIR keeps the
disassembly.
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

# setup's and select's forms --sweep select-setup times: each replaces
# csrc/binned.cu's kSelectForms and kSetupForms by one form at every shape of
# the traversal: `group` lanes a ray, `threads` a block. group 1 is a thread a
# ray: select's register form up to 72 slots (the shared-memory column above
# it) and setup_kernel (64 threads a block, whatever `threads` says).
SHAPE_SWEEP = [dict(group=g, threads=t) for g in (1, 2, 4, 8, 16, 32) for t in (128, 256)]
# the dense kernels' forms --sweep dense times: values of
# csrc/dense_intersect.cu's kCoopMax (ballots of at most this many rays
# spread their tests over the warp; 0: never) and kDenseWarps (warps a block)
DENSE_SWEEP = [dict(kCoopMax=g, kDenseWarps=w) for g in (0, 8, 16, 24, 32) for w in (2, 4, 8)]
# the Plücker kernels' forms --sweep plucker times: values of csrc/plucker.cu's
# kPlkN (prims a wgmma product), kDefWarpgroups (warpgroups a block of the
# wgmma kernel), kDefMinBlocks (its __launch_bounds__ blocks a SM, which caps
# its registers), kHighRays and kMtRays (rays a thread)
PLUCKER_SWEEP = [dict(kPlkN=n, kDefWarpgroups=w, kDefMinBlocks=b, kHighRays=r, kMtRays=r)
                 for n, w, b, r in ((16, 2, 1, 4), (16, 2, 4, 4), (8, 2, 4, 4), (32, 2, 1, 4),
                                    (16, 4, 1, 2), (16, 4, 2, 2))]
# cycles the card spins (torch.cuda._sleep) before each timed C entry, so
# that the host's ctypes call ends before the launch's start event: ~60 us
SLEEP_CYCLES = 100_000
# --refill's: ~0.6 ms, past the host's ctypes call of 17 arguments after the
# plain refill's hundreds of ops
REFILL_SLEEP_CYCLES = 1_000_000
# --refill's rows by rays a launch: (least rays, name)
REFILL_WIDTHS = ((2 ** 20, "n >= 2^20"), (2 ** 16, "2^16 <= n < 2^20"), (0, "n < 2^16"))

# the megakernel's stages, in csrc/mega_stages.cuh's order
STAGES = ("trace", "shadow trace", "interaction", "texture stage", "RNG + BSDF sample",
          "light pick / sample / BSDF eval", "RR + banking + regeneration",
          "pool: queues, sort, barriers")
# the occupancy query of the untextured and textured forms, for a
# megakernel.cu from before the path pool, which has none (its forms stage
# 10 rows of padded prims in 128-thread blocks); the A/B against such a
# checkout needs it, one with a path pool does not
PARENT_OCCUPANCY = """
extern "C" int megakernel_occupancy(int textured, int padded, int* out) {
  const void* fn = textured ? reinterpret_cast<const void*>(mega_kernel<true, false>)
                            : reinterpret_cast<const void*>(mega_kernel<false, false>);
  const size_t smem = sizeof(float) * 10 * (size_t)padded;
  // (raised to the envelope's 2048 padded prims, never lowered below what a
  // later launch of a larger scene needs)
  const size_t room = smem > 10 * 2048 * sizeof(float) ? smem : 10 * 2048 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(room));
  int blocks = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kBlock, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  out[0] = blocks;
  out[1] = kBlock;
  out[2] = static_cast<int>(smem);
  out[3] = sms;
  return static_cast<int>(err);
}
"""


def bind_binned(lib) -> None:
    """The argument types of a binned.cu library's C functions."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.binned_setup.argtypes = [ptr, i32, ptr, i32, i32, i32, ptr, ptr]
    lib.binned_select.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr, ptr]
    lib.binned_seg.argtypes = lib.binned_seg_exact.argtypes = [
        ptr, ptr, i32, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
    for fn in (lib.binned_setup, lib.binned_select, lib.binned_seg, lib.binned_seg_exact):
        fn.restype = i32
    for name in ("binned_setup_occupancy", "binned_select_occupancy"):  # absent from older checkouts
        if hasattr(lib, name):
            getattr(lib, name).argtypes, getattr(lib, name).restype = [i32, i32, ptr], i32
    if hasattr(lib, "binned_refill"):  # absent from older checkouts
        lib.binned_refill.argtypes = [ptr, i32, ptr, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                      i32, ptr, ptr, ptr, ptr]
        lib.binned_refill.restype = i32


def bind_dense(lib) -> None:
    """The argument types of a dense_intersect.cu library's C functions."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    common = [ptr, ptr, i32, ptr, i32, ptr, i32, ptr, i32, i32, i32]
    lib.dense_trace.argtypes, lib.dense_trace.restype = common + [ptr] * 5, i32
    lib.dense_occlude.argtypes, lib.dense_occlude.restype = common + [ptr] * 2, i32
    if hasattr(lib, "dense_occupancy"):  # absent from older checkouts
        lib.dense_occupancy.argtypes, lib.dense_occupancy.restype = [i32, i32, i32, ptr], i32


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
    csrc = root / "echorenderer_tpu_torch" / "csrc"
    mega = csrc / "megakernel.cu"
    if "megakernel_occupancy" not in mega.read_text():  # from before the pool redesign
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, out)
        mega = out / "megakernel.cu"
        mega.write_text((csrc / "megakernel.cu").read_text() + PARENT_OCCUPANCY)
    procs = {stem: nvcc(mega if stem == "megakernel" else csrc / f"{stem}.cu",
                        out / f"lib{stem}.so")
             for stem in ("hier_walk", "megakernel", "binned", "dense_intersect")}
    libs = {}
    for stem, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the other checkout's {stem}.cu:\n{err}")
        libs[stem] = ctypes.CDLL(str(out / f"lib{stem}.so"))
        libs[f"{stem}_path"] = out / f"lib{stem}.so"
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    common = [ptr, ptr, ptr, i32, ptr, ptr, ptr, i32, ptr, ptr, i32, i32, i32]
    h = libs["hier_walk"]
    h.hier_trace.argtypes, h.hier_trace.restype = common + [ptr] * 6, i32
    h.hier_occlude.argtypes, h.hier_occlude.restype = common + [ptr, ptr], i32
    bind_mega(libs["megakernel"])
    bind_binned(libs["binned"])
    bind_dense(libs["dense_intersect"])
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


def shape_sweep_source(text: str, group: int, threads: int) -> str:
    """binned.cu's text with its form tables replaced by one SHAPE_SWEEP form."""
    if group == 1:
        select, setup = f"{{{{72, 1, {threads}}}}}", "{{512, 1, 64}}"
    else:
        select = "{" + ", ".join(f"{{{w}, {group}, {threads}}}" for w in (72, 160, 320)) + "}"
        setup = f"{{{{512, {group}, {threads}}}}}"
    for table, value in (("kSelectForms", select), ("kSetupForms", setup)):
        text, n = re.subn(rf"constexpr (\w+) {table}\[\] = \{{.*?\}};",
                          rf"constexpr \1 {table}[] = {value};", text, flags=re.S)
        if n != 1:
            raise RuntimeError(f"binned.cu has no single {table}")
    return text


def build_shape_sweep(dest: Path) -> dict:
    """This tree's binned.cu built once for each form of SHAPE_SWEEP under
    `dest`: {name: (ctypes handle, form)}."""
    csrc = REPO / "echorenderer_tpu_torch" / "csrc"
    text = (csrc / "binned.cu").read_text()
    procs, forms = {}, {}
    for form in SHAPE_SWEEP:
        name = f"G{form['group']} t{form['threads']}"
        d = dest / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, d)
        (d / "binned.cu").write_text(shape_sweep_source(text, **form))
        procs[name] = nvcc(d / "binned.cu", d / "libbinned.so")
        forms[name] = form
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the select/setup form {name}:\n{err}")
        lib = ctypes.CDLL(str(dest / name.replace(" ", "_") / "libbinned.so"))
        bind_binned(lib)
        libs[name] = (lib, forms[name])
    return libs


def form_fits(form: dict):
    """fn(kind, shape) -> whether a SHAPE_SWEEP form's launch fits the
    card's 232,448 bytes of shared memory a block (setup_group's table, rows
    and tile; every select form and setup_kernel fit the traversal's shapes)."""
    def fits(kind, shape):
        if kind != "setup" or form["group"] == 1:
            return True
        s_count, s_out = shape
        rays = form["threads"] // form["group"]
        ts, rs = (s_count + 3) & ~3, ((s_count + 7) & ~7) + 4
        return 4 * (6 * ts + rays * rs + s_out * rays) <= 232_448
    return fits


def marked_source(root: Path) -> str:
    """`root`'s megakernel.cu, which must hold the stage marks."""
    text = (root / "echorenderer_tpu_torch" / "csrc" / "megakernel.cu").read_text()
    if "ECHO_STAGE(" not in text:
        raise RuntimeError(f"{root}: megakernel.cu has no stage marks (csrc/mega_stages.cuh)")
    return text


def build_stage_libs(root: Path, dest: Path) -> dict:
    """`root`'s marked megakernel.cu built into `dest` twice with this
    tree's flags plus -lineinfo: as the port builds it ("plain") and with
    the stage clocks ("clocks"). Returns {"plain": lib, "clocks": lib,
    "source": text, "ptxas": the plain build's report}."""
    dest.mkdir(parents=True, exist_ok=True)
    csrc = root / "echorenderer_tpu_torch" / "csrc"
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, dest)
    text = marked_source(root)
    (dest / "megakernel.cu").write_text(text)
    from echorenderer_tpu_torch.ops import cuda_build

    procs = {}
    for name, extra in (("plain", []), ("clocks", ["-DECHO_MEGA_STAGES"])):
        lib = dest / f"libmegakernel_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-lineinfo", *extra, "-o", str(lib),
             str(dest / "megakernel.cu")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    out = dict(source=text)
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {dest / 'megakernel.cu'} ({name}):\n{err}")
        out[name] = lib
        if name == "plain":
            out["ptxas"] = err
    return out


def bind_mega(lib):
    """ctypes handle of a megakernel library with its C functions typed."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.megakernel.argtypes, lib.megakernel.restype = [ptr, ptr, ctypes.c_float, ptr], i32
    lib.megakernel_hier.argtypes = [ptr, ptr, ptr, i32, ctypes.c_float, ptr]
    lib.megakernel_hier.restype = i32
    lib.megakernel_occupancy.argtypes, lib.megakernel_occupancy.restype = [i32, i32, ptr], i32
    if hasattr(lib, "megakernel_stages"):
        lib.megakernel_stages.argtypes, lib.megakernel_stages.restype = [ptr, i32], i32
    return lib


def mega_occupancy(lib, padded: int) -> str:
    """The untextured form's residency at `padded` prims, by the library's
    occupancy query."""
    occ = (ctypes.c_int * 4)()
    err = lib.megakernel_occupancy(0, padded, occ)
    if err:
        raise RuntimeError(f"megakernel_occupancy failed: cudaError {err}")
    return (f"{occ[2]} bytes dynamic smem a {occ[1]}-thread block, {occ[0]} blocks = "
            f"{occ[0] * occ[1] // 32} resident warps/SM")


def stage_of_lines(source: str) -> dict:
    """{source line: stage index} of every line of a top-level definition
    that holds stage marks, from its first mark on: the stage of the last
    mark at or before the line."""
    names = {f"ECHO_STAGE_{k}": i for i, k in enumerate(
        ("TRACE", "SHADOW", "INTERACT", "TEXTURE", "BSDF", "NEE", "END", "POOL"))}
    out, block, cur = {}, {}, None
    for no, line in enumerate(source.splitlines(), 1):
        if line[:1] not in ("", " ", "}", "/", "#"):  # a top-level definition starts
            out.update(block)
            block, cur = {}, None
        m = re.search(r"ECHO_STAGE(?:_CLOCK)?\((ECHO_STAGE_[A-Z]+)\)", line)
        if m and m.group(1) in names:
            cur = names[m.group(1)]
        if cur is not None:
            block[no] = cur
    out.update(block)
    return out


def sass_by_stage(lib: Path, source: str, dump: Path | None) -> dict:
    """{kernel form: [static SASS instructions of each stage] + [the rest]}
    of the untextured and textured forms in `lib`: each instruction is
    charged to the innermost frame of its nvdisasm line information (with
    inlining) that lies on a marked line of megakernel.cu."""
    from echorenderer_tpu_torch.ops import cuda_build

    bindir = Path(cuda_build._nvcc()).parent
    work = lib.parent / (lib.stem + "_sass")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    subprocess.run([str(bindir / "cuobjdump"), "-xelf", "all", str(lib)], cwd=work, check=True,
                   capture_output=True)
    cubins = sorted(work.glob("*.cubin"))
    text = "".join(subprocess.run([str(bindir / "nvdisasm"), "-gi", "-c", str(c)],
                                  capture_output=True, text=True, check=True).stdout
                   for c in cubins)
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text(text)
    return count_sass(text, source)


def called_stages(source: str, stage_at: dict) -> dict:
    """{source line: stage index, or -1 for several} of the functions that
    the marked lines call, directly or through other functions: a function
    that the compiler keeps out of line has only its own lines in its
    instructions' line information."""
    lines = source.splitlines()
    starts = [no for no, line in enumerate(lines, 1)
              if line[:1] not in ("", " ", "}", "/", "#")] + [len(lines) + 1]
    spans, name = [], None  # (name, first line, last line) of each top-level definition
    for a, b in zip(starts, starts[1:]):
        head = " ".join(lines[a - 1:min(a + 2, b - 1)])
        got = re.search(r"([A-Za-z_]\w*)\s*\(", head.split("{")[0])
        if got:
            spans.append((got.group(1), a, b - 1))
    names = {n for n, _, _ in spans}
    call = re.compile(r"\b([A-Za-z_]\w*)\s*(?:<[^;()]*?>)?\s*\(")
    stages = {n: set() for n in names}
    calls = {n: set() for n in names}
    for n, a, b in spans:
        for no in range(a + 1, b + 1):
            for callee in call.findall(lines[no - 1]):
                if callee in names and callee != n:
                    if no in stage_at:
                        stages[callee].add(stage_at[no])
                    else:
                        calls[n].add(callee)
    changed = True
    while changed:  # a callee inherits its callers' stages
        changed = False
        for n, callees in calls.items():
            for c in callees:
                if not stages[n] <= stages[c]:
                    stages[c] |= stages[n]
                    changed = True
    out = {}
    for n, a, b in spans:
        if stages[n]:
            for no in range(a, b + 1):
                out[no] = next(iter(stages[n])) if len(stages[n]) == 1 else -1
    return out


def count_sass(text: str, source: str) -> dict:
    """count_sass of an nvdisasm -gi listing: see sass_by_stage. A list of
    len(STAGES) + 2: the stages, code shared by several stages (a function
    kept out of line that several stages call), the rest."""
    stage_at = stage_of_lines(source)
    called = called_stages(source, stage_at)
    forms = {"ILb0ELb0E": "untextured", "ILb1ELb0E": "textured"}
    counts, form, frames, fresh = {}, None, [], False
    for line in text.splitlines():
        head = re.match(r"\s*\.text\.(\S+):", line) or re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            form = next((f for key, f in forms.items() if "mega_kernel" in name and key in name),
                        None)
            if form:
                counts.setdefault(form, [0] * (len(STAGES) + 2))
            frames = []
            continue
        if "//##" in line:  # one line a frame, innermost first, where the frames change
            got = re.search(r'File "([^"]+)", line (\d+)', line)
            if fresh:
                frames, fresh = [], False
            if got:
                frames.append((got.group(1), int(got.group(2))))
            continue
        if not re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            continue
        fresh = True  # the frames hold until the next annotation
        if form is not None:
            own = [n for f, n in frames if f.endswith("megakernel.cu")]
            stage = next((stage_at[n] for n in own if n in stage_at), None)
            if stage is None and own:
                stage = called.get(own[-1])
                stage = len(STAGES) if stage == -1 else stage
            counts[form][len(STAGES) + 1 if stage is None else stage] += 1
    return counts


def stage_launches(dev) -> dict:
    """{label: (scene, res, spp)} of the launches the stage breakdown reads."""
    from chip_smoke import showcase_scene
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    return {
        "bench sphere_field(80) 960x540 64 spp": (
            prepare_scene(scenes.sphere_field(80), device=dev), (960, 540), 64),
        "showcase 960x540 64 spp (textured)": (
            prepare_scene(showcase_scene(), device=dev), (960, 540), 64),
        "cornell 128x128 8 spp": (prepare_scene(scenes.cornell_box(), device=dev), (128, 128), 8),
        "material_ball 320x180 8 spp": (
            prepare_scene(scenes.material_ball(), device=dev), (320, 180), 8),
        "sphere_grid(1900) 320x180 8 spp (2048 padded prims)": (
            prepare_scene(scenes.sphere_grid(1900), device=dev), (320, 180), 8),
    }


def mega_stages(root: Path, label: str, dump: Path | None, smi: str) -> None:
    """The stage breakdown of `root`'s untextured and textured megakernel
    forms (see the module's docstring)."""
    import torch

    from chip_smoke import occupancy_cap, ptxas_forms, tile_lanes
    from echorenderer_tpu_torch.ops import megakernel as mk

    dev = torch.device("cuda")
    libs = build_stage_libs(root, REPO / "echorenderer_tpu_torch" / "_build" / "stages" / label)
    plain, clocks = bind_mega(ctypes.CDLL(str(libs["plain"]))), bind_mega(
        ctypes.CDLL(str(libs["clocks"])))
    ptxas = {f: r for n, r in ptxas_forms(libs["ptxas"], "mega_kernel").items()
             for key, f in (("ILb0ELb0E", "untextured"), ("ILb1ELb0E", "textured")) if key in n}
    sass = sass_by_stage(libs["plain"], libs["source"],
                         None if dump is None else dump / f"{label}.sass.txt")
    for form in ("untextured", "textured"):
        got = sass.get(form, [])
        print(f"[stages] {smi} | {label} {form} form: ptxas {ptxas.get(form)}; static SASS "
              f"instructions a stage: " + ", ".join(
                  f"{s} {c}" for s, c in zip(STAGES + ("shared by several stages",
                                                       "outside the stages"), got)))
    real = mk._lib
    for name, (scene, res, spp) in stage_launches(dev).items():
        textured = scene.tex_atlas.shape[0] > 0
        form = "textured" if textured else "untextured"
        pid, pxy = tile_lanes(res, dev)
        launch = lambda: mk.sample_frame_mega(scene, pid, pxy, res, 0, 0, spp, bounce_limit=16,
                                              survivability=2.5)
        occ = (ctypes.c_int * 4)()
        err = plain.megakernel_occupancy(int(textured), scene.prim_soa.padded, occ)
        if err:
            raise RuntimeError(f"megakernel_occupancy failed: cudaError {err}")
        occ_d = dict(blocks=occ[0], block=occ[1], smem=occ[2], warps=occ[0] * occ[1] // 32)
        prepared = mk._prepare_launch(scene, pid, pxy, res, 0, 0, spp, 16, None)
        alone = lambda: mk._run_launch(scene, prepared, 2.5)  # the C entry alone
        try:
            mk._lib = plain
            ms = median_ms(launch)
            kernel_ms = median_ms(alone)
            mk._lib = clocks
            launch()
            cyc = (ctypes.c_ulonglong * (len(STAGES) + 1))()
            clocks.megakernel_stages(cyc, 1)  # zero after the warm-up
            clk_ms = median_ms(launch, runs=1, warm=False)
            err = clocks.megakernel_stages(cyc, 1)
            if err:
                raise RuntimeError(f"megakernel_stages failed: cudaError {err}")
        finally:
            mk._lib = real
        total = sum(cyc[:len(STAGES)])
        print(f"[stages] {smi} | {label}, {name} ({form} form): {ms:.4f} ms a call of "
              f"sample_frame_mega, {kernel_ms:.4f} ms the C entry alone (medians of 10; a call "
              f"with the clocks {clk_ms:.4f} ms, {cyc[len(STAGES)]} threads); {occ_d['smem']} bytes "
              f"dynamic smem a {occ_d['block']}-thread block, {occ_d['blocks']} blocks = "
              f"{occ_d['warps']} resident warps/SM on {occ[3]} SMs, capped by "
              f"{occupancy_cap(occ_d, ptxas[form])}; warp cycles a stage (sum over threads / 32), "
              f"share, share x the C entry's ms: " + "; ".join(
                  f"{s} {c / 32:.4g}, {100.0 * c / max(total, 1):.2f}%, "
                  f"{kernel_ms * c / max(total, 1):.4f} ms" for s, c in zip(STAGES, cyc)))


def sass(lib: Path) -> dict:
    """{kernel: [instructions]} of a library, by cuobjdump -sass, with the
    addresses, encodings and the translation unit's hash left out."""
    from chip_smoke import sass_functions

    return {re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "_GLOBAL__N_", name): code
            for name, code in sass_functions(lib).items()}


def compare_sass(other: dict, smi: str) -> None:
    """The dense kernels', hier_kernel's, the binned kernels' (seg, setup,
    select) and every megakernel form's SASS against the other checkout's
    (a change to intersect.cuh, hier_walk.cuh or one kernel's source must
    leave the others as they were)."""
    from echorenderer_tpu_torch.ops import cuda_build

    built = cuda_build.build()
    for stem, kernels in (("dense_intersect", ("trace_kernel", "occlude_kernel")),
                          ("hier_walk", ("hier_kernel",)),
                          ("binned", ("seg_kernel", "setup_", "select_")),
                          ("megakernel", ("mega_kernel",))):
        mine, theirs = sass(built[stem].path), sass(other[f"{stem}_path"])
        for name in sorted(n for n in mine if any(k in n for k in kernels)):
            a, b = mine[name], theirs.get(name)
            verdict = ("not in the other checkout" if b is None else "identical" if a == b else
                       f"differs: {sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))} of "
                       f"{len(a)} instructions ({len(b)} there)")
            print(f"[sass] {smi} | {stem} {name}: {verdict}")


# this tree's binned_trace.refill, kept while `use` binds a binned library
# without the refill kernel
_KERNEL_REFILL: list = []


def use(libs: dict):
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.ops import megakernel as mk
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    ph._lib = libs.get("hier_walk", ph._lib)
    mk._lib = libs.get("megakernel", mk._lib)
    pi._lib = libs.get("dense_intersect", pi._lib)
    bt._lib, bt.ROW = libs["binned"], libs["row"]
    if not _KERNEL_REFILL:
        _KERNEL_REFILL.append(bt.refill)
    # a checkout from before the refill kernel refills by PyTorch ops
    bt.refill = (_KERNEL_REFILL[0] if hasattr(libs["binned"], "binned_refill")
                 else bt.refill_plain)


def median_ms(fn, runs: int = 10, warm: bool = True) -> float:
    from chip_smoke import run_ms

    return statistics.median(run_ms(fn, runs, warm))


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


class ShapeTimer:
    """While open, every setup_rank and select launch on the card also runs
    the C entry (binned_setup / binned_select) of each library of `libs`
    ({label: ctypes handle}) on the same inputs, in turns (the list, then
    reversed): each on a fresh copy of select's in-place buffer, the card
    kept busy while the host makes the call (torch.cuda._sleep), timed by
    CUDA events around the call alone, its outputs held bitwise to the
    wrapper's. The wrapper's own launch is timed as chip_smoke.timed times
    it. Each library's first launch at a shape runs once untimed first (CUDA
    loads a kernel's module at its first launch). `rows` gets one dict a
    launch, from the program named by `source`:
    its shape (select: n, w, k, refilling rays; setup: n, supers, s_out and
    the mean and largest count L of eligible supers a ray), the wrapper's
    ms, each library's ms a turn, the bound. `fits` ({label: fn(kind,
    shape) -> bool}) names the launches a sweep's form cannot take (too much
    shared memory): those are not made, and their ms is nan."""

    def __init__(self, libs: dict, fits=None):
        self.libs, self.fits, self.source, self.rows = libs, fits or {}, "", []

    def __enter__(self):
        import torch

        from chip_smoke import bound_ms, select_work, setup_work, timed
        from echorenderer_tpu_torch.ops import binned_trace as bt

        self._saved = setup_k, select_k = bt.setup_rank, bt.select
        order = list(self.libs) + list(self.libs)[::-1]

        warm = set()

        def turns(kind, shape, call, check):
            ms = {label: [] for label in self.libs}
            stream = torch.cuda.current_stream().cuda_stream
            for label in order:
                if not self.fits.get(label, lambda *_: True)(kind, shape):
                    ms[label].append(float("nan"))
                    continue
                if (label, kind, shape) not in warm:  # the kernel's module loads on first use
                    warm.add((label, kind, shape))
                    call(self.libs[label], stream)()
                prepared = call(self.libs[label], stream)
                torch.cuda._sleep(SLEEP_CYCLES)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                err = prepared()
                end.record()
                end.synchronize()
                if err:
                    raise RuntimeError(f"{label}'s C entry failed: cudaError {err}")
                ms[label].append(start.elapsed_time(end))
                if not check():
                    raise AssertionError(f"{label}'s C entry differs from the wrapper "
                                         f"({self.source})")
            return ms

        def setup(rays, sup_cb, sbits, cap=None):
            got, w_ms = timed(lambda: setup_k(rays, sup_cb, sbits, cap))
            (s_out, n), s = got.shape, sup_cb.shape[0]
            if n == 0:
                return got
            out = torch.empty_like(got)

            def call(lib, stream):
                out.fill_(0)
                return lambda: lib.binned_setup(rays.data_ptr(), n, sup_cb.data_ptr(), s, sbits,
                                                s_out, out.data_ptr(), stream)

            ms = turns("setup", (s, s_out), call, lambda: torch.equal(out, got))
            eligible = torch.cat([(bt._slab_all(r[0:3].T, r[3:6].T, sup_cb, r[6]) < bt._INF).sum(1)
                                  for r in rays.split(bt.PLAIN_SLICE, dim=1)])
            self.rows.append(dict(kind="setup", source=self.source, n=n, s_count=s, s_out=s_out,
                                  l_mean=float(eligible.double().mean()),
                                  l_max=int(eligible.max()), wrapper_ms=w_ms, ms=ms,
                                  bound=bound_ms(*setup_work(n, s, s_out))))
            return got

        def select(cand, new_keys, best_t, do_refill, k, cbits):
            orig = cand.clone()
            got, w_ms = timed(lambda: select_k(cand, new_keys, best_t, do_refill, k, cbits))
            w, n = cand.shape
            if n == 0:
                return got
            buf = torch.empty_like(orig)
            outs = [torch.empty_like(x) for x in got]

            def call(lib, stream):
                buf.copy_(orig)
                for x in outs:
                    x.fill_(0)
                return lambda: lib.binned_select(buf.data_ptr(), w, n, new_keys.data_ptr(),
                                                 best_t.data_ptr(), do_refill.data_ptr(), k, cbits,
                                                 *(x.data_ptr() for x in outs), stream)

            ms = turns("select", (w, k), call, lambda: torch.equal(buf, cand) and all(
                torch.equal(a, b) for a, b in zip(outs, got)))
            refills = int(do_refill.sum())
            self.rows.append(dict(kind="select", source=self.source, n=n, w=w, k=k,
                                  refills=refills, wrapper_ms=w_ms, ms=ms,
                                  bound=bound_ms(*select_work(w, n, k, refills))))
            return got

        bt.setup_rank, bt.select = setup, select
        return self

    def __exit__(self, *exc):
        from echorenderer_tpu_torch.ops import binned_trace as bt

        bt.setup_rank, bt.select = self._saved


def binned_runs(dev, grid, tlas, rnd, rs) -> dict:
    """{label: run} of the binned traversal's inputs: one program of the 1M
    and of the TLAS scene (first sample 1), and one trace and one occlude
    call of 2^20 random rays through the binned traversal, flat and
    instanced (per-instance ignores)."""
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

    return {
        "1M program": lambda: _sample_frame(grid, "path", RES, 0, 1, 1, 6, 2.5),
        "TLAS program": lambda: _sample_frame(tlas, "path", RES, 0, 1, 1, 6, 2.5),
        "random rays": both(soa, rnd),
        "instanced random rays": both(isoa, irnd),
    }


def refill_turns(runs: dict, smi: str) -> None:
    """--refill: every refill of `runs` ({label: run}), on the same inputs
    in turns (plain, kernel, kernel, plain): the plain refill (`refill_plain`,
    the PyTorch ops the parent's rounds issue) timed by CUDA events around
    the call on an idle card (host issue and card); the kernel's C entry
    (binned_refill) with the card kept busy for REFILL_SLEEP_CYCLES while
    the host makes the call (the card's time alone), then the wrapper on an
    idle card (as a round pays it); every output held bitwise to the plain
    version's. One line a (run, ksup, order, width): launches, rays,
    refilling rays, the three ms a launch, the bound (chip_smoke.refill_work)
    and % of bound, launches x (plain - wrapper); then one line a run."""
    import statistics as st

    import torch

    from chip_smoke import bound_ms, refill_work
    from echorenderer_tpu_torch.ops import binned_trace as bt

    kernel, rows, source = bt.refill, [], [""]
    lib = bt._load()

    def ms_of(fn, busy):
        if busy:
            torch.cuda._sleep(REFILL_SLEEP_CYCLES)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def timed(*args):
        rays, sup_ord, cursor, best_t, do_refill, next_sup, base, ksup, sbits, cbits = args
        want = bt.refill_plain(*args)
        kernel(*args)  # the module loads at the first launch
        outs = [torch.empty_like(x) for x in want]
        stream = torch.cuda.current_stream().cuda_stream

        def entry():
            err = lib.binned_refill(rays.data_ptr(), rays.shape[1], sup_ord.data_ptr(),
                                    sup_ord.shape[0], cursor.data_ptr(), best_t.data_ptr(),
                                    do_refill.data_ptr(), next_sup.data_ptr(), base.data_ptr(),
                                    base.shape[0], ksup, sbits, cbits,
                                    *(x.data_ptr() for x in outs), stream)
            if err:
                raise RuntimeError(f"binned_refill failed: cudaError {err}")
            return outs

        ms = dict(plain=[], kernel=[], wrapper=[])
        for who in ("plain", "kernel", "kernel", "plain"):
            if who == "plain":
                got = [ms_of(lambda: bt.refill_plain(*args), False)]
                ms["plain"].append(got[0][1])
            else:
                for x in outs:
                    x.fill_(0)
                got = [ms_of(entry, True), ms_of(lambda: kernel(*args), False)]
                ms["kernel"].append(got[0][1])
                ms["wrapper"].append(got[1][1])
            if not all(torch.equal(a, b) for out, _ in got for a, b in zip(out, want)):
                raise AssertionError(f"the refill kernel differs from refill_plain ({source[0]})")
        rows.append(dict(source=source[0], ksup=ksup, capped=sup_ord.shape[0] < base.shape[0],
                         n=rays.shape[1], refills=int(do_refill.sum()),
                         ms={k: st.fmean(v) for k, v in ms.items()},
                         bound=bound_ms(*refill_work(sup_ord, cursor, best_t, do_refill, base,
                                                     ksup, sbits))))
        return want

    bt.refill = timed
    try:
        for label, run in runs.items():
            source[0] = label
            run()
    finally:
        bt.refill = kernel
    groups = {}
    for r in rows:
        width = next(w for w in REFILL_WIDTHS if r["n"] >= w[0])[1]
        groups.setdefault((r["source"], r["ksup"], r["capped"], width), []).append(r)
    for (label, ksup, capped, width), rs_ in groups.items():
        n = [r["n"] for r in rs_]
        mean = {k: st.fmean(r["ms"][k] for r in rs_) for k in ("plain", "kernel", "wrapper")}
        bound = st.fmean(r["bound"][0] for r in rs_)
        by = rs_[0]["bound"][1]
        print(f"[refill] {smi} | {label}, ksup {ksup}, {'capped' if capped else 'uncapped'} "
              f"order, {width}: {len(rs_)} launches on {min(n)}-{max(n)} rays (mean "
              f"{st.fmean(n):.0f}), "
              f"refilling rays {100.0 * sum(r['refills'] for r in rs_) / max(sum(n), 1):.1f}%; "
              f"ms a launch: plain {mean['plain']:.4f}, C entry {mean['kernel']:.4f} (the card), "
              f"wrapper {mean['wrapper']:.4f} (an idle card); bound {bound:.6f} ms ({by}) = "
              f"{100.0 * bound / mean['kernel']:.2f}% of bound; launches x (plain - wrapper) "
              f"{len(rs_) * (mean['plain'] - mean['wrapper']):.4f} ms")
    for label in runs:
        rs_ = [r for r in rows if r["source"] == label]
        sums = {k: sum(r["ms"][k] for r in rs_) for k in ("plain", "kernel", "wrapper")}
        print(f"[refill] {smi} | {label}: {len(rs_)} refills, summed ms: plain "
              f"{sums['plain']:.4f}, kernel {sums['kernel']:.4f}, wrapper {sums['wrapper']:.4f}, "
              f"bound {sum(r['bound'][0] for r in rs_):.4f}")


def seg_items(runs) -> tuple:
    """({name: fn}, {name: launches}) of the seg kernel, keyed and exact, on
    the recorded launches of `binned_runs`."""
    from echorenderer_tpu_torch.ops import binned_trace as bt

    recorded = {label: seg_launches(run) for label, run in runs.items()}
    items, counts = {}, {}
    for label, launches in recorded.items():
        for form, fn in (("keyed", "seg_keys"), ("exact", "seg_hits")):
            name = f"seg {form}, {label}"
            items[name] = lambda ls=launches, fn=fn: [
                getattr(bt, fn)(rec, c, pcs, tri, sph, inst=inst)
                for rec, c, pcs, tri, sph, inst in ls]
            counts[name] = len(launches)
    return items, counts


def large_scenes(dev) -> tuple:
    """(the 1M scene, the TLAS scene, 2^20 random rays against the 1M scene
    (ray columns, sorted ignores), the seeded RandomState they came from)."""
    import numpy as np
    import torch

    from chip_smoke import random_rays
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.ops import pallas_intersect as pi
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    grid = prepare_scene(scenes.sphere_grid(1_000_000), device=dev)
    tlas = prepare_scene(scenes.instanced_sphere_grids(), instancing="tlas", device=dev)
    soa = grid.hier_soa
    rs = np.random.RandomState(2024)
    lo = soa.chunk_bounds[:, 0:3].amin(0).tolist()
    hi = soa.chunk_bounds[:, 3:6].amax(0).tolist()
    o, d, t_max, ignore = (torch.as_tensor(np.ascontiguousarray(a), device=dev) for a in
                           random_rays(rs, 2 ** 20, [lo[0], 0.05, lo[2]],
                                       [hi[0], hi[1] + 1.0, hi[2]],
                                       grid.geometry.num_primitives))
    return grid, tlas, (pi.ray_columns(o, d, t_max), ph._sorted_ignore(soa, ignore)), rs


def inputs(dev):
    """(kernel items {name: fn}, launches or calls per item, scenes, the
    binned traversal's runs) on this tree's kernels."""
    from chip_smoke import showcase_scene, tile_lanes
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.ops import megakernel as mk
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    grid, tlas, rnd, rs = large_scenes(dev)
    soa, isoa = grid.hier_soa, tlas.hier_soa
    flat, inst = first_wave(grid), first_wave(tlas)
    pid, pxy = tile_lanes(RES, dev)
    bench = prepare_scene(scenes.sphere_field(80), device=dev)
    show = prepare_scene(showcase_scene(), device=dev)
    cornell = prepare_scene(scenes.cornell_box(), device=dev)
    ball = prepare_scene(scenes.material_ball(), device=dev)
    top = prepare_scene(scenes.sphere_grid(1900), device=dev)  # 2048 padded prims
    spid, spxy = tile_lanes((960, 540), dev)
    cpid, cpxy = tile_lanes((128, 128), dev)
    bpid, bpxy = tile_lanes((320, 180), dev)

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
        "untextured megakernel cornell 128x128 8 spp launch": lambda: mk.sample_frame_mega(
            cornell, cpid, cpxy, (128, 128), 0, 0, 8, bounce_limit=16, survivability=2.5),
        "untextured megakernel material_ball 320x180 8 spp launch": lambda: mk.sample_frame_mega(
            ball, bpid, bpxy, (320, 180), 0, 0, 8, bounce_limit=16, survivability=2.5),
        "untextured megakernel sphere_grid(1900) 320x180 8 spp launch": lambda: (
            mk.sample_frame_mega(top, bpid, bpxy, (320, 180), 0, 0, 8, bounce_limit=16,
                                 survivability=2.5)),
    }
    counts = {"first-wave trace": len(flat["trace"]), "first-wave occlude": len(flat["occlude"]),
              "instanced first-wave trace": len(inst["trace"]),
              "instanced first-wave occlude": len(inst["occlude"])}
    runs = binned_runs(dev, grid, tlas, rnd, rs)
    seg, seg_counts = seg_items(runs)
    items.update(seg)
    counts.update(seg_counts)
    return items, counts, dict(grid=grid, tlas=tlas, bench=bench, show=show, top=top), runs


def select_setup_launches(runs: dict, libs: dict, fits=None) -> list:
    """ShapeTimer's rows over every run of `runs` ({label: run}), timing the
    C entries of `libs` in turns (see ShapeTimer for `fits`)."""
    with ShapeTimer(libs, fits) as timer:
        for label, run in runs.items():
            timer.source = label
            run()
    return timer.rows


def shape_table(rows: list, smi: str) -> None:
    """The setup/select shape table: one line a (kernel, program, shape),
    the shape's launches, rays, refills or eligible supers, each library's C
    entry ms a launch (the mean of its launches, each the mean of its turns),
    the wrapper's, the bound, % of bound and launches x (ms - bound); then a
    line a kernel summing launches x (ms - bound) over every launch."""
    import statistics as st

    groups = {}
    for r in rows:
        shape = (r["w"], r["k"]) if r["kind"] == "select" else (r["s_count"], r["s_out"])
        groups.setdefault((r["kind"], r["source"], shape), []).append(r)
    labels = list(rows[0]["ms"]) if rows else []
    for (kind, source, shape), rs_ in groups.items():
        n = [r["n"] for r in rs_]
        bound = st.fmean(r["bound"][0] for r in rs_)
        by = max({r["bound"][1] for r in rs_}, key=lambda b: sum(
            r["bound"][0] for r in rs_ if r["bound"][1] == b))
        if kind == "select":
            what = (f"select w {shape[0]} k {shape[1]}, {source}: {len(rs_)} launches, n "
                    f"{min(n)}-{max(n)} (mean {st.fmean(n):.0f}), refilling rays "
                    f"{100.0 * sum(r['refills'] for r in rs_) / max(sum(n), 1):.1f}%")
        else:
            what = (f"setup {shape[0]} supers s_out {shape[1]}, {source}: {len(rs_)} launches, n "
                    f"{min(n)}-{max(n)} (mean {st.fmean(n):.0f}), eligible supers a ray L mean "
                    f"{st.fmean(r['l_mean'] for r in rs_):.2f}, largest "
                    f"{max(r['l_max'] for r in rs_)}")
        per = []
        for label in labels:
            ms = st.fmean(st.fmean(r["ms"][label]) for r in rs_)
            gap = sum(st.fmean(r["ms"][label]) - r["bound"][0] for r in rs_)
            per.append(f"{label} {ms:.4f} ms = {100.0 * bound / ms:.2f}% of bound, launches x "
                       f"(ms - bound) {gap:.4f}")
        print(f"[shapes] {smi} | {what}; C entry a launch: " + "; ".join(per)
              + f"; the wrapper (this tree) {st.fmean(r['wrapper_ms'] for r in rs_):.4f} ms; "
              f"bound {bound:.6f} ms ({by})")
    for kind in ("setup", "select"):
        rs_ = [r for r in rows if r["kind"] == kind]
        if rs_:
            print(f"[shapes] {smi} | {kind}, every recorded launch ({len(rs_)}): launches x "
                  f"(ms - bound) " + ", ".join(
                      f"{label} {sum(st.fmean(r['ms'][label]) - r['bound'][0] for r in rs_):.4f} ms"
                      for label in labels)
                  + f", the wrapper (this tree) "
                  f"{sum(r['wrapper_ms'] - r['bound'][0] for r in rs_):.4f} ms")


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


def dense_sets(dev) -> dict:
    """{label: (scene or None, prim table, {"trace": calls, "occlude": calls})}
    of the dense kernels' A/B and sweep: the recorded calls of the
    sphere_field(2400) and sphere_grid(MESH_GRID) renders, and one call each
    of the 42k soup's 2^20 rays (chip_smoke.py's, from the same seeded
    draws)."""
    import numpy as np

    from chip_smoke import (MESH_GRID, N_RAYS, dense_calls, random_rays, recorded_calls,
                            soup_42k)
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    field = prepare_scene(scenes.sphere_field(2400), device=dev)
    mesh = prepare_scene(scenes.sphere_grid(MESH_GRID), device=dev)
    rs = np.random.RandomState(2024)
    bench = prepare_scene(scenes.sphere_field(80), device=dev)
    random_rays(rs, N_RAYS, [-20, 0.05, -20], [20, 4, 20], bench.prim_soa.num_prims)
    soup, rays = soup_42k(rs, dev)
    return {
        "sphere_field(2400) path calls": (field, field.prim_soa,
                                          recorded_calls(field, (320, 180), 8, 16)),
        f"sphere_grid({MESH_GRID}) calls": (mesh, mesh.prim_soa,
                                           recorded_calls(mesh, (320, 180), 8, 6)),
        "42k soup, 2^20 rays": (None, soup, dense_calls(soup, rays, dev)),
    }


def dense_bounds(soa, calls) -> dict:
    """{kind: (mean bound ms a call, by)} of a set, as chip_smoke.compare_dense
    counts them (the least prim-test work of this tree's hits, the bytes)."""
    import torch

    from chip_smoke import bound_ms, least_flops, table_bytes
    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    tables = table_bytes(soa.rows, soa.chunk_bounds, soa.super_bounds)
    out = {}
    for kind in ("trace", "occlude"):
        bounds = []
        for rays, ig in calls[kind]:
            if kind == "trace":
                t = pi.dense_trace(rays, ig, soa)[0]
                flops, nbytes = least_flops(soa, rays, ig, t_end=t), rays.shape[1] * 48 + tables
            else:
                flops, nbytes = least_flops(soa, rays, ig), rays.shape[1] * 33 + tables
            bounds.append(bound_ms(flops, nbytes))
        torch.cuda.synchronize()
        out[kind] = (statistics.fmean(b for b, _ in bounds),
                     statistics.mode(by for _, by in bounds))
    return out


def dense_runs(lib, sets) -> dict:
    """{(set, kind): fn} running `lib`'s C entry over each set's calls."""
    from chip_smoke import dense_entry

    return {(label, kind): dense_entry(lib, kind, soa, calls[kind])
            for label, (_, soa, calls) in sets.items() for kind in ("trace", "occlude")}


def dense_want(sets) -> dict:
    """{(set, kind): this tree's wrapper outputs}, as dense_entry returns them."""
    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    return {(label, kind): [getattr(pi, f"dense_{kind}")(rays, ig, soa)
                            for rays, ig in calls[kind]]
            for label, (_, soa, calls) in sets.items() for kind in ("trace", "occlude")}


def dense_check(runs, want, who) -> None:
    """Each run's outputs bitwise equal to this tree's wrapper's."""
    import torch

    for key, fn in runs.items():
        got = fn()
        torch.cuda.synchronize()
        for g, w in zip(got, want[key]):
            if not same(g, w):
                raise AssertionError(f"{who}: the dense {key[1]} C entry differs on {key[0]}")


def dense_breakdown(sets, smi) -> None:
    """Per set and kind, the work of the kernels' warps, counted from the
    plain walk's visits (the kernels take the same per-ray decisions): live
    rays and warps, chunks tested a live ray and, for trace, the chunks it
    enters before its final hit (the bound's count), warp stages (taken
    chunks) a warp, the mean ballot, and the share of stages and of member
    tests in the spread form (ballots of at most kCoopMax rays)."""
    import torch

    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    source = (REPO / "echorenderer_tpu_torch" / "csrc" / "dense_intersect.cu").read_text()
    coop = int(re.search(r"constexpr int kCoopMax = (\d+);", source).group(1))
    for label, (_, soa, calls) in sets.items():
        for kind in ("trace", "occlude"):
            live = warps = tested = ideal = stages = spread = members = spread_members = 0
            for rays, ig in calls[kind]:
                for r, i in pi._slices(rays, ig):
                    visits = []
                    out = pi._walk(r, i, soa, kind == "occlude", visits=visits)
                    live += int((r[6] > 0).sum())
                    warps += r.shape[1] // 32
                    for idx, _ in visits:
                        g = torch.bincount(idx // 32)
                        g = g[g > 0]
                        tested += idx.numel()
                        stages += g.numel()
                        spread += int((g <= coop).sum())
                        members += int(g.sum())
                        spread_members += int(g[g <= coop].sum())
                    if kind == "trace":
                        t_end = torch.where(out[1] >= 0, out[0], r[6])
                        inv = [pi._safe_inv(r[k]) for k in (3, 4, 5)]
                        for j in range(soa.n_chunks):
                            ideal += int(((r[6] > 0) & pi._box_reach(soa.chunk_bounds, j, r, inv,
                                                                     t_end)).sum())
            bound = (f" (the bound counts {ideal / max(live, 1):.3f}: the chunks it enters "
                     f"before its final hit)" if kind == "trace" else "")
            print(f"[dense-ab] {smi} | breakdown, {label} {kind}: {live} live rays in {warps} "
                  f"warps; chunks tested a live ray {tested / max(live, 1):.3f}{bound}; "
                  f"{stages / max(warps, 1):.3f} stages (taken chunks) a warp, mean ballot "
                  f"{members / max(stages, 1):.2f} rays; {100.0 * spread / max(stages, 1):.1f}% of "
                  f"stages and {100.0 * spread_members / max(members, 1):.1f}% of member tests "
                  f"spread over the warp (ballots of at most {coop} rays)")


def dense_walk_yardstick(sets, smi) -> None:
    """The walk (hier_trace / hier_occlude) on the sphere_grid(MESH_GRID)
    calls, a call of the wrapper, its hits held to the dense kernels'
    (original prim ids, t bitwise); then that frame rendered on the dense
    kernels and on the walk alone, in turns."""
    import torch

    from chip_smoke import MESH_GRID, median_ms
    from echorenderer_tpu_torch.evaluation import scene_ops
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    mesh, soa, calls = sets[f"sphere_grid({MESH_GRID}) calls"]
    hsoa = mesh.hier_soa

    def hier_ig(ig):
        orig = torch.where(ig >= 0, soa.order[ig.clamp(min=0).long()], -1)
        return ph._sorted_ignore(hsoa, orig)

    hcalls = {k: [(r, hier_ig(ig)) for r, ig in v] for k, v in calls.items()}
    for (r, ig), (_, hig) in zip(calls["trace"], hcalls["trace"]):
        dt, dp = pi.dense_trace(r, ig, soa)[:2]
        ht, hp = ph.hier_trace(r, hig, hsoa)[:2]
        d_id = torch.where(dp >= 0, soa.order[dp.clamp(min=0).long()], -1)
        h_id = torch.where(hp >= 0, hsoa.order[hp.clamp(min=0).long()], -1)
        if not (torch.equal(d_id, h_id) and torch.equal(dt, ht)):
            raise AssertionError("the walk and the dense kernels disagree on the mesh's calls")
    for (r, ig), (_, hig) in zip(calls["occlude"], hcalls["occlude"]):
        if not torch.equal(pi.dense_occlude(r, ig, soa), ph.hier_occlude(r, hig, hsoa)):
            raise AssertionError("the walk and the dense kernels disagree on the mesh's flags")
    for kind in ("trace", "occlude"):
        dense = median_ms(lambda: [getattr(pi, f"dense_{kind}")(r, ig, soa)
                                   for r, ig in calls[kind]]) / len(calls[kind])
        walk = median_ms(lambda: [getattr(ph, f"hier_{kind}")(r, ig, hsoa)
                                  for r, ig in hcalls[kind]]) / len(calls[kind])
        print(f"[dense-ab] {smi} | sphere_grid({MESH_GRID}) {kind}, {len(calls[kind])} calls, "
              f"the same hits: the dense wrapper {dense:.4f} ms a call, the walk's "
              f"{walk:.4f} ms a call")
    def render(walk):
        def run():
            with scene_ops.walk_only() if walk else contextlib.nullcontext():
                return _render(mesh, 6)
        return run

    got = {"dense": [], "walk alone": []}
    images = {}
    for label in ("dense", "walk alone", "walk alone", "dense"):
        images[label] = render(label == "walk alone")()[0]
        got[label].append(path_turn({label: (render(label == "walk alone"),
                                             320 * 180 * 8)})[label])
    print(f"[dense-ab] {smi} | sphere_grid({MESH_GRID}) 320x180 8 spp bounce 6 render, Mspps "
          f"(median of 5; dense, walk, walk, dense): dense {got['dense'][0]:.4f}, "
          f"{got['dense'][1]:.4f}; walk alone {got['walk alone'][0]:.4f}, "
          f"{got['walk alone'][1]:.4f}; images bitwise equal: "
          f"{bool((images['dense'] == images['walk alone']).all())}")


def dense_ab(other, this, sets, smi) -> None:
    """The dense kernels' A/B: per set and kind the C entry a launch and a
    call of the wrapper, each checkout in turns (other, this, this, other),
    every output held to this tree's wrapper's; the bound, % of bound and
    launches x (ms - bound); then the walk's yardstick and the render paths
    the dense kernels run, in turns."""
    from chip_smoke import entry_ms, median_ms
    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    use(this)
    want = dense_want(sets)
    bounds = {label: dense_bounds(soa, calls) for label, (_, soa, calls) in sets.items()}
    runs = {"other": dense_runs(other["dense_intersect"], sets),
            "this": dense_runs(this["dense_intersect"], sets)}
    for label, r in runs.items():
        dense_check(r, want, label)
    occ = {(a, t, s_): pi.occupancy(a, t, s_) for a in (False, True)
           for t, s_ in ((True, True), (True, False), (False, True))}
    print(f"[dense-ab] {smi} | this tree's resident warps/SM (trace, occlude): " + "; ".join(
        f"{'mixed' if t and s_ else 'triangles' if t else 'spheres'} "
        f"{occ[(False, t, s_)]['warps']}, {occ[(True, t, s_)]['warps']}"
        for t, s_ in ((True, True), (True, False), (False, True))))
    entry = {key: {"other": [], "this": []} for key in runs["this"]}
    wrapper = {key: {"other": [], "this": []} for key in runs["this"]}
    for label in ("other", "this", "this", "other"):
        use(other if label == "other" else this)
        for key, fn in runs[label].items():
            entry[key][label].append(entry_ms(fn))
            _, soa, calls = sets[key[0]]
            wrapper[key][label].append(median_ms(
                lambda: [getattr(pi, f"dense_{key[1]}")(r, ig, soa) for r, ig in calls[key[1]]]))
    use(this)
    for (label, kind), e in entry.items():
        _, soa, calls = sets[label]
        n = len(calls[kind])
        b, by = bounds[label][kind]
        o = [x / n for x in e["other"]]
        t = [x / n for x in e["this"]]
        wo = [x / n for x in wrapper[(label, kind)]["other"]]
        wt = [x / n for x in wrapper[(label, kind)]["this"]]
        mt, mo = statistics.fmean(t), statistics.fmean(o)
        mwt, mwo = statistics.fmean(wt), statistics.fmean(wo)
        print(f"[dense-ab] {smi} | {label} {kind}, {n} launches: C entry a launch other "
              f"{o[0]:.4f}, {o[1]:.4f}; this {t[0]:.4f}, {t[1]:.4f} ms (this / other "
              f"{mt / mo:.3f}); the wrapper a call other {wo[0]:.4f}, {wo[1]:.4f}; this "
              f"{wt[0]:.4f}, {wt[1]:.4f} ms (this / other {mwt / mwo:.3f}); bound {b:.6f} ms "
              f"({by}): this {100.0 * b / mt:.3f}% (C entry), {100.0 * b / mwt:.3f}% "
              f"(wrapper), other {100.0 * b / mo:.3f}%; launches x (ms - bound): C entry other "
              f"{n * (mo - b):.4f}, this {n * (mt - b):.4f}; wrapper other {n * (mwo - b):.4f}, "
              f"this {n * (mwt - b):.4f}")
    dense_breakdown(sets, smi)
    dense_walk_yardstick(sets, smi)
    paths = {f"{label.split(' ')[0]} 320x180 8 spp render": (
        lambda scene=scene, bounce=(16 if "2400" in label else 6): _render(scene, bounce),
        320 * 180 * 8) for label, (scene, _, _) in sets.items() if scene is not None}
    turns = []
    for label in ("other", "this", "this", "other"):
        use(other if label == "other" else this)
        turns.append((label, path_turn(paths)))
    use(this)
    for name in paths:
        o = [t[name] for lab, t in turns if lab == "other"]
        s_ = [t[name] for lab, t in turns if lab == "this"]
        print(f"[dense-ab] {smi} | {name}: other {o[0]:.4f}, {o[1]:.4f} Mspps; this "
              f"{s_[0]:.4f}, {s_[1]:.4f} Mspps; this / other "
              f"{statistics.fmean(s_) / statistics.fmean(o):.3f}")


def _render(scene, bounce):
    """One render_layer epoch of `scene` at 320x180, 8 spp, bounce limit `bounce`."""
    from echorenderer_tpu_torch.processes.render import EvaluationProfile, render_layer

    prof = EvaluationProfile(samples_per_epoch=8, max_epoch=1, bounce_limit=bounce,
                             survivability=2.5, adaptive=False)
    return render_layer(scene, prof, (320, 180))


def build_dense_sweep(dest: Path) -> dict:
    """This tree's dense_intersect.cu built once for each form of
    DENSE_SWEEP under `dest`: {name: (ctypes handle, ptxas report)}."""
    csrc = REPO / "echorenderer_tpu_torch" / "csrc"
    text = (csrc / "dense_intersect.cu").read_text()
    procs = {}
    for form in DENSE_SWEEP:
        name = "g{kCoopMax} w{kDenseWarps}".format(**form)
        d = dest / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, d)
        src = text
        for const, value in form.items():
            src, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                             src)
            if n != 1:
                raise RuntimeError(f"dense_intersect.cu has no single {const}")
        (d / "dense_intersect.cu").write_text(src)
        procs[name] = nvcc(d / "dense_intersect.cu", d / "libdense_intersect.so")
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the dense form {name}:\n{err}")
        lib = ctypes.CDLL(str(dest / name.replace(" ", "_") / "libdense_intersect.so"))
        bind_dense(lib)
        libs[name] = (lib, err)
    return libs


def dense_form_name(entry: str) -> str:
    """trace_kernel<has_tri, has_sph> or occlude_kernel<...> from a mangled
    entry name."""
    tri, sph = re.search(r"ILb(\d)ELb(\d)E", entry).groups()
    kind = "trace" if "trace_kernel" in entry else "occlude"
    return f"{kind}<{tri}, {sph}>"


def dense_sweep(sets, smi) -> None:
    """Every DENSE_SWEEP form's C entry on the dense sets, two passes."""
    from chip_smoke import entry_ms, ptxas_forms

    forms = build_dense_sweep(REPO / "echorenderer_tpu_torch" / "_build" / "dense_sweep")
    want = dense_want(sets)
    runs = {}
    for name, (lib, ptxas) in forms.items():
        runs[name] = dense_runs(lib, sets)
        dense_check(runs[name], want, name)
        occ = (ctypes.c_int * 3)()
        regs = "; ".join(f"{dense_form_name(k)} {v.split(',')[0]}" for k, v in
                         {**ptxas_forms(ptxas, "trace_kernel"),
                          **ptxas_forms(ptxas, "occlude_kernel")}.items())
        warps = []
        for any_hit in (0, 1):
            lib.dense_occupancy(any_hit, 1, 1, occ)
            warps.append(occ[0] * occ[1] // 32)
        print(f"[sweep-dense] {smi} | {name}: resident warps/SM (mixed trace, occlude) "
              f"{warps[0]}, {warps[1]}; {occ[2]} bytes dynamic smem a block; {regs}")
    times = {name: {key: [] for key in runs[name]} for name in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            for key, fn in runs[name].items():
                times[name][key].append(entry_ms(fn, runs=5))
    for key in next(iter(runs.values())):
        n = len(sets[key[0]][2][key[1]])
        print(f"[sweep-dense] {smi} | {key[0]} {key[1]} ({n} launches), C entry ms a launch "
              f"(median of 5, two passes): " + "; ".join(
                  f"{name} {t[key][0] / n:.4f}, {t[key][1] / n:.4f}" for name, t in times.items()))
    for name, t in times.items():
        print(f"[sweep-dense] {smi} | {name}: every set's launches summed, ms (two passes): "
              + ", ".join(f"{sum(v[p] for v in t.values()):.4f}" for p in (0, 1)))


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


def build_plucker(csrc: Path, dest: Path, forms: dict) -> dict:
    """csrc/plucker.cu of the directory `csrc` built with this tree's flags
    once for each entry of `forms` ({name: {constant: value}}; {} builds it
    as it is) under dest/<name>/: {name: (ctypes handle, ptxas report)}."""
    from echorenderer_tpu_torch.benchmarks import plucker_micro as pm

    procs = {}
    for name, consts in forms.items():
        d = dest / name
        d.mkdir(parents=True, exist_ok=True)
        for header in csrc.glob("*.cuh"):
            shutil.copy(header, d)
        src = (csrc / "plucker.cu").read_text()
        for const, value in consts.items():
            src, k = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                             src)
            if k != 1:
                raise RuntimeError(f"plucker.cu has no single {const}")
        (d / "plucker.cu").write_text(src)
        procs[name] = nvcc(d / "plucker.cu", d / "libplucker.so")
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the Plücker form {name}:\n{err}")
        libs[name] = (pm._bind(ctypes.CDLL(str(dest / name / "libplucker.so"))), err)
    return libs


def plucker_form_line(lib, ptxas: str) -> str:
    """Each kernel's ptxas registers / spills and, where the library has the
    form query, resident warps/SM and rays a thread or prims a product."""
    from chip_smoke import PLUCKER_ENTRIES, ptxas_forms

    parts = []
    for i, (kernel, entry) in enumerate(PLUCKER_ENTRIES.items()):
        reports = ptxas_forms(ptxas, entry) or ptxas_forms(ptxas, "plk_kernel" if i else entry)
        report = "; ".join(r.split(", 0 bytes static")[0] for r in reports.values())
        if hasattr(lib, "plucker_form"):
            out = (ctypes.c_int * 5)()
            lib.plucker_form(i, out)
            report += (f"; {out[0] * out[1] // 32} warps/SM, "
                       f"{out[4]} {'prims a product' if i == 2 else 'rays a thread'}")
        parts.append(f"{kernel}: {report}")
    return " | ".join(parts)


def plucker_ab(other: Path | None, sweep: bool, smi: str) -> None:
    """--plucker and --sweep plucker: the Plücker kernels' C entries of each
    library in turns, every output held to this tree's plain versions; the
    plain versions, the bound and the library yardstick beside them."""
    import torch
    from chip_smoke import entry_ms, median_ms, plucker_bounds, plucker_products
    from echorenderer_tpu_torch.benchmarks import plucker_micro as pm
    from echorenderer_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    n = 2 ** 20
    prims, cols = pm.micro_scene(n, device=dev)
    local, center = pm.local_frame(prims, cols)
    plk = pm.build_plk(prims, center)
    csrc = REPO / "echorenderer_tpu_torch" / "csrc"
    dest = REPO / "echorenderer_tpu_torch" / "_build" / "plucker_ab"
    if sweep:
        forms = {"n{kPlkN}_wg{kDefWarpgroups}_b{kDefMinBlocks}_r{kHighRays}".format(**f): f
                 for f in PLUCKER_SWEEP}
        libs = build_plucker(csrc, dest, forms)
    else:
        libs = {"this": (pm._load(), cuda_build.build()["plucker"].ptxas)}
        if other is not None:
            libs = {"other": build_plucker(other / "echorenderer_tpu_torch" / "csrc", dest,
                                           {"other": {}})["other"], **libs}
    for name, (lib, ptxas) in libs.items():
        print(f"[plucker-ab] {smi} | {name}: {plucker_form_line(lib, ptxas)}")
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(n, dtype=torch.int32, device=dev)

    def call(lib, kernel):
        def run():
            if kernel == "mt":
                err = lib.plucker_mt(prims.data_ptr(), local.data_ptr(), n, out.data_ptr(), stream)
            else:
                err = lib.plucker_plk(plk.data_ptr(), local.data_ptr(), n,
                                      int(kernel == "plk_default"), out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
        return run

    kernels = pm.KERNELS
    plain = {"mt": lambda: pm.keys_mt_plain(prims, local),
             "plk_highest": lambda: pm.keys_plk_plain(plk, local, "highest"),
             "plk_default": lambda: pm.keys_plk_plain(plk, local, "default")}
    want = {k: fn() for k, fn in plain.items()}
    failed = []  # raised after the timings, which still say what a failing form costs
    for name, (lib, _) in libs.items():
        for kernel in kernels:
            call(lib, kernel)()
            torch.cuda.synchronize()
            if torch.equal(out, want[kernel]):
                verdict = "bitwise equal to the plain version"
            elif kernel == "plk_default":
                ok, counts = pm.default_within_contract(out, want[kernel])
                verdict = f"{'within' if ok else 'BREAKS'} the DEFAULT contract: {counts}"
                if not ok:
                    failed.append(f"{name} {kernel}")
            else:
                verdict = (f"DIFFERS from the plain version on "
                           f"{int((out != want[kernel]).sum())} rays")
                failed.append(f"{name} {kernel}")
            print(f"[plucker-ab] {smi} | {name} {kernel}: {verdict}")
    turns = (list(libs) + list(libs)[::-1] if sweep else
             ["other", "this", "this", "other"] if "other" in libs else ["this", "this"])
    times = {name: {k: [] for k in kernels} for name in libs}
    for name in turns:
        for kernel in kernels:
            times[name][kernel].append(entry_ms(call(libs[name][0], kernel)))
    bounds = plucker_bounds(n, {k: pm.inside_pairs(plk, local, k.split("_")[1])
                                for k in ("plk_highest", "plk_default")})
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        library = {"plk_highest": median_ms(plucker_products(pm, plk, local, torch.float32)),
                   "plk_default": median_ms(plucker_products(pm, plk, local, torch.bfloat16))}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    for kernel in kernels:
        bound, by, reckoning = bounds[kernel]
        plain_ms = median_ms(plain[kernel], runs=3)
        each = "; ".join(
            f"{name} " + ", ".join(f"{t:.4f}" for t in times[name][kernel]) +
            f" ms ({100.0 * bound / statistics.fmean(times[name][kernel]):.2f}% of bound)"
            for name in libs)
        ratio = ""
        if "other" in libs:
            mean = {name: statistics.fmean(times[name][kernel]) for name in ("this", "other")}
            ratio = f"; this / other {mean['this'] / mean['other']:.3f}"
        lib_ms = f"; library {library[kernel]:.4f} ms" if kernel in library else ""
        print(f"[plucker-ab] {smi} | {kernel}: {each}{ratio}; plain {plain_ms:.4f} ms; bound "
              f"{bound:.6f} ms by {by} ({reckoning}){lib_ms}; "
              f"{n * pm.H} (ray, triangle) pairs")
    if failed:
        raise AssertionError(f"outputs that fail their check: {', '.join(failed)}")


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
    ap.add_argument("--sweep", nargs="?", const="seg",
                    choices=("seg", "select-setup", "dense", "plucker"),
                    help="time the seg kernel's shapes of SWEEP, setup's and select's forms "
                         "of SHAPE_SWEEP, the dense kernels' forms of DENSE_SWEEP, or the "
                         "Plücker kernels' forms of PLUCKER_SWEEP, instead")
    ap.add_argument("--plucker", action="store_true",
                    help="only the Plücker micro-benchmark's kernels (with --other DIR, both "
                         "checkouts')")
    ap.add_argument("--dense", action="store_true",
                    help="with --other DIR: only the dense kernels' A/B")
    ap.add_argument("--shapes", action="store_true",
                    help="only the setup/select shape table (with --other, both checkouts')")
    ap.add_argument("--mega-stages", action="store_true",
                    help="the megakernel's stage breakdown, of this tree or of --other DIR")
    ap.add_argument("--dump", type=Path, help="with --mega-stages: keep the disassembly here")
    ap.add_argument("--refill", action="store_true",
                    help="only the refill kernel against the plain refill, in turns")
    a = ap.parse_args()
    if (not a.mega_stages and not a.shapes and not a.plucker and not a.refill
            and (a.other is not None) == bool(a.sweep)):
        ap.error("give --other DIR, --sweep, --shapes, --plucker, --refill or --mega-stages")
    import torch

    if not torch.cuda.is_available():
        print("hier_ab: no CUDA device", file=sys.stderr)
        return 1
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from echorenderer_tpu_torch.ops import megakernel as mk
    from echorenderer_tpu_torch.ops import pallas_hier as ph
    from echorenderer_tpu_torch.ops import pallas_intersect as pi

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    if a.mega_stages:
        root = REPO if a.other is None else a.other.resolve()
        mega_stages(root, "this" if a.other is None else "other", a.dump, smi)
        return 0
    if a.plucker or a.sweep == "plucker":
        plucker_ab(None if a.other is None else a.other.resolve(), a.sweep == "plucker", smi)
        return 0
    this = dict(hier_walk=ph._load(), megakernel=mk._load(), binned=bt._load(), row=bt.ROW,
                dense_intersect=pi._load())
    t0 = time.perf_counter()
    if a.dense or a.sweep == "dense":
        sets = dense_sets(dev)
        print(f"[ab] {smi} | dense sets in {time.perf_counter() - t0:.1f} s: " + ", ".join(
            f"{label} ({len(c['trace'])} + {len(c['occlude'])} calls, {soa.n_chunks} chunks)"
            for label, (_, soa, c) in sets.items()))
        if a.sweep:
            dense_sweep(sets, smi)
            return 0
        other = build_other(a.other.resolve())
        compare_sass(other, smi)
        dense_ab(other, this, sets, smi)
        return 0
    if a.refill:
        runs = binned_runs(dev, *large_scenes(dev))
        print(f"[ab] {smi} | inputs in {time.perf_counter() - t0:.1f} s")
        refill_turns(runs, smi)
        return 0
    if a.shapes or a.sweep == "select-setup":
        runs = binned_runs(dev, *large_scenes(dev))
        libs = {"this": this["binned"]}
        if a.other is not None and not a.sweep:
            libs = {"other": build_other(a.other.resolve())["binned"], "this": this["binned"]}
        print(f"[ab] {smi} | inputs in {time.perf_counter() - t0:.1f} s")
        fits = {}
        if a.sweep:
            forms = build_shape_sweep(REPO / "echorenderer_tpu_torch" / "_build" / "shapes")
            libs.update({name: lib for name, (lib, _) in forms.items()})
            fits = {name: form_fits(form) for name, (_, form) in forms.items()}
        shape_table(select_setup_launches(runs, libs, fits), smi)
        return 0
    items, counts, scenes_, runs = inputs(dev)
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
    compare_sass(other, smi)
    shape_table(select_setup_launches(runs, {"other": other["binned"], "this": this["binned"]}), smi)
    for key in ("bench", "top"):  # the untextured form's residency in each checkout
        padded = scenes_[key].prim_soa.padded
        print(f"[ab] {smi} | untextured megakernel at {padded} padded prims: " + "; ".join(
            f"{label} {mega_occupancy(libs['megakernel'], padded)}"
            for label, libs in (("other", other), ("this", this))))
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
