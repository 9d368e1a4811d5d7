#!/usr/bin/env python3
"""Profile one render epoch of the PyTorch port (echorenderer_tpu_torch)
on one NVIDIA GPU under torch.profiler.

    python3 tools/torch_profile.py                       # the bench epoch
    python3 tools/torch_profile.py --count 2400 --res 320x180 --spp 8
    python3 tools/torch_profile.py --spp 8 --wavefront   # the wavefront's frame
    python3 tools/torch_profile.py --tris 1000000 --res 1920x1080 --spp 1 --bounce 6
    python3 tools/torch_profile.py --instanced --res 1920x1080 --spp 1 --bounce 6
    ECHO_MEGA_HIER=1 python3 tools/torch_profile.py --tris 1000000 --res 1920x1080 --spp 1 --bounce 6
    python3 tools/torch_profile.py --adaptive            # bench.py's adaptive configuration

The scene is sphere_field(count) (bench.py's scene at the default 80),
rendered through `render_layer` for one epoch of `spp` samples at bounce
limit `bounce` (the megakernel where it takes the scene); with
`--wavefront`, one frame of the same samples through the wavefront, as a
render that asks for the wavefront's stats runs it. With `--tris N` the
scene is sphere_grid(N) instead (bench.py's large scene at 1,000,000), and
an epoch is one program of `_sample_frame`, as bench.py times it (the
wavefront; from 65,536 padded prims on its first wave takes the chunk-tree
walk and every later wave the binned traversal). With `--instanced` the
scene is instanced_sphere_grids() prepared with instancing="tlas" (4
placements of a 123,008-triangle pack: the instanced walk, then the
instanced binned traversal), an epoch one program as with `--tris`. Under
ECHO_MEGA_HIER, `--tris` programs take the megakernel's chunk-tree form
(one launch each) instead of the wavefront.
Prints the card's name and power limit, the wall time of two unprofiled
epochs after a warm-up, then for one profiled epoch: its wall time, the
device's busy time (sum of kernel and copy times) and idle share, device
time grouped by kernel name with launch counts, and the share of
PyTorch's elementwise kernels.

With `--adaptive`, bench.py's adaptive configuration instead
(`large_scene_adaptive_time_to_256spp_seconds`): sphere_grid(--tris,
default 1,000,000) at --res (default 1920x1080), 8 samples an epoch,
min_epoch 1, --max-epoch epochs at most (default 32: 256 spp), noise
threshold 0.045, bounce 6, survivability 2.5, through `render_layer`'s
adaptive epochs. After a one-sample warm-up program it prints one
unprofiled run (seconds, epochs, samples, mean spp, effective Mspps, peak
memory, and each epoch's active pixels, seconds and Mspps), then the same
run under the profiler (device activities only) with the breakdown above.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--count", type=int, default=80)
    ap.add_argument("--res", default=None, help="WxH (default 960x540; 1920x1080 adaptive)")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--bounce", type=int, default=16)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--wavefront", action="store_true")
    ap.add_argument("--tris", type=int, default=0, help="profile sphere_grid(TRIS) instead")
    ap.add_argument("--instanced", action="store_true",
                    help="profile the TLAS scene instanced_sphere_grids() instead")
    ap.add_argument("--adaptive", action="store_true",
                    help="bench.py's adaptive configuration on sphere_grid(TRIS or 1M)")
    ap.add_argument("--max-epoch", type=int, default=32, help="--adaptive's epoch budget")
    a = ap.parse_args()
    a.res = a.res or ("1920x1080" if a.adaptive else "960x540")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.ops import binned_trace
    from echorenderer_tpu_torch.processes.render import (EvaluationProfile, _sample_frame,
                                                         render_layer)
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    res = tuple(int(v) for v in a.res.split("x"))
    if a.adaptive:
        return profile_adaptive(a, res, smi)
    program = a.tris or a.instanced  # an epoch is one bench.py program
    if a.instanced:
        name, make, mode = "instanced_sphere_grids (TLAS)", scenes.instanced_sphere_grids, "tlas"
    elif a.tris:
        name, make, mode = f"sphere_grid({a.tris})", lambda: scenes.sphere_grid(a.tris), "auto"
    else:
        name, make, mode = f"sphere_field({a.count})", lambda: scenes.sphere_field(a.count), "auto"
    t0 = time.perf_counter()
    scene = prepare_scene(make(), instancing=mode, device="cuda")
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    prof = EvaluationProfile(samples_per_epoch=a.spp, max_epoch=1, bounce_limit=a.bounce,
                             survivability=2.5, adaptive=False)
    _, info = render_layer(scene, prof, res)  # warm-up: kernel build and load
    dispatch = info["dispatch"]

    def epoch():
        if program:  # one bench.py program
            _sample_frame(scene, "path", res, 0, 1, a.spp, a.bounce, 2.5)
        elif a.wavefront:
            _sample_frame(scene, "path", res, 0, 0, a.spp, a.bounce, 2.5, return_stats=True)
        else:
            render_layer(scene, prof, res)

    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    samples = res[0] * res[1] * a.spp
    integ = ("wavefront: stats render" if a.wavefront
             else f"{dispatch['integrator']}: {dispatch['integrator_reason']}")
    print(f"[profile] {smi} | {name} {res[0]}x{res[1]} {a.spp} spp bounce "
          f"{a.bounce} | {integ} | {dispatch['accelerator']} | prepared in {prep_s:.2f} s")
    print("[profile] unprofiled epochs: " + ", ".join(
        f"{w:.4f} s = {samples / w / 1e6:.3f} Mspps" for w in walls))

    torch.cuda.synchronize()
    binned_trace.reset_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(p, wall, a.top, "epoch")
    st = binned_trace.STATS
    print(f"[profile] binned traversal in the profiled epoch: {st['calls']} calls, "
          f"{st['rounds']} rounds, {st['syncs']} host reads")

    # host pieces of every epoch, timed alone (median of 5)
    from echorenderer_tpu_torch.ops import megakernel
    from echorenderer_tpu_torch.processes.tiles import lane_order

    def host_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[2]

    image = torch.zeros((res[1], res[0], 3), device="cuda")
    tables = "" if program else (
        f", megakernel tables {host_ms(lambda: megakernel._build_tables(scene)):.3f}")
    print(f"[profile] host pieces (ms, median of 5): lane_order at {res[0] * res[1]} keys "
          f"{host_ms(lambda: lane_order(res)):.3f}{tables}"
          f", image download {host_ms(lambda: image.cpu().numpy()):.3f}")
    return 0


def report(p, wall: float, top: int, what: str) -> None:
    """Device busy and idle share of a profiled run, its `top` kernels and
    the kernel families' shares."""
    from torch.autograd import DeviceType

    rows = []
    for evt in p.key_averages():
        if evt.device_type != DeviceType.CUDA:  # host ops: their kernels are listed apart
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"[profile] profiled {what}: {wall * 1e3:.3f} ms wall, device busy {busy_ms:.3f} ms "
          f"({busy_ms / (wall * 1e3):.1%}), idle {1 - busy_ms / (wall * 1e3):.1%}; "
          f"{sum(r[1] for r in rows)} device activities")
    for dev_us, count, key in rows[:top]:
        print(f"[profile]   {dev_us / 1e3:10.3f} ms {dev_us / 1e3 / busy_ms:7.2%} "
              f"{count:8d}x  {key[:90]}")
    families = {  # csrc kernels by name, then PyTorch's own
        "binned setup_kernel": "setup_kernel|setup_group", "binned select_kernel":
        "select_kernel|select_group", "binned seg_kernel": "seg_kernel", "hier_kernel":
        "hier_kernel", "dense trace/occlude": "trace_kernel|occlude_kernel", "mega_kernel":
        "mega_kernel", "PyTorch sorts": "sort|Sort", "PyTorch elementwise kernels": "elementwise",
    }
    for label, keys in families.items():
        fam = [r for r in rows if any(k in r[2] for k in keys.split("|"))]
        if fam:
            ms = sum(r[0] for r in fam) / 1e3
            print(f"[profile] {label}: {ms:.3f} ms ({ms / busy_ms:.1%} of busy) in "
                  f"{sum(r[1] for r in fam)} launches")


def profile_adaptive(a, res, smi) -> int:
    """bench.py's adaptive configuration: an unprofiled run, then a
    profiled one (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.ops import binned_trace
    from echorenderer_tpu_torch.processes.render import (EvaluationProfile, _sample_frame,
                                                         render_layer)
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    tris = a.tris or 1_000_000
    t0 = time.perf_counter()
    scene = prepare_scene(scenes.sphere_grid(tris), device="cuda")
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    prof = EvaluationProfile(samples_per_epoch=8, min_epoch=1, max_epoch=a.max_epoch,
                             noise_threshold=0.045, bounce_limit=6, survivability=2.5)
    _sample_frame(scene, "path", res, 0, 0, 1, 6, 2.5)  # warm-up: kernel build and load
    torch.cuda.synchronize()
    n = res[0] * res[1]

    def run(label):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        binned_trace.reset_stats()
        _, info = render_layer(scene, prof, res)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        d = info["dispatch"]
        print(f"[profile] {smi} | {label} adaptive run, sphere_grid({tris}) {res[0]}x{res[1]}, "
              f"8 spp an epoch, at most {a.max_epoch} epochs, threshold 0.045, bounce 6 | "
              f"{d['integrator']} | {d['accelerator']} | prepared in {prep_s:.2f} s")
        print(f"[profile] {info['seconds']:.3f} s, {info['epochs']} epochs, {info['samples']} "
              f"samples, {info['samples'] / n:.3f} spp mean, "
              f"{info['samples_per_second'] / 1e6:.4f} Mspps effective, peak {peak:.2f} GiB; "
              f"{info['wavefront_iterations']} wavefront iterations, binned "
              f"{binned_trace.STATS['calls']} calls, {binned_trace.STATS['rounds']} rounds, "
              f"{binned_trace.STATS['syncs']} host reads")
        for e in info["epoch_log"]:
            print(f"[profile]   epoch {e['epoch']}: {e['active']} pixels, {e['seconds']:.4f} s = "
                  f"{e['active'] * 8 / e['seconds'] / 1e6:.4f} Mspps")
        return info

    run("unprofiled")
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        run("profiled")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(p, wall, a.top, "adaptive run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
