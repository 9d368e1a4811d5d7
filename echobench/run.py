"""The benchmark of the port (echorenderer_tpu_torch): one run of one cell.

    python3 -m echobench --workload field80.image256 --seed 7 --seconds 40 --trace 0

A run makes its scene from the cell's configuration file and its image
seeds from --seed, sets up the port (import, kernels, `prepare_scene`, one
warm-up image of the cell's own shapes: all of that is `setup_s`), then
renders image after image for --seconds (a closed loop, one client) and
reports the cell's end-to-end metrics (--trace 0) or, with the window under
torch.profiler, its per-layer metrics (--trace 1). After the window it
checks a sample of the images against the plain reference (check.py) and
that no JAX module was loaded (imports.py). The last line of standard
output is the result; the last lines of standard error are each number
compared with its limit.

A run needs as many CUDA devices as the cell asks for; without them it
exits with 2 and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import check, imports, manifest

ROOT = manifest.HERE.parent


@dataclasses.dataclass
class Image:
    start: float  # host clock, seconds
    end: float
    infos: dict  # layer name -> the entry's info dict


@dataclasses.dataclass
class Run:
    """What a metric reader reads (metrics/<name>.py `read(run)`)."""

    traffic: dict
    setup: dict  # "setup_s", "prepare_s": seconds
    images: list  # Image of every image the window completed
    window: tuple  # (start, end) host clock: from the first image's call to the last image
    trace: object = None  # trace.Trace of the traced images (--trace 1), else None

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def image_seeds(seed: int):
    """The closed loop's image seeds: 32-bit words drawn from --seed."""
    g = np.random.Generator(np.random.PCG64(int(seed) & (2**63 - 1)))
    while True:
        yield int(g.integers(0, 2**32))


def host_info() -> dict:
    """The card's name and power limit, the host's CPU model and cores."""
    info = {}
    try:
        info["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        info["card"] = f"nvidia-smi failed: {e}"
    model = "unknown"
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    info["cpu"] = model
    info["cores"] = len(os.sched_getaffinity(0))
    return info


def window(entry, scene, seeds, seconds: float, sample, traced: int, profiler=None):
    """Images one after the other until `seconds` have passed since the
    first call, each handed to `sample` (check.Sample) and dropped; the
    first `traced` images run under `profiler` (None: no trace). Returns
    (images, failures, the kineto events or None)."""
    import torch

    images, failed, events = [], 0, None
    prof = profiler.__enter__() if profiler is not None else None
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end or not images:
        s = next(seeds)
        t0 = time.perf_counter()
        try:
            if prof is not None:
                with torch.profiler.record_function("echobench.image"):
                    layers, infos = entry(scene, s)
            else:
                layers, infos = entry(scene, s)
        except Exception as e:  # a failed image counts; the window goes on
            print(f"echobench: image with seed {s} failed: {e!r}", file=sys.stderr)
            failed += 1
            if failed > 3:
                break
            continue
        images.append(Image(t0, time.perf_counter(), infos))
        sample.take(s, layers)
        if prof is not None and len(images) == traced:
            profiler.__exit__(None, None, None)
            events, prof = profiler.profiler.kineto_results.events(), None
    if prof is not None:
        profiler.__exit__(None, None, None)
        events = profiler.profiler.kineto_results.events()
    return images, failed, events


def measure(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device,
            root: Path = ROOT, bench: dict | None = None, t_setup: float | None = None) -> dict:
    """One run of a cell on `device`; returns the result object. Set-up
    counts from `t_setup` (host clock; default: now)."""
    t_setup = time.perf_counter() if t_setup is None else t_setup
    import torch

    from . import port
    from . import trace as trace_mod

    if (cell.traffic.get("loop"), cell.traffic.get("clients")) != ("closed", 1):
        raise ValueError("the generator runs a closed loop of one client")
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    spec = cell.scene()
    torch.empty(1, device=device)  # the device's context starts outside prepare_s
    sync()
    t0 = time.perf_counter()
    context_s = t0 - t_setup
    scene = port.prepare(spec, device)
    sync()
    prepare_s = time.perf_counter() - t0
    entry = port.Entry(cell.traffic)
    seeds = image_seeds(seed)
    entry(scene, next(seeds))  # the warm-up image: builds and loads every kernel it runs
    sync()
    setup = {"setup_s": time.perf_counter() - t_setup, "prepare_s": prepare_s}
    print(f"echobench: set-up {setup['setup_s']:.3f} s: imports, the scene's arrays and "
          f"the device's context {context_s:.3f} s, prepare_scene {prepare_s:.3f} s, the "
          f"warm-up image {setup['setup_s'] - context_s - prepare_s:.3f} s", file=sys.stderr)

    profiler = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
    sample = check.Sample(cell.check, cell.traffic, seed, module=cell.reference)
    images, failed, events = window(entry, scene, seeds, seconds, sample,
                                    int(cell.traffic.get("trace_images", 10**9)), profiler)
    run = Run(cell.traffic, setup, images,
              (images[0].start, images[-1].end) if images else (0.0, 0.0))
    if events is not None:
        run.trace = trace_mod.from_kineto(events)

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": cell.chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else 0}
    if run.trace is not None:
        dev_info["busy_s"] = run.trace.busy_s()
        dev_info["window_s"] = run.trace.window_s

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.reader(root, m["name"], bench)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs on the same card
    del scene, entry, profiler
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    compared = check.run(sample, spec, device) if images else {}
    times = sorted(im.end - im.start for im in images)
    if times:
        print(f"echobench: {len(images)} images in {run.window_s:.3f} s (image seconds min "
              f"{times[0]:.4f}, median {times[len(times) // 2]:.4f}, max {times[-1]:.4f}); "
              f"the check took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = bool(images) and failed == 0 and all(v <= lim for v, lim in compared.values())

    result = {"correct": correct, "attempted": len(images) + failed, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if run.trace is not None:
        result["breakdown"] = trace_mod.breakdown(run.trace)
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m echobench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    # the dispatch users get: no chunk-tree megakernel, no device checks
    for name in ("ECHO_MEGA_HIER", "ECHO_DEBUG_DEVICE"):
        os.environ.pop(name, None)
    bench = manifest.load(ROOT)
    cell = manifest.cell(ROOT, a.workload, bench)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"echobench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = measure(cell, a.seed, a.seconds, bool(a.trace), "cuda", ROOT, bench, t_start)
    info = host_info()
    print(f"echobench: {info['card']} | host {info['cpu']}, {info['cores']} cores",
          file=sys.stderr)
    found = imports.loaded()
    if found:
        print(f"echobench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        print(f"echobench check: {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0
