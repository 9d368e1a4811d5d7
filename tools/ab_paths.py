#!/usr/bin/env python3
"""Time the render paths of one checkout on one NVIDIA GPU, its Python and
its kernels both: each path the median of 5 synchronised runs after a
warm-up, and the 1M scene's prepare_scene seconds.

    python3 tools/ab_paths.py DIR

DIR is a checkout (`.`, or the parent unpacked by `git archive` into a
directory .gitignore lists). Comparing two commits' host code takes one
process a checkout, in turns, on one card:

    for d in _archive/parent . . _archive/parent; do python3 tools/ab_paths.py $d; done

Paths: the bench scene (sphere_field(80)) and the showcase at 960x540, 64
spp, bounce 16 through render_layer (the megakernel); sphere_grid(1_000_000)
at 1920x1080, 1 spp, bounce 6 through the main dispatch, the walk alone and
ECHO_MEGA_HIER's chunk-tree form; the TLAS slice (instanced_sphere_grids)
at the same traffic; the README's standard_path_traced_profile call on
material_ball at 1280x720 (seconds).
"""
import contextlib
import os
import statistics
import sys
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
import torch

from echorenderer_tpu_torch.evaluation import scene_ops
from echorenderer_tpu_torch.models import scenes
from echorenderer_tpu_torch.ops import cuda_build
from echorenderer_tpu_torch.processes.render import (EvaluationProfile, _sample_frame, render,
                                                     render_layer, standard_path_traced_profile)
from echorenderer_tpu_torch.scene.prepare import prepare_scene

assert scenes.__file__.startswith(root), scenes.__file__
import chip_smoke as cs

dev = torch.device("cuda")
cuda_build.build()
t = time.perf_counter()
grid = prepare_scene(scenes.sphere_grid(1_000_000), device=dev)
torch.cuda.synchronize()
prep = time.perf_counter() - t
bench = prepare_scene(scenes.sphere_field(80), device=dev)
show = prepare_scene(cs.showcase_scene(), device=dev)
tlas = prepare_scene(scenes.instanced_sphere_grids(), instancing="tlas", device=dev)
ball = prepare_scene(scenes.material_ball(), device=dev)
prof = EvaluationProfile(samples_per_epoch=64, max_epoch=1, bounce_limit=16, survivability=2.5,
                         adaptive=False)
RES = (1920, 1080)
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


readme = standard_path_traced_profile(1.0, (1280, 720))
paths = {
    "bench 64 spp": (lambda: render_layer(bench, prof, (960, 540)), 960 * 540 * 64),
    "showcase 64 spp": (lambda: render_layer(show, prof, (960, 540)), 960 * 540 * 64),
    "1M main dispatch": (program(grid), n_px),
    "1M walk alone": (program(grid, scene_ops.walk_only), n_px),
    "1M chunk-tree form": (program(grid, mega_hier), n_px),
    "TLAS": (program(tlas), n_px),
    "README call (s)": (lambda: render(ball, readme), None),
}
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
    w = statistics.median(walls)
    out[name] = w if samples is None else samples / w / 1e6
print(f"[ab-paths] {root}: 1M prepare {prep:.2f} s; " + ", ".join(
    f"{k} {v:.4f}" for k, v in out.items()), flush=True)
