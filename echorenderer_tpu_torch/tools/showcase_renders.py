"""The showcase images (counterpart of tools/showcase_renders.py, whose
output is docs/renders/): path tracing with the albedo and normal_depth
AOVs, then the learned denoiser and ACES.

    python -m echorenderer_tpu_torch.tools.showcase_renders --out DIR [--device cuda|cpu]

Writes cornell_box.png, material_ball.png and instanced_forest.png into
`--out`, never into docs/renders/. Runs on the card unless `--device cpu`
is given; with no card it raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from . import card_line, check_writable, require_device

# name, scene maker (by name below), width, height, samples an epoch, max
# epochs, bounce limit: the JAX tool's budgets
JOBS = (
    ("cornell_box", 640, 480, 32, 8, 8),
    ("material_ball", 640, 400, 32, 8, 8),
    ("instanced_forest", 480, 300, 4, 6, 4),
)


def instanced_forest():
    """1,500 instances of a 3-prim pack: the TLAS showcase."""
    from ..scene import (
        AmbientLight, BoxEntity, Diffuse, EntityPack, PackInstance,
        PerspectiveCamera, PlaneEntity, Scene, SphereEntity,
    )
    from ..scene.materials import Conductor, Emissive

    pack = EntityPack()
    pack.add(BoxEntity(size=(0.12, 1.2, 0.12), material=Diffuse(albedo=(0.45, 0.3, 0.2)),
                       position=(0, 0.6, 0)))
    pack.add(SphereEntity(radius=0.45, material=Diffuse(albedo=(0.15, 0.45, 0.2)),
                          position=(0, 1.4, 0)))
    pack.add(SphereEntity(radius=0.05, material=Emissive(albedo=(10, 8, 4)),
                          position=(0.3, 1.1, 0.2)))

    scene = Scene()
    rs = np.random.RandomState(11)
    for _ in range(1500):
        scene.add(PackInstance(
            pack,
            position=(rs.uniform(-28, 28), 0.0, rs.uniform(2, 70)),
            scale=float(rs.uniform(0.6, 1.6)),
            rotation=(0, float(rs.uniform(0, 360)), 0),
        ))
    scene.add(PlaneEntity(size=(220, 220), material=Diffuse(albedo=(0.34, 0.33, 0.3))))
    scene.add(SphereEntity(radius=1.3, material=Conductor(albedo=(0.95, 0.93, 0.9), roughness=0.03),
                           position=(0, 1.3, 6)))
    scene.add(AmbientLight(intensity=(0.42, 0.5, 0.65)))
    cam = PerspectiveCamera(field_of_view=58, position=(0.5, 2.6, -4.0))
    cam.look_at((0, 1.0, 12))
    scene.add(cam)
    return scene


def make_scene(name: str):
    from ..models import scenes

    return instanced_forest() if name == "instanced_forest" else getattr(scenes, name)()


def showcase_profile(w, h, spe, max_epoch, bounces):
    """The JAX tool's profile: adaptive path epochs, albedo, normal_depth,
    then LearnedDenoise and ACES."""
    from ..processes.composition import LearnedDenoise, ToneMapper
    from ..processes.render import EvaluationProfile, RenderProfile

    return RenderProfile(
        resolution=(w, h),
        evaluations=(
            EvaluationProfile(
                evaluator="path", samples_per_epoch=spe, min_epoch=2,
                max_epoch=max_epoch, noise_threshold=0.08,
                bounce_limit=bounces,
            ),
            EvaluationProfile(evaluator="albedo", layer_name="albedo"),
            EvaluationProfile(evaluator="normal_depth", layer_name="normal_depth"),
        ),
        composition=(LearnedDenoise(), ToneMapper(curve="aces")),
    )


def render_job(job, out_dir, device="cuda", log=print) -> dict:
    """Render one entry of JOBS and save `<out_dir>/<name>.png`; returns
    the render's layers and info."""
    from ..io import images
    from ..processes.render import render
    from ..scene.prepare import prepare_scene

    name, w, h, spe, max_epoch, bounces = job
    path = check_writable(os.path.join(out_dir, f"{name}.png"))
    t0 = time.perf_counter()
    prepared = prepare_scene(make_scene(name), device=device)
    out = render(prepared, showcase_profile(w, h, spe, max_epoch, bounces))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    images.save(path, out["main"])
    info = out["__info__"]
    layers = ", ".join(f"{k} {v['seconds']:.2f}s" for k, v in info.items() if "seconds" in v)
    log(f"{name}: {info['main']['samples']:,} samples, {time.perf_counter() - t0:.1f}s "
        f"({layers}; path: {info['main']['epochs']} epochs, {info['main']['dispatch']})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for the PNGs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    check_writable(args.out)
    if dev.type == "cuda":
        print(f"card: {card_line()}", flush=True)
    for job in JOBS:
        render_job(job, args.out, dev, log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
