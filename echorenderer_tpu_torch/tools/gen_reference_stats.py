"""Per-tile reference statistics of the independent brute-force oracle
(counterpart of tools/gen_reference_stats.py), in the layout of
tests/fixtures/tile_stats/<scene>.npz that
tests/test_reference_scenes.py::TestTileStats reads.

    python -m echorenderer_tpu_torch.tools.gen_reference_stats --out DIR [--spp 256]
        [--device cuda|cpu]

For each scene it renders the naive integrator (no NEE, MIS or light tree:
an unbiased estimator that shares nothing with the production path) at
RES through the port's `_sample_frame`, STEP samples a call, summed in
float64, then stores each TILE x TILE tile's luminance mean and per-sample
variance (`tile_stats`). The production path tracer estimates the same
integral, so its tile means must match within z-sigma of the combined
standard error (`tile_z`). It writes `<scene>.npz` into `--out`, never
into tests/fixtures/. Runs on the card unless `--device cpu` is given;
with no card it raises.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from . import card_line, check_writable, require_device

RES = (960, 540)
TILE = 60  # 16 x 9 tiles
SCENES = ("cornell_box", "material_ball", "sphere_field")
STEP = 8  # samples a call
BOUNCE_LIMIT = 6
SURVIVABILITY = 2.5
LUM_W = np.asarray([0.212671, 0.715160, 0.072169], np.float32)


def tile_stats(s_sum, s_sq, count, resolution, tile=TILE):
    """Per-tile luminance mean and per-SAMPLE variance from the frame's
    (sum, sum_sq) accumulators."""
    w, h = resolution
    mean_c = np.asarray(s_sum).reshape(h, w, 3) / count
    e2_c = np.asarray(s_sq).reshape(h, w, 3) / count
    m = mean_c @ LUM_W
    # luminance variance is not derivable from per-channel sums (cross
    # covariances are not accumulated); use the Cauchy-Schwarz upper bound
    # (sum_i w_i sigma_i)^2: conservative, so the z-test never tightens
    # beyond the true sampling error
    sigma_c = np.sqrt(np.maximum(e2_c - mean_c ** 2, 0.0))
    var_px = (sigma_c @ LUM_W) ** 2
    ty, tx = h // tile, w // tile
    mt = m[: ty * tile, : tx * tile].reshape(ty, tile, tx, tile)
    vt = var_px[: ty * tile, : tx * tile].reshape(ty, tile, tx, tile)
    return mt.mean(axis=(1, 3)), vt.mean(axis=(1, 3))


def naive_sums(scene, spp, resolution=RES, step=STEP, log=None):
    """The naive integrator's (sum, sum_sq) over `spp` samples a pixel,
    float64 (H*W, 3) arrays in scan order, rendered `step` samples a call."""
    from ..processes.render import _sample_frame

    s_sum = s_sq = None
    for start in range(0, spp, step):
        count = min(step, spp - start)
        a, b = _sample_frame(scene, "naive", tuple(resolution), 0, start, count, BOUNCE_LIMIT,
                             SURVIVABILITY)
        a = a.cpu().numpy().astype(np.float64)
        b = b.cpu().numpy().astype(np.float64)
        s_sum = a if s_sum is None else s_sum + a
        s_sq = b if s_sq is None else s_sq + b
        if log is not None:
            log(f"{start + count}/{spp} spp")
    return s_sum, s_sq


def tile_z(s_sum, spp, ref: dict):
    """TestTileStats's z of each tile: |tile mean of the (sum over `spp`
    samples) frame - the reference's| over the combined standard error
    (floored at 1e-4). `ref` holds the npz's mean, var, spp, tile and res."""
    w, h = (int(v) for v in ref["res"])
    tile = int(ref["tile"])
    m = (np.asarray(s_sum).reshape(h, w, 3) / spp) @ LUM_W
    ty, tx = h // tile, w // tile
    mt = m[: ty * tile, : tx * tile].reshape(ty, tile, tx, tile).mean(axis=(1, 3))
    se = np.sqrt(ref["var"] * (1.0 / (spp * tile * tile) + 1.0 / (int(ref["spp"]) * tile * tile)))
    return np.abs(mt - ref["mean"]) / np.maximum(se, 1e-4)


def stats_arrays(s_sum, s_sq, spp, resolution=RES, tile=TILE) -> dict:
    """The fixture's arrays, as the JAX tool writes them."""
    mean_t, var_t = tile_stats(s_sum, s_sq, spp, resolution, tile)
    return dict(mean=mean_t.astype(np.float32), var=var_t.astype(np.float32),
                spp=np.int32(spp), tile=np.int32(tile), res=np.asarray(resolution, np.int32),
                bounce_limit=np.int32(BOUNCE_LIMIT))


def generate(name, out_dir, spp, device="cuda", log=print) -> dict:
    """Render scene `name` (a function of models/scenes.py) with the naive
    integrator and write `<out_dir>/<name>.npz`. Returns its arrays."""
    from ..models import scenes as scene_mod
    from ..scene.prepare import prepare_scene

    path = check_writable(os.path.join(out_dir, f"{name}.npz"))
    scene = prepare_scene(getattr(scene_mod, name)(), device=device)
    s_sum, s_sq = naive_sums(scene, spp, log=lambda m: log(f"{name}: {m}"))
    stats = stats_arrays(s_sum, s_sq, spp)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **stats)
    log(f"{name}: wrote stats, tile-mean range [{stats['mean'].min():.4f}, "
        f"{stats['mean'].max():.4f}]")
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for <scene>.npz")
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    check_writable(args.out)
    if dev.type == "cuda":
        print(f"card: {card_line()}", flush=True)
    for name in SCENES:
        t0 = time.perf_counter()
        generate(name, args.out, args.spp, dev, log=lambda m: print(m, flush=True))
        print(f"{name}: {time.perf_counter() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
