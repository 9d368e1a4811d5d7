"""Render orchestration (counterpart of echorenderer_tpu/processes/render.py):
profiles, the path-traced frame sampler and the epoch loop with per-pixel
Welford accumulation.

This package runs the "path" evaluator, full-frame epochs only: through
the fused megakernel for CUDA scenes inside its envelope (and, under
ECHO_MEGA_HIER, larger ones inside its chunk-tree form's), otherwise
through the regenerating wavefront. Adaptive per-pixel epochs and the
composition stack raise NotImplementedError until they are ported.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..scene.prepare import PreparedScene
from ..utils import accumulator as acc_mod

# lanes one wavefront may hold: chains multiply the lane count up to this
MAX_LANES = 4_194_304


@dataclasses.dataclass
class EvaluationProfile:
    """What/how to evaluate one AOV layer (reference EvaluationProfile.cs)."""

    evaluator: str = "path"
    layer_name: str = "main"
    min_epoch: int = 1
    max_epoch: int = 20
    noise_threshold: float = 0.045
    samples_per_epoch: int = 16
    bounce_limit: int = 128
    survivability: float = 2.5
    adaptive: bool = True


@dataclasses.dataclass
class RenderProfile:
    """A full render description (reference RenderProfile.cs)."""

    resolution: tuple = (960, 540)
    evaluations: tuple = (EvaluationProfile(),)
    composition: tuple = ()
    seed: int = 0


def _sample_frame(scene: PreparedScene, evaluator: str, resolution, seed, sample_start,
                  count, bounce_limit, survivability, return_stats: bool = False):
    """Accumulate `count` samples for every pixel. Returns (sum, sum_sq) of
    shape (H*W, 3) in scan order (plus the wavefront's stats dict when
    `return_stats`)."""
    if evaluator != "path":
        raise NotImplementedError(
            f"evaluator {evaluator!r} is not in the PyTorch port yet (only 'path')"
        )
    from ..evaluation.scene_ops import dispatch_summary
    from ..evaluation.wavefront import sample_frame_wavefront
    from .tiles import lane_order

    dev = scene.device
    width, height = resolution
    n = width * height
    # tile-major lane order: each kernel block covers a compact pixel tile
    perm, inv = lane_order(resolution)
    pixel_id = torch.as_tensor(perm.astype(np.int64), device=dev)
    pixel_xy = torch.stack([pixel_id % width, pixel_id // width], dim=-1).to(torch.int32)

    # independent sample chains per pixel in one wave: wider waves, shorter
    # regeneration tail; only the order of summation changes. The fused
    # megakernel has no per-iteration cost to spread, and chains would only
    # shorten each thread's run of samples: one chain when it takes the frame
    chains = 1
    integrator = dispatch_summary(scene, return_stats)["integrator"]
    mega = integrator in ("megakernel", "megakernel-hier")
    for k in () if mega else (4, 2):
        if count % k == 0 and n * k <= MAX_LANES:
            chains = k
            break
    rep = lambda a: a.repeat((chains,) + (1,) * (a.dim() - 1))
    chain = torch.repeat_interleave(
        torch.arange(chains, dtype=torch.int64, device=dev) * (count // chains), n
    )
    out = sample_frame_wavefront(
        scene, rep(pixel_id), rep(pixel_xy), resolution, seed,
        (int(sample_start) + chain) & 0xFFFFFFFF, count // chains,
        bounce_limit=bounce_limit, survivability=survivability, return_stats=return_stats,
    )
    s_sum, s_sq = out[0], out[1]
    if chains > 1:
        s_sum = s_sum.reshape(chains, n, 3).sum(0)
        s_sq = s_sq.reshape(chains, n, 3).sum(0)
    inv_d = torch.as_tensor(inv.astype(np.int64), device=dev)
    if return_stats:
        return s_sum[inv_d], s_sq[inv_d], out[2]
    return s_sum[inv_d], s_sq[inv_d]  # back to scan (pixel-id) order


def render_layer(scene: PreparedScene, profile: EvaluationProfile, resolution,
                 seed: int = 0, progress=None):
    """Run the epoch loop for one layer. Returns (image (H, W, C) numpy,
    info dict with sample statistics)."""
    adaptive = (
        profile.adaptive and profile.evaluator == "path"
        and profile.max_epoch > profile.min_epoch
    )
    if adaptive:
        raise NotImplementedError(
            "adaptive epochs are not in the PyTorch port yet "
            "(ROADMAP.md: queue 1, adaptive epochs); pass adaptive=False"
        )
    from ..evaluation.scene_ops import dispatch_summary

    width, height = resolution
    n = width * height
    acc = acc_mod.create((n,), channels=3, device=scene.device)
    total_samples = 0
    dispatch = dispatch_summary(scene)
    # the wavefront's counters cost nothing extra; asking for them on a
    # megakernel frame would bypass the kernel
    stats_on = dispatch["integrator"] == "wavefront"
    iterations = 0 if stats_on else None
    start = time.perf_counter()

    epoch = -1
    for epoch in range(profile.max_epoch):
        out = _sample_frame(
            scene, profile.evaluator, tuple(resolution), seed,
            epoch * profile.samples_per_epoch, profile.samples_per_epoch,
            profile.bounce_limit, profile.survivability, return_stats=stats_on,
        )
        s_sum, s_sq = out[0], out[1]
        if stats_on:
            iterations += out[2]["Loop/Iterations"]
        acc = acc_mod.add_many(acc, s_sum, s_sq, float(profile.samples_per_epoch))
        total_samples += profile.samples_per_epoch * n

        noise = float(torch.max(acc_mod.max_noise(acc)))
        if progress:
            progress(epoch + 1, profile.max_epoch, noise)
        if epoch + 1 >= profile.min_epoch and noise < profile.noise_threshold:
            break

    image = acc.mean.reshape(height, width, 3).cpu().numpy()
    elapsed = time.perf_counter() - start
    info = dict(
        samples=total_samples,
        epochs=epoch + 1,
        seconds=elapsed,
        samples_per_second=total_samples / max(elapsed, 1e-9),
        wavefront_iterations=iterations,
        dispatch=dispatch,
    )
    return image, info


def render(scene: PreparedScene, profile: RenderProfile, progress=None):
    """Render all layers of a profile. Returns dict layer_name -> image,
    plus an info dict under '__info__'."""
    if profile.composition:
        raise NotImplementedError(
            "the composition stack is not in the PyTorch port yet "
            "(ROADMAP.md: queue 1, composition)"
        )
    layers, infos = {}, {}
    for ep in profile.evaluations:
        img, info = render_layer(scene, ep, profile.resolution, profile.seed, progress)
        layers[ep.layer_name] = img
        infos[ep.layer_name] = info
    layers["__info__"] = infos
    return layers
