"""Render checkpoint/resume (counterpart of
echorenderer_tpu/processes/checkpoint.py): accumulator-state snapshots.

The reference has no render-state checkpointing — only pause/resume of a
live operation and the lossless `.fpi` image format (SURVEY.md §5). A
render's whole mutable state is the per-pixel Welford accumulator (mean,
m2, count) plus the epoch counter, so snapshotting it makes renders
resumable across process restarts.

Format: a single .npz with the accumulator arrays + JSON metadata, the
JAX package's format, so a checkpoint written by either package loads in
the other. With the deterministic sample streams a resumed render
produces the SAME image as an uninterrupted one (continuation draws
sample_id where it left off)."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..utils import accumulator as acc_mod
from ..utils.accumulator import Accumulator

FORMAT_VERSION = 1


def save_checkpoint(path, acc: Accumulator, *, epoch: int, layer: str = "main",
                    seed: int = 0, resolution=None, extra: dict | None = None):
    """Snapshot an accumulator + loop position to `path` (.npz)."""
    meta = dict(
        version=FORMAT_VERSION,
        epoch=int(epoch),
        layer=layer,
        seed=int(seed),
        resolution=list(resolution) if resolution else None,
        **(extra or {}),
    )
    np.savez_compressed(
        Path(path),
        mean=acc.mean.cpu().numpy(),
        m2=acc.m2.cpu().numpy(),
        count=acc.count.cpu().numpy(),
        meta=json.dumps(meta),
    )


def load_checkpoint(path, device=None) -> tuple[Accumulator, dict]:
    """Load a snapshot -> (Accumulator on `device`, metadata dict)."""
    with np.load(Path(path), allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta.get('version')}")
        acc = Accumulator(
            mean=torch.as_tensor(z["mean"], device=device),
            m2=torch.as_tensor(z["m2"], device=device),
            count=torch.as_tensor(z["count"], device=device),
        )
    return acc, meta


def resume_render_layer(scene, profile, resolution, checkpoint_path, *,
                        seed: int = 0, progress=None, save_every: int = 0):
    """render_layer's full-frame epochs with persistence: resumes from
    `checkpoint_path` if it exists; optionally writes a snapshot every
    `save_every` epochs. Returns (image (H, W, C) numpy, info)."""
    from .render import AOV_CHANNELS, _sample_frame

    width, height = resolution
    n = width * height
    channels = AOV_CHANNELS[profile.evaluator]
    start_epoch = 0
    path = Path(checkpoint_path)
    if path.exists():
        acc, meta = load_checkpoint(path, device=scene.device)
        if meta.get("resolution") and tuple(meta["resolution"]) != tuple(resolution):
            raise ValueError("checkpoint resolution mismatch")
        start_epoch = meta["epoch"]
        seed = meta.get("seed", seed)
    else:
        acc = acc_mod.create((n,), channels=channels, device=scene.device)

    t0 = time.perf_counter()
    total = int(float(torch.sum(acc.count[..., 0])))
    epoch = start_epoch
    ran_epochs = False
    for epoch in range(start_epoch, profile.max_epoch):
        ran_epochs = True
        s_sum, s_sq = _sample_frame(
            scene, profile.evaluator, tuple(resolution), seed,
            epoch * profile.samples_per_epoch, profile.samples_per_epoch,
            profile.bounce_limit, profile.survivability,
        )
        acc = acc_mod.add_many(acc, s_sum, s_sq, float(profile.samples_per_epoch))
        total += profile.samples_per_epoch * n
        noise = float(torch.max(acc_mod.max_noise(acc)))
        if progress:
            progress(epoch + 1, profile.max_epoch, noise)
        if save_every and (epoch + 1) % save_every == 0:
            save_checkpoint(path, acc, epoch=epoch + 1, layer=profile.layer_name,
                            seed=seed, resolution=resolution)
        if epoch + 1 >= profile.min_epoch and noise < profile.noise_threshold:
            break

    # only persist when work actually ran: resuming an already-complete
    # checkpoint must not inflate the epoch counter (a phantom epoch would
    # silently skip its sample_id range if max_epoch is later raised,
    # breaking the resumed == uninterrupted determinism contract)
    epochs_done = epoch + 1 if ran_epochs else start_epoch
    if ran_epochs:
        save_checkpoint(path, acc, epoch=epochs_done, layer=profile.layer_name,
                        seed=seed, resolution=resolution)
    image = acc.mean.reshape(height, width, channels).cpu().numpy()
    info = dict(samples=total, epochs=epochs_done, seconds=time.perf_counter() - t0)
    return image, info
