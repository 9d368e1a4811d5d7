"""Wavefront path tracing with path regeneration (counterpart of
echorenderer_tpu/evaluation/wavefront.py).

Each lane owns one pixel and runs a continuous stream of paths: when a
lane's path ends it banks the sample into its (sum, sum²) and respawns the
next sample's camera ray in the same iteration, so every trace/shade wave
runs near full width until the tail. Draws are a pure function of (seed,
pixel, sample, dim), so regeneration reorders evaluation, not the sample
streams; all physics is `integrators.path_step`.
"""

from __future__ import annotations

import torch

from ..scene.cameras import spawn_rays
from ..scene.prepare import PreparedScene
from ..utils.rng import SampleStream, as_u32
from .integrators import path_step

STAT_NAMES = (
    "Ray/Traced", "Ray/Shadow", "Sample/Completed",
    "Sample/Rejected", "Bounce/Created", "Path/RRKilled",
)


def sample_frame_wavefront(
    scene: PreparedScene,
    pixel_id,  # (N,) absolute pixel ids (stable across devices)
    pixel_xy,  # (N, 2) int
    resolution,
    seed,
    sample_start,  # scalar or (N,) first sample index per lane
    count: int,
    *,
    bounce_limit: int = 128,
    survivability: float = 2.5,
    return_stats: bool = False,
):
    """Accumulate `count` path samples per pixel lane. Returns (sum, sum_sq)
    of shape (N, 3); with return_stats also a dict of event counters and
    the iteration count."""
    dev = scene.device
    n = pixel_id.shape[0]
    f3 = lambda: torch.zeros((n, 3), dtype=torch.float32, device=dev)
    pid = as_u32(pixel_id, dev)
    pxy = pixel_xy.to(dev)
    s0 = as_u32(sample_start, dev).expand(n)
    seed_t = as_u32(seed, dev)

    def stream_lanes(sample_id):
        return SampleStream(pixel_id=pid, sample_id=(s0 + sample_id) & 0xFFFFFFFF, seed=seed_t)

    def spawn(sample_id):
        s = stream_lanes(sample_id)
        return spawn_rays(scene.camera, pxy, s.next_2d(0), s.next_2d(1), resolution)

    sample = torch.zeros(n, dtype=torch.int64, device=dev)  # current sample per lane
    o, d = spawn(sample)
    st = dict(
        radiance=f3(),
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        o=o,
        d=d,
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        prev_pdf=torch.zeros(n, dtype=torch.float32, device=dev),
        prev_specular=torch.ones(n, dtype=torch.bool, device=dev),  # camera rays: specular
        prev_point=o,
        ignore=torch.full((n,), -1, dtype=torch.int32, device=dev),
    )
    s_sum, s_sq = f3(), f3()
    lane_done = torch.zeros(n, dtype=torch.bool, device=dev)
    counters = torch.zeros(6, dtype=torch.float32, device=dev)
    iters = 0

    while bool((~lane_done).any()):
        live = ~lane_done
        out = path_step(
            scene, stream_lanes(sample), st, live,
            bounce_limit=bounce_limit, survivability=survivability,
        )
        radiance = out["radiance"]
        aux = out["aux"]

        # --- regeneration: finished paths bank the sample and respawn ---
        path_done = live & ~out["continues"]
        finite = torch.isfinite(torch.sum(radiance, dim=-1))  # reject non-finite
        bank = path_done & finite
        s_sum = s_sum + torch.where(bank[..., None], radiance, 0.0)
        s_sq = s_sq + torch.where(bank[..., None], radiance * radiance, 0.0)
        sample = sample + path_done.to(torch.int64)
        lane_done = lane_done | (path_done & (sample >= count))
        respawn = path_done & ~lane_done

        cam_o, cam_d = spawn(sample)
        r3 = respawn[..., None]
        st = dict(
            radiance=torch.where(r3, 0.0, radiance),
            throughput=torch.where(r3, 1.0, out["new_tp"]),
            o=torch.where(r3, cam_o, out["cont_o"]),
            d=torch.where(r3, cam_d, out["wi_world"]),
            depth=torch.where(respawn, 0, st["depth"] + 1),
            prev_pdf=torch.where(respawn, 0.0, out["bs_pdf"]),
            prev_specular=torch.where(respawn, True, out["bs_specular"]),
            prev_point=torch.where(r3, cam_o, out["contact_point"]),
            ignore=torch.where(respawn, -1, out["hit_prim"]).to(torch.int32),
        )
        iters += 1
        counters = counters + torch.stack([
            live.sum(),  # Ray/Traced
            aux["candidate"].sum(),  # Ray/Shadow
            bank.sum(),  # Sample/Completed
            (path_done & ~finite).sum(),  # Sample/Rejected
            aux["found"].sum(),  # Bounce/Created
            (aux["has_bounce"] & ~aux["survived"]).sum(),  # Path/RRKilled
        ]).to(torch.float32)

    if return_stats:
        stats = dict(zip(STAT_NAMES, counters.tolist()))
        stats["Loop/Iterations"] = iters
        return s_sum, s_sq, stats
    return s_sum, s_sq
