"""Wavefront path tracing with path regeneration (counterpart of
echorenderer_tpu/evaluation/wavefront.py).

Each lane owns one pixel and runs a continuous stream of paths: when a
lane's path ends it banks the sample into its (sum, sum²) and respawns the
next sample's camera ray in the same iteration, so every trace/shade wave
runs near full width until the tail. Draws are a pure function of (seed,
pixel, sample, dim), so regeneration reorders evaluation, not the sample
streams; all physics is `integrators.path_step`.

`sample_frame_wavefront` is the dispatch: a CUDA scene inside the
megakernel's envelope, rendered without stats, goes to the fused kernel
(ops/megakernel.py), which computes the same draws and physics in one
launch, and under ECHO_MEGA_HIER a larger one inside the chunk-tree
form's envelope to that form (`scene_ops._use_mega_hier`); every other
frame runs the wavefront loop, `run_wavefront`, which narrows its waves as
lanes finish their samples (the liveness cascade).
"""

from __future__ import annotations

import torch

from ..ops import megakernel
from ..scene.cameras import spawn_rays
from ..scene.prepare import PreparedScene
from ..utils import vec
from ..utils.rng import SampleStream, as_u32
from .integrators import path_step
from .scene_ops import dispatch_summary

# lane count from which the liveness cascade engages, and the narrowest
# stage width (`run_wavefront`)
WAVE_CASCADE_MIN = 2 ** 18
WAVE_CASCADE_FLOOR = 8192

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
    the iteration count (the wavefront's own, so such a frame never takes
    the megakernel)."""
    integrator = dispatch_summary(scene, return_stats)["integrator"]
    if integrator in ("megakernel", "megakernel-hier"):
        return megakernel.sample_frame_mega(
            scene, pixel_id, pixel_xy, resolution, seed, sample_start, count,
            bounce_limit=bounce_limit, survivability=survivability,
            hier=integrator == "megakernel-hier",
        )
    return run_wavefront(scene, pixel_id, pixel_xy, resolution, seed, sample_start, count,
                         bounce_limit=bounce_limit, survivability=survivability,
                         return_stats=return_stats)


def cascade_widths(n: int) -> list[int]:
    """Stage widths of the liveness cascade for n lanes (the JAX package's
    schedule): each a quarter of the last, rounded up to 1024 lanes, down
    to max(WAVE_CASCADE_FLOOR, n / 64); none below WAVE_CASCADE_MIN lanes."""
    widths: list[int] = []
    if n < WAVE_CASCADE_MIN:
        return widths
    w = n
    while True:
        w = -(-(w // 4) // 1024) * 1024
        if w < max(WAVE_CASCADE_FLOOR, n // 64) or (widths and w >= widths[-1]) or w >= n:
            return widths
        widths.append(w)


def run_wavefront(
    scene: PreparedScene,
    pixel_id,
    pixel_xy,
    resolution,
    seed,
    sample_start,
    count: int,
    *,
    bounce_limit: int = 128,
    survivability: float = 2.5,
    return_stats: bool = False,
):
    """The regenerating wavefront loop over `path_step`, on the scene's
    device (the plain version the megakernel is held to).

    Liveness cascade: as lanes finish their samples, the live ones thin out
    while every iteration still pays for the full width. From
    WAVE_CASCADE_MIN lanes on, once the live count falls to a stage width
    (`cascade_widths`), the lanes are compacted by a stable argsort of
    their done flags, live lanes first, and the loop goes on at that width;
    the stage's results are scattered back at its end. A lane keeps its
    pixel and sample identity, and every draw keys on (pixel, sample, dim),
    so its sums are bitwise the same; the counters and the iteration count
    carry across stages."""
    dev = scene.device
    n = pixel_id.shape[0]
    seed_t = as_u32(seed, dev)

    def stream_lanes(ln, sample_id):
        return SampleStream(pixel_id=ln["pid"], sample_id=(ln["s0"] + sample_id) & 0xFFFFFFFF,
                            seed=seed_t)

    def spawn(ln, sample_id):
        s = stream_lanes(ln, sample_id)
        return spawn_rays(scene.camera, ln["pxy"], s.next_2d(0), s.next_2d(1), resolution)

    f3 = lambda: torch.zeros((n, 3), dtype=torch.float32, device=dev)
    lane = dict(  # every per-lane tensor of the loop, indexed by lane
        pid=as_u32(pixel_id, dev),
        pxy=pixel_xy.to(dev),
        s0=as_u32(sample_start, dev).expand(n).contiguous(),
        sample=torch.zeros(n, dtype=torch.int64, device=dev),  # current sample per lane
        lane_done=torch.zeros(n, dtype=torch.bool, device=dev),
        s_sum=f3(),
        s_sq=f3(),
    )
    o, d = spawn(lane, lane["sample"])
    lane.update(
        radiance=f3(),
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        o=o,
        d=d,
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        prev_pdf=torch.zeros(n, dtype=torch.float32, device=dev),
        prev_specular=torch.ones(n, dtype=torch.bool, device=dev),  # camera rays: specular
        prev_point=o,
        ignore=torch.full((n,), -1, dtype=torch.int32, device=dev),
        ignore_inst=torch.zeros(n, dtype=torch.int32, device=dev),
    )
    counters = torch.zeros(6, dtype=torch.int64, device=dev)  # exact past 2^24 events
    iters = 0

    def step(ln, coherent=False):
        nonlocal counters, iters
        live = ~ln["lane_done"]
        out = path_step(
            scene, stream_lanes(ln, ln["sample"]), ln, live,
            bounce_limit=bounce_limit, survivability=survivability, coherent=coherent,
        )
        radiance = out["radiance"]
        aux = out["aux"]

        # --- regeneration: finished paths bank the sample and respawn ---
        path_done = live & ~out["continues"]
        finite = torch.isfinite(vec.component_sum(radiance))  # reject non-finite
        bank = path_done & finite
        sample = ln["sample"] + path_done.to(torch.int64)
        lane_done = ln["lane_done"] | (path_done & (sample >= count))
        respawn = path_done & ~lane_done

        cam_o, cam_d = spawn(ln, sample)
        r3 = respawn[..., None]
        iters += 1
        counters = counters + torch.stack([
            live.sum(),  # Ray/Traced
            aux["candidate"].sum(),  # Ray/Shadow
            bank.sum(),  # Sample/Completed
            (path_done & ~finite).sum(),  # Sample/Rejected
            aux["found"].sum(),  # Bounce/Created
            (aux["has_bounce"] & ~aux["survived"]).sum(),  # Path/RRKilled
        ])
        return dict(
            pid=ln["pid"],
            pxy=ln["pxy"],
            s0=ln["s0"],
            sample=sample,
            lane_done=lane_done,
            s_sum=ln["s_sum"] + torch.where(bank[..., None], radiance, 0.0),
            s_sq=ln["s_sq"] + torch.where(bank[..., None], radiance * radiance, 0.0),
            radiance=torch.where(r3, 0.0, radiance),
            throughput=torch.where(r3, 1.0, out["new_tp"]),
            o=torch.where(r3, cam_o, out["cont_o"]),
            d=torch.where(r3, cam_d, out["wi_world"]),
            depth=torch.where(respawn, 0, ln["depth"] + 1),
            prev_pdf=torch.where(respawn, 0.0, out["bs_pdf"]),
            prev_specular=torch.where(respawn, True, out["bs_specular"]),
            prev_point=torch.where(r3, cam_o, out["contact_point"]),
            ignore=torch.where(respawn, -1, out["hit_prim"]).to(torch.int32),
            ignore_inst=torch.where(respawn, 0, out["hit_inst"]).to(torch.int32),
        )

    def run_until(ln, floor):
        """Step until at most `floor` lanes are live."""
        while int((~ln["lane_done"]).sum()) > floor:
            ln = step(ln)
        return ln

    # iteration 0 is peeled: every lane holds its first camera ray, in
    # tile-major order, so its trace and shadow waves are marked coherent
    # (the chunk-tree walk on a large scene, `scene_ops.trace`); the loop,
    # the counters and the cascade carry on from it
    if count >= 1:
        lane = step(lane, coherent=True)
    widths = cascade_widths(n)
    lane = run_until(lane, widths[0] if widths else 0)
    for i, width in enumerate(widths):
        take = torch.argsort(lane["lane_done"].to(torch.uint8), stable=True)[:width]
        sub = run_until({k: v[take] for k, v in lane.items()},
                        widths[i + 1] if i + 1 < len(widths) else 0)
        # lanes left out were all done and keep their sums
        for k, v in sub.items():
            lane[k] = lane[k].index_copy(0, take, v)

    if return_stats:
        stats = dict(zip(STAT_NAMES, counters.tolist()))
        stats["Loop/Iterations"] = iters
        return lane["s_sum"], lane["s_sq"], stats
    return lane["s_sum"], lane["s_sq"]
