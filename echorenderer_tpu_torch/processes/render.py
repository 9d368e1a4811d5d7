"""Render orchestration (counterpart of echorenderer_tpu/processes/render.py):
profiles, the frame samplers and the epoch loop with per-pixel Welford
accumulation and adaptive per-pixel epochs.

The "path" evaluator runs through the fused megakernel for CUDA scenes
inside its envelope (and, under ECHO_MEGA_HIER, larger ones inside its
chunk-tree form's), otherwise through the regenerating wavefront. The
other evaluators of `EVALUATORS` (the lockstep path tracer, the naive
one and the first-hit AOVs) run a sample at a time over every pixel in
scan order; the deterministic AOVs stop after one epoch.

Adaptive epochs (the "path" evaluator's default): after `min_epoch`
full-frame epochs, each epoch samples only the pixels whose own noise is
above the threshold, compacted into dense lanes in tile order, each
continuing its own sample stream, and merges their sums back by scatter.
An epoch costs one host read, the 2-float (active count, max noise) of
`_active_stats`. The JAX package pads the compacted lanes to a few
bucket sizes (`_bucket_size`) with masked copies of one pixel, to bound
its number of compiled programs; every draw keys on (seed, pixel, sample,
dim) and every lane's sums are its own, so the padding changes no sum,
and this port samples the active lanes alone.

`render` runs the layers, then the profile's composition stack
(processes/composition.py) on the scene's device: the layers are uploaded
once, composed and downloaded.

Progress (the CLI's console line and the live preview, terminal.py and
ui/preview.py): `progress(epoch, max_epoch, noise)` after each epoch, with
the keywords `layer=`, `samples=`, `image=` and `tile_batch=` that the
callback's signature names (`_Progress`). `tile_progress=K` renders a path
layer's first epoch as K spiral-ordered tile batches
(`_tiled_first_epoch`), a partial image after each; every pixel's sums
are bitwise those of the untiled epoch.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import time

import numpy as np
import torch

from ..evaluation import integrators
from ..scene.cameras import spawn_rays
from ..scene.prepare import PreparedScene
from ..utils import accumulator as acc_mod
from ..utils import diagnostics
from ..utils.rng import MASK32, SampleStream, as_u32

# lanes one wavefront may hold: chains multiply the lane count up to this
MAX_LANES = 4_194_304

EVALUATORS = {
    "path": integrators.path_trace,  # runs as the wavefront or the megakernel
    "path_lockstep": integrators.path_trace,  # lockstep A/B reference
    "naive": integrators.naive_trace,
    "albedo": integrators.albedo,
    "normal_depth": integrators.normal_depth,
    "aggregator_quality": integrators.aggregator_quality,
}

AOV_CHANNELS = {
    "path": 3, "path_lockstep": 3, "naive": 3,
    "albedo": 3, "normal_depth": 4, "aggregator_quality": 3,
}

# deterministic AOVs: one epoch is the image
ONE_EPOCH = ("albedo", "normal_depth", "aggregator_quality")


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
    camera_name: str | None = None
    seed: int = 0
    scene: object = None  # optional Scene (set by the .echo loader / CLI)


def standard_path_traced_profile(
    quality: float = 1.0,
    resolution: tuple = (960, 540),
    *,
    denoise: bool = True,
    watermark: bool = True,
) -> RenderProfile:
    """One-knob preset mirroring the reference StandardPathTracedProfile
    (StandardPathTracedProfile.cs:17-105): albedo + path + normal_depth
    evaluations, then denoise + postprocess composition. `quality` scales
    sample counts and adaptive epoch budget."""
    from .composition import AutoExposure, Bloom, LearnedDenoise, ToneMapper, Vignette, Watermark

    spe = max(8, int(32 * quality))
    max_epoch = max(2, int(12 * quality))
    evaluations = (
        EvaluationProfile(evaluator="albedo", layer_name="albedo"),
        EvaluationProfile(
            evaluator="path",
            layer_name="main",
            samples_per_epoch=spe,
            min_epoch=1,
            max_epoch=max_epoch,
            noise_threshold=0.045 / max(quality, 0.25),
        ),
        EvaluationProfile(evaluator="normal_depth", layer_name="normal_depth"),
    )
    stack = []
    if denoise:
        stack.append(LearnedDenoise())
    stack += [AutoExposure(), Bloom(), ToneMapper(curve="aces"), Vignette()]
    if watermark:
        stack.append(Watermark())
    return RenderProfile(
        resolution=tuple(resolution), evaluations=evaluations, composition=tuple(stack)
    )


def _sample_frame(scene: PreparedScene, evaluator: str, resolution, seed, sample_start,
                  count, bounce_limit, survivability, return_stats: bool = False):
    """Accumulate `count` samples for every pixel. Returns (sum, sum_sq) of
    shape (H*W, C) in scan order, C = AOV_CHANNELS[evaluator] (plus, for
    the "path" evaluator, the wavefront's stats dict when
    `return_stats`)."""
    if evaluator != "path":
        return _sample_frame_aov(scene, evaluator, resolution, seed, sample_start, count,
                                 bounce_limit, survivability)
    from .tiles import lane_order

    dev = scene.device
    n = resolution[0] * resolution[1]
    # tile-major lane order: each kernel block covers a compact pixel tile
    perm, inv = lane_order(resolution)
    pixel_id = torch.as_tensor(perm.astype(np.int64), device=dev)
    out = _sample_active(scene, pixel_id, int(sample_start) & MASK32, resolution, seed, count,
                         bounce_limit, survivability, return_stats=return_stats,
                         chains=_chains(scene, count, n, return_stats))
    inv_d = torch.as_tensor(inv.astype(np.int64), device=dev)
    if return_stats:
        return out[0][inv_d], out[1][inv_d], out[2]
    return out[0][inv_d], out[1][inv_d]  # back to scan (pixel-id) order


def _chains(scene: PreparedScene, count: int, n: int, return_stats: bool = False) -> int:
    """Independent sample chains per pixel in one wave of an n-pixel frame:
    wider waves, shorter regeneration tail; only the order of summation
    changes. The fused megakernel has no per-iteration cost to spread, and
    chains would only shorten each thread's run of samples: one chain when
    it takes the frame."""
    from ..evaluation.scene_ops import dispatch_summary

    if dispatch_summary(scene, return_stats)["integrator"] in ("megakernel", "megakernel-hier"):
        return 1
    for k in (4, 2):
        if count % k == 0 and n * k <= MAX_LANES:
            return k
    return 1


def _sample_frame_aov(scene: PreparedScene, evaluator: str, resolution, seed, sample_start,
                      count, bounce_limit, survivability):
    """Every other evaluator: a sample at a time over every pixel in scan
    order, each sample's camera ray from the stream's dims 0 and 1.
    The path tracers' non-finite values count as 0. path_lockstep's
    relative sample 0 takes the coherent dispatch, as the wavefront's
    peeled iteration 0 does."""
    if evaluator not in EVALUATORS:
        raise ValueError(f"unknown evaluator {evaluator!r}; one of {sorted(EVALUATORS)}")
    dev = scene.device
    width, height = resolution
    n = width * height
    channels = AOV_CHANNELS[evaluator]
    pixel_id = torch.arange(n, dtype=torch.int64, device=dev)
    pixel_xy = torch.stack([pixel_id % width, pixel_id // width], dim=-1).to(torch.int32)
    fn = EVALUATORS[evaluator]
    seed_t = as_u32(seed, dev)

    def one_sample(i, s_sum, s_sq, first=False):
        stream = SampleStream(pixel_id=pixel_id,
                              sample_id=as_u32((int(sample_start) + i) & MASK32, dev),
                              seed=seed_t)
        o, d = spawn_rays(scene.camera, pixel_xy, stream.next_2d(0), stream.next_2d(1),
                          resolution)
        if evaluator == "path_lockstep":
            value = fn(scene, stream, o, d, bounce_limit=bounce_limit,
                       survivability=survivability, first_wave_coherent=first)
        elif evaluator == "naive":
            value = fn(scene, stream, o, d, bounce_limit=bounce_limit)
        else:
            value = fn(scene, stream, o, d)
        if evaluator in ("path_lockstep", "naive"):
            value = torch.nan_to_num(value, nan=0.0, posinf=0.0, neginf=0.0)
        return s_sum + value, s_sq + value * value

    s_sum = torch.zeros((n, channels), dtype=torch.float32, device=dev)
    s_sq = torch.zeros_like(s_sum)
    start_i = 0
    if evaluator == "path_lockstep" and count >= 1:
        s_sum, s_sq = one_sample(0, s_sum, s_sq, first=True)
        start_i = 1
    for i in range(start_i, count):
        s_sum, s_sq = one_sample(i, s_sum, s_sq)
    return s_sum, s_sq


def _sample_active(scene: PreparedScene, ids, starts, resolution, seed, count: int,
                   bounce_limit, survivability, return_stats: bool = False, chains: int = 1):
    """`count` path samples for an arbitrary (compacted) set of pixel
    lanes `ids`, each continuing its own stream at its `starts` index
    (32-bit words; a tensor of one a lane, or an int for all), as `chains`
    independent runs of count // chains samples a lane in one wave, added
    chain by chain. Returns (sum, sum_sq), each (m, 3) in lane order (and
    the wavefront's stats when `return_stats`)."""
    from ..evaluation.wavefront import sample_frame_wavefront

    m = ids.shape[0]
    width = resolution[0]
    pixel_xy = torch.stack([ids % width, ids // width], dim=-1).to(torch.int32)
    if chains > 1:
        rep = lambda a: a.repeat((chains,) + (1,) * (a.dim() - 1))
        chain = torch.repeat_interleave(
            torch.arange(chains, dtype=torch.int64, device=ids.device) * (count // chains), m)
        starts = ((rep(starts) if torch.is_tensor(starts) else starts) + chain) & MASK32
        ids, pixel_xy = rep(ids), rep(pixel_xy)
    out = sample_frame_wavefront(
        scene, ids, pixel_xy, resolution, seed, starts, count // chains,
        bounce_limit=bounce_limit, survivability=survivability, return_stats=return_stats,
    )
    if chains == 1:
        return out
    # chain by chain, left to right: the same bits for any set of lanes
    parts = [t.reshape(chains, m, 3) for t in out[:2]]
    sums = []
    for part in parts:
        total = part[0]
        for c in range(1, chains):
            total = total + part[c]
        sums.append(total)
    return tuple(sums) + tuple(out[2:])


def _active_stats(acc: acc_mod.Accumulator, threshold: torch.Tensor) -> torch.Tensor:
    """[active-pixel count, max noise] as one 2-float tensor on the
    accumulator's device, so an adaptive epoch reads the host once."""
    noise_px = acc_mod.max_noise(acc)
    m = torch.sum(noise_px > threshold).to(torch.float32)
    return torch.stack([m, torch.max(noise_px)])


def _adaptive_step(scene: PreparedScene, acc: acc_mod.Accumulator, drawn, perm, threshold,
                   resolution, count: int, bounce_limit, survivability, seed, m: int,
                   return_stats: bool = False):
    """One adaptive epoch: the `m` pixels whose noise is above `threshold`,
    taken in lane (tile) order (`perm`), sample `count` more samples each
    from `drawn[pixel]` on, and their sums are scattered into zeros and
    merged. `m` is `_active_stats`' count on the same accumulator; the
    compaction is a stable sort of the inactive flags, so it reads nothing
    back. `drawn` is an (n,) int64 tensor of 32-bit words, the samples
    each pixel has drawn. Returns (acc, drawn), plus the wavefront's stats
    when `return_stats`."""
    n = perm.shape[0]
    dev = acc.mean.device
    active = acc_mod.max_noise(acc)[perm] > threshold  # lane (tile) order
    lanes = torch.argsort((~active).to(torch.uint8), stable=True)[:m]
    ids = perm[lanes]
    out = _sample_active(scene, ids, drawn[ids], resolution, seed, count, bounce_limit,
                         survivability, return_stats=return_stats)
    zeros = lambda c: torch.zeros((n, c), dtype=torch.float32, device=dev)
    full_sum = zeros(3).index_add_(0, ids, out[0])
    full_sq = zeros(3).index_add_(0, ids, out[1])
    k = zeros(1).index_fill_(0, ids, float(count))
    new_acc = acc_mod.add_many(acc, full_sum, full_sq, k)
    new_drawn = drawn.index_add(0, ids, torch.full_like(ids, count)) & MASK32
    if return_stats:
        return new_acc, new_drawn, out[2]
    return new_acc, new_drawn


def _adaptive_epochs(scene: PreparedScene, profile, resolution, seed, acc, drawn,
                     first_epoch: int, progress, total_samples: int, stats_on: bool,
                     log: list):
    """The per-pixel adaptive phase: epochs `first_epoch` .. max_epoch - 1,
    each one `_active_stats` read and one `_adaptive_step`, until no pixel
    is above the threshold; `progress` is the layer's `_Progress`. The
    schedule is a pure function of the accumulated state, and each pixel
    draws its own sample ids [drawn, drawn + count), so a (scene, seed,
    profile) always gives the same image. Appends one entry an epoch to `log` (epoch, active pixels,
    the time of its host read). Returns (acc, epochs_run, total_samples,
    wavefront iterations or None)."""
    from .tiles import lane_order

    dev = acc.mean.device
    perm, _ = lane_order(resolution)
    perm_d = torch.as_tensor(perm.astype(np.int64), device=dev)
    thr = torch.tensor(profile.noise_threshold, dtype=torch.float32, device=dev)
    spe = profile.samples_per_epoch
    epochs_run = first_epoch
    iterations = 0 if stats_on else None
    for epoch in range(first_epoch, profile.max_epoch):
        m_f, noise_max = _active_stats(acc, thr).tolist()
        m = int(m_f)
        if m == 0:
            break
        log.append(dict(epoch=epoch + 1, active=m, read_at=time.perf_counter()))
        out = _adaptive_step(scene, acc, drawn, perm_d, thr, tuple(resolution), spe,
                             profile.bounce_limit, profile.survivability, seed, m,
                             return_stats=stats_on)
        acc, drawn = out[0], out[1]
        if stats_on:
            iterations += out[2]["Loop/Iterations"]
        total_samples += spe * m
        epochs_run = epoch + 1
        progress(epoch + 1, profile.max_epoch, float(noise_max), total_samples, acc)
    return acc, epochs_run, total_samples, iterations


_PUBLISH_INTERVAL = float(os.environ.get("ECHO_PUBLISH_INTERVAL", "2.0"))
_PROGRESS_KEYS = ("layer", "samples", "image", "tile_batch")


class _ImageThrottle:
    """A progress image is the accumulator's mean read back to the host,
    which on the card waits for every queued epoch; so off the CPU images
    go out at most every ECHO_PUBLISH_INTERVAL seconds. On the CPU every
    epoch publishes."""

    def __init__(self, device):
        self.every_epoch = torch.device(device).type == "cpu"
        self._last = -1e30

    def ready(self) -> bool:
        if self.every_epoch:
            return True
        now = time.monotonic()
        if now - self._last >= _PUBLISH_INTERVAL:
            self._last = now
            return True
        return False


def _progress_keys(fn) -> frozenset:
    """The keywords of `_PROGRESS_KEYS` that a progress callback takes: all
    with **kwargs, else those its signature names (none: the three
    positional arguments alone)."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):  # no signature to read: three arguments
        return frozenset()
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params):
        return frozenset(_PROGRESS_KEYS)
    named = (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY)
    return frozenset(p.name for p in params if p.name in _PROGRESS_KEYS and p.kind in named)


class _Progress:
    """One layer's progress callback in the form it takes, decided once from
    its signature (`_progress_keys`): `fn(epoch, max_epoch, noise)` plus
    `layer=`, `samples=`, `image=` (the (H, W, C) mean, throttled, None
    between images) and `tile_batch=` (b, n_batches) as far as it names
    them. Tile-batch reports go only to a callback that takes `tile_batch`."""

    def __init__(self, fn, layer: str, shape, device):
        self.fn = fn
        self.keys = _progress_keys(fn) if fn is not None else frozenset()
        self.layer = layer
        self.shape = tuple(shape)
        self.throttle = _ImageThrottle(device)

    def __call__(self, epoch, max_epoch, noise, samples, acc, tile_batch=None, last=False):
        if self.fn is None or (tile_batch is not None and "tile_batch" not in self.keys):
            return
        kw = {}
        if "layer" in self.keys:
            kw["layer"] = self.layer
        if "samples" in self.keys:
            kw["samples"] = samples
        if "image" in self.keys:
            ready = self.throttle.ready() or last
            kw["image"] = acc.mean.reshape(self.shape).cpu().numpy() if ready else None
        if tile_batch is not None:
            kw["tile_batch"] = tile_batch
        self.fn(epoch, max_epoch, noise, **kw)


def _tiled_first_epoch(scene: PreparedScene, profile, resolution, seed, acc, progress,
                       n_batches: int, chains: int, stats_on: bool, tile_size: int = 32):
    """Epoch 0 of a path layer rendered as spiral-ordered tile batches, a
    partial image published after each (the reference ViewerUI's live tile
    fill-in, Areas/ViewerUI.EvaluationOperationMode.cs:19-50). Each pixel
    draws sample ids [0, spe) of its own stream in the untiled epoch's
    `chains`, so its sums are bitwise the untiled epoch's; only the
    schedule differs. Returns (acc, wavefront iterations or None)."""
    from .tiles import lane_order, spiral, tile_grid

    width, height = resolution
    n = width * height
    dev = acc.mean.device
    ntx, nty = tile_grid(resolution, tile_size)
    order = np.asarray(spiral(ntx, nty))  # (T, 2) tile xy in schedule order
    rank = np.empty(ntx * nty, np.int64)
    rank[order[:, 1] * ntx + order[:, 0]] = np.arange(len(order))
    ids_all = np.arange(n, dtype=np.int64)
    tile_of = (ids_all // width // tile_size) * ntx + (ids_all % width) // tile_size
    # lanes scheduled by spiral tile rank; tile-major within each tile
    perm, _ = lane_order(resolution, tile_size)
    perm = perm.astype(np.int64)
    sched = torch.as_tensor(perm[np.argsort(rank[tile_of[perm]], kind="stable")], device=dev)

    spe = profile.samples_per_epoch
    n_batches = max(1, min(n_batches, len(order)))
    bucket = -(-n // n_batches)
    iterations = 0 if stats_on else None
    zeros = lambda c: torch.zeros((n, c), dtype=torch.float32, device=dev)
    for b in range(n_batches):
        ids = sched[b * bucket:(b + 1) * bucket]
        if ids.shape[0] == 0:
            break
        sample_args = (scene, ids, 0, tuple(resolution), seed, spe, profile.bounce_limit,
                       profile.survivability)
        if b == 0 and diagnostics.device_checks_enabled():
            out = diagnostics.run_checked(_sample_active, *sample_args,
                                          return_stats=stats_on, chains=chains)
        else:
            out = _sample_active(*sample_args, return_stats=stats_on, chains=chains)
        if stats_on:
            iterations += out[2]["Loop/Iterations"]
        k = zeros(1).index_fill_(0, ids, float(spe))
        acc = acc_mod.add_many(acc, zeros(3).index_add_(0, ids, out[0]),
                               zeros(3).index_add_(0, ids, out[1]), k)
        progress(1, profile.max_epoch, float("inf"), spe * min((b + 1) * bucket, n), acc,
                 tile_batch=(b + 1, n_batches), last=b == n_batches - 1)
    return acc, iterations


def render_layer(scene: PreparedScene, profile: EvaluationProfile, resolution,
                 seed: int = 0, progress=None, tile_progress: int = 0):
    """Run the epoch loop for one layer: full-frame epochs, then, for an
    adaptive "path" layer, the adaptive phase. Returns (image (H, W, C)
    numpy, info dict with sample statistics; info["epoch_log"] lists each
    epoch's pixels sampled and seconds, host read to host read).
    `tile_progress=K` renders a path layer's first epoch as K spiral tile
    batches, reported to `progress` (`_Progress`); the image is bitwise
    the same."""
    from ..evaluation.scene_ops import dispatch_summary

    width, height = resolution
    n = width * height
    channels = AOV_CHANNELS[profile.evaluator]
    acc = acc_mod.create((n,), channels=channels, device=scene.device)
    total_samples = 0
    report = _Progress(progress, profile.layer_name, (height, width, channels), scene.device)
    dispatch = dispatch_summary(scene)
    # one log line per layer naming the integrator/accelerator path and why
    diagnostics.log_event(diagnostics.get_logger("render"), "dispatch",
                          layer=profile.layer_name, **dispatch)
    # the wavefront's counters cost nothing extra; asking for them on a
    # megakernel frame would bypass the kernel
    stats_on = profile.evaluator == "path" and dispatch["integrator"] == "wavefront"
    iterations = 0 if stats_on else None
    # per-pixel adaptive: min_epoch full-frame epochs (every pixel needs 2
    # samples for a noise estimate), then only still-noisy pixels continue
    adaptive = (
        profile.adaptive and profile.evaluator == "path"
        and profile.max_epoch > profile.min_epoch
    )
    full_epochs = profile.min_epoch if adaptive else profile.max_epoch
    tiled = bool(tile_progress) and profile.evaluator == "path"
    log: list = []
    start = time.perf_counter()

    epoch = -1
    for epoch in range(full_epochs):
        log.append(dict(epoch=epoch + 1, active=n, read_at=time.perf_counter()))
        if epoch == 0 and tiled:
            chains = _chains(scene, profile.samples_per_epoch, n, stats_on)
            acc, more = _tiled_first_epoch(scene, profile, tuple(resolution), seed, acc, report,
                                           tile_progress, chains, stats_on)
            if stats_on:
                iterations += more
        else:
            sample_args = (
                scene, profile.evaluator, tuple(resolution), seed,
                epoch * profile.samples_per_epoch, profile.samples_per_epoch,
                profile.bounce_limit, profile.survivability,
            )
            if epoch == 0 and diagnostics.device_checks_enabled():
                # debug runs (ECHO_DEBUG_DEVICE=1): the first epoch under
                # run_checked, so path_step's dchecks raise with their messages
                out = diagnostics.run_checked(_sample_frame, *sample_args,
                                              return_stats=stats_on)
            else:
                out = _sample_frame(*sample_args, return_stats=stats_on)
            if stats_on:
                iterations += out[2]["Loop/Iterations"]
            acc = acc_mod.add_many(acc, out[0], out[1], float(profile.samples_per_epoch))
        total_samples += profile.samples_per_epoch * n
        if profile.evaluator in ONE_EPOCH:
            break  # deterministic AOVs need one epoch

        noise = float(torch.max(acc_mod.max_noise(acc)))
        report(epoch + 1, profile.max_epoch, noise, total_samples, acc)
        if epoch + 1 >= profile.min_epoch and noise < profile.noise_threshold:
            break

    epochs_done = epoch + 1
    if adaptive:
        drawn = torch.full((n,), epochs_done * profile.samples_per_epoch, dtype=torch.int64,
                           device=scene.device) & MASK32
        acc, epochs_done, total_samples, more = _adaptive_epochs(
            scene, profile, tuple(resolution), seed, acc, drawn, epochs_done, report,
            total_samples, stats_on, log,
        )
        if stats_on:
            iterations += more

    image = acc.mean.reshape(height, width, channels).cpu().numpy()
    end = time.perf_counter()
    elapsed = end - start
    marks = [e.pop("read_at") for e in log] + [end]
    for e, t0, t1 in zip(log, marks, marks[1:]):
        e["seconds"] = t1 - t0
    info = dict(
        samples=total_samples,
        epochs=epochs_done,
        seconds=elapsed,
        samples_per_second=total_samples / max(elapsed, 1e-9),
        wavefront_iterations=iterations,
        dispatch=dispatch,
        epoch_log=log,
    )
    return image, info


def compose_on(device, layers: dict, operators) -> tuple[dict, dict]:
    """Run a composition stack on `device`: the (numpy) layers are uploaded
    once, composed there and downloaded. Returns (numpy layers, errors)."""
    from .composition import compose

    composed, errors = compose(layers, operators, device=device)
    return {k: v.cpu().numpy() for k, v in composed.items()}, errors


def render(scene: PreparedScene, profile: RenderProfile, progress=None,
           tile_progress: int = 0):
    """Render all layers of a profile, then run the composition stack on
    the scene's device. Returns dict layer_name -> image, plus an info
    dict under '__info__' (reference ScheduledRender: evaluations then
    CompositionOperation); an operator that failed is skipped and named in
    info["composition_errors"]. `progress` and `tile_progress` go to each
    layer's `render_layer`."""
    layers, infos = {}, {}
    for ep in profile.evaluations:
        img, info = render_layer(scene, ep, profile.resolution, profile.seed, progress,
                                 tile_progress=tile_progress)
        layers[ep.layer_name] = img
        infos[ep.layer_name] = info
    if profile.composition:
        layers, errors = compose_on(scene.device, layers, profile.composition)
        if errors:
            infos["composition_errors"] = errors
    layers["__info__"] = infos
    return layers
