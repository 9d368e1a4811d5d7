"""Multi-GPU rendering over a 1-D mesh of pixel shards (counterpart of
echorenderer_tpu/parallel/sharding.py).

Data parallelism over pixels: the padded lane axis of a frame is cut into
`mesh.size` contiguous shards along the axis "px", each shard renders on
its own device's replica of the prepared scene (`replicate_scene`: the
scene is read-only during evaluation), and the shards' sums are gathered
in shard order onto the mesh's first device. Only the scalar sample
counter is reduced.

Determinism: every random draw is a pure hash of (seed, absolute pixel id,
sample id, dimension) (utils/rng.py), and a shard runs one sample chain a
lane (`evaluation/wavefront.sample_frame_wavefront` straight on its lanes,
not `processes/render._sample_frame`, whose chain count follows the lane
count). So the image is bitwise the same for any shard count, and for any
process count (parallel/multihost.py).

A mesh may repeat a device (`make_mesh(devices=["cpu"] * 8)`, or
`["cuda:0"] * 4`): shards on one device run one after another. Shards on
different cards are enqueued card by card from this one host thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..evaluation.wavefront import sample_frame_wavefront
from ..processes.render import AOV_CHANNELS, EVALUATORS
from ..scene.cameras import spawn_rays
from ..scene.prepare import PreparedScene
from ..utils.rng import MASK32, SampleStream, as_u32

# a compacted adaptive shard's width is a multiple of this (the JAX
# package's lane alignment, kept so both give the same padded length)
ACTIVE_ALIGN = 128


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D pixel mesh: this process's `devices`, one a shard. Over several
    processes (parallel/multihost.make_global_mesh) the axis holds `world`
    times as many shards, and shard `rank * len(devices) + j` lives on
    `devices[j]`."""

    devices: tuple
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """Shards along the axis, over every process."""
        return self.world * len(self.devices)

    @property
    def first_shard(self) -> int:
        return self.rank * len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D pixel mesh. Without `devices`, the visible cards cuda:0 ..
    cuda:k-1 (the first `n_devices`); it raises where there is no CUDA
    device or fewer cards than `n_devices`. An explicit `devices` list may
    repeat a device or name the CPU."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; name the devices to shard over a CPU "
                               "mesh, e.g. make_mesh(devices=['cpu'] * 8)")
        count = torch.cuda.device_count()
        if n_devices is not None and n_devices > count:
            raise ValueError(f"make_mesh({n_devices}): {count} CUDA device(s) visible; name the "
                             f"devices to repeat one")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [_normal(d) for d in devices][:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(devices))


def shard_pixels(n_pixels: int, n_shards: int) -> int:
    """Padded per-shard pixel count (pixels are padded to a multiple of the
    shard count; padded lanes render pixel 0 and are discarded)."""
    return -(-n_pixels // n_shards)


def _normal(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _moved(x, device):
    """`x` with every tensor it holds, through NamedTuples, tuples, lists,
    dicts and dataclasses, on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_moved(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_moved(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _moved(v, device) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _moved(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x) if f.init})
    return x


def replicate_scene(scene: PreparedScene, device) -> PreparedScene:
    """The scene with every table on `device` (the JAX package's replicated
    scene); the same object when it is already there."""
    device = _normal(device)
    if scene.device == device:
        return scene
    return _moved(scene, device)


def _on(device):
    """The CUDA current-device context a shard's launches need."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class _Layout(NamedTuple):
    pixel_id: np.ndarray  # (padded,) int64 lane -> pixel id
    inv: np.ndarray | None  # (n,) pixel -> lane ("path"), or None (scan order)
    n: int
    per: int


def _layout(n_shards: int, resolution, evaluator: str) -> _Layout:
    """The JAX package's lane axis: for "path" the tile-major `perm` of
    `tiles.lane_order`, else scan order; padded with pixel 0 up to a
    multiple of the shard count."""
    width, height = resolution
    n = width * height
    per = shard_pixels(n, n_shards)
    padded = per * n_shards
    if evaluator == "path":
        from ..processes.tiles import lane_order

        perm, inv = lane_order(resolution)
        pixel_id = np.pad(perm.astype(np.int64), (0, padded - n))
        return _Layout(pixel_id, inv.astype(np.int64), n, per)
    pixel_id = np.arange(padded, dtype=np.int64)
    pixel_id[n:] = 0
    return _Layout(pixel_id, None, n, per)


def _sample_pixels(scene, pixel_id, seed, sample_start, count, resolution,
                   evaluator="path", bounce_limit=128, survivability=2.5):
    """`count` samples for one shard's lanes, on the scene's device: the
    JAX package's shard body. "path" is one wavefront (or megakernel) call
    of one chain; every other evaluator a sample at a time from the
    stream's dims 0 and 1, with the path tracers' non-finite values
    counted as 0 and no coherent first wave. `sample_start`: an int, or
    for "path" a tensor of one a lane."""
    width = resolution[0]
    pixel_xy = torch.stack([pixel_id % width, pixel_id // width], dim=-1).to(torch.int32)
    if evaluator == "path":
        return sample_frame_wavefront(scene, pixel_id, pixel_xy, resolution, seed, sample_start,
                                      count, bounce_limit=bounce_limit,
                                      survivability=survivability)
    if evaluator not in EVALUATORS:
        raise ValueError(f"unknown evaluator {evaluator!r}; one of {sorted(EVALUATORS)}")
    fn = EVALUATORS[evaluator]
    dev = scene.device
    seed_t = as_u32(seed, dev)
    s_sum = torch.zeros((pixel_id.shape[0], AOV_CHANNELS[evaluator]), dtype=torch.float32,
                        device=dev)
    s_sq = torch.zeros_like(s_sum)
    for i in range(count):
        stream = SampleStream(pixel_id=pixel_id,
                              sample_id=as_u32((int(sample_start) + i) & MASK32, dev),
                              seed=seed_t)
        o, d = spawn_rays(scene.camera, pixel_xy, stream.next_2d(0), stream.next_2d(1),
                          resolution)
        if evaluator == "path_lockstep":
            value = fn(scene, stream, o, d, bounce_limit=bounce_limit,
                       survivability=survivability)
        elif evaluator == "naive":
            value = fn(scene, stream, o, d, bounce_limit=bounce_limit)
        else:
            value = fn(scene, stream, o, d)
        if evaluator in ("path_lockstep", "naive"):
            value = torch.nan_to_num(value, nan=0.0, posinf=0.0, neginf=0.0)
        s_sum = s_sum + value
        s_sq = s_sq + value * value
    return s_sum, s_sq


def _render_shards(mesh: Mesh, scene, lanes: list, body) -> tuple:
    """Run `body(scene_replica, *lane_tensors)` for each of this process's
    shards (`lanes[j]`: its numpy lane arrays) on its device; returns the
    outputs concatenated in shard order on the mesh's first device."""
    replicas, outs = {}, []
    for dev, arrays in zip(mesh.devices, lanes):
        if dev not in replicas:
            replicas[dev] = replicate_scene(scene, dev)
        with _on(dev):
            args = [torch.as_tensor(a, device=dev) for a in arrays]
            outs.append(body(replicas[dev], *args))
    first = mesh.devices[0]
    return tuple(torch.cat([o[i].to(first) for o in outs]) for i in range(len(outs[0])))


def _local_epoch(mesh: Mesh, scene, resolution, seed, sample_start, count, evaluator,
                 bounce_limit, survivability):
    """This process's shards of one epoch: (sum, sum_sq), each
    (len(mesh.devices) * per, C) in lane order, and the global layout."""
    layout = _layout(mesh.size, tuple(resolution), evaluator)
    per = layout.per
    lanes = [(layout.pixel_id[g * per:(g + 1) * per],)
             for g in range(mesh.first_shard, mesh.first_shard + len(mesh.devices))]
    body = lambda rep, pid: _sample_pixels(
        rep, pid, seed, sample_start, count, tuple(resolution), evaluator=evaluator,
        bounce_limit=bounce_limit, survivability=survivability)
    return _render_shards(mesh, scene, lanes, body), layout


def _to_scan_order(lanes: torch.Tensor, layout: _Layout) -> torch.Tensor:
    """Gathered lanes (padded, C) -> (n, C) in scan (pixel-id) order."""
    if layout.inv is not None:
        return lanes[torch.as_tensor(layout.inv, device=lanes.device)]
    return lanes[:layout.n]


def render_epoch_sharded(
    mesh: Mesh,
    scene: PreparedScene,
    resolution,
    seed: int,
    sample_start: int,
    count: int,
    *,
    evaluator: str = "path",
    bounce_limit: int = 16,
    survivability: float = 2.5,
):
    """One sampling epoch distributed over the mesh. Returns (sum, sum_sq)
    of shape (H*W, C) in scan order on the mesh's first device, and the
    sample counter, a (1,) float32 tensor: every padded lane's samples."""
    if mesh.world > 1:
        raise ValueError("a mesh over several processes renders through "
                         "parallel.multihost.render_frame_multihost")
    (s_sum, s_sq), layout = _local_epoch(mesh, scene, resolution, seed, sample_start, count,
                                         evaluator, bounce_limit, survivability)
    n_samples = torch.tensor([float(layout.per * mesh.size * count)], dtype=torch.float32,
                             device=s_sum.device)
    return _to_scan_order(s_sum, layout), _to_scan_order(s_sq, layout), n_samples


def _lane_array(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def sample_active_sharded(
    mesh: Mesh,
    scene: PreparedScene,
    ids,
    starts,
    resolution,
    seed: int,
    count: int,
    *,
    bounce_limit: int = 16,
    survivability: float = 2.5,
):
    """One adaptive epoch over the mesh: a compacted set of pixel lanes
    (`ids`) each continuing its own stream at `starts` (the contract of
    processes.render._sample_active), sharded across devices. Each shard's
    width is rounded up to a multiple of 128; the padded lanes duplicate
    lane 0, and the returned (sum, sum_sq) keep the padded length for the
    caller to mask. Bitwise the single-device epoch's sums on the valid
    rows, for any shard count."""
    if mesh.world > 1:
        raise ValueError("sample_active_sharded runs on a one-process mesh")
    ids = _lane_array(ids)
    m = ids.shape[0]
    starts = np.broadcast_to(_lane_array(starts), (m,)) & MASK32
    per = -(-shard_pixels(m, mesh.size) // ACTIVE_ALIGN) * ACTIVE_ALIGN
    padded = per * mesh.size
    ids_p = np.concatenate([ids, np.broadcast_to(ids[:1], (padded - m,))])
    st_p = np.concatenate([starts, np.broadcast_to(starts[:1], (padded - m,))])
    lanes = [(ids_p[g * per:(g + 1) * per], st_p[g * per:(g + 1) * per])
             for g in range(mesh.size)]
    body = lambda rep, pid, st: _sample_pixels(
        rep, pid, seed, st, count, tuple(resolution), bounce_limit=bounce_limit,
        survivability=survivability)
    return _render_shards(mesh, scene, lanes, body)


def render_frame_sharded(
    mesh: Mesh,
    scene: PreparedScene,
    resolution,
    *,
    spp: int = 16,
    seed: int = 0,
    evaluator: str = "path",
    bounce_limit: int = 16,
    survivability: float = 2.5,
) -> np.ndarray:
    """Render a full frame at fixed spp over the mesh; returns (H, W, C)."""
    width, height = resolution
    s_sum, _, _ = render_epoch_sharded(
        mesh, scene, resolution, seed, 0, spp,
        evaluator=evaluator, bounce_limit=bounce_limit, survivability=survivability,
    )
    img = s_sum.cpu().numpy() / float(spp)
    return img.reshape(height, width, -1)
