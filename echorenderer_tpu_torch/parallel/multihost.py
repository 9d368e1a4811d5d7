"""Multi-process rendering on `torch.distributed` (counterpart of
echorenderer_tpu/parallel/multihost.py), one process per card.

The pixel axis of parallel/sharding.py stretches over every process: after
`initialize`, `make_global_mesh` gives a mesh of world x local shards, of
which this process holds shards rank * local .. rank * local + local - 1 on
its own devices. Each process renders only those shards of the global
padded lane axis; the image is all-gathered in rank order and every
process gets the whole frame. The scene is replicated and every draw keys
on (seed, pixel, sample, dim), so the frame is bitwise the same for any
process count.

One process and no launcher (`WORLD_SIZE` unset or 1) is the degenerate
mode: `initialize()` does nothing and returns False, and the same code runs
undistributed. Under torchrun:

    torchrun --nproc-per-node=<cards> script.py   # script: initialize(), then
    mesh = make_global_mesh()                     # render_frame_multihost(mesh, ...)

The backend is the caller's: NCCL by default for a CUDA process, gloo for
a CPU one. Ranks that share one card take `backend="gloo"` (NCCL refuses
two ranks on one device); gloo gathers host copies. Nothing falls back
from one backend to another.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .sharding import Mesh, _local_epoch, _normal, _to_scan_order


def initialize(init_method=None, world_size: int | None = None, rank: int | None = None,
               backend: str | None = None, timeout_s: float = 300.0) -> bool:
    """Join the process group when a world larger than one is configured,
    from the arguments or torchrun's environment (WORLD_SIZE, RANK,
    MASTER_ADDR and MASTER_PORT); returns whether distributed mode is
    active. `init_method` is a URL (`tcp://host:port`, `file:///path`,
    `env://`) or a `torch.distributed.Store`. A no-op that returns False
    without such a world."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if init_method is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = "env://"
    if world_size in (None, 1):
        return False
    if init_method is None or rank is None:
        raise ValueError(f"a world of {world_size} processes needs init_method (or MASTER_ADDR "
                         f"and MASTER_PORT) and rank (or RANK)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    store = init_method if isinstance(init_method, dist.Store) else None
    dist.init_process_group(backend=backend, init_method=None if store else init_method,
                            store=store, world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return True


def make_global_mesh(devices=None) -> Mesh:
    """The pixel mesh over every process's devices. This process's devices
    are `devices`, else cuda:LOCAL_RANK in a process group or under a
    launcher, else every visible card (then it equals
    `sharding.make_mesh()`). Raises without CUDA unless `devices` is given."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_global_mesh: no CUDA device; name this process's devices")
        if world > 1 or "LOCAL_RANK" in os.environ:
            devices = [torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))]
        else:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(tuple(_normal(d) for d in devices), rank=rank, world=world)


def process_shard_info(mesh: Mesh) -> tuple[int, int, int]:
    """(rank, world size, devices of this process) of the mesh."""
    return mesh.rank, mesh.world, len(mesh.devices)


def _all_gather(local: torch.Tensor) -> torch.Tensor:
    """Every rank's `local` rows, in rank order: on the card under NCCL
    (`all_gather_into_tensor`), on host copies under any other backend."""
    world = dist.get_world_size()
    if dist.get_backend() == "nccl":
        out = torch.empty((world * local.shape[0],) + tuple(local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        with torch.cuda.device(local.device):
            dist.all_gather_into_tensor(out, local.contiguous())
        return out
    host = local.cpu()
    parts = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(parts, host)
    return torch.cat(parts)


def render_frame_multihost(
    mesh: Mesh,
    scene,
    resolution,
    *,
    spp: int = 16,
    seed: int = 0,
    evaluator: str = "path",
    bounce_limit: int = 128,
    survivability: float = 2.5,
) -> np.ndarray:
    """Render a frame over a (possibly multi-process) pixel mesh; every
    process gets the full (H, W, C) image, bitwise the one
    `sharding.render_frame_sharded` gives on one process over as many
    shards. In a process group the sums are all-gathered over it (the
    gather's milliseconds go to `render_frame_multihost.gather_ms`);
    without one this is `render_frame_sharded`."""
    width, height = resolution
    (s_sum, _), layout = _local_epoch(mesh, scene, resolution, seed, 0, spp, evaluator,
                                      bounce_limit, survivability)
    if dist.is_initialized():
        if mesh.world != dist.get_world_size() or mesh.rank != dist.get_rank():
            raise ValueError(f"mesh of rank {mesh.rank} in a world of {mesh.world}, process "
                             f"{dist.get_rank()} of {dist.get_world_size()}: take "
                             f"make_global_mesh()")
        t0 = time.perf_counter()
        s_sum = _all_gather(s_sum)
        if s_sum.device.type == "cuda":
            torch.cuda.synchronize(s_sum.device)
        render_frame_multihost.gather_ms = (time.perf_counter() - t0) * 1e3
    elif mesh.world > 1:
        raise ValueError("a mesh over several processes needs initialize() first")
    img = _to_scan_order(s_sum, layout).cpu().numpy() / float(spp)
    return img.reshape(height, width, -1)


render_frame_multihost.gather_ms = None
