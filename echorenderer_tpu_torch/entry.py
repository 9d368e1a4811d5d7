"""Entry point of the PyTorch port: one 8-sample path-traced evaluation
epoch over a 128x128 pixel grid of the Cornell box (bounce limit 16,
survivability 2.5), the counterpart of `__graft_entry__.entry()`.

    from echorenderer_tpu_torch.entry import entry
    fn, args = entry("cuda")
    s_sum, s_sq = fn(*args)

`dryrun_multichip(n)` runs the multi-GPU paths (parallel/) over an n-shard
mesh: a sharded epoch, a TLAS scene, an adaptive epoch and a checkpoint
resume, on tiny shapes.
"""

from __future__ import annotations

RESOLUTION = (128, 128)
SAMPLES = 8
BOUNCE_LIMIT = 16
SURVIVABILITY = 2.5


def entry(device="cuda"):
    """Returns (fn, example_args): fn(scene, sample_start) renders one
    epoch and returns per-pixel (sum, sum_sq), each (128*128, 3)."""
    from .models import scenes
    from .processes.render import _sample_frame
    from .scene.prepare import prepare_scene

    scene = prepare_scene(scenes.cornell_box(), device=device)

    def fn(scene, sample_start):
        return _sample_frame(
            scene, "path", RESOLUTION, 0, sample_start, SAMPLES, BOUNCE_LIMIT, SURVIVABILITY
        )

    return fn, (scene, 0)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The multi-GPU paths over an n-shard mesh on tiny shapes (the
    counterpart of `__graft_entry__.dryrun_multichip`):

    1. a path-traced epoch of the Cornell box, pixels over the shards, and
       its sample counter;
    2. the same on the TLAS scene `instanced_grid(side=2)`, its instancing
       pinned to "tlas";
    3. one adaptive epoch of the noisiest half of the pixels, each
       continuing its own stream;
    4. a checkpoint saved and loaded, and that epoch again on the resumed
       accumulator: bitwise the straight-through accumulator.

    `device="cuda"` shards over the visible cards, repeating them (and
    saying so) when there are fewer than `n_devices`; `device="cpu"` over
    n CPU shards."""
    import tempfile

    import torch

    from .models import scenes
    from .parallel import make_mesh, render_epoch_sharded, sample_active_sharded
    from .processes import checkpoint as ckpt
    from .scene.prepare import prepare_scene
    from .utils import accumulator as acc_mod

    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device (pass device='cpu' for the CPU)")
        cards = torch.cuda.device_count()
        devices = [torch.device("cuda", i % cards) for i in range(n_devices)]
        if cards < n_devices:
            print(f"dryrun_multichip: {cards} card(s) for {n_devices} shards; the mesh repeats "
                  f"them: {[str(d) for d in devices]}")
    else:
        devices = [torch.device(device)] * n_devices
    mesh = make_mesh(devices=devices)
    first = mesh.devices[0]
    scene = prepare_scene(scenes.cornell_box(), device=first)
    resolution = (32, 16)  # tiny shapes: 512 pixels over n shards
    n = resolution[0] * resolution[1]
    s_sum, s_sq, n_samples = render_epoch_sharded(
        mesh, scene, resolution, seed=0, sample_start=0, count=2, evaluator="path",
        bounce_limit=4)
    _check(s_sum.shape == (n, 3) and bool(torch.isfinite(s_sum).all()),
           "the sharded epoch is misshapen or not finite")
    padded = -(-n // mesh.size) * mesh.size
    _check(float(n_samples[0]) == padded * 2, "the sample counter missed padded lanes")

    # --- the TLAS scene through the instanced walk under the mesh
    inst_scene = prepare_scene(scenes.instanced_grid(side=2), device=first, instancing="tlas")
    _check(inst_scene.instances is not None and inst_scene.hier_soa.instanced,
           "instanced_grid must prepare to a TLAS-instanced scene")
    i_sum, _, i_n = render_epoch_sharded(
        mesh, inst_scene, resolution, seed=0, sample_start=0, count=1, evaluator="path",
        bounce_limit=3)
    _check(bool(torch.isfinite(i_sum).all()) and float(i_n[0]) > 0,
           "the TLAS epoch is not finite or counted no sample")

    # --- one adaptive epoch: the noisiest half of the pixels, per-pixel starts
    acc = acc_mod.create((n,), channels=3, device=first)
    acc = acc_mod.add_many(acc, s_sum, s_sq, torch.full((n, 1), 2.0, device=first))
    active = torch.argsort(-acc_mod.max_noise(acc), stable=True)[: n // 2]
    starts = torch.full((active.shape[0],), 2, dtype=torch.int64, device=first)
    a_sum, a_sq = sample_active_sharded(mesh, scene, active, starts, resolution, seed=0, count=2,
                                        bounce_limit=4)
    m = active.shape[0]
    _check(a_sum.shape[0] >= m and bool(torch.isfinite(a_sum).all()),
           "the adaptive epoch is misshapen or not finite")

    # --- checkpoint + resume under the mesh: bitwise the straight-through run
    def merge(a, s, q):
        zeros = lambda c: torch.zeros((n, c), dtype=torch.float32, device=first)
        return acc_mod.add_many(a, zeros(3).index_add_(0, active, s[:m]),
                                zeros(3).index_add_(0, active, q[:m]),
                                zeros(1).index_fill_(0, active, 2.0))

    straight = merge(acc, a_sum, a_sq)
    with tempfile.TemporaryDirectory() as td:
        path = td + "/ck.npz"
        ckpt.save_checkpoint(path, acc, epoch=1, resolution=resolution)
        acc2, meta = ckpt.load_checkpoint(path, device=first)
        _check(meta["epoch"] == 1, "the checkpoint lost its epoch")
        r_sum, r_sq = sample_active_sharded(mesh, scene, active, starts, resolution, seed=0,
                                            count=2, bounce_limit=4)
        resumed = merge(acc2, r_sum, r_sq)
    _check(all(torch.equal(x, y) for x, y in zip(resumed, straight)),
           "sharded checkpoint-resume diverged bitwise")


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")
