"""PyTorch port: multi-GPU rendering (`parallel/`) on CPU meshes.

- The port against itself, bitwise: meshes of 1 and 8 shards (`["cpu"] *
  8`), the sharded "path" epoch against one wavefront call of one chain,
  `sample_active_sharded` over 1 and 8 shards and against
  `render._sample_active`, the TLAS `instanced_grid(side=2)` over 1 and 4
  shards, `render_frame_multihost` in one process and over two gloo
  processes.
- The port against the JAX package's `render_epoch_sharded` /
  `sample_active_sharded` on its 8 virtual CPU devices, both fed the same
  tables (`from_jax_arrays`) and the JAX side routed through its
  interpreted dense Pallas kernels, as tests/test_torch_path.py does:
  per-sample sums atol/rtol 2e-3, sums of squares atol 4e-2, mean images
  1e-5; the sharded albedo at tests/test_torch_evaluators.py's 1e-6.
- The counter, the unsharded renderer (atol 1e-5, as the JAX package's
  test), the seed, `replicate_scene` on the meta device, `make_mesh()`
  without CUDA, `initialize()` without a world, and the dry run.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echorenderer_tpu.evaluation import scene_ops as jscene_ops
from echorenderer_tpu.models import scenes as jscenes
from echorenderer_tpu.parallel import make_mesh as jmake_mesh
from echorenderer_tpu.parallel import render_epoch_sharded as jrender_epoch_sharded
from echorenderer_tpu.parallel import sample_active_sharded as jsample_active_sharded
from echorenderer_tpu.parallel import sharding as jsharding
from echorenderer_tpu.scene.prepare import prepare_scene as jprepare
from echorenderer_tpu_torch.evaluation.wavefront import sample_frame_wavefront
from echorenderer_tpu_torch.models import scenes
from echorenderer_tpu_torch.parallel import (
    make_mesh,
    multihost,
    render_epoch_sharded,
    render_frame_sharded,
    replicate_scene,
    sample_active_sharded,
    shard_pixels,
)
from echorenderer_tpu_torch.parallel.sharding import Mesh
from echorenderer_tpu_torch.processes import render as render_mod
from echorenderer_tpu_torch.processes.tiles import lane_order
from echorenderer_tpu_torch.scene.convert import from_jax_arrays
from echorenderer_tpu_torch.scene.prepare import prepare_scene

from test_torch_prepare import flatten_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RES = (32, 24)
N = RES[0] * RES[1]
KW = dict(bounce_limit=4)
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def cornell():
    return prepare_scene(scenes.cornell_box(), device="cpu")


@pytest.fixture(scope="module")
def epochs(cornell):
    """(sum, sum_sq, counter) of the 2-spp Cornell epoch over 1 and 8 shards."""
    return {k: render_epoch_sharded(make_mesh(devices=["cpu"] * k), cornell, RES, 0, 0, 2, **KW)
            for k in (1, 8)}


@pytest.fixture
def jax_pair(monkeypatch):
    """The JAX Cornell box and the port's copy of its tables; the JAX side
    routed through the interpreted dense Pallas kernels. The JAX package's
    sharded programs are cached by their arguments, not by the routing, so
    the caches are emptied before and after: no other test reuses a program
    traced here."""
    monkeypatch.setattr(jscene_ops, "_use_pallas", lambda scene: scene.prim_soa is not None)
    jsharding._sharded_epoch_fn.cache_clear()
    jsharding._sharded_active_fn.cache_clear()
    jscene = jprepare(jscenes.cornell_box())
    yield jscene, from_jax_arrays(flatten_jax(jscene), device="cpu")
    jsharding._sharded_epoch_fn.cache_clear()
    jsharding._sharded_active_fn.cache_clear()


def _active_lanes():
    rs = np.random.RandomState(7)
    ids = np.sort(rs.choice(N, size=101, replace=False)).astype(np.int64)
    return ids, rs.randint(0, 5, size=101).astype(np.int64)


# --- the port against itself, bitwise ---------------------------------------


def test_1_vs_8_shards_bitwise(epochs):
    (a, a2, _), (b, b2, _) = epochs[1], epochs[8]
    assert a.shape == (N, 3) and float(a.sum()) > 0
    assert torch.equal(a, b) and torch.equal(a2, b2)


def test_path_epoch_is_one_wavefront_call(cornell, epochs):
    """A shard runs one chain: the sharded epoch is one sample_frame_wavefront
    call over every lane in tile order, put back into scan order."""
    perm, inv = lane_order(RES)
    pid = torch.as_tensor(perm.astype(np.int64))
    pxy = torch.stack([pid % RES[0], pid // RES[0]], -1).to(torch.int32)
    s, s2 = sample_frame_wavefront(cornell, pid, pxy, RES, 0, 0, 2, **KW)
    inv = torch.as_tensor(inv.astype(np.int64))
    a, a2, _ = epochs[8]
    assert torch.equal(s[inv], a) and torch.equal(s2[inv], a2)


def test_active_epoch_shard_invariant_and_matches_single(cornell):
    ids, starts = _active_lanes()
    m = ids.shape[0]
    a1, q1 = sample_active_sharded(make_mesh(devices=["cpu"]), cornell, ids, starts, RES,
                                   seed=0, count=2, **KW)
    a8, q8 = sample_active_sharded(make_mesh(devices=CPU8), cornell, torch.as_tensor(ids),
                                   torch.as_tensor(starts), RES, seed=0, count=2, **KW)
    assert a1.shape[0] == 128 and a8.shape[0] == 8 * 128  # each shard lane-aligned
    assert torch.equal(a1[:m], a8[:m]) and torch.equal(q1[:m], q8[:m])
    s, sq = render_mod._sample_active(cornell, torch.as_tensor(ids), torch.as_tensor(starts),
                                      RES, 0, 2, 4, 2.5)
    assert torch.equal(a8[:m], s) and torch.equal(q8[:m], sq)
    # the padded lanes duplicate lane 0
    assert torch.equal(a8[m:], a8[:1].expand(8 * 128 - m, 3))


def test_tlas_scene_1_vs_4_shards_bitwise():
    scene = prepare_scene(scenes.instanced_grid(side=2), device="cpu", instancing="tlas")
    assert scene.instances is not None and scene.hier_soa.instanced
    res = (24, 16)
    a, a2, _ = render_epoch_sharded(make_mesh(devices=["cpu"]), scene, res, 3, 0, 1,
                                    bounce_limit=3)
    b, b2, _ = render_epoch_sharded(make_mesh(devices=["cpu"] * 4), scene, res, 3, 0, 1,
                                    bounce_limit=3)
    assert bool(torch.isfinite(a).all()) and float(a.sum()) > 0
    assert torch.equal(a, b) and torch.equal(a2, b2)


# --- the port against the JAX package's sharded programs --------------------


def test_path_epoch_matches_jax_sharded(jax_pair, epochs):
    jscene, tscene = jax_pair
    a, a2, na = jrender_epoch_sharded(jmake_mesh(8), jscene, RES, 0, 0, 2, **KW)
    b, b2, nb = render_epoch_sharded(make_mesh(devices=CPU8), tscene, RES, 0, 0, 2, **KW)
    a, a2, b, b2 = np.asarray(a), np.asarray(a2), b.numpy(), b2.numpy()
    assert a.sum() > 0 and float(np.asarray(na)[0]) == float(nb[0])
    np.testing.assert_allclose(b, a, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(b2, a2, atol=4e-2, rtol=2e-3)
    np.testing.assert_allclose(b.mean(0), a.mean(0), atol=1e-5, rtol=1e-5)
    # the converted tables render the port's own scene's bits
    assert torch.equal(torch.as_tensor(b), epochs[8][0])


def test_active_epoch_matches_jax_sharded(jax_pair):
    jscene, tscene = jax_pair
    ids, starts = _active_lanes()
    m = ids.shape[0]
    a, a2 = jsample_active_sharded(jmake_mesh(8), jscene, jnp.asarray(ids.astype(np.uint32)),
                                   jnp.asarray(starts.astype(np.uint32)), RES, seed=0, count=2,
                                   **KW)
    b, b2 = sample_active_sharded(make_mesh(devices=CPU8), tscene, ids, starts, RES, seed=0,
                                  count=2, **KW)
    a, a2 = np.asarray(a), np.asarray(a2)
    assert a.shape == tuple(b.shape)  # the same padded length
    b, b2 = b.numpy()[:m], b2.numpy()[:m]
    np.testing.assert_allclose(b, a[:m], atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(b2, a2[:m], atol=4e-2, rtol=2e-3)
    np.testing.assert_allclose(b.mean(0), a[:m].mean(0), atol=1e-5, rtol=1e-5)


def test_albedo_sharded_matches_jax(jax_pair):
    jscene, tscene = jax_pair
    a, a2, na = jrender_epoch_sharded(jmake_mesh(8), jscene, RES, 0, 0, 1, evaluator="albedo")
    b, b2, nb = render_epoch_sharded(make_mesh(devices=CPU8), tscene, RES, 0, 0, 1,
                                     evaluator="albedo")
    assert float(np.asarray(na)[0]) == float(nb[0]) == float(N)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b2.numpy(), np.asarray(a2), rtol=1e-6, atol=1e-6)


# --- the counter, the unsharded renderer, the seed, the other evaluators ----


def test_counter_counts_padded_lanes(cornell):
    _, _, n = render_epoch_sharded(make_mesh(devices=["cpu"] * 7), cornell, RES, 0, 0, 2, **KW)
    padded = shard_pixels(N, 7) * 7
    assert padded > N and float(n[0]) == padded * 2


def test_matches_single_chip_renderer(cornell, epochs):
    b, _ = render_mod._sample_frame(cornell, "path", RES, 0, 0, 2, 4, 2.5)
    np.testing.assert_allclose(epochs[8][0].numpy(), b.numpy(), atol=1e-5)


def test_seed_changes_image(cornell, epochs):
    c, _, _ = render_epoch_sharded(make_mesh(devices=CPU8), cornell, RES, 7, 0, 2, **KW)
    assert float((epochs[8][0] - c).abs().max()) > 0.0


@pytest.mark.parametrize("evaluator", ["albedo", "normal_depth", "naive", "path_lockstep"])
def test_other_evaluators_shard_invariant(cornell, evaluator):
    """The AOV shard body over 1 and 8 shards; the deterministic AOVs are
    the unsharded `_sample_frame_aov` bitwise."""
    res = (16, 12)
    kw = dict(evaluator=evaluator, bounce_limit=3)
    a, a2, _ = render_epoch_sharded(make_mesh(devices=["cpu"]), cornell, res, 2, 0, 2, **kw)
    b, b2, _ = render_epoch_sharded(make_mesh(devices=CPU8), cornell, res, 2, 0, 2, **kw)
    assert bool(torch.isfinite(a).all()) and torch.equal(a, b) and torch.equal(a2, b2)
    if evaluator in ("albedo", "normal_depth"):
        s, s2 = render_mod._sample_frame(cornell, evaluator, res, 2, 0, 2, 3, 2.5)
        assert torch.equal(a, s) and torch.equal(a2, s2)


# --- structure ----------------------------------------------------------------


def _tensors(x, path="scene", seen=None):
    """(path, tensor) of every tensor reachable from x through NamedTuples,
    tuples, lists, dicts, dataclasses and object attributes."""
    seen = set() if seen is None else seen
    if id(x) in seen or isinstance(x, (str, bytes, int, float, bool, type(None), np.ndarray)):
        return
    seen.add(id(x))
    if isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for name, v in zip(x._fields, x):
            yield from _tensors(v, f"{path}.{name}", seen)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _tensors(v, f"{path}[{i}]", seen)
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _tensors(v, f"{path}[{k!r}]", seen)
    elif hasattr(x, "__dict__"):
        for k, v in vars(x).items():
            yield from _tensors(v, f"{path}.{k}", seen)


@pytest.mark.parametrize("name", ["cornell_box", "instanced_grid", "hdr_environment",
                                  "many_lights"])
def test_replicate_scene_moves_every_tensor(name):
    kw = dict(instancing="tlas") if name == "instanced_grid" else {}
    maker = {"instanced_grid": lambda: scenes.instanced_grid(side=2),
             "many_lights": lambda: scenes.many_lights(96)}.get(name, getattr(scenes, name))
    scene = prepare_scene(maker(), device="cpu", **kw)
    before = list(_tensors(scene))
    assert replicate_scene(scene, "cpu") is scene
    meta = replicate_scene(scene, "meta")
    after = list(_tensors(meta))
    assert [p for p, _ in after] == [p for p, _ in before]
    assert [p for p, t in after if t.device.type != "meta"] == []
    assert all(t.shape == u.shape and t.dtype == u.dtype
               for (_, t), (_, u) in zip(after, before))
    assert meta.device.type == "meta" and type(meta) is type(scene)


def test_make_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.make_global_mesh()
    mesh = make_mesh(4, devices=CPU8)
    assert mesh == Mesh((torch.device("cpu"),) * 4) and mesh.size == 4


# --- multihost ------------------------------------------------------------------

MULTIHOST_RES = (16, 12)
MULTIHOST_KW = dict(spp=2, seed=3, bounce_limit=3)


def test_degenerate_initialize_and_frame(monkeypatch, cornell):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    mesh = multihost.make_global_mesh(devices=["cpu"] * 2)
    assert multihost.process_shard_info(mesh) == (0, 1, 2)
    img_mh = multihost.render_frame_multihost(mesh, cornell, MULTIHOST_RES, **MULTIHOST_KW)
    img_sh = render_frame_sharded(make_mesh(devices=["cpu"] * 2), cornell, MULTIHOST_RES,
                                  **MULTIHOST_KW)
    assert img_mh.shape == (12, 16, 3)
    np.testing.assert_array_equal(img_mh, img_sh)


RANK_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from echorenderer_tpu_torch.models import scenes
    from echorenderer_tpu_torch.parallel import multihost
    from echorenderer_tpu_torch.scene.prepare import prepare_scene
    store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    assert multihost.initialize(f"file://{store}", world_size=2, rank=rank, backend="gloo",
                                timeout_s=100)
    mesh = multihost.make_global_mesh(devices=["cpu"])
    assert multihost.process_shard_info(mesh) == (rank, 2, 1)
    scene = prepare_scene(scenes.cornell_box(), device="cpu")
    img = multihost.render_frame_multihost(mesh, scene, (16, 12), spp=2, seed=3, bounce_limit=3)
    np.save(out, img)
    torch.distributed.destroy_process_group()
""")


def test_two_process_gloo_frame_bitwise(tmp_path, cornell):
    """Two ranks on the CPU over a file store: each renders its half of the
    padded lanes, and both get the one-process two-shard frame."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    outs = [tmp_path / f"rank{r}.npy" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", RANK_SCRIPT, str(tmp_path / "store"),
                               str(r), str(outs[r])], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a rank did not finish within 120 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    want = render_frame_sharded(make_mesh(devices=["cpu"] * 2), cornell, MULTIHOST_RES,
                                **MULTIHOST_KW)
    for out in outs:
        np.testing.assert_array_equal(np.load(out), want)


def test_dryrun_multichip_cpu():
    from echorenderer_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(8, device="cpu")

