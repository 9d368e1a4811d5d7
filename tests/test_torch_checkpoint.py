"""PyTorch port: render checkpoints and resume.

- The .npz format is the JAX package's: a checkpoint written by either
  package loads in the other, arrays bitwise and metadata equal.
- The port's resumed render equals its uninterrupted one bitwise (the
  same `_sample_frame` calls on the same sample ids, merged in the same
  order); the JAX package's own test holds this to atol 1e-6.
- A JAX-written checkpoint resumed by the port gives the port's
  uninterrupted image to tests/test_torch_path.py's port-vs-JAX tolerance
  (atol/rtol 2e-3: the first epoch's sums come from the JAX package).
- Resuming a finished checkpoint runs nothing and rewrites nothing.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echorenderer_tpu.processes import checkpoint as jcp
from echorenderer_tpu.utils import accumulator as jacc
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.processes import checkpoint as tcp
from echorenderer_tpu_torch.processes.render import EvaluationProfile
from echorenderer_tpu_torch.scene.prepare import prepare_scene
from echorenderer_tpu_torch.utils import accumulator as tacc

torch.set_num_threads(1)

RES = (12, 8)


def _profile(epochs, **kw):
    return EvaluationProfile(evaluator="path", samples_per_epoch=4, min_epoch=epochs,
                             max_epoch=epochs, noise_threshold=0.0, bounce_limit=4, **kw)


@pytest.fixture(scope="module")
def cornell():
    return prepare_scene(tscenes.cornell_box(), device="cpu")


def _acc(seed=0):
    rs = np.random.RandomState(seed)
    acc = tacc.create((12,), channels=3)
    for _ in range(3):
        acc = tacc.add(acc, torch.as_tensor(rs.uniform(0, 2, (12, 3)).astype(np.float32)))
    return acc


def test_roundtrip(tmp_path):
    acc = _acc()
    p = tmp_path / "c.npz"
    tcp.save_checkpoint(p, acc, epoch=3, seed=9, resolution=(4, 3), extra={"note": "x"})
    back, meta = tcp.load_checkpoint(p, device="cpu")
    for a, b in zip(back, acc):
        assert torch.equal(a, b)
    assert meta == dict(version=tcp.FORMAT_VERSION, epoch=3, layer="main", seed=9,
                        resolution=[4, 3], note="x")


def test_port_checkpoint_loads_in_jax(tmp_path):
    acc = _acc(1)
    p = tmp_path / "port.npz"
    tcp.save_checkpoint(p, acc, epoch=5, layer="albedo", seed=2, resolution=(4, 3))
    back, meta = jcp.load_checkpoint(p)
    for a, b in zip(back, acc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert meta["epoch"] == 5 and meta["layer"] == "albedo" and meta["resolution"] == [4, 3]


def test_jax_checkpoint_loads_in_port(tmp_path):
    rs = np.random.RandomState(2)
    acc = jacc.create((12,), channels=4)
    for _ in range(2):
        acc = jacc.add(acc, jnp.asarray(rs.uniform(0, 2, (12, 4)).astype(np.float32)))
    p = tmp_path / "jax.npz"
    jcp.save_checkpoint(p, acc, epoch=2, seed=7, resolution=(4, 3))
    back, meta = tcp.load_checkpoint(p, device="cpu")
    for a, b in zip(back, acc):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert meta == dict(version=1, epoch=2, layer="main", seed=7, resolution=[4, 3])


def test_version_mismatch_raises(tmp_path):
    p = tmp_path / "v.npz"
    np.savez_compressed(p, mean=np.zeros((2, 3), np.float32), m2=np.zeros((2, 3), np.float32),
                        count=np.zeros((2, 1), np.float32), meta=json.dumps(dict(version=99)))
    with pytest.raises(ValueError, match="unsupported checkpoint version 99"):
        tcp.load_checkpoint(p)


def test_resume_equals_uninterrupted(tmp_path, cornell):
    """1 epoch, then resumed to 3, against 3 straight: bitwise."""
    cp = tmp_path / "resume.npz"
    img1, info1 = tcp.resume_render_layer(cornell, _profile(1), RES, cp)
    assert info1["epochs"] == 1 and info1["samples"] == 4 * 96
    img_resumed, info = tcp.resume_render_layer(cornell, _profile(3), RES, cp)
    assert info["epochs"] == 3 and info["samples"] == 3 * 4 * 96
    img_straight, _ = tcp.resume_render_layer(cornell, _profile(3), RES, tmp_path / "straight.npz")
    assert img_resumed.shape == (8, 12, 3) and img_resumed.mean() > 0
    np.testing.assert_array_equal(img_resumed, img_straight)
    assert not np.array_equal(img1, img_straight)


def test_resume_with_save_every_and_finished_checkpoint(tmp_path, cornell):
    cp = tmp_path / "every.npz"
    seen = []
    img, info = tcp.resume_render_layer(cornell, _profile(4), RES, cp, save_every=2,
                                        progress=lambda e, m, noise: seen.append(e))
    assert seen == [1, 2, 3, 4] and info["epochs"] == 4
    before = cp.read_bytes()
    # already finished: nothing runs, the epoch counter and the file stay
    again, info2 = tcp.resume_render_layer(cornell, _profile(4), RES, cp)
    assert info2["epochs"] == 4 and info2["samples"] == info["samples"]
    np.testing.assert_array_equal(again, img)
    assert cp.read_bytes() == before
    with pytest.raises(ValueError, match="resolution mismatch"):
        tcp.resume_render_layer(cornell, _profile(5), (6, 4), cp)


def test_resume_jax_checkpoint_in_port(tmp_path, cornell):
    """A first epoch rendered and saved by the JAX package, resumed by the
    port on the same scene, against the port's uninterrupted render."""
    from echorenderer_tpu.models import scenes as jscenes
    from echorenderer_tpu.processes.render import EvaluationProfile as JProfile
    from echorenderer_tpu.scene.prepare import prepare_scene as jprepare

    cp = tmp_path / "from_jax.npz"
    jprof = JProfile(evaluator="path", samples_per_epoch=4, min_epoch=1, max_epoch=1,
                     noise_threshold=0.0, bounce_limit=4)
    jcp.resume_render_layer(jprepare(jscenes.cornell_box()), jprof, RES, cp)
    img, info = tcp.resume_render_layer(cornell, _profile(2), RES, cp)
    assert info["epochs"] == 2
    straight, _ = tcp.resume_render_layer(cornell, _profile(2), RES, tmp_path / "port.npz")
    np.testing.assert_allclose(img, straight, atol=2e-3, rtol=2e-3)
