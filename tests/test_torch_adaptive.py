"""PyTorch port: adaptive per-pixel epochs.

- One adaptive epoch (`_adaptive_step`) against the JAX package's, jitted,
  on the same prepared tables, accumulator, per-pixel draw counts and lane
  order: `drawn` bitwise (it wraps as a 32-bit word), the accumulator to
  tests/test_torch_path.py's port-vs-JAX tolerances (the sums' float
  reduction order is the only difference: atol/rtol 2e-3 on means, 4e-2
  on m2; the counts exactly).
- The whole adaptive `render_layer` against the JAX package's on the
  Cornell box at 64x32 (tests/test_adaptive.py's profile): equal epochs
  and samples, images to atol/rtol 2e-3.
- Determinism, and tests/test_adaptive.py's gate (fewer samples at the
  same quality) in the port.
- The JAX package pads the compacted lanes to `_bucket_size` with masked
  copies of one pixel; the port samples the active lanes alone. Padding
  them here gives the same accumulator bitwise.
- `render(scene, RenderProfile(...))` with the default profiles.
- On the card (`cuda`): an adaptive render through the megakernel equals
  the same render on the wavefront bitwise.
"""

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.evaluation import scene_ops as tso
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.ops import megakernel as tmk
from echorenderer_tpu_torch.processes import render as trender
from echorenderer_tpu_torch.processes.render import (
    EvaluationProfile,
    RenderProfile,
    render,
    render_layer,
)
from echorenderer_tpu_torch.processes.tiles import lane_order
from echorenderer_tpu_torch.scene.prepare import prepare_scene
from echorenderer_tpu_torch.utils import accumulator as acc_mod
from echorenderer_tpu_torch.utils import diagnostics

torch.set_num_threads(1)

RES = (64, 32)
THRESHOLD = 0.15
SPE = 8
MAX_EPOCH = 40


def _profile(adaptive, **kw):
    kw = dict(dict(evaluator="path", samples_per_epoch=SPE, min_epoch=2, max_epoch=MAX_EPOCH,
                   noise_threshold=THRESHOLD, bounce_limit=4), **kw)
    return EvaluationProfile(adaptive=adaptive, **kw)


def _jax_pair():
    """The JAX Cornell box and the port's scene on its tables (the JAX
    package is imported here: the card's machine has no jax)."""
    from echorenderer_tpu.models import scenes as jscenes
    from echorenderer_tpu.scene.prepare import prepare_scene as jprepare
    from echorenderer_tpu_torch.scene.convert import from_jax_arrays
    from test_torch_prepare import flatten_jax

    jscene = jprepare(jscenes.cornell_box())
    return jscene, from_jax_arrays(flatten_jax(jscene), device="cpu")


@pytest.fixture(scope="module")
def pair():
    return _jax_pair()


@pytest.fixture(scope="module")
def cornell():
    return prepare_scene(tscenes.cornell_box(), device="cpu")


def _bucket_size(m: int, n: int) -> int:
    """The JAX package's bucket: the smallest power-of-two division of n
    (down to 1024) that holds m lanes."""
    b = n
    while b % 2 == 0 and b // 2 >= max(m, 1024) and b > 1024:
        b //= 2
    return b


def _start_state(scene, res, seed=3):
    """An accumulator after two 4-sample epochs and per-pixel draw counts
    near the 32-bit wrap, some pixels converged (zeroed noise)."""
    n = res[0] * res[1]
    acc = acc_mod.create((n,), device="cpu")
    for e in range(2):
        s, q = trender._sample_frame(scene, "path", res, seed, 4 * e, 4, 4, 2.5)
        acc = acc_mod.add_many(acc, s, q, 4.0)
    rs = np.random.RandomState(1)
    done = torch.as_tensor(rs.rand(n) < 0.4)
    acc = acc_mod.Accumulator(mean=acc.mean, m2=torch.where(done[:, None], 0.0, acc.m2),
                              count=acc.count)
    drawn = np.where(rs.rand(n) < 0.5, 8, 2 ** 32 - 3 - rs.randint(0, 6, n)).astype(np.uint32)
    return acc, drawn


def test_adaptive_step_matches_jax(pair):
    import jax.numpy as jnp

    from echorenderer_tpu.processes import render as jrender
    from echorenderer_tpu.utils import accumulator as jacc

    jscene, tscene = pair
    res, count, seed = (32, 24), 4, 9
    n = res[0] * res[1]
    acc, drawn = _start_state(tscene, res)
    perm, _ = lane_order(res)
    thr = np.float32(0.2)
    m = int(trender._active_stats(acc, torch.tensor(thr))[0])
    assert 0 < m < n
    jacc_in = jacc.Accumulator(*(jnp.asarray(a.numpy()) for a in acc))
    ja, jd = jrender._adaptive_step(
        jscene, jacc_in, jnp.asarray(drawn), jnp.asarray(perm.astype(np.int32)),
        jnp.asarray(thr), res, count, 4, 2.5, seed, jrender._bucket_size(m, n))
    ta, td = trender._adaptive_step(
        tscene, acc, torch.as_tensor(drawn.astype(np.int64)),
        torch.as_tensor(perm.astype(np.int64)), torch.tensor(thr), res, count, 4, 2.5, seed, m)
    np.testing.assert_array_equal(td.numpy().astype(np.uint32), np.asarray(jd))
    assert int((td.numpy() < 3).sum()) > 0  # some pixels wrapped past 2^32
    np.testing.assert_array_equal(ta.count.numpy(), np.asarray(ja.count))
    np.testing.assert_allclose(ta.mean.numpy(), np.asarray(ja.mean), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(ta.m2.numpy(), np.asarray(ja.m2), atol=4e-2, rtol=2e-3)
    grew = ta.count.numpy()[:, 0] > acc.count.numpy()[:, 0]
    assert int(grew.sum()) == m


@pytest.fixture(scope="module")
def jax_adaptive(pair):
    from echorenderer_tpu.processes.render import EvaluationProfile as JProfile
    from echorenderer_tpu.processes.render import render_layer as jrender_layer

    jscene, _ = pair
    prof = JProfile(evaluator="path", samples_per_epoch=SPE, min_epoch=2, max_epoch=MAX_EPOCH,
                    noise_threshold=THRESHOLD, bounce_limit=4, adaptive=True)
    return jrender_layer(jscene, prof, RES, seed=3)


def test_adaptive_render_matches_jax(pair, jax_adaptive):
    j_img, j_info = jax_adaptive
    img, info = render_layer(pair[1], _profile(True), RES, seed=3)
    assert (info["epochs"], info["samples"]) == (j_info["epochs"], j_info["samples"])
    assert info["epochs"] > 2  # the adaptive phase ran
    active = [e["active"] for e in info["epoch_log"]]
    assert active[:2] == [RES[0] * RES[1]] * 2 and active[2] < active[0]
    assert sum(a * SPE for a in active) == info["samples"]
    np.testing.assert_allclose(img, np.asarray(j_img), atol=2e-3, rtol=2e-3)


def test_adaptive_deterministic(cornell):
    a, ia = render_layer(cornell, _profile(True), RES, seed=7)
    b, ib = render_layer(cornell, _profile(True), RES, seed=7)
    np.testing.assert_array_equal(a, b)
    assert ia["samples"] == ib["samples"] and ia["epochs"] == ib["epochs"]


def test_adaptive_saves_samples_at_same_quality(cornell):
    img_fixed, info_fixed = render_layer(cornell, _profile(False), RES, seed=3)
    img_adapt, info_adapt = render_layer(cornell, _profile(True), RES, seed=3)
    assert info_fixed["epochs"] < MAX_EPOCH
    assert info_adapt["epochs"] <= info_fixed["epochs"] + 2
    assert info_adapt["samples"] < 0.7 * info_fixed["samples"]
    scale = max(float(np.mean(img_fixed)), 1e-6)
    assert float(np.mean(np.abs(img_adapt - img_fixed))) / scale < 0.35


def test_padded_lanes_change_no_sum(cornell):
    """The JAX step's bucket padding (copies of perm[0], masked to zero)
    applied to the port's lanes: the same accumulator and draw counts,
    bitwise."""
    res, count, seed = (40, 30), 4, 11
    n = res[0] * res[1]
    acc, drawn_np = _start_state(cornell, res)
    drawn = torch.as_tensor(drawn_np.astype(np.int64))
    perm = torch.as_tensor(lane_order(res)[0].astype(np.int64))
    thr = torch.tensor(0.2)
    m = int(trender._active_stats(acc, thr)[0])
    bucket = _bucket_size(m, n)
    assert m < bucket  # padded lanes exist
    want_acc, want_drawn = trender._adaptive_step(cornell, acc, drawn, perm, thr, res, count, 4,
                                                  2.5, seed, m)
    # the JAX step's compaction and masked scatter, in torch
    active = acc_mod.max_noise(acc)[perm] > thr
    cnt = torch.cumsum(active.to(torch.int64), 0)
    pos = torch.where(active & (cnt <= bucket), cnt - 1, bucket)
    lanes = torch.zeros(bucket + 1, dtype=torch.int64).scatter_(0, pos, torch.arange(n))[:bucket]
    ids = perm[lanes]
    valid = (torch.arange(bucket) < m).to(torch.float32)[:, None]
    s, q = trender._sample_active(cornell, ids, drawn[ids], res, seed, count, 4, 2.5)
    full_s = torch.zeros((n, 3)).index_add_(0, ids, s * valid)
    full_q = torch.zeros((n, 3)).index_add_(0, ids, q * valid)
    k = torch.zeros((n, 1)).index_add_(0, ids, valid * float(count))
    got_acc = acc_mod.add_many(acc, full_s, full_q, k)
    got_drawn = drawn.index_add(0, ids, (valid[:, 0] * count).to(torch.int64)) & 0xFFFFFFFF
    for got, want in zip(got_acc, want_acc):
        assert torch.equal(got, want)
    assert torch.equal(got_drawn, want_drawn)


def test_default_profile_renders(cornell):
    """render() with RenderProfile's and EvaluationProfile's defaults:
    adaptive epochs on."""
    out = render(cornell, RenderProfile(resolution=(32, 24)))
    img = out["main"]
    assert img.shape == (24, 32, 3) and np.isfinite(img).all() and img.mean() > 0
    info = out["__info__"]["main"]
    assert info["epochs"] > 1 and info["samples"] < 20 * 16 * 32 * 24
    assert info["wavefront_iterations"] > 0


def test_progress_called_each_epoch(cornell):
    calls = []
    _, info = render_layer(cornell, _profile(True, max_epoch=6), (16, 12), seed=2,
                           progress=lambda e, total, noise: calls.append((e, total, noise)))
    assert [c[0] for c in calls] == list(range(1, info["epochs"] + 1))
    assert all(c[1] == 6 and np.isfinite(c[2]) for c in calls)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the megakernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sphere_field(80)", "cornell"])
def test_cuda_adaptive_megakernel_equals_wavefront(cuda, monkeypatch, name):
    """An adaptive render (compacted lanes, per-lane starts, the split form
    on the small epochs) through the megakernel, against the same render on
    the wavefront with one sample chain: every pixel and the schedule
    bitwise."""
    make = {"sphere_field(80)": lambda: tscenes.sphere_field(80), "cornell": tscenes.cornell_box}
    scene = prepare_scene(make[name](), device=cuda)
    assert tmk.supported(scene)
    prof = EvaluationProfile(samples_per_epoch=8, max_epoch=6, noise_threshold=0.1,
                             bounce_limit=8)
    diagnostics.reset_counts()
    img, info = render_layer(scene, prof, (160, 90), seed=4)
    assert diagnostics.counts()["launches.mega"] == info["epochs"] > 1
    monkeypatch.setattr(trender, "MAX_LANES", 0)  # one chain: the kernel's sample order
    monkeypatch.setattr(tmk, "supported", lambda s: False)
    assert tso.dispatch_summary(scene)["integrator"] == "wavefront"
    wimg, winfo = render_layer(scene, prof, (160, 90), seed=4)
    assert (info["epochs"], info["samples"]) == (winfo["epochs"], winfo["samples"])
    np.testing.assert_array_equal(img, wimg)
