"""PyTorch port: the offline tools (echorenderer_tpu_torch/tools/) against
the JAX package's tools/*.py.

The JAX tools run code at import (tools/gen_reference_stats.py calls main(),
both set jax's compile cache), so the tests load their functions from the
source, top-level calls left out. tools/train_denoiser.py's loss is a
closure in its main(); the reference step is restated here from it: the
JAX package's `denoise.apply`, the tool's `tonemap`, the mean L1,
`jax.value_and_grad` and `optax.adam`. Crops are 16x16, 3 a batch, on
seeded numpy inputs and seeded weights. Tolerances and their reasons:
- loss: rtol 1e-5 (float32 sums of the convolutions in another order:
  XLA's against oneDNN's; 8.3e-8 measured);
- gradients at the same params: per tensor, the largest difference within
  1e-4 of the tensor's largest |gradient| (1.0e-6 measured);
- Adam alone on the same gradients: rtol 1e-6, atol 1e-4 of the learning
  rate (optax computes 1 - 0.999^t in float32, 1.3e-5 off at t = 1; torch
  in double: a step differs by up to ~1e-5 of the learning rate; 8.9e-8
  measured after 3 steps);
- 3 full steps: losses rtol 1e-4 (5.8e-7 measured), and per tensor the L2
  distance of the two packages' params within 2e-2 of the L2 length of the
  JAX params' move (1.0e-4 measured). Adam turns a gradient's rounding
  into a step of up to the learning rate wherever the gradient is near
  zero, so after a step the two trajectories part at the float32 level
  (the port's float32 steps against its float64 ones at full size, 16
  crops of 64x64 on the eval frames: 9.3e-3 at most);
- render_frame: tests/test_torch_evaluators.py's tolerances (the path
  layer as the per-sample sums, atol/rtol 2e-3, 5.7e-7 measured; albedo
  1e-6, equal measured; normals 1e-5 on the Cornell box, 6e-8 measured);
- a saved npz through both packages' `apply`: tests/test_torch_denoise.py's
  rtol 1e-4 / atol 1e-5;
- tile statistics: `tile_stats` bitwise on the same sums (the same numpy
  arithmetic); the naive integrator's sums atol/rtol 2e-3 and squares
  atol 4e-2 (the evaluators' tolerances; 9.5e-7 and 1.5e-5 measured), tile
  means and variances atol 1e-5 (6.4e-9 and 5.8e-8 measured).
The crop draws differ from jax.random's by design (a torch.Generator on
the CPU, the same on every device); test_crop_draws_cover_the_jax_ranges
holds them to the same ranges.
"""

import ast
import hashlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from echorenderer_tpu.evaluation import scene_ops as jscene_ops
from echorenderer_tpu.models import scenes as jscenes
from echorenderer_tpu.processes import denoise as jd
from echorenderer_tpu.scene import prepare as jprep
from echorenderer_tpu_torch import tools
from echorenderer_tpu_torch.processes import denoise as td
from echorenderer_tpu_torch.scene.convert import from_jax_arrays
from echorenderer_tpu_torch.tools import gen_reference_stats as gs
from echorenderer_tpu_torch.tools import showcase_renders as sr
from echorenderer_tpu_torch.tools import train_denoiser as tr

from test_torch_prepare import flatten_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WIDTH, BATCH, LR = 16, 3, 2e-3
GRAD_REL = 1e-4
STEP_REL = 2e-2


def _jax_tool(name: str, **constants) -> dict:
    """tools/<name>.py's functions and constants, its top-level call
    statements left out; `constants` overrides module globals."""
    path = REPO / "tools" / f"{name}.py"
    tree = ast.parse(path.read_text())
    tree.body = [s for s in tree.body
                 if not (isinstance(s, ast.Expr) and isinstance(s.value, ast.Call))]
    ns = {"__name__": f"jax_{name}"}
    exec(compile(tree, str(path), "exec"), ns)
    ns.update(constants)
    return ns


@pytest.fixture(scope="module")
def jtool():
    return _jax_tool("train_denoiser")


@pytest.fixture
def same_intersector(monkeypatch):
    # the JAX scene's rays through its interpreted dense kernels, the
    # kernels the port's plain versions stand for
    monkeypatch.setattr(jscene_ops, "_use_pallas", lambda scene: scene.prim_soa is not None)


def _frames(seed=0, n=3, h=40, w=48):
    """(noisy, albedo, normal, clean) float32 frame stacks."""
    rs = np.random.RandomState(seed)
    return [rs.uniform(0, 3, (n, h, w, 3)).astype(np.float32),
            rs.uniform(0, 1, (n, h, w, 3)).astype(np.float32),
            rs.uniform(-1, 1, (n, h, w, 3)).astype(np.float32),
            rs.uniform(0, 3, (n, h, w, 3)).astype(np.float32)]


def _jax_loss(jtool):
    def loss(params, cn, ca, cm, cc):
        out = jd.apply(params, cn, ca, cm)
        return jnp.mean(jnp.abs(jtool["tonemap"](out) - jtool["tonemap"](cc)))
    return loss


def _np_crops(frames, f, y, x, width=WIDTH):
    """The crops cut from numpy frames, as the JAX tool's dynamic_slice."""
    return [np.stack([a[fi, yi:yi + width, xi:xi + width] for fi, yi, xi in
                      zip(f.tolist(), y.tolist(), x.tolist())]) for a in frames]


def _as_jax(params: dict) -> dict:
    # copies: on the CPU jnp.asarray may alias the numpy view of the
    # tensor, which the torch optimizer then updates in place
    return {k: jnp.asarray(v.detach().numpy().copy()) for k, v in params.items()}


def _close_by_max(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} > {rel} x {scale:.3e}"


def test_loss_and_gradients_match_jax(jtool):
    frames = _frames(1)
    f, y, x = tr.sample_crops(torch.Generator().manual_seed(5), 3, BATCH, (48, 40), WIDTH)
    batch = tr.crop([torch.as_tensor(a) for a in frames], f, y, x, WIDTH)
    params = tr.init_params(7, "cpu")
    loss = tr.loss_fn(params, *batch)
    loss.backward()
    want, grads = jax.value_and_grad(_jax_loss(jtool))(
        _as_jax(params), *(jnp.asarray(a) for a in _np_crops(frames, f, y, x)))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert sorted(grads) == sorted(params)
    for k, p in params.items():
        assert p.grad is not None and p.grad.shape == p.shape, k
        _close_by_max(p.grad.numpy(), np.asarray(grads[k]), GRAD_REL, f"grad {k}")


def test_adam_matches_optax_on_the_same_gradients():
    params = tr.init_params(3, "cpu")
    jparams = _as_jax(params)
    opt = tr.make_optimizer(params, LR)
    jopt = optax.adam(LR)
    state = jopt.init(jparams)
    rs = np.random.RandomState(4)
    for step in range(3):
        grads = {k: rs.normal(scale=10.0 ** -(2 + step), size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        grads["b4"][:3] = 0.0  # zero gradients: Adam's eps alone in the denominator
        for k, p in params.items():
            p.grad = torch.as_tensor(grads[k])
        opt.step()
        updates, state = jopt.update({k: jnp.asarray(v) for k, v in grads.items()}, state)
        jparams = optax.apply_updates(jparams, updates)
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-4 * LR, err_msg=k)


def test_three_train_steps_match_jax(jtool):
    frames = _frames(2)
    data = [torch.as_tensor(a) for a in frames]
    params = tr.init_params(0, "cpu")
    start = {k: v.detach().clone() for k, v in params.items()}
    jparams = _as_jax(params)
    opt = tr.make_optimizer(params, LR)
    jopt = optax.adam(LR)
    state = jopt.init(jparams)

    @jax.jit
    def step(p, s, cn, ca, cm, cc):
        loss, grads = jax.value_and_grad(_jax_loss(jtool))(p, cn, ca, cm, cc)
        updates, s = jopt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss

    gen = torch.Generator().manual_seed(42)
    for _ in range(3):
        f, y, x = tr.sample_crops(gen, 3, BATCH, (48, 40), WIDTH)
        loss = tr.train_step(params, opt, tr.crop(data, f, y, x, WIDTH))
        jparams, state, jloss = step(jparams, state,
                                     *(jnp.asarray(a) for a in _np_crops(frames, f, y, x)))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for k, p in params.items():
        move = np.linalg.norm(np.asarray(jparams[k]) - start[k].numpy())
        gap = np.linalg.norm(p.detach().numpy() - np.asarray(jparams[k]))
        assert move > 0 and gap <= STEP_REL * move, f"{k}: {gap:.3e} vs move {move:.3e}"


def test_train_is_deterministic_and_keeps_the_flags():
    """Two runs from one seed: the same losses and params bitwise; the
    backward pass ran with TF32 off and deterministic algorithms, and the
    process's flags are as they were."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    data = [torch.as_tensor(a) for a in _frames(3)]
    seen = []
    runs = []
    for _ in range(2):
        params = tr.init_params(1, "cpu")
        for p in params.values():
            p.register_hook(lambda g: seen.append((torch.backends.cudnn.allow_tf32,
                                                   torch.backends.cudnn.deterministic)) or g)
        losses = tr.train(params, data, 4, BATCH, LR, seed=9, width=WIDTH, log_every=0)
        runs.append((losses, params))
    assert torch.equal(runs[0][0], runs[1][0]) and runs[0][0].shape == (4,)
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k
    assert len(seen) == 2 * 4 * len(runs[0][1]) and set(seen) == {(False, True)}
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic) == before


def test_crops_never_differentiate_the_pad():
    """The loss's graph holds no replicate pad backward (its CUDA form
    sums with atomics), and crops that require grad are refused."""
    data = [torch.as_tensor(a) for a in _frames(4)]
    f, y, x = tr.sample_crops(torch.Generator().manual_seed(1), 3, BATCH, (48, 40), WIDTH)
    batch = tr.crop(data, f, y, x, WIDTH)
    params = tr.init_params(2, "cpu")
    seen, stack = set(), [tr.loss_fn(params, *batch).grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and node not in seen:
            seen.add(node)
            stack.extend(n for n, _ in node.next_functions)
    names = {node.name() for node in seen}
    assert any("Convolution" in n for n in names)
    assert not any("Pad" in n for n in names), sorted(names)
    batch[0].requires_grad_()
    with pytest.raises(ValueError, match="grad"):
        tr.train_step(params, tr.make_optimizer(params, LR), batch)


def test_float32_convs_nests():
    """A training step holds the lock around `apply`, which takes it again."""
    noisy, albedo, normal, _ = (torch.as_tensor(a[:1]) for a in _frames(5))
    params = td.init_params(torch.Generator().manual_seed(0))
    want = td.apply(params, noisy, albedo, normal)
    with td.float32_convs():
        with td.float32_convs():
            got = td.apply(params, noisy, albedo, normal)
        assert not torch.backends.cudnn.allow_tf32
    assert torch.equal(got, want)


def test_sample_crops_seeded_and_in_range():
    a = tr.sample_crops(torch.Generator().manual_seed(42), 44, 4096)
    b = tr.sample_crops(torch.Generator().manual_seed(42), 44, 4096)
    c = tr.sample_crops(torch.Generator().manual_seed(43), 44, 4096)
    for u, v in zip(a, b):
        assert torch.equal(u, v) and u.dtype == torch.int64 and u.device.type == "cpu"
    assert not all(torch.equal(u, v) for u, v in zip(a, c))
    f, y, x = a
    assert 0 <= int(f.min()) and int(f.max()) < 44
    assert 0 <= int(y.min()) and int(y.max()) < tr.RES[1] - tr.CROP
    assert 0 <= int(x.min()) and int(x.max()) < tr.RES[0] - tr.CROP
    cut = tr.crop([torch.arange(44 * 128 * 192 * 3, dtype=torch.float32).reshape(44, 128, 192, 3)],
                  f[:5], y[:5], x[:5])[0]
    assert cut.shape == (5, tr.CROP, tr.CROP, 3)
    assert float(cut[2, 0, 0, 0]) == ((int(f[2]) * 128 + int(y[2])) * 192 + int(x[2])) * 3


def test_crop_draws_cover_the_jax_ranges():
    """The stated deviation: the port draws other crops than jax.random
    (another generator), over the same ranges. 4096 draws of each index
    cover every value of the JAX tool's randint ranges in both."""
    n = 4096
    f, y, x = tr.sample_crops(torch.Generator().manual_seed(0), 11, n)
    kf, ky, kx = jax.random.split(jax.random.PRNGKey(42), 3)
    jf = np.asarray(jax.random.randint(kf, (n,), 0, 11))
    jy = np.asarray(jax.random.randint(ky, (n,), 0, tr.RES[1] - tr.CROP))
    jx = np.asarray(jax.random.randint(kx, (n,), 0, tr.RES[0] - tr.CROP))
    for got, want in ((f, jf), (y, jy), (x, jx)):
        assert set(got.tolist()) == set(want.tolist())
    assert not np.array_equal(f.numpy(), jf)


def test_scene_variants_are_the_jax_tools(jtool):
    assert [n for n, _ in tr.scene_variants()] == [n for n, _ in jtool["scene_variants"]()]
    assert (tr.RES, tr.NOISY_SPP, tr.CLEAN_SPP, tr.NOISY_VIEWS, tr.CROP) == (
        jtool["RES"], jtool["NOISY_SPP"], jtool["CLEAN_SPP"], jtool["NOISY_VIEWS"], jtool["CROP"])
    args = tr.build_argparser().parse_args([])
    assert (args.steps, args.batch, args.lr) == (20000, 16, 2e-3)


def test_render_frame_matches_jax(same_intersector, jtool):
    res = (16, 12)
    jscene = jprep.prepare_scene(jscenes.cornell_box())
    tscene = from_jax_arrays(flatten_jax(jscene), device="cpu")
    want = _jax_tool("train_denoiser", RES=res)["render_frame"](jscene, 4, 3)
    got = tr.render_frame(tscene, 4, 3, resolution=res)
    assert [g.shape for g in got] == [(12, 16, 3)] * 3 and all(g.dtype == np.float32 for g in got)
    assert want[0].sum() > 0
    np.testing.assert_allclose(got[0], want[0], atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got[0].mean((0, 1)), want[0].mean((0, 1)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)


def test_saved_weights_apply_alike_in_both_packages(tmp_path):
    params = tr.init_params(4, "cpu")
    data = [torch.as_tensor(a) for a in _frames(6)]
    tr.train(params, data, 2, BATCH, LR, width=WIDTH, log_every=0)
    path = tr.save_params(params, tmp_path / "w.npz")
    with np.load(path) as got, np.load(td.WEIGHTS_PATH) as committed:
        assert sorted(got.files) == sorted(committed.files)
        for k in committed.files:
            assert got[k].dtype == np.float32 and got[k].shape == committed[k].shape, k
        jparams = {k: jnp.asarray(got[k]) for k in got.files}
        tparams = {k: torch.as_tensor(got[k]) for k in got.files}
    noisy, albedo, normal, _ = _frames(7, n=2, h=20, w=28)
    want = np.asarray(jd.apply(jparams, noisy, albedo, normal))
    out = td.apply(tparams, *(torch.as_tensor(a) for a in (noisy, albedo, normal)))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-5)


def _digest(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def test_tools_refuse_the_committed_files(tmp_path):
    for path in (td.WEIGHTS_PATH, jd.WEIGHTS_PATH, tr.EVAL_FIXTURE):
        with pytest.raises(ValueError, match="refusing"):
            tr.save_params(tr.init_params(0, "cpu"), path)
        with pytest.raises(ValueError, match="refusing"):
            tr.main(["--out", path, "--device", "cpu"])
    with pytest.raises(ValueError, match="refusing"):
        tr.build_eval_fixture(tr.EVAL_FIXTURE, device="cpu")
    with pytest.raises(ValueError, match="refusing"):
        gs.generate("cornell_box", REPO / "tests" / "fixtures" / "tile_stats", 1, "cpu")
    with pytest.raises(ValueError, match="refusing"):
        sr.render_job(sr.JOBS[0], REPO / "docs" / "renders", "cpu")


def test_training_run_leaves_the_committed_files(tmp_path, capsys):
    """main() on the CPU from a small cached dataset: it trains, evaluates
    on the committed fixture beside the committed weights, writes --out,
    and the committed weights and fixture keep their bytes."""
    committed = {p: _digest(p) for p in (td.WEIGHTS_PATH, jd.WEIGHTS_PATH, tr.EVAL_FIXTURE)}
    cache = tmp_path / "dataset.npz"
    frames = _frames(8, n=2, h=72, w=80)
    np.savez(cache, noisy=frames[0], albedo=frames[1], normal=frames[2], clean=frames[3])
    out = tmp_path / "trained.npz"
    assert tr.main(["--steps", "3", "--batch", "2", "--cache", str(cache), "--out", str(out),
                    "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "step 2: loss" in text and f"saved {out}" in text
    for label in ("trained", "committed"):
        for scene in tr.EVAL_SCENES:
            assert f"{label} {scene}: MSE noisy" in text
    assert "committed cornell" in text and "gate pass" in text
    with np.load(out) as w:
        assert sorted(w.files) == sorted(f"{p}{i}" for p in "wb" for i in range(5))
    assert {p: _digest(p) for p in committed} == committed


def test_no_card_raises_without_device_cpu():
    """The tools run on the card unless asked for the CPU; with no card
    they raise rather than fall back."""
    if torch.cuda.is_available():
        assert tools.require_device("cuda").type == "cuda"
        return
    for main in (tr.main, gs.main, sr.main):
        argv = [] if main is tr.main else ["--out", "unused"]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert tools.require_device("cpu").type == "cpu"


def test_tile_stats_match_the_jax_tool():
    js = _jax_tool("gen_reference_stats", TILE=8)
    rs = np.random.RandomState(10)
    res = (24, 16)
    s_sum = rs.uniform(0, 8, (res[0] * res[1], 3))
    s_sq = s_sum ** 2 / 4 + rs.uniform(0, 2, s_sum.shape)
    want = js["tile_stats"](s_sum, s_sq, 4, res)
    got = gs.tile_stats(s_sum, s_sq, 4, res, tile=8)
    for g, w in zip(got, want):
        assert g.shape == (2, 3)
        np.testing.assert_array_equal(g, w)


def test_naive_generator_matches_jax(same_intersector):
    """The tiny naive run of the JAX tool's loop (_sample_frame_jit, steps
    of 2 samples summed in float64) against the port's naive_sums, and the
    tile statistics of both."""
    from echorenderer_tpu.processes.render import _sample_frame_jit

    res, spp, step = (24, 16), 4, 2
    jscene = jprep.prepare_scene(jscenes.cornell_box())
    tscene = from_jax_arrays(flatten_jax(jscene), device="cpu")
    want_sum = want_sq = 0.0
    for start in range(0, spp, step):
        a, b = _sample_frame_jit(jscene, "naive", res, 0, jnp.asarray(start, jnp.uint32), step,
                                 6, 2.5)
        want_sum = want_sum + np.asarray(a, np.float64)
        want_sq = want_sq + np.asarray(b, np.float64)
    got_sum, got_sq = gs.naive_sums(tscene, spp, res, step=step)
    assert got_sum.dtype == np.float64 and got_sum.shape == (res[0] * res[1], 3)
    assert want_sum.sum() > 0
    np.testing.assert_allclose(got_sum, want_sum, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(got_sq, want_sq, atol=4e-2, rtol=2e-3)
    js = _jax_tool("gen_reference_stats", TILE=8)
    want = js["tile_stats"](want_sum, want_sq, spp, res)
    got = gs.stats_arrays(got_sum, got_sq, spp, res, tile=8)
    np.testing.assert_allclose(got["mean"], want[0], atol=1e-5)
    np.testing.assert_allclose(got["var"], want[1], atol=1e-5)
    assert (int(got["spp"]), int(got["tile"]), tuple(got["res"]), int(got["bounce_limit"])) == (
        spp, 8, res, 6)
    # the z-test against the port's own stats: its own sums give z = 0
    assert float(gs.tile_z(got_sum, spp, got).max()) < 1e-3
