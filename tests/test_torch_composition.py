"""PyTorch port: the composition stack against the JAX package's.

The same layers, made from a numpy seed at 48x64, go through each
package's operator. Tolerances and their reasons:
- every operator and curve: rtol 1e-5 / atol 1e-6 elementwise (the same
  float32 ops; XLA may order a reduction or round a transcendental
  otherwise: AutoExposure's prefix sums (XLA's reduce_window against the
  port's doubling steps) and mass sums, exp, tanh);
  AutoExposure's scale (its output over its input) rtol 1e-5;
- LearnedDenoise: the denoiser's tolerance, rtol 1e-4 / atol 1e-5
  (tests/test_torch_denoise.py: the convolutions sum in another order);
- STANDARD_STACK through `compose`: rtol 1e-5 / atol 1e-6;
- `render(cornell, standard_path_traced_profile(...))` at 32x24 against
  the JAX package's render on the same tables: atol 1e-4 on the composed
  `main` (2.4e-6 measured), albedo and normal_depth to the AOV tolerances
  of tests/test_torch_evaluators.py.
BilateralDenoise's neighbours are rolls (the filter wraps at the frame's
edges), AutoExposure's sort is stable and Watermark's slice updates clamp
their starts, as in the JAX package; the edge pixels, the tied luminances
and the clamped starts below hold the port to each.
Below them, tests/test_composition.py's reference behaviours on the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from echorenderer_tpu.processes import composition as jc
from echorenderer_tpu_torch.processes import composition as tc

torch.set_num_threads(1)

H, W = 48, 64


def _layers(seed=0, ties=False):
    rs = np.random.RandomState(seed)
    main = rs.uniform(0, 4, (H, W, 3)).astype(np.float32) ** 2
    if ties:  # a few grey levels: many equal log luminances
        main = np.repeat(rs.randint(0, 6, (H, W, 1)).astype(np.float32) * 0.37, 3, axis=-1)
    main[5, 7] = 60.0  # a hot pixel for the bloom
    return {
        "main": main,
        "albedo": rs.uniform(0, 1, (H, W, 3)).astype(np.float32),
        "normal_depth": rs.uniform(-1, 1, (H, W, 4)).astype(np.float32),
    }


def _both(op, layers):
    """The JAX operator and the port's twin (same class name and fields)
    applied to the same layers; numpy dicts out."""
    twin = getattr(tc, type(op).__name__)(
        **{f.name: getattr(op, f.name) for f in dataclasses.fields(op)})
    a = op.apply({k: jnp.asarray(v) for k, v in layers.items()})
    b = twin.apply({k: torch.as_tensor(v) for k, v in layers.items()})
    return ({k: np.asarray(v) for k, v in a.items()}, {k: v.numpy() for k, v in b.items()})


OPERATORS = {
    "texture_manage": (jc.TextureManage(copy_from="main", copy_to="copy", clear="albedo",
                                        clear_color=(0.1, 0.2, 0.3)), False),
    "auto_exposure": (jc.AutoExposure(), False),
    "auto_exposure_ties": (jc.AutoExposure(center_weight=2.0, percent_lower=0.3), True),
    "bloom": (jc.Bloom(threshold=0.5, sigma=0.05), False),
    "tone_mapper": (jc.ToneMapper(curve="hable", exposure=1.5, saturation=0.7), False),
    "vignette": (jc.Vignette(intensity=0.4, grain=0.05), False),
    "watermark": (jc.Watermark(text="echo-1.0", scale=1, margin=4), False),
    "bilateral": (jc.BilateralDenoise(), False),
    "bilateral_ties": (jc.BilateralDenoise(radius=2, sigma_color=0.1), True),
    "learned": (jc.LearnedDenoise(), False),
}


@pytest.mark.parametrize("name", list(OPERATORS))
def test_operator_matches_jax(name):
    op, ties = OPERATORS[name]
    layers = _layers(1, ties)
    a, b = _both(op, layers)
    assert sorted(a) == sorted(b)
    tol = dict(rtol=1e-4, atol=1e-5) if name == "learned" else dict(rtol=1e-5, atol=1e-6)
    for k in a:
        assert b[k].shape == a[k].shape and b[k].dtype == np.float32, k
        np.testing.assert_allclose(b[k], a[k], err_msg=k, **tol)
    if name != "texture_manage":
        assert not np.array_equal(b["main"], layers["main"])  # the operator did something


@pytest.mark.parametrize("ties", [False, True])
def test_auto_exposure_scale_matches_jax(ties):
    layers = _layers(2, ties)
    a, b = _both(jc.AutoExposure(), layers)
    px = layers["main"][..., 0] > 0
    sa = a["main"][..., 0][px] / layers["main"][..., 0][px]
    sb = b["main"][..., 0][px] / layers["main"][..., 0][px]
    np.testing.assert_allclose(sb, sa, rtol=1e-5)


@pytest.mark.parametrize("which", ["no_aovs", "albedo_only"])
def test_learned_falls_back_like_jax(which):
    """Without both AOVs LearnedDenoise is the bilateral filter, in both."""
    layers = _layers(3)
    del layers["normal_depth"]
    if which == "no_aovs":
        del layers["albedo"]
    a, b = _both(jc.LearnedDenoise(), layers)
    np.testing.assert_allclose(b["main"], a["main"], rtol=1e-5, atol=1e-6)
    bil = tc.BilateralDenoise().apply({k: torch.as_tensor(v) for k, v in layers.items()})
    np.testing.assert_array_equal(b["main"], bil["main"].numpy())


def test_bilateral_wraps_at_the_edges():
    """A bright column on the left edge reaches the right edge's pixels
    (rolled neighbours), as in the JAX package."""
    layers = _layers(4)
    layers["main"][:] = 0.1
    layers["main"][:, 0] = 1.0
    layers["albedo"][:] = 0.5
    layers["normal_depth"][:] = 0.0
    a, b = _both(jc.BilateralDenoise(radius=2, sigma_color=10.0), layers)
    assert b["main"][:, -1].mean() > 0.15
    np.testing.assert_allclose(b["main"], a["main"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(jc.LUMINANCE_CURVES))
def test_curve_matches_jax(name):
    rs = np.random.RandomState(5)
    l = np.concatenate([np.linspace(0.0, 20.0, 257), rs.uniform(0, 4, 512),
                        [0.5, 1.0, 11.2, 1e-9]]).astype(np.float32)
    a = np.asarray(jc.LUMINANCE_CURVES[name](jnp.asarray(l)))
    b = tc.LUMINANCE_CURVES[name](torch.as_tensor(l)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("start", [(3, 5), (-4, 2), (40, 70), (-9, -9), (100, -1)])
def test_update_slice_clamps_like_lax(start):
    rs = np.random.RandomState(6)
    operand = rs.uniform(0, 1, (H, W)).astype(np.float32)
    update = rs.uniform(2, 3, (11, 17)).astype(np.float32)
    want = np.asarray(lax.dynamic_update_slice(jnp.asarray(operand), jnp.asarray(update), start))
    got = tc._update_slice(torch.as_tensor(operand), torch.as_tensor(update), start).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 1000, H * W])
def test_inclusive_sum_is_a_prefix_sum(n):
    """AutoExposure's prefix sums (doubling steps, the same bits on every
    device and call) against float64 cumsum."""
    x = np.random.RandomState(n).uniform(1.0, 2.0, n).astype(np.float32)
    got = tc._inclusive_sum(torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64)), rtol=1e-6)


@pytest.mark.parametrize("sigma", [0.0, 0.7, 2.0, 6.5])
def test_gaussian_blur_matches_jax(sigma):
    img = np.random.RandomState(7).uniform(0, 1, (H, W, 3)).astype(np.float32)
    a = np.asarray(jc.gaussian_blur(jnp.asarray(img), sigma))
    b = tc.gaussian_blur(torch.as_tensor(img), sigma).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_standard_stack_matches_jax():
    layers = _layers(8)
    a, ea = jc.compose(layers, jc.STANDARD_STACK)
    b, eb = tc.compose(layers, tc.STANDARD_STACK, device="cpu")
    assert ea == eb == {}
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    res = b["main"].numpy()
    assert np.isfinite(res).all() and res.min() >= -0.05 and res.max() <= 1.1


class _BrokenApply:
    def apply(self, layers):
        raise RuntimeError("boom")


class _BrokenValidate:
    def validate(self, layers):
        raise ValueError("no such layer")

    def apply(self, layers):
        layers["main"] = layers["main"] * 0.0
        return layers


class _HalfDone:
    """Writes one layer, then fails: the stack must go on without its write."""

    def apply(self, layers):
        layers["main"] = layers["main"] * 100.0
        raise RuntimeError("half done")


def test_compose_error_capture_matches_jax():
    layers = _layers(9)
    jops = (_BrokenApply(), _BrokenValidate(), jc.ToneMapper(), _HalfDone(), "tonemap",
            jc.Vignette())
    tops = (_BrokenApply(), _BrokenValidate(), tc.ToneMapper(), _HalfDone(), "tonemap",
            tc.Vignette())
    a, ea = jc.compose(layers, jops)
    b, eb = tc.compose(layers, tops, device="cpu")
    assert sorted(ea) == sorted(eb) == ["_BrokenApply", "_BrokenValidate", "_HalfDone", "str"]
    assert eb["_BrokenApply"] == "boom" and eb["_BrokenValidate"] == "no such layer"
    np.testing.assert_allclose(b["main"].numpy(), np.asarray(a["main"]), rtol=1e-5, atol=1e-6)
    assert b["main"].numpy().max() <= 1.0  # the half-done write did not land


def test_compose_uploads_arrays_to_its_device():
    """Arrays go to `device`, the card unless the caller asks for another
    (the JAX package's compose runs on its default accelerator); tensors
    stay on their own device."""
    layers = _layers(10)
    out, errors = tc.compose(layers, (tc.ToneMapper(),), device="meta")
    assert errors == {} and {v.device.type for v in out.values()} == {"meta"}
    tensors = {k: torch.as_tensor(v) for k, v in layers.items()}
    out, errors = tc.compose(tensors, (tc.ToneMapper(),), device="meta")
    assert errors == {} and {v.device.type for v in out.values()} == {"cpu"}
    if torch.cuda.is_available():
        out, _ = tc.compose(layers, (tc.ToneMapper(),))
        assert {v.device.type for v in out.values()} == {"cuda"}
    else:  # no card: the default raises, it does not fall back to the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            tc.compose(layers, (tc.ToneMapper(),))


@pytest.mark.parametrize("quality", [0.25, 1.0, 2.0])
def test_standard_profile_matches_jax(quality):
    from echorenderer_tpu.processes.render import standard_path_traced_profile as jprofile
    from echorenderer_tpu_torch.processes.render import standard_path_traced_profile as tprofile

    for kw in ({}, dict(denoise=False, watermark=False)):
        a = jprofile(quality, (320, 180), **kw)
        b = tprofile(quality, (320, 180), **kw)
        assert b.resolution == a.resolution and b.seed == a.seed
        assert [dataclasses.asdict(e) for e in b.evaluations] == \
            [dataclasses.asdict(e) for e in a.evaluations]
        assert [(type(o).__name__, dataclasses.asdict(o)) for o in b.composition] == \
            [(type(o).__name__, dataclasses.asdict(o)) for o in a.composition]


def test_standard_profile_render_matches_jax():
    """The README's call, cut to 32x24 and quality 0.25 (8 spp an epoch, at
    most 3 epochs), on the Cornell box: the port's render against the JAX
    package's on the same tables."""
    from echorenderer_tpu.models import scenes as jscenes
    from echorenderer_tpu.processes import render as jrender
    from echorenderer_tpu.scene.prepare import prepare_scene as jprepare
    from echorenderer_tpu_torch.processes import render as trender
    from echorenderer_tpu_torch.scene.convert import from_jax_arrays

    from test_torch_prepare import flatten_jax

    jscene = jprepare(jscenes.cornell_box())
    tscene = from_jax_arrays(flatten_jax(jscene), device="cpu")
    res = (32, 24)
    a = jrender.render(jscene, jrender.standard_path_traced_profile(0.25, res))
    b = trender.render(tscene, trender.standard_path_traced_profile(0.25, res))
    assert "composition_errors" not in a["__info__"]
    assert "composition_errors" not in b["__info__"]
    assert sorted(b) == sorted(a) == ["__info__", "albedo", "main", "normal_depth"]
    for k in ("albedo", "normal_depth", "main"):
        assert isinstance(b[k], np.ndarray) and b[k].shape == np.asarray(a[k]).shape, k
    assert b["__info__"]["main"]["epochs"] == a["__info__"]["main"]["epochs"]
    assert b["__info__"]["main"]["samples"] == a["__info__"]["main"]["samples"]
    main = b["main"]
    assert np.isfinite(main).all() and main.min() >= 0.0 and main.max() <= 1.0
    assert main.std() > 0.01
    np.testing.assert_allclose(main, np.asarray(a["main"]), atol=1e-4)
    np.testing.assert_allclose(b["albedo"], np.asarray(a["albedo"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b["normal_depth"][..., :3], np.asarray(a["normal_depth"])[..., :3],
                               atol=1e-5)
    np.testing.assert_allclose(b["normal_depth"][..., 3], np.asarray(a["normal_depth"])[..., 3],
                               rtol=1e-5)


# --- tests/test_composition.py's reference behaviours, on the port ---


def _img(h=24, w=32, value=0.5):
    return torch.full((h, w, 3), value, dtype=torch.float32)


def test_gaussian_blur_preserves_mean_and_smooths():
    img = torch.as_tensor(np.random.RandomState(0).uniform(0, 1, (16, 16, 3)).astype(np.float32))
    out = tc.gaussian_blur(img, 1.5)
    assert float(out.std()) < float(img.std())
    np.testing.assert_allclose(float(out.mean()), float(img.mean()), atol=0.02)


def test_auto_exposure_hits_target():
    out = tc.AutoExposure(average_luminance=0.18).apply({"main": _img(value=0.02)})
    np.testing.assert_allclose(out["main"].numpy().mean(), 0.18, rtol=0.05)


def test_auto_exposure_clamps():
    out = tc.AutoExposure(average_luminance=0.18, clamp=(0.5, 4.0)).apply(
        {"main": _img(value=1e-5)})
    assert out["main"].numpy().max() <= 1e-5 * 4.0 + 1e-9


def test_bloom_only_brightens():
    img = np.zeros((16, 16, 3), np.float32)
    img[8, 8] = 40.0  # hot pixel
    out = tc.Bloom(threshold=1.0, intensity=1.0, sigma=0.1).apply({"main": torch.as_tensor(img)})
    res = out["main"].numpy()
    assert (res >= img - 1e-6).all()
    assert res[8, 4].sum() > 0.0  # energy spread to neighbors


def test_tonemap_curves_bounded_and_monotone():
    l = torch.linspace(0.0, 20.0, 256)
    for name, fn in tc.LUMINANCE_CURVES.items():
        y = fn(l).numpy()
        assert np.isfinite(y).all(), name
        assert (np.diff(y) >= -1e-4).all(), f"{name} not monotone"
        if name != "pass_through":
            assert y.max() <= 1.5, name


def test_tonemapper_output_in_unit_range():
    res = tc.ToneMapper(curve="aces").apply({"main": _img(value=7.0)})["main"].numpy()
    assert res.min() >= 0.0 and res.max() <= 1.0


def test_vignette_darkens_corners_not_center():
    res = tc.Vignette(intensity=0.5, grain=0.0).apply({"main": _img(32, 32, 0.8)})["main"].numpy()
    assert res[16, 16].mean() > res[0, 0].mean()


def test_watermark_changes_corner_only():
    res = tc.Watermark(text="echo", scale=1, margin=4).apply({"main": _img(64, 128, 0.5)})
    res = res["main"].numpy()
    np.testing.assert_allclose(res[-1, 0], 0.5, atol=1e-6)
    assert np.abs(res[:20, -40:] - 0.5).max() > 0.01


def test_texture_manage_copy_clear():
    layers = {"a": _img(value=0.3), "b": _img(value=0.9)}
    out = tc.TextureManage(copy_from="a", copy_to="c").apply(dict(layers))
    np.testing.assert_array_equal(out["c"].numpy(), layers["a"].numpy())
    out = tc.TextureManage(clear="b", clear_color=(0, 0, 0)).apply(out)
    assert out["b"].numpy().max() == 0.0


def test_bilateral_reduces_noise_preserves_edge():
    rs = np.random.RandomState(1)
    h, w = 24, 24
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, w // 2 :] = 1.0  # hard vertical edge
    normal = np.zeros((h, w, 4), np.float32)
    normal[..., 2] = 1.0
    noisy = clean + rs.normal(0, 0.1, clean.shape).astype(np.float32)
    layers = {"main": torch.as_tensor(noisy), "albedo": torch.as_tensor(clean),
              "normal_depth": torch.as_tensor(normal)}
    res = tc.BilateralDenoise(radius=3).apply(layers)["main"].numpy()
    assert np.abs(res - clean).mean() < np.abs(noisy - clean).mean() * 0.6
    assert res[:, : w // 2 - 2].mean() < 0.2
    assert res[:, w // 2 + 2 :].mean() > 0.8
