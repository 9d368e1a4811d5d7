"""PyTorch port: the learned denoiser against the JAX package's.

- `denoise.apply` on the committed eval fixture (tests/fixtures/
  denoise_eval.npz, three 128x192 scenes) with the committed weights, and
  with weights drawn from a seed: rtol 1e-4 / atol 1e-5 against the JAX
  package's (the convolutions sum their 288 terms in another order:
  XLA's against oneDNN's; 2.4e-6 absolute measured on the fixture).
- Each convolution alone (HWIO weights as OIHW, "SAME" zero padding per
  dilation): rtol 1e-5 / atol 1e-5.
- The weight file is the JAX package's, byte for byte.
- tests/test_denoise.py's gate on the port: the learned denoiser beats the
  cross-bilateral filter on the fixture, and LearnedDenoise routes through it.
"""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echorenderer_tpu.processes import denoise as jd
from echorenderer_tpu_torch.processes import denoise as td
from echorenderer_tpu_torch.processes.composition import BilateralDenoise, LearnedDenoise

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "denoise_eval.npz")
SCENES = ["cornell", "ball", "spheres"]


def _inputs(scene):
    fx = np.load(FIXTURE)
    return (fx[f"{scene}_noisy"], fx[f"{scene}_albedo"], fx[f"{scene}_normal"],
            fx[f"{scene}_clean"])


def test_weights_are_the_jax_packages_bytes():
    with open(jd.WEIGHTS_PATH, "rb") as a, open(td.WEIGHTS_PATH, "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(td.WEIGHTS_PATH).endswith(os.path.join("echorenderer_tpu_torch", "data"))


@pytest.mark.parametrize("scene", SCENES)
def test_apply_matches_jax_on_fixture(scene):
    noisy, albedo, normal, _ = _inputs(scene)
    want = np.asarray(jd.apply(jd.load_params(), noisy[None], albedo[None], normal[None]))[0]
    got = td.apply(td.load_params(), *(torch.as_tensor(a)[None] for a in (noisy, albedo, normal)))
    assert got.shape == (1,) + noisy.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-4, atol=1e-5)


def test_apply_matches_jax_with_seeded_weights():
    """Weights drawn from a torch.Generator, the same arrays in both packages
    (every conv and the kernel's channel order exercised off the trained
    values)."""
    params = td.init_params(torch.Generator().manual_seed(11))
    rs = np.random.RandomState(12)
    color = rs.uniform(0, 3, (2, 20, 28, 3)).astype(np.float32)
    albedo = rs.uniform(0, 1, (2, 20, 28, 3)).astype(np.float32)
    normal = rs.uniform(-1, 1, (2, 20, 28, 3)).astype(np.float32)
    want = np.asarray(jd.apply({k: jnp.asarray(v.numpy()) for k, v in params.items()},
                               color, albedo, normal))
    got = td.apply(params, torch.as_tensor(color), torch.as_tensor(albedo),
                   torch.as_tensor(normal)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_init_params_shapes_and_seed():
    a = td.init_params(torch.Generator().manual_seed(3))
    b = td.init_params(torch.Generator().manual_seed(3))
    j = jd.init_params(jax.random.PRNGKey(0))
    assert sorted(a) == sorted(j)
    for k in a:
        assert tuple(a[k].shape) == tuple(j[k].shape), k
        assert torch.equal(a[k], b[k]), k
    fan_in = 9 * 9  # w0: 3x3 taps of 9 input channels
    assert abs(float(a["w0"].std()) - np.sqrt(2.0 / fan_in)) < 0.02
    assert float(a["b4"].abs().sum()) == 0.0


@pytest.mark.parametrize("dilation", [1, 2, 4])
def test_conv_matches_lax(dilation):
    rs = np.random.RandomState(dilation)
    x = rs.normal(size=(1, 13, 17, 5)).astype(np.float32)  # NHWC
    w = rs.normal(size=(3, 3, 5, 7)).astype(np.float32)  # HWIO
    b = rs.normal(size=(7,)).astype(np.float32)
    want = np.asarray(jd._conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), dilation))
    got = td._conv(torch.as_tensor(x).permute(0, 3, 1, 2), torch.as_tensor(w),
                   torch.as_tensor(b), dilation).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_load_params_on_device():
    params = td.load_params(device="cpu")
    ref = np.load(jd.WEIGHTS_PATH)
    assert sorted(params) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(params[k].numpy(), ref[k])


# --- tests/test_denoise.py's gate, on the port ---


def _mse(a, b):
    ta = np.log1p(np.maximum(np.asarray(a), 0.0))
    tb = np.log1p(np.maximum(np.asarray(b), 0.0))
    return float(np.mean((ta - tb) ** 2))


def _ssim(a, b):
    """Global SSIM on log-tonemapped luminance (single-window variant)."""
    lum = lambda x: np.log1p(np.maximum(np.asarray(x), 0.0)).mean(-1)
    x, y = lum(a), lum(b)
    mx, my = x.mean(), y.mean()
    vx, vy = x.var(), y.var()
    cxy = ((x - mx) * (y - my)).mean()
    c1, c2 = 0.01**2, 0.03**2
    return float(((2 * mx * my + c1) * (2 * cxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2)))


@pytest.mark.parametrize("scene", SCENES)
def test_learned_beats_bilateral(scene):
    noisy, albedo, normal, clean = _inputs(scene)
    learned = td.denoise(noisy, albedo, normal, td.load_params(), device="cpu").numpy()
    bilateral = BilateralDenoise().apply(
        {"main": torch.as_tensor(noisy), "albedo": torch.as_tensor(albedo),
         "normal_depth": torch.as_tensor(normal)})["main"].numpy()
    m_l, m_b, m_n = _mse(learned, clean), _mse(bilateral, clean), _mse(noisy, clean)
    assert m_l < m_b, f"learned {m_l:.6f} !< bilateral {m_b:.6f} (noisy {m_n:.6f})"
    assert m_l < m_n  # and it actually denoises
    assert _ssim(learned, clean) >= _ssim(bilateral, clean) - 0.005


def test_composition_operator_uses_learned():
    noisy, albedo, normal, _ = _inputs("cornell")
    layers = {"main": torch.as_tensor(noisy), "albedo": torch.as_tensor(albedo),
              "normal_depth": torch.as_tensor(normal)}
    out = LearnedDenoise().apply(dict(layers))["main"]
    direct = td.denoise(noisy, albedo, normal, td.load_params(), device="cpu")
    np.testing.assert_array_equal(out.numpy(), direct.numpy())


def test_denoise_without_weights_raises(monkeypatch):
    monkeypatch.setattr(td, "WEIGHTS_PATH", os.path.join(os.path.dirname(FIXTURE), "absent.npz"))
    assert td.load_params() is None
    noisy, albedo, normal, _ = _inputs("ball")
    with pytest.raises(FileNotFoundError):
        td.denoise(noisy, albedo, normal, device="cpu")
    # the operator falls back to the bilateral filter instead
    layers = {"main": torch.as_tensor(noisy), "albedo": torch.as_tensor(albedo),
              "normal_depth": torch.as_tensor(normal)}
    out = LearnedDenoise().apply(dict(layers))["main"]
    np.testing.assert_array_equal(out.numpy(), BilateralDenoise().apply(layers)["main"].numpy())


def test_denoise_uploads_arrays_to_its_device():
    """Arrays go to `device`, the card unless the caller asks for another;
    tensors stay on their own device."""
    noisy, albedo, normal, _ = _inputs("ball")
    params = {k: v.to("meta") for k, v in td.load_params().items()}
    assert td.denoise(noisy, albedo, normal, params, device="meta").device.type == "meta"
    tensors = [torch.as_tensor(a) for a in (noisy, albedo, normal)]
    assert td.denoise(*tensors, td.load_params(), device="meta").device.type == "cpu"
    if torch.cuda.is_available():
        assert td.denoise(noisy, albedo, normal).device.type == "cuda"
    else:  # no card: the default raises, it does not fall back to the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            td.denoise(noisy, albedo, normal)


def test_concurrent_denoises_keep_the_cudnn_flags(monkeypatch):
    """Two threads denoising at once: every convolution runs with TF32 off,
    each output equals the single-threaded float32 result, and the process's
    cuDNN flags are as they were afterwards. `cudnn.flags` saves and
    restores process-wide flags, so without the module's lock one thread's
    exit turns TF32 back on under the other's convolutions, and the last
    exit can leave it off."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic)
    noisy, albedo, normal, _ = _inputs("spheres")
    args = [torch.as_tensor(a[None, :24, :32]) for a in (noisy, albedo, normal)]
    params = td.load_params()
    want = td.apply(params, *args).numpy()
    seen, real_conv = [], td._conv

    def conv(*a):
        seen.append(torch.backends.cudnn.allow_tf32)
        return real_conv(*a)

    monkeypatch.setattr(td, "_conv", conv)
    outs, errors = [], []

    def work():
        try:
            for _ in range(40):
                outs.append(td.apply(params, *args).numpy())
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(interval)
    assert not errors and len(outs) == 80
    assert len(seen) == 80 * len(td.DILATIONS) and not any(seen)
    for out in outs:
        np.testing.assert_array_equal(out, want)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic) == before
