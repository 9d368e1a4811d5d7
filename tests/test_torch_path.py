"""PyTorch port: the path tracer as a whole.

- The port's wavefront against the JAX wavefront on 1024 lanes, both fed
  the same prepared tables (`from_jax_arrays`) and the JAX side routed
  through its (interpreted) dense Pallas kernels, as
  tests/test_megakernel.py does: per-sample sums to atol/rtol 2e-3, sums
  of squares to atol 4e-2, mean images to 1e-5 (float reduction order is
  the only difference).
- The port's `_sample_frame` against the committed golden images with
  tests/test_golden.py's tolerances.
- Importing and running the port (an adaptive layer, an albedo layer and
  a frame sharded over two CPU shards included) leaves jax out of the
  process.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echorenderer_tpu.evaluation import scene_ops as jscene_ops
from echorenderer_tpu.evaluation.wavefront import sample_frame_wavefront as jwavefront
from echorenderer_tpu.models import scenes as jscenes
from echorenderer_tpu.scene.prepare import prepare_scene as jprepare
from echorenderer_tpu_torch.evaluation.wavefront import sample_frame_wavefront
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.processes.render import (
    EvaluationProfile,
    RenderProfile,
    _sample_frame,
    render,
    render_layer,
)
from echorenderer_tpu_torch.scene.convert import from_jax_arrays
from echorenderer_tpu_torch.scene.prepare import prepare_scene

from test_torch_prepare import flatten_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GOLDEN_DIR = REPO / "tests" / "golden"


@pytest.fixture
def same_intersector(monkeypatch):
    # route the JAX wavefront through the interpreted dense pallas kernel,
    # the kernel the port's trace/occlude stand for
    monkeypatch.setattr(jscene_ops, "_use_pallas", lambda scene: scene.prim_soa is not None)


@pytest.mark.parametrize("name", ["cornell_box", "sphere_field"])
def test_wavefront_matches_jax(same_intersector, name):
    jscene = jprepare(getattr(jscenes, name)())
    tscene = from_jax_arrays(flatten_jax(jscene), device="cpu")
    n, res = 1024, (32, 32)
    pid = np.arange(n, dtype=np.uint32)
    pxy = np.stack([pid % res[0], pid // res[0]], -1).astype(np.int32)
    kw = dict(bounce_limit=3, survivability=2.5)
    a, a2 = jwavefront(jscene, jnp.asarray(pid), jnp.asarray(pxy), res, 11,
                       jnp.uint32(0), 2, **kw)
    b, b2 = sample_frame_wavefront(tscene, torch.as_tensor(pid.astype(np.int64)),
                                   torch.as_tensor(pxy), res, 11, 0, 2, **kw)
    a, a2 = np.asarray(a), np.asarray(a2)
    b, b2 = b.numpy(), b2.numpy()
    assert a.sum() > 0
    np.testing.assert_allclose(b, a, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(b2, a2, atol=4e-2, rtol=2e-3)
    np.testing.assert_allclose(b.mean(0), a.mean(0), atol=1e-5, rtol=1e-5)


GOLDEN = {
    "cornell": (tscenes.cornell_box, (32, 24), 8, 4),
    "spheres": (lambda: tscenes.sphere_field(80), (32, 18), 4, 6),
    "material_ball": (tscenes.material_ball, (32, 18), 4, 6),
}


@pytest.mark.parametrize("name", list(GOLDEN))
def test_golden(name):
    maker, res, spp, bounce = GOLDEN[name]
    s_sum, _ = _sample_frame(prepare_scene(maker(), device="cpu"), "path", res, 0, 0, spp, bounce, 2.5)
    img = (s_sum.numpy() / spp).reshape(res[1], res[0], 3)
    ref = np.load(GOLDEN_DIR / f"{name}.npy")
    assert img.shape == ref.shape
    diff = np.abs(img - ref)
    assert diff.mean() < 5e-3, f"mean diff {diff.mean():.5f}"
    assert np.abs(img.mean() - ref.mean()) < 2e-3


def test_render_layer_counts_samples_and_iterations():
    scene = prepare_scene(tscenes.cornell_box(), device="cpu")
    prof = EvaluationProfile(samples_per_epoch=2, max_epoch=2, bounce_limit=3, adaptive=False,
                             noise_threshold=0.0)
    img, info = render_layer(scene, prof, (16, 12))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all() and img.mean() > 0
    assert info["samples"] == 2 * 2 * 16 * 12 and info["epochs"] == 2
    assert info["wavefront_iterations"] >= 2
    assert info["dispatch"]["accelerator"] == "dense-stream"
    assert info["dispatch"]["integrator"] == "wavefront"
    assert info["dispatch"]["integrator_reason"] == "not on CUDA"


def test_unported_render_options_raise():
    """The composition-error half of what this test held while the image
    readers were missing (ImportGrid and hdr_environment(hdr_path=...) now
    work: test_image_texture_and_hdr_sky_work): a composition stack runs,
    and an operator that fails is recorded, as in the JAX package."""
    scene = prepare_scene(tscenes.material_ball(), device="cpu")
    out = render(scene, RenderProfile(resolution=(8, 8), composition=("tonemap",), evaluations=(
        EvaluationProfile(evaluator="albedo"),)))
    assert out["__info__"]["composition_errors"] == {"str": "'str' object has no attribute 'apply'"}
    assert out["main"].shape == (8, 8, 3)


def test_image_texture_and_hdr_sky_work(tmp_path):
    """ImportGrid and hdr_environment(hdr_path=...), which raised before the
    image readers were ported, prepare and render."""
    from echorenderer_tpu_torch.io import images
    from echorenderer_tpu_torch.scene import Diffuse
    from echorenderer_tpu_torch.textures.grids import ImportGrid

    rs = np.random.RandomState(4)
    images.save(tmp_path / "wood.png", rs.uniform(0, 1, (8, 8, 3)).astype(np.float32))
    images.save(tmp_path / "sky.hdr", rs.uniform(0.1, 3, (8, 16, 3)).astype(np.float32))
    ball = prepare_scene(tscenes.material_ball(Diffuse(albedo=ImportGrid(tmp_path / "wood.png"))),
                         device="cpu")
    sky = prepare_scene(tscenes.hdr_environment(hdr_path=tmp_path / "sky.hdr"), device="cpu")
    assert ball.tex_atlas.shape[0] == 1 and len(sky.env_maps) == 1
    for scene in (ball, sky):
        out = render(scene, RenderProfile(resolution=(8, 8), evaluations=(
            EvaluationProfile(evaluator="albedo"),)))
        assert np.isfinite(out["main"]).all() and out["main"].max() > 0


def test_port_runs_without_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from echorenderer_tpu_torch.models import scenes\n"
        "from echorenderer_tpu_torch.scene.prepare import prepare_scene\n"
        "from echorenderer_tpu_torch.processes.render import _sample_frame\n"
        "from echorenderer_tpu_torch.ops import megakernel\n"
        "from echorenderer_tpu_torch.aggregation import light_tree\n"
        "from echorenderer_tpu_torch.ops import pallas_hier, binned_trace\n"
        "from echorenderer_tpu_torch.evaluation import scene_ops\n"
        "g = prepare_scene(scenes.sphere_grid(17_000), device='cpu')\n"
        "assert g.hier_soa is not None\n"
        "scene_ops.HIER_TRACE_MIN = 0\n"
        "s, _ = _sample_frame(g, 'path', (4, 4), 0, 0, 1, 2, 2.5)\n"
        "assert bool(torch.isfinite(s).all()) and pallas_hier.hier_trace.launches == 0\n"
        "assert binned_trace.STATS['calls'] > 0 and binned_trace.LAUNCHES['seg'] == 0\n"
        "s, _ = _sample_frame(prepare_scene(scenes.cornell_box(), device='cpu'), 'path', (8, 6),\n"
        "                     0, 0, 2, 3, 2.5)\n"
        "assert bool(torch.isfinite(s).all())\n"
        "from echorenderer_tpu_torch.processes.render import EvaluationProfile, render_layer\n"
        "c = prepare_scene(scenes.cornell_box(), device='cpu')\n"
        "img, info = render_layer(c, EvaluationProfile(samples_per_epoch=2, max_epoch=3,\n"
        "                         bounce_limit=3), (8, 6))\n"
        "assert info['epochs'] > 1 and info['samples'] < 3 * 2 * 48, info\n"
        "alb, _ = render_layer(c, EvaluationProfile(evaluator='albedo'), (8, 6))\n"
        "assert alb.shape == (6, 8, 3) and float(alb.min()) >= 0.0\n"
        "from echorenderer_tpu_torch.processes.render import render, standard_path_traced_profile\n"
        "out = render(c, standard_path_traced_profile(0.25, (24, 16)))\n"
        "assert out['main'].shape == (16, 24, 3) and 'composition_errors' not in out['__info__']\n"
        "from echorenderer_tpu_torch.processes import checkpoint, scheduler\n"
        "from echorenderer_tpu_torch import native, terminal, ui\n"
        "from echorenderer_tpu_torch.io import echo_dsl, echo_registry, exr, images, models\n"
        "from echorenderer_tpu_torch.ui import preview\n"
        "from echorenderer_tpu_torch.aggregation.bvh import build_bvh\n"
        "src = echo_dsl.EchoSource('scenes/cornell.echo')\n"
        "prof = src.construct('fast')\n"
        "c2 = prepare_scene(prof.scene, device='cpu')\n"
        "assert c2.geometry.num_triangles == 36 and build_bvh.native_calls + build_bvh.numpy_calls\n"
        "assert images.encode_png(alb)[:4] == b'\\x89PNG'\n"
        "import numpy as np\n"
        "from echorenderer_tpu_torch.parallel import make_mesh, render_frame_sharded\n"
        "from echorenderer_tpu_torch.parallel import multihost\n"
        "img = render_frame_sharded(make_mesh(devices=['cpu'] * 2), c, (8, 6), spp=2,\n"
        "                           bounce_limit=3)\n"
        "assert img.shape == (6, 8, 3) and bool(np.isfinite(img).all())\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'echorenderer_tpu' or m.startswith('echorenderer_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
