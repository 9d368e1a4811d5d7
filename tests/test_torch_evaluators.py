"""PyTorch port: the evaluators besides "path" against the JAX package.

Both packages render from the same prepared tables (`from_jax_arrays`,
the JAX BVH included), the JAX side routed through its (interpreted)
dense Pallas kernels where the port takes its dense kernels' plain
version, as tests/test_torch_path.py does. Tolerances and their reasons:
- albedo: rtol/atol 1e-6 on untextured scenes (the same hits gather the
  same material rows); 1e-5 on the textured scene (the atlas's bilinear
  weights, tests/test_torch_textures.py's tolerance for triangles).
- normal_depth: depth rtol 1e-5 (the hit distance; 7.8e-6 measured on
  sphere_field), misses exactly INF (compared with equal_nan), and with two
  samples inf on the same pixels in both packages (two INFs overflow); normals
  atol 1e-5 (interpolated and normalized shading normals), but 5e-4 on
  the scenes with spheres (sphere_field, the TLAS grid, 4.1e-5 measured
  there): a sphere's normal is (o + t d - centre) / r, and the two
  packages' sphere t differ in their last bits (the quadratic's
  cancellation, tests/test_torch_dense.py), times a distance of ~25
  (1.7e-4 measured).
- aggregator_quality: atol 1e-6; the traversal costs are equal exactly
  (integer counts), only log1p's rounding may differ by an ulp.
- naive, path_lockstep: tests/test_torch_path.py's per-sample sums
  (atol/rtol 2e-3, sums of squares atol 4e-2, mean images 1e-5).
- path_lockstep against the port's own wavefront: sums bitwise, squares
  rtol 1e-6 (tests/test_integrators.py's case).
- subdivide: every array bitwise (the same numpy code).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echorenderer_tpu.evaluation import scene_ops as jscene_ops
from echorenderer_tpu.models import scenes as jscenes
from echorenderer_tpu.processes import render as jrender
from echorenderer_tpu.scene import prepare as jprep
from echorenderer_tpu_torch.aggregation.bvh import on_device, trace_cost
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.processes.render import (
    EVALUATORS,
    EvaluationProfile,
    RenderProfile,
    _sample_frame,
    render,
    render_layer,
)
from echorenderer_tpu_torch.scene import prepare as tprep
from echorenderer_tpu_torch.scene.convert import from_jax_arrays

from test_torch_prepare import flatten_jax

torch.set_num_threads(1)

RES = (12, 10)


@pytest.fixture
def same_intersector(monkeypatch):
    # the JAX scene's rays through its interpreted dense kernels, the
    # kernels the port's plain versions stand for
    monkeypatch.setattr(jscene_ops, "_use_pallas", lambda scene: scene.prim_soa is not None)


def _textured(pkg):
    import test_torch_textures

    return test_torch_textures.textured(pkg)


def _pair(make_jax, **kw):
    jscene = jprep.prepare_scene(make_jax(), **kw)
    return jscene, from_jax_arrays(flatten_jax(jscene), device="cpu")


SCENES = {
    "cornell": lambda: jscenes.cornell_box(),
    "sphere_field": lambda: jscenes.sphere_field(),
}
AOV_SCENES = dict(SCENES, textured=lambda: _textured("jax"))


@pytest.fixture(scope="module")
def pairs():
    out = {name: _pair(make) for name, make in AOV_SCENES.items()}
    out["instanced_grid tlas"] = _pair(lambda: jscenes.instanced_grid(side=2), instancing="tlas")
    return out


def _both(pair, evaluator, count=1, bounce=3, seed=5):
    jscene, tscene = pair
    a, a2 = jrender._sample_frame(jscene, evaluator, RES, seed, jnp.uint32(0), count, bounce, 2.5)
    b, b2 = _sample_frame(tscene, evaluator, RES, seed, 0, count, bounce, 2.5)
    return np.asarray(a), np.asarray(a2), b.numpy(), b2.numpy()


@pytest.mark.parametrize("name", list(AOV_SCENES) + ["instanced_grid tlas"])
def test_albedo_matches_jax(same_intersector, pairs, name):
    a, _, b, _ = _both(pairs[name], "albedo")
    assert b.shape == (RES[0] * RES[1], 3) and a.sum() > 0
    tol = 1e-5 if name == "textured" else 1e-6
    np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


@pytest.mark.parametrize("name", list(AOV_SCENES) + ["instanced_grid tlas"])
def test_normal_depth_matches_jax(same_intersector, pairs, name):
    a, _, b, _ = _both(pairs[name], "normal_depth")
    assert b.shape == (RES[0] * RES[1], 4)
    spheres = pairs[name][1].geometry.sph_center.shape[0] > 0
    np.testing.assert_allclose(b[:, :3], a[:, :3], atol=5e-4 if spheres else 1e-5)
    np.testing.assert_allclose(b[:, 3], a[:, 3], rtol=1e-5, equal_nan=True)
    miss = a[:, 3] >= 3e38
    np.testing.assert_array_equal(b[miss, 3], a[miss, 3])  # INF on the misses
    # two samples: a miss's INF depth sums to inf in both packages
    a2, _, b2, _ = _both(pairs[name], "normal_depth", count=2)
    np.testing.assert_array_equal(np.isinf(b2[:, 3]), np.isinf(a2[:, 3]))


@pytest.mark.parametrize("name", list(SCENES))
def test_aggregator_quality_matches_jax(same_intersector, pairs, name):
    a, _, b, _ = _both(pairs[name], "aggregator_quality")
    assert b.std() > 0.01
    np.testing.assert_allclose(b, a, atol=1e-6)


@pytest.mark.parametrize("evaluator", ["naive", "path_lockstep"])
@pytest.mark.parametrize("name", list(SCENES))
def test_path_evaluators_match_jax(same_intersector, pairs, name, evaluator):
    a, a2, b, b2 = _both(pairs[name], evaluator, count=2)
    assert a.sum() > 0
    np.testing.assert_allclose(b, a, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(b2, a2, atol=4e-2, rtol=2e-3)
    np.testing.assert_allclose(b.mean(0), a.mean(0), atol=1e-5, rtol=1e-5)


def test_lockstep_matches_wavefront_bitwise():
    """The lockstep tracer and the wavefront share path_step and the
    coherent peel of relative sample 0, so their per-sample sums are
    bitwise equal (3 samples: one sample chain in the wavefront)."""
    scene = tprep.prepare_scene(tscenes.cornell_box(), device="cpu")
    res, spp = (24, 18), 3
    a, asq = _sample_frame(scene, "path", res, 0, 0, spp, 6, 2.5)
    b, bsq = _sample_frame(scene, "path_lockstep", res, 0, 0, spp, 6, 2.5)
    assert float(a.sum()) > 0
    np.testing.assert_array_equal(b.numpy(), a.numpy())
    np.testing.assert_allclose(bsq.numpy(), asq.numpy(), rtol=1e-6)


@pytest.mark.parametrize("name", list(SCENES))
def test_trace_cost_on_jax_bvh_equal(pairs, name):
    """The port's traversal-cost walk over the JAX scene's own BVH arrays
    gives the JAX function's costs exactly."""
    from echorenderer_tpu.aggregation.bvh import trace_cost as jtrace_cost

    jscene, tscene = pairs[name]
    rs = np.random.RandomState(4)
    o = rs.uniform(-3, 3, (300, 3)).astype(np.float32)
    o[:5] = np.asarray(jscene.camera.position)
    d = rs.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[5:8] = [[1, 0, 0], [0, -1, 0], [0, 0, 1]]  # axis-aligned: the 1e-12 guard
    want = np.asarray(jtrace_cost(jscene.geometry, jscene.bvh, jnp.asarray(o), jnp.asarray(d)))
    got = trace_cost(tscene.bvh, torch.as_tensor(o), torch.as_tensor(d)).numpy()
    assert want.max() > want.min()
    np.testing.assert_array_equal(got, want)


def test_kept_bvh_matches_jax_on_cornell():
    """prepare_scene keeps the BVH its prim order came from: the JAX
    scene's tree, node for node."""
    jscene = jprep.prepare_scene(jscenes.cornell_box())
    tscene = tprep.prepare_scene(tscenes.cornell_box(), device="cpu")
    for field in ("child_min", "child_max", "child_code", "prim_order"):
        np.testing.assert_array_equal(getattr(tscene.bvh, field).numpy(),
                                      np.asarray(getattr(jscene.bvh, field)), err_msg=field)
    assert tscene.bvh.root_code == int(jscene.bvh.root_code)


def test_tlas_bvh_joins_the_packs():
    """A TLAS scene's kept tree covers every storage prim once and walks."""
    scene = tprep.prepare_scene(tscenes.instanced_grid(side=3), instancing="tlas", device="cpu")
    order = scene.bvh.prim_order.numpy()
    assert sorted(order.tolist()) == list(range(scene.geometry.num_primitives))
    img, _ = render_layer(scene, EvaluationProfile(evaluator="aggregator_quality"), (16, 12))
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0


def _subdivide_input():
    rs = np.random.RandomState(9)
    f = 40
    parts = dict(
        v0=rs.uniform(-5, 5, (f, 3)), e1=rs.uniform(-4, 4, (f, 3)), e2=rs.uniform(-4, 4, (f, 3)),
        n0=rs.normal(size=(f, 3)), n1=rs.normal(size=(f, 3)), n2=rs.normal(size=(f, 3)),
        uv0=rs.uniform(0, 1, (f, 2)), uv1=rs.uniform(0, 1, (f, 2)), uv2=rs.uniform(0, 1, (f, 2)),
    )
    parts = {k: v.astype(np.float32) for k, v in parts.items()}
    parts["tmat"] = rs.randint(0, 5, f).astype(np.int32)
    return parts


@pytest.mark.parametrize("threshold", [0.5, 4.0, 1e9])
def test_subdivide_triangles_bitwise(threshold):
    want = jprep.subdivide_triangles(_subdivide_input(), threshold)
    got = tprep.subdivide_triangles(_subdivide_input(), threshold)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_subdivide_prepared_geometry_bitwise():
    jscene = jprep.prepare_scene(jscenes.cornell_box(), subdivide=10.0)
    tscene = tprep.prepare_scene(tscenes.cornell_box(), subdivide=10.0, device="cpu")
    for field in tscene.geometry._fields:
        np.testing.assert_array_equal(getattr(tscene.geometry, field).numpy(),
                                      np.asarray(getattr(jscene.geometry, field)), err_msg=field)


def test_subdivide_oversized_triangles():
    """tests/test_features.py's checks in the port: more triangles, the same
    area, none above the threshold, the same albedo image."""
    base = tprep.prepare_scene(tscenes.cornell_box(), device="cpu")
    sub = tprep.prepare_scene(tscenes.cornell_box(), subdivide=10.0, device="cpu")
    assert sub.geometry.num_triangles > base.geometry.num_triangles
    area = lambda g: 0.5 * np.linalg.norm(np.cross(g.tri_e1.numpy(), g.tri_e2.numpy()), axis=-1)
    np.testing.assert_allclose(area(sub.geometry).sum(), area(base.geometry).sum(), rtol=1e-5)
    assert area(sub.geometry).max() <= 10.0 + 1e-4
    prof = RenderProfile(resolution=(32, 24),
                         evaluations=(EvaluationProfile(evaluator="albedo", layer_name="a"),))
    np.testing.assert_allclose(render(sub, prof)["a"], render(base, prof)["a"], atol=2e-3)


def test_every_jax_evaluator_runs_in_render_layer():
    assert set(EVALUATORS) == set(jrender.EVALUATORS)
    scene = tprep.prepare_scene(tscenes.cornell_box(), device="cpu")
    for evaluator in EVALUATORS:
        prof = EvaluationProfile(evaluator=evaluator, samples_per_epoch=2, max_epoch=2,
                                 bounce_limit=3, layer_name=evaluator)
        img, info = render_layer(scene, prof, (8, 6))
        assert img.shape == (6, 8, jrender.AOV_CHANNELS[evaluator]), evaluator
        assert np.isfinite(img).all(), evaluator
        one = evaluator in ("albedo", "normal_depth", "aggregator_quality")
        assert info["epochs"] == (1 if one else 2) or evaluator == "path", evaluator
