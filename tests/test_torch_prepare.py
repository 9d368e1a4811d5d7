"""PyTorch port: prepared-scene tables against the JAX package's
`prepare_scene` on the three golden scenes and on many-light scenes with
a light tree (integers exact, floats to rtol/atol 1e-6), the
`from_jax_arrays` round trip, a scene large enough for the chunk-tree
tables, a procedural albedo texture and an env map (tests/test_torch_textures.py
holds the rest of the texture system)."""

import numpy as np
import pytest
import torch

from echorenderer_tpu.models import scenes as jscenes
from echorenderer_tpu.scene.prepare import prepare_scene as jprepare
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.scene import AmbientLight, Diffuse, MeshEntity
from echorenderer_tpu_torch.scene.convert import from_jax_arrays, to_arrays
from echorenderer_tpu_torch.scene.prepare import prepare_scene as tprepare

torch.set_num_threads(1)

SCENES = {
    "cornell_box": "cornell_box",
    "sphere_field": "sphere_field",
    "material_ball": "material_ball",
}


def flatten_jax(prepared) -> dict:
    """The JAX PreparedScene's tables under their field paths."""
    out = {}
    for name, value in zip(prepared._fields, prepared):
        if hasattr(value, "_fields"):
            for sub, v in zip(value._fields, value):
                if hasattr(v, "_fields"):  # the light tree
                    for leaf, w in zip(v._fields, v):
                        out[f"{name}.{sub}.{leaf}"] = np.asarray(w)
                elif v is not None:
                    out[f"{name}.{sub}"] = np.asarray(v)
        elif name == "env_maps":
            for e, env in enumerate(value):
                for part in ("grid", "dist"):
                    table = getattr(env, part)
                    for sub, v in zip(table._fields, table):
                        out[f"env_maps.{e}.{part}.{sub}"] = np.asarray(v)
                out[f"env_maps.{e}.mean_lum"] = np.asarray(env.mean_lum)
        elif value is not None and not isinstance(value, tuple):
            out[name] = np.asarray(value)
    return out


def _pair(name):
    return jprepare(getattr(jscenes, name)()), tprepare(getattr(tscenes, name)(), device="cpu")


def _assert_tables_equal(got: dict, ref: dict):
    for key, value in got.items():
        assert key in ref, key
        want = ref[key]
        assert value.shape == want.shape, (key, value.shape, want.shape)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(value, want, rtol=1e-6, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(value, want, err_msg=key)


@pytest.mark.parametrize("name", list(SCENES))
def test_tables_match_jax(name):
    jscene, tscene = _pair(name)
    got = to_arrays(tscene)
    assert len(got) > 40
    _assert_tables_equal(got, flatten_jax(jscene))
    assert all(t.device.type == "cpu" for t in tscene.geometry)


@pytest.mark.parametrize("name", list(SCENES))
def test_from_jax_arrays_round_trips(name):
    jscene, tscene = _pair(name)
    ref = flatten_jax(jscene)
    carried = from_jax_arrays(ref, device="cpu")
    got = to_arrays(carried)
    _assert_tables_equal(got, ref)
    assert got.keys() == to_arrays(tscene).keys()
    assert carried.materials.present == tscene.materials.present
    assert carried.prim_soa.padded == tscene.prim_soa.padded


def test_procedural_albedo_texture_raises():
    """A procedural albedo texture no longer raises: the material ball in a
    CloudTexture prepares with the JAX package's atlas (bitwise) and
    mat_pack texture ids."""
    from echorenderer_tpu.scene.materials import Diffuse as JDiffuse
    from echorenderer_tpu.textures import CloudTexture as JCloud
    from echorenderer_tpu_torch.textures import CloudTexture

    jscene = jprepare(jscenes.material_ball(material=JDiffuse(albedo=JCloud(seed=2))))
    tscene = tprepare(tscenes.material_ball(material=Diffuse(albedo=CloudTexture(seed=2))),
                      device="cpu")
    ref, got = flatten_jax(jscene), to_arrays(tscene)
    _assert_tables_equal(got, ref)
    assert tscene.tex_atlas.shape[0] == 1 and tscene.materials.tex_flags == (True, False, False)
    np.testing.assert_array_equal(got["tex_atlas"], ref["tex_atlas"])
    np.testing.assert_array_equal(got["mat_pack"][:, 11], ref["mat_pack"][:, 11])


def test_env_map_raises():
    """An env map no longer raises: hdr_environment()'s sky on the material
    ball prepares with the JAX package's env-map record, rotation, scale,
    power and importance tables."""
    def sky(m):
        return next(e for e in m.hdr_environment(resolution=(32, 16)).children
                    if getattr(e, "texture", None) is not None).texture

    from echorenderer_tpu.scene import AmbientLight as JAmbient

    jball = jscenes.material_ball()
    jball.add(JAmbient(intensity=(1, 1, 1), texture=sky(jscenes)))
    tball = tscenes.material_ball()
    tball.add(AmbientLight(intensity=(1, 1, 1), texture=sky(tscenes)))
    jscene, tscene = jprepare(jball), tprepare(tball, device="cpu")
    got = to_arrays(tscene)
    assert len(tscene.env_maps) == 1 and "env_maps.0.dist.conditional_cdf" in got
    assert tscene.lights.env_power.shape == (1,)
    _assert_tables_equal(got, flatten_jax(jscene))


@pytest.mark.parametrize("count", [96, 128])
def test_light_tree_tables_match_jax(count):
    """From 64 finite lights both packages build the light tree: its node
    rows, leaf paths and depths and the record maps match the JAX
    package's, and `from_jax_arrays` carries the tree across."""
    jscene = jprepare(jscenes.many_lights(count))
    tscene = tprepare(tscenes.many_lights(count), device="cpu")
    assert tscene.lights.tree is not None
    ref = flatten_jax(jscene)
    got = to_arrays(tscene)
    assert {"lights.tree.nodes", "lights.tree.light_path", "lights.tree_records"} <= got.keys()
    _assert_tables_equal(got, ref)
    assert tscene.lights.tree.max_depth == jscene.lights.tree.max_depth
    carried = from_jax_arrays(ref, device="cpu")
    _assert_tables_equal(to_arrays(carried), ref)
    assert carried.lights.tree.max_depth == jscene.lights.tree.max_depth


def test_large_scene_raises():
    """A scene of 65,536 or more padded prims no longer raises: it prepares
    with the chunk-tree tables and dispatches to the binned traversal (its
    first wave to their walk)."""
    from echorenderer_tpu_torch.evaluation.scene_ops import HIER_TRACE_MIN, dispatch_summary

    rs = np.random.RandomState(0)
    scene = tscenes.material_ball()
    scene.add(MeshEntity(vertices=rs.uniform(-5, 5, (3 * 65536, 3)),
                         faces=np.arange(3 * 65536).reshape(-1, 3), material=Diffuse()))
    prepared = tprepare(scene, device="cpu")
    assert prepared.prim_soa.padded >= HIER_TRACE_MIN
    soa = prepared.hier_soa
    assert soa is not None and soa.num_prims == prepared.geometry.num_primitives
    assert soa.num_chunks == -(-soa.num_prims // 256) and soa.root_code >= 0
    summary = dispatch_summary(prepared)
    assert summary["accelerator"] == "binned"
    assert summary["integrator"] == "wavefront"


def test_tlas_instancing_raises_and_small_auto_bakes():
    # 4 instances of a two-sphere pack: "auto" bakes it like the JAX package;
    # "tlas" no longer raises: it keeps one pack-space copy and a TLAS
    # (tests/test_torch_instancing.py holds its tables to the JAX package's)
    baked = tprepare(tscenes.instanced_grid(side=2), device="cpu")
    assert baked.geometry.num_spheres == 8 and baked.instances is None
    tlas = tprepare(tscenes.instanced_grid(side=2), instancing="tlas", device="cpu")
    assert tlas.geometry.num_spheres == 2 and tlas.instances.num_instances == 5
    assert tlas.prim_soa is None and tlas.hier_soa.instanced
