"""The frozen scene generators make what the port's models/scenes.py makes
today, and the reference's tables are the port's prepared ones."""

import numpy as np
import pytest
import torch

from echobench import manifest, port, run
from echobench.reference.flat import flatten


def generator(name):
    """generators/<name>.py, loaded as the manifest loads it."""
    return manifest._load(run.ROOT / "echobench" / "generators" / f"{name}.py", f"test_{name}")


def _cases():
    from echorenderer_tpu_torch.models import scenes as port_scenes

    return [(generator("sphere_field").make(80, 3), lambda: port_scenes.sphere_field(80, 3)),
            (generator("sphere_grid").make(3000), lambda: port_scenes.sphere_grid(3000))]


@pytest.fixture(scope="module")
def prepared():
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    out = []
    for spec, make in _cases():
        out.append((spec, prepare_scene(port.build_scene(spec), device="cpu"),
                    prepare_scene(make(), device="cpu")))
    return out


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)) and a and hasattr(a[0], "_fields"):
        return all(_same(x, y) for x, y in zip(a, b))
    if hasattr(a, "_fields"):
        return all(_same(getattr(a, f), getattr(b, f)) for f in a._fields)
    return a == b if not isinstance(a, np.ndarray) else np.array_equal(a, b)


@pytest.mark.parametrize("case", [0, 1], ids=["sphere_field_80", "sphere_grid_3000"])
def test_generators_give_the_ports_scene(prepared, case):
    _, ours, theirs = prepared[case]
    for field in ("geometry", "materials", "lights", "camera", "shade_pack", "mat_pack",
                  "emissive_pack"):
        assert _same(getattr(ours, field), getattr(theirs, field)), field


def test_grid_mesh_is_the_ports():
    from echorenderer_tpu_torch.models import scenes as port_scenes

    for a, b in zip(generator("sphere_grid").mesh(3, 9), port_scenes.sphere_grid_mesh(3, 9)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", [0, 1], ids=["sphere_field_80", "sphere_grid_3000"])
def test_reference_tables_are_the_prepared_ones(prepared, case):
    spec, ours, _ = prepared[case]
    f = flatten(spec)
    g = ours.geometry
    for mine, port_t in ((f.tri_v0, g.tri_v0), (f.tri_e1, g.tri_e1), (f.tri_e2, g.tri_e2),
                         (f.tri_n[:, 0], g.tri_n0), (f.tri_n[:, 2], g.tri_n2),
                         (f.sph_center, g.sph_center), (f.sph_radius, g.sph_radius)):
        assert np.array_equal(mine, port_t.numpy())
    assert np.array_equal(f.tri_geo_n, ours.shade_pack[:f.num_tris, 0:3].numpy())
    area = np.concatenate([f.tri_area, f.sph_area])
    assert np.array_equal(area, ours.shade_pack[:, 19].numpy())
    lt = ours.lights
    assert np.array_equal(f.light_cdf, lt.cdf.numpy())
    assert np.array_equal(f.light_power, lt.power.numpy())
    assert np.array_equal(f.light_kind, lt.kind.numpy())
    assert np.array_equal(f.prim_light, lt.prim_light.numpy())
    assert np.array_equal(f.emit_area, ours.emissive_pack[:, 15].numpy())
    assert np.array_equal(f.ambient, lt.ambient_all.numpy())
    assert np.array_equal(f.cam_rotation, ours.camera.rotation.numpy())
    assert np.array_equal(f.cam_position, ours.camera.position.numpy())
    assert f.cam_forward == ours.camera.forward_length.item()
    mats = ours.mat_pack.numpy()
    prim_mat = np.concatenate([f.tri_mat, f.sph_mat])
    port_mat = ours.shade_pack[:, 18].numpy().astype(np.int64)
    assert np.array_equal(f.mat_albedo[prim_mat], mats[port_mat, 0:3])
    assert np.array_equal(f.mat_params[prim_mat], mats[port_mat, 3:7])
    assert np.array_equal(f.mat_extra[prim_mat], mats[port_mat, 7:10])
    assert np.array_equal(f.mat_type[prim_mat], mats[port_mat, 10].astype(np.int32))


@pytest.mark.parametrize("bad", [
    dict(materials=[dict(kind="Mirror", albedo=(1, 1, 1))]),
    dict(entities=[dict(kind="SphereEntity", material=0, radius=1.0, scale=2.0)]),
    dict(lights=[dict(kind="PointLight", intensity=(1, 1, 1))]),
], ids=["material", "key", "light"])
def test_the_reference_refuses_what_it_does_not_cover(bad):
    spec = generator("sphere_field").make(3, 3)
    for field, items in bad.items():
        setattr(spec, field, getattr(spec, field) + items)
    with pytest.raises(ValueError, match="the reference has no"):
        flatten(spec)
