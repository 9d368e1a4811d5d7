"""PyTorch port: the texture system against the JAX package.

Both packages run in this process on the same inputs (numpy, seeded).
Tolerances and their reasons:
- Texture data, procedural noise, the atlas and the texture ids of
  mat_pack: bitwise (the same numpy code; the atlas's bf16 rounding is
  round-to-nearest-even in both, torch here and ml_dtypes there).
- `PreparedGrid.sample_uv`, every wrap and filter: rtol/atol 1e-6 (one
  float32 bilinear formula; XLA may contract multiply-adds).
- The other prepared tables: test_torch_prepare's (integers exact, floats
  rtol/atol 1e-6).
- `interact` on the same hits: shade normals, uv and albedo to rtol/atol
  1e-5 on triangles. Sphere uv: the port computes atan2/acos through the
  JAX megakernel's polynomial (`ops/intersect.poly_atan2`, one expression
  for the plain version and the CUDA kernel), the JAX wavefront through
  arctan2/arccos: up to ~2e-6 rad apart, so uv to atol 1e-6 and texture
  values to atol 1e-4 (a 256-texel atlas turns 2e-6 of uv into 5e-4 of a
  texel, times a texel step below 0.2). The JAX package's own kernel makes
  the same deviation against its wavefront (tests/test_megakernel.py).
- Env maps: evaluate, sample and pdf to rtol 1e-5 / atol 1e-6, a pdf near
  the poles (divided by sin theta) to rtol 1e-4; a lookup's radiance to
  atol 1e-5 (torch's and XLA's atan2/arccos may differ by an ulp, and the
  bilinear weights carry that to the texel step).
- Wavefront per-sample sums: tests/test_torch_path.py's (atol/rtol 2e-3,
  sums of squares atol 4e-2, mean images 1e-5); under an env map, mean
  images to rtol 5e-5 (its lookups' ulps, weighted by a sun of radiance
  900).
"""

import importlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import echorenderer_tpu_torch.textures as ttx
from echorenderer_tpu_torch.evaluation import scene_ops as tso
from echorenderer_tpu_torch.evaluation.wavefront import sample_frame_wavefront
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.ops import megakernel as tmk
from echorenderer_tpu_torch.scene.convert import from_jax_arrays, to_arrays
from echorenderer_tpu_torch.scene.prepare import prepare_scene as tprepare

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _pkg(name):
    """(scene module, textures module) of "jax" or "torch"."""
    root = {"jax": "echorenderer_tpu", "torch": "echorenderer_tpu_torch"}[name]
    return importlib.import_module(root + ".scene"), importlib.import_module(root + ".textures")


def _jnp():
    """jax.numpy, imported where a test needs it: the card's machine, which
    runs the CUDA tests of test_torch_megakernel.py on these scenes, has no
    jax."""
    import jax.numpy as jnp

    return jnp


def flatten_jax(prepared):
    from test_torch_prepare import flatten_jax as flatten

    return flatten(prepared)


def _assert_tables_equal(got, ref):
    from test_torch_prepare import _assert_tables_equal as assert_equal

    assert_equal(got, ref)


def _jprepare(scene, **kw):
    from echorenderer_tpu.scene.prepare import prepare_scene

    return prepare_scene(scene, **kw)


# ---------------------------------------------------------------------------
# scenes, built with either package ("jax" or "torch")
# ---------------------------------------------------------------------------


def showcase(pkg):
    """scenes/showcase.echo: the JAX package loads the file, the port builds
    chip_smoke.py's transcription."""
    if pkg == "jax":
        from echorenderer_tpu.io.echo_dsl import EchoSource
        from echorenderer_tpu.scene import Scene

        return EchoSource(str(REPO / "scenes" / "showcase.echo")).construct_first(Scene)
    sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke.showcase_scene()


def textured(pkg):
    """tests/test_megakernel.py's `_textured_scene`: a cloud-textured plane,
    a gradient-textured box and an untextured emitter."""
    sc, tx = _pkg(pkg)
    scene = sc.Scene()
    scene.add(sc.PlaneEntity(size=(10, 10), material=sc.Diffuse(albedo=tx.CloudTexture(scale=4.0,
                                                                                       seed=5))))
    scene.add(sc.BoxEntity(size=(1.5, 2.0, 1.5), position=(0, 1.0, 1.0), material=sc.Diffuse(
        albedo=tx.GradientTexture(start=(0.1, 0.2, 0.7), end=(0.9, 0.8, 0.3), axis=1))))
    scene.add(sc.PlaneEntity(size=(3, 3), material=sc.Emissive(albedo=(12.0, 11.0, 10.0)),
                             position=(0, 6, 0), rotation=(180, 0, 0)))
    cam = sc.PerspectiveCamera(field_of_view=45.0, position=(0, 2.5, -6))
    cam.look_at((0, 1, 0))
    scene.add(cam)
    return scene


def sphere_texture(pkg):
    """tests/test_megakernel.py's sphere-texture scene: equirectangular
    sphere uv."""
    sc, tx = _pkg(pkg)
    scene = sc.Scene()
    scene.add(sc.SphereEntity(radius=1.0, position=(0, 1, 0), material=sc.Diffuse(
        albedo=tx.GradientTexture(start=(0.8, 0.1, 0.1), end=(0.1, 0.1, 0.8), axis=0))))
    scene.add(sc.PlaneEntity(size=(8, 8), material=sc.Diffuse(albedo=(0.6, 0.6, 0.6))))
    scene.add(sc.PlaneEntity(size=(2, 2), material=sc.Emissive(albedo=(15.0, 14.0, 13.0)),
                             position=(0, 5, 0), rotation=(180, 0, 0)))
    cam = sc.PerspectiveCamera(field_of_view=45.0, position=(0, 2, -5))
    cam.look_at((0, 1, 0))
    scene.add(cam)
    return scene


def _ramp(tx):
    """tests/test_rough_texture.py's roughness ramp, 0 -> 1 along u."""
    data = np.linspace(0.0, 1.0, 64, dtype=np.float32)
    return tx.ArrayGrid(np.tile(data[None, :, None], (64, 1, 3)))


def _bumps(tx):
    """A tangent-space normal map: a 16x16 grid of tilted normals."""
    y, x = np.mgrid[0:16, 0:16].astype(np.float32) / 16.0
    rgb = np.stack([0.5 + 0.35 * np.sin(6.0 * x), 0.5 + 0.35 * np.cos(5.0 * y),
                    np.full_like(x, 0.85)], -1)
    return tx.ArrayGrid(rgb.astype(np.float32))


def rough_normal(pkg):
    """A normal-mapped diffuse sphere, a conductor sphere and a conductor
    floor with the roughness ramp, under one emitter: the normal-map and
    roughness stages on sphere and triangle uv."""
    sc, tx = _pkg(pkg)
    ramp = _ramp(tx)
    scene = sc.Scene()
    scene.add(sc.PlaneEntity(size=(8, 8), material=sc.Conductor(albedo=(0.9, 0.8, 0.7),
                                                                roughness=ramp)))
    scene.add(sc.SphereEntity(radius=1.0, position=(-1.1, 1, 0), material=sc.Diffuse(
        albedo=(0.7, 0.6, 0.5), normal=_bumps(tx), normal_intensity=0.8)))
    scene.add(sc.SphereEntity(radius=0.8, position=(1.2, 0.8, 0.3),
                              material=sc.Conductor(albedo=(0.95, 0.7, 0.4), roughness=ramp)))
    scene.add(sc.PlaneEntity(size=(2, 2), material=sc.Emissive(albedo=(14.0, 13.0, 12.0)),
                             position=(0, 5, 0), rotation=(180, 0, 0)))
    scene.add(sc.AmbientLight(intensity=(0.1, 0.1, 0.12)))
    cam = sc.PerspectiveCamera(field_of_view=50.0, position=(0, 2.2, -5))
    cam.look_at((0, 0.8, 0))
    scene.add(cam)
    return scene


def five_textures(pkg):
    """The showcase with a fifth atlas texture: outside the megakernel's
    envelope."""
    if pkg == "torch":
        sys.path.insert(0, str(REPO))
        import chip_smoke

        return chip_smoke.showcase_scene(fifth_texture=True)
    sc, tx = _pkg(pkg)
    scene = showcase(pkg)
    scene.add(sc.SphereEntity(material=sc.Diffuse(albedo=tx.CloudTexture(scale=3.0, seed=9)),
                              radius=0.5, position=(-1.2, 0.5, -1.5)))
    return scene


def hdr_env(pkg):
    """models/scenes.hdr_environment with a 16x8 procedural sky."""
    root = {"jax": "echorenderer_tpu", "torch": "echorenderer_tpu_torch"}[pkg]
    return importlib.import_module(root + ".models.scenes").hdr_environment(resolution=(16, 8))


def _gradient_env(h=16, w=32, top=(2.0, 0.2, 0.2), bottom=(0.1, 0.1, 0.1)):
    v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    img = np.asarray(bottom, np.float32) * (1 - v) + np.asarray(top, np.float32) * v
    return np.broadcast_to(img, (h, w, 3)).copy()


def two_env(pkg, constant=False):
    """tests/test_multi_env.py's two textured ambient lights, the second
    rotated (the mixture branch); `constant` adds a constant ambient."""
    sc, tx = _pkg(pkg)
    s = sc.Scene()
    s.add(sc.SphereEntity(radius=0.7, material=sc.Diffuse(albedo=(0.7, 0.7, 0.7))))
    s.add(sc.PlaneEntity(size=(6, 6), position=(0, -0.7, 0),
                         material=sc.Diffuse(albedo=(0.5, 0.5, 0.5))))
    s.add(sc.AmbientLight(intensity=(1, 1, 1),
                          texture=tx.CylindricalTexture(_gradient_env(top=(2.5, 0.3, 0.2)))))
    s.add(sc.AmbientLight(intensity=(0.8, 0.9, 1.0), directly_visible=False,
                          texture=tx.CylindricalTexture(_gradient_env(top=(0.2, 0.4, 2.5))),
                          rotation=(0.0, 90.0, 0.0)))
    if constant:
        s.add(sc.AmbientLight(intensity=(0.05, 0.06, 0.07)))
    cam = sc.PerspectiveCamera(field_of_view=45.0, position=(0, 0.4, -2.4))
    cam.look_at((0, 0, 0))
    s.add(cam)
    return s


SCENES = {
    "showcase": showcase,
    "textured": textured,
    "sphere_texture": sphere_texture,
    "rough_normal": rough_normal,
    "five_textures": five_textures,
    "hdr_environment": hdr_env,
    "two_env": two_env,
    "two_env_constant": lambda pkg: two_env(pkg, constant=True),
}
TEXTURED = ["showcase", "textured", "sphere_texture", "rough_normal"]
ENV = ["hdr_environment", "two_env", "two_env_constant"]


def pair(name):
    """The JAX scene and the port's, each prepared from its own package's
    description."""
    return _jprepare(SCENES[name]("jax")), tprepare(SCENES[name]("torch"), device="cpu")


def carried(name):
    """The JAX scene and the port's scene built from its tables."""
    jscene = _jprepare(SCENES[name]("jax"))
    return jscene, from_jax_arrays(flatten_jax(jscene), device="cpu")


# ---------------------------------------------------------------------------
# texture data and grid sampling (tests/test_textures.py TestGrids,
# TestProcedural, TestDirectional)
# ---------------------------------------------------------------------------

TEXTURES = {
    "pure": lambda tx: tx.Pure((0.25, 0.5, 0.75)),
    "array_gray": lambda tx: tx.ArrayGrid(np.random.RandomState(1).uniform(size=(5, 7))),
    "array_rgb": lambda tx: tx.ArrayGrid(np.random.RandomState(2).uniform(size=(6, 4, 3))),
    "gradient_u": lambda tx: tx.GradientTexture(start=(0, 0.2, 0.4), end=(1, 0.5, 0.1), axis=0),
    "gradient_v": lambda tx: tx.GradientTexture(start=(0.3, 0, 0), end=(0.1, 1, 1), axis=1,
                                                resolution=32),
    "cacheable": lambda tx: tx.CacheableTexture(lambda u, v: np.stack([u, v, u * v], -1),
                                                resolution=(24, 16)),
    "cloud": lambda tx: tx.CloudTexture(scale=5.0, seed=4, resolution=(48, 40)),
}


@pytest.mark.parametrize("name", list(TEXTURES))
def test_texture_data_matches_jax(name):
    a = TEXTURES[name](_pkg("jax")[1])
    b = TEXTURES[name](ttx)
    np.testing.assert_array_equal(b.data(), a.data())
    np.testing.assert_array_equal(b.average(), a.average())


def test_procedural_matches_jax():
    from echorenderer_tpu.textures import procedural as jproc

    x, y = np.meshgrid(np.linspace(-3, 8, 64), np.linspace(0, 8, 48))
    for seed in (0, 3):
        np.testing.assert_array_equal(ttx.simplex_noise(x, y, seed), jproc.simplex_noise(x, y, seed))
        np.testing.assert_array_equal(ttx.fbm_noise(x, y, octaves=5, seed=seed),
                                      jproc.fbm_noise(x, y, octaves=5, seed=seed))
    n = ttx.simplex_noise(x, y, seed=3)
    assert n.min() >= -1.01 and n.max() <= 1.01 and n.std() > 0.05
    stops = [(0.0, (0, 0, 0)), (0.4, (1, 0.5, 0)), (1.0, (1, 0, 0))]
    t = np.linspace(-0.2, 1.2, 29)
    np.testing.assert_array_equal(ttx.Gradient(stops)(t), jproc.Gradient(stops)(t))
    np.testing.assert_allclose(ttx.Gradient([(0.0, (0, 0, 0)), (1.0, (1, 0, 0))])(0.5)[:3],
                               [0.5, 0, 0], atol=1e-6)


@pytest.mark.parametrize("wrap", ["clamp", "repeat", "mirror"])
@pytest.mark.parametrize("filt", ["point", "bilinear"])
def test_sample_uv_matches_jax(wrap, filt):
    jnp = _jnp()
    rs = np.random.RandomState(7)
    data = rs.uniform(size=(5, 7, 4)).astype(np.float32)
    uv = rs.uniform(-1.5, 2.5, (512, 2)).astype(np.float32)
    jg = _pkg("jax")[1].ArrayGrid(data, wrap=wrap, filter=filt).prepare()
    tg = ttx.ArrayGrid(data, wrap=wrap, filter=filt).prepare()
    assert (tg.wrap, tg.filter) == (jg.wrap, jg.filter)
    want = np.asarray(jg.sample_uv(jnp.asarray(uv)))
    got = tg.sample_uv(torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_wrap_index_floor_mod():
    i = torch.arange(-9, 10)
    n = 4
    np.testing.assert_array_equal(ttx.grids._wrap_index(i, n, ttx.REPEAT).numpy(),
                                  np.arange(-9, 10) % n)
    mirror = ttx.grids._wrap_index(i, n, ttx.MIRROR).numpy()
    assert mirror.min() == 0 and mirror.max() == n - 1
    np.testing.assert_array_equal(mirror[9:17], [0, 1, 2, 3, 3, 2, 1, 0])
    np.testing.assert_array_equal(ttx.grids._wrap_index(i, n, ttx.CLAMP).numpy(),
                                  np.clip(np.arange(-9, 10), 0, n - 1))


def test_grid_examples():
    """tests/test_textures.py TestGrids on the port."""
    np.testing.assert_allclose(ttx.Pure((0.25, 0.5, 0.75)).average()[:3], [0.25, 0.5, 0.75])
    tex = ttx.ArrayGrid(np.asarray([[[0.0, 0, 0, 1], [1.0, 1, 1, 1]]]), wrap="clamp")
    np.testing.assert_allclose(tex.sample_uv([[0.5, 0.5]]).numpy()[0, :3], [0.5] * 3, atol=1e-6)
    arr = np.zeros((1, 4, 4), np.float32)
    arr[0, :, 0] = np.arange(4)
    u = [[1.1, 0.5]]  # past the right edge
    assert float(ttx.ArrayGrid(arr, wrap="repeat", filter="point").sample_uv(u)[0, 0]) == 0.0
    assert float(ttx.ArrayGrid(arr, wrap="clamp", filter="point").sample_uv(u)[0, 0]) == 3.0
    g = ttx.GradientTexture(start=(0, 0, 0), end=(1, 1, 1), axis=0)
    assert float(g.sample_uv([[0.01, 0.5]])[0, 0]) < 0.05
    assert float(g.sample_uv([[0.99, 0.5]])[0, 0]) > 0.95


def test_image_files_wait_for_the_loaders(tmp_path):
    """ImportGrid and an hdr_environment sky read from a file waited for
    io/images.py, which the port now has: both read the file, lazily
    (tests/test_torch_io.py holds their tables to the JAX package's)."""
    from echorenderer_tpu_torch.io import images

    img = _env_img()
    images.save(tmp_path / "sky.hdr", img)
    grid = ttx.ImportGrid(tmp_path / "missing.hdr")  # nothing read yet
    grid.path = str(tmp_path / "sky.hdr")
    np.testing.assert_array_equal(grid.data(), images.load(tmp_path / "sky.hdr"))
    sky = next(e for e in tscenes.hdr_environment(hdr_path=tmp_path / "sky.hdr").children
               if getattr(e, "texture", None) is not None).texture
    np.testing.assert_array_equal(sky.data(), grid.data()[..., :3])


def _env_img():
    img = np.full((32, 64, 3), 0.1, np.float32)
    img[24:, :, :] = [5.0, 4.0, 3.0]  # a bright band near the top
    return img


DIRECTIONAL = {
    "cylindrical": lambda tx: tx.CylindricalTexture(_env_img()),
    "colorful": lambda tx: tx.ColorfulDirectionalTexture(),
    "cubemap": lambda tx: tx.Cubemap(
        [np.random.RandomState(10 + f).uniform(0, 2, (8, 8, 3)).astype(np.float32)
         for f in range(6)], resolution=(64, 32)),
}


def _dirs(n, seed):
    d = np.random.RandomState(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", list(DIRECTIONAL))
def test_directional_matches_jax(name):
    jnp = _jnp()
    jenv = DIRECTIONAL[name](_pkg("jax")[1])
    tenv = DIRECTIONAL[name](ttx)
    np.testing.assert_array_equal(tenv.data(), jenv.data())
    j, t = jenv.prepare(), tenv.prepare()
    np.testing.assert_array_equal(t.grid.texels.numpy(), np.asarray(j.grid.texels))
    assert (t.grid.wrap, t.grid.filter, t.grid.wrap_v) == (j.grid.wrap, j.grid.filter,
                                                           j.grid.wrap_v)
    for field in t.dist._fields:
        np.testing.assert_allclose(getattr(t.dist, field).numpy(),
                                   np.asarray(getattr(j.dist, field)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(t.mean_luminance()), float(j.mean_luminance()), rtol=1e-6)
    d = _dirs(1024, 5)
    # radiance at rtol/atol 1e-5: the two frameworks' atan2/arccos can
    # differ by an ulp, which the bilinear weights carry to the texel step
    np.testing.assert_allclose(t.evaluate(torch.as_tensor(d)).numpy(),
                               np.asarray(j.evaluate(jnp.asarray(d))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.pdf(torch.as_tensor(d)).numpy(),
                               np.asarray(j.pdf(jnp.asarray(d))), rtol=1e-4, atol=1e-6)
    u2 = np.random.RandomState(6).uniform(size=(1024, 2)).astype(np.float32)
    td, tpdf = t.sample(torch.as_tensor(u2))
    jd, jpdf = j.sample(jnp.asarray(u2))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-4)
    np.testing.assert_allclose(t.average().numpy(), np.asarray(j.average()), rtol=1e-5)


def test_directional_estimators():
    """tests/test_textures.py TestDirectional on the port: the Monte Carlo
    mean against `average`, the importance-sampled estimate, `pdf` against
    `sample`'s pdf, the octant pattern."""
    from echorenderer_tpu_torch.utils import rng

    env = ttx.CylindricalTexture(_env_img()).prepare()
    stream = lambda n, seed: rng.SampleStream(pixel_id=torch.arange(n), sample_id=0, seed=seed)
    dirs = rng.uniform_sphere(stream(4096, 11).next_2d(0))
    np.testing.assert_allclose(env.evaluate(dirs).numpy().mean(0), env.average().numpy(),
                               rtol=0.15)
    d, pdf = env.sample(stream(8192, 13).next_2d(1))
    lum = env.evaluate(d).numpy().mean(-1)
    est = (lum / np.maximum(pdf.numpy(), 1e-12)).mean() / (4 * np.pi)
    np.testing.assert_allclose(est, env.average().numpy().mean(), rtol=0.1)
    d, pdf = env.sample(stream(256, 17).next_2d(2))
    np.testing.assert_allclose(env.pdf(d).numpy(), pdf.numpy(), rtol=1e-3)
    octants = ttx.ColorfulDirectionalTexture().prepare()
    up = octants.evaluate(torch.tensor([[0.0, 1.0, 0.0]])).numpy()
    down = octants.evaluate(torch.tensor([[0.0, -1.0, 0.0]])).numpy()
    assert up[0, 1] > down[0, 1]


# ---------------------------------------------------------------------------
# prepare: the atlas, mat_pack's texture columns, env-map light records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TEXTURED + ["five_textures"] + ENV)
def test_tables_match_jax(name):
    jscene, tscene = pair(name)
    ref, got = flatten_jax(jscene), to_arrays(tscene)
    _assert_tables_equal(got, ref)
    np.testing.assert_array_equal(got["tex_atlas"], ref["tex_atlas"])
    np.testing.assert_array_equal(got["mat_pack"][:, [11, 13, 15]],
                                  ref["mat_pack"][:, [11, 13, 15]])
    assert tscene.materials.tex_flags == jscene.materials.tex_flags
    assert len(tscene.env_maps) == len(jscene.env_maps)
    if name in ENV:
        assert any(k.startswith("env_maps.0.") for k in got)
    else:
        assert tscene.tex_atlas.shape[0] == {"showcase": 4, "textured": 2, "sphere_texture": 1,
                                             "rough_normal": 2, "five_textures": 5}[name]


@pytest.mark.parametrize("name", ["rough_normal", "two_env_constant"])
def test_from_jax_arrays_carries_textures_and_env_maps(name):
    jscene, tscene = carried(name)
    ref = flatten_jax(jscene)
    got = to_arrays(tscene)
    _assert_tables_equal(got, ref)
    assert got.keys() == to_arrays(tprepare(SCENES[name]("torch"), device="cpu")).keys()
    assert tscene.materials.tex_flags == jscene.materials.tex_flags
    for tenv, jenv in zip(tscene.env_maps, jscene.env_maps):
        assert tenv.grid.wrap_v == jenv.grid.wrap_v and tenv.dist.shape == jenv.dist.shape


# ---------------------------------------------------------------------------
# shading: interact on the same hits, env lights
# ---------------------------------------------------------------------------


def _camera_rays(scene, n, seed):
    """Rays from the scene's camera position toward random points of its
    geometry's box (most hit)."""
    rs = np.random.RandomState(seed)
    g = scene.geometry
    pts = [g.tri_v0.numpy(), (g.tri_v0 + g.tri_e1).numpy(), g.sph_center.numpy()]
    pts = np.concatenate([p.reshape(-1, 3) for p in pts], 0)
    pts = pts[np.abs(pts).max(-1) < 1e6]
    lo, hi = pts.min(0), pts.max(0)
    o = np.broadcast_to(scene.camera.position.numpy(), (n, 3)).astype(np.float32).copy()
    d = (rs.uniform(lo, hi, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("name", TEXTURED)
def test_interact_matches_jax(name):
    jnp = _jnp()
    from echorenderer_tpu.evaluation import scene_ops as jso
    from echorenderer_tpu.ops.intersect import Hit as JHit

    jscene, tscene = carried(name)
    n = 2048
    o, d = _camera_rays(tscene, n, seed=4)
    hit = tso.trace(tscene, torch.as_tensor(o), torch.as_tensor(d), torch.full((n,), 1e30),
                    torch.full((n,), -1, dtype=torch.int32))
    found = hit.prim.numpy() >= 0
    assert found.sum() > 200
    jhit = JHit(*(jnp.asarray(x.numpy()) for x in hit[:3]))
    jc = jso.interact(jscene, jhit, jnp.asarray(o), jnp.asarray(d))
    tc = tso.interact(tscene, hit, torch.as_tensor(o), torch.as_tensor(d))
    sph = found & (hit.prim.numpy() >= tscene.geometry.num_triangles)
    tri = found & ~sph
    for mask, uv_atol, tex_atol in ((tri, 1e-5, 1e-5), (sph, 1e-6, 1e-4)):
        np.testing.assert_allclose(tc.uv.numpy()[mask], np.asarray(jc.uv)[mask], atol=uv_atol)
        for label, got, want in (
                ("albedo", tc.material.albedo, jc.material.albedo),
                ("params", tc.material.params, jc.material.params),
                ("shade_normal", tc.shade_normal, jc.shade_normal)):
            np.testing.assert_allclose(got.numpy()[mask], np.asarray(want)[mask], rtol=1e-5,
                                       atol=tex_atol, err_msg=label)
    np.testing.assert_array_equal(tc.material.type.numpy()[found],
                                  np.asarray(jc.material.type)[found])
    # the stages ran: textured albedos differ from the packed constants
    mrow = tscene.mat_pack[tc.mat_id.long()]
    textured_lane = found & (mrow[:, 11].numpy() >= 0)
    assert (textured_lane.sum() > 50) == tscene.materials.tex_flags[0]
    if tscene.materials.tex_flags[0]:
        assert not np.allclose(tc.material.albedo.numpy()[textured_lane],
                               mrow[:, 0:3].numpy()[textured_lane])
    if name == "rough_normal":
        n_lane = found & (mrow[:, 13].numpy() >= 0)
        r_lane = found & (mrow[:, 15].numpy() >= 0)
        assert n_lane.sum() > 50 and r_lane.sum() > 50
        geo = tc.geo_normal.numpy()[n_lane]
        assert np.abs((tc.shade_normal.numpy()[n_lane] * geo).sum(-1) - 1).max() > 1e-2
        assert np.ptp(tc.material.params.numpy()[r_lane, 0]) > 0.3


def test_sphere_uv_polynomial():
    """The port's sphere uv (the JAX megakernel's polynomial) against the
    JAX wavefront's arctan2/arccos form and the JAX kernel's `_matan2`."""
    jnp = _jnp()
    from echorenderer_tpu.ops.intersect import sphere_uv as jsphere_uv
    from echorenderer_tpu.ops.megakernel import _matan2

    from echorenderer_tpu_torch.ops.intersect import poly_atan2, sphere_uv

    p = _dirs(4096, 8) * 1.7
    r = np.full(4096, 1.7, np.float32)
    got = sphere_uv(torch.as_tensor(p), torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsphere_uv(jnp.asarray(p), jnp.asarray(r))),
                               atol=1e-6)
    y, x = p[:, 0], p[:, 2]
    np.testing.assert_array_equal(poly_atan2(torch.as_tensor(y), torch.as_tensor(x)).numpy(),
                                  np.asarray(_matan2(jnp.asarray(y), jnp.asarray(x))))


def test_sample_atlas_never_wraps_negative_ids():
    """A -1 id reads slice 0 (masked out by the caller), never the last."""
    atlas = torch.zeros((3, 4, 4, 4))
    atlas[0] = 1.0
    atlas[2] = 5.0
    uv = torch.rand(16, 2)
    got = tso._sample_atlas(atlas, torch.full((16,), -1, dtype=torch.int32), uv)
    assert torch.equal(got, torch.ones(16, 3))
    # uv wraps with a floor-mod: u = -0.25 reads as 0.75
    ramp = torch.arange(16.0).reshape(1, 1, 16, 1).expand(1, 16, 16, 4).contiguous()
    a = tso._sample_atlas(ramp, torch.zeros(1, dtype=torch.int32), torch.tensor([[-0.25, 0.5]]))
    b = tso._sample_atlas(ramp, torch.zeros(1, dtype=torch.int32), torch.tensor([[0.75, 0.5]]))
    assert torch.equal(a, b)


def test_rough_texture_varies_per_contact():
    """tests/test_rough_texture.py on the port: a roughness ramp across a
    conductor plane, and a constant roughness left alone."""
    sc, tx = _pkg("torch")
    for rough, check in ((_ramp(tx), "ramp"), (0.3, "constant")):
        scene = sc.Scene()
        scene.add(sc.PlaneEntity(size=(2, 2), material=sc.Conductor(roughness=rough)))
        scene.add(sc.AmbientLight(intensity=(1, 1, 1)))
        scene.add(sc.PerspectiveCamera(position=(0, 2, 0), rotation=(90, 0, 0)))
        prepared = tprepare(scene, device="cpu")
        n = 8
        xs = np.linspace(-0.9, 0.9, n, dtype=np.float32)
        o = torch.as_tensor(np.stack([xs, np.ones(n, np.float32), np.zeros(n, np.float32)], -1))
        d = torch.tensor([[0.0, -1.0, 0.0]]).repeat(n, 1)
        hit = tso.trace(prepared, o, d, torch.full((n,), 10.0), torch.full((n,), -1,
                                                                          dtype=torch.int32))
        assert bool((hit.prim >= 0).all())
        r = tso.interact(prepared, hit, o, d).material.params[:, 0].numpy()
        if check == "ramp":
            assert int(prepared.mat_pack[:, 15].max()) >= 0
            assert r.max() - r.min() > 0.5
            assert (np.diff(r) >= -1e-3).all() or (np.diff(r) <= 1e-3).all()
        else:
            np.testing.assert_allclose(r, 0.3, rtol=1e-5)


@pytest.mark.parametrize("name", ENV)
def test_env_lights_match_jax(name):
    jnp = _jnp()
    from echorenderer_tpu.evaluation import scene_ops as jso

    jscene, tscene = carried(name)
    n = 2048
    d = _dirs(n, 9)
    for visible in (True, False):
        np.testing.assert_allclose(
            tso.eval_infinite(tscene, torch.as_tensor(d), visible).numpy(),
            np.asarray(jso.eval_infinite(jscene, jnp.asarray(d), visible)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tso.env_pdf(tscene, torch.as_tensor(d)).numpy(),
                               np.asarray(jso.env_pdf(jscene, jnp.asarray(d))), rtol=1e-4)
    # NEE toward every light record from points above the floor
    rs = np.random.RandomState(12)
    x = rs.uniform([-2, 0.05, -2], [2, 2, 2], (n, 3)).astype(np.float32)
    rec = (np.arange(n) % tscene.lights.num_lights).astype(np.int32)
    u2 = rs.uniform(size=(n, 2)).astype(np.float32)
    js = jso.sample_light(jscene, jnp.asarray(rec), jnp.asarray(x), jnp.asarray(u2))
    ts = tso.sample_light(tscene, torch.as_tensor(rec), torch.as_tensor(x), torch.as_tensor(u2))
    for field in ("target_prim", "use_mis"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(), np.asarray(getattr(js, field)))
    for field in ("radiant", "incident", "travel", "pdf"):
        np.testing.assert_allclose(getattr(ts, field).numpy(), np.asarray(getattr(js, field)),
                                   rtol=1e-4 if field == "pdf" else 1e-5, atol=1e-6,
                                   err_msg=field)
    # the mixture pdf integrates to 1 over the sphere
    from echorenderer_tpu_torch.utils import rng

    u = rng.SampleStream(pixel_id=torch.arange(65536), sample_id=0, seed=3).next_2d(0)
    mc = float((tso.env_pdf(tscene, rng.uniform_sphere(u)) * 4 * math.pi).mean())
    assert abs(mc - 1.0) < 0.05


# ---------------------------------------------------------------------------
# the wavefront (the megakernel's plain version) against the JAX wavefront
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["textured", "sphere_texture", "rough_normal", "hdr_environment",
                                  "two_env"])
def test_wavefront_matches_jax(name):
    jnp = _jnp()
    from echorenderer_tpu.evaluation.wavefront import sample_frame_wavefront as jwavefront

    jscene, tscene = carried(name)
    n, res = 1024, (32, 32)
    pid = np.arange(n, dtype=np.uint32)
    pxy = np.stack([pid % res[0], pid // res[0]], -1).astype(np.int32)
    kw = dict(bounce_limit=3, survivability=2.5)
    a, a2 = jwavefront(jscene, jnp.asarray(pid), jnp.asarray(pxy), res, 11, jnp.uint32(0), 2, **kw)
    b, b2 = sample_frame_wavefront(tscene, torch.as_tensor(pid.astype(np.int64)),
                                   torch.as_tensor(pxy), res, 11, 0, 2, **kw)
    a, a2, b, b2 = np.asarray(a), np.asarray(a2), b.numpy(), b2.numpy()
    assert a.sum() > 0
    np.testing.assert_allclose(b, a, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(b2, a2, atol=4e-2, rtol=2e-3)
    # mean images to 1e-5, or 5e-5 under an env map: its lookups' atan2 and
    # arccos differ by ulps between the frameworks (module doc), and
    # hdr_environment's sun (radiance 900) carries that into the mean
    mean_rtol = 5e-5 if name in ENV else 1e-5
    np.testing.assert_allclose(b.mean(0), a.mean(0), atol=1e-5, rtol=mean_rtol)


# ---------------------------------------------------------------------------
# textured TLAS scenes
# ---------------------------------------------------------------------------


def textured_packs(pkg):
    """instanced_grid-style: one pack of a gradient-textured sphere and a
    normal-mapped one, placed four times with a swatch on two, on a
    cloud-textured floor under an env map."""
    sc, tx = _pkg(pkg)
    base = sc.Diffuse(albedo=tx.GradientTexture(start=(0.9, 0.2, 0.1), end=(0.1, 0.3, 0.9)))
    pack = sc.EntityPack()
    pack.add(sc.SphereEntity(radius=0.5, material=base))
    pack.add(sc.SphereEntity(radius=0.22, position=(0, 0.75, 0), material=sc.Diffuse(
        albedo=(0.8, 0.8, 0.7), normal=_bumps(tx))))
    scene = sc.Scene()
    scene.add(sc.PlaneEntity(size=(12, 12), material=sc.Diffuse(albedo=tx.CloudTexture(seed=2))))
    swap = sc.Diffuse(albedo=tx.CloudTexture(scale=2.0, seed=8, resolution=(32, 32)))
    for i in range(4):
        scene.add(sc.PackInstance(pack, material_swatch={base: swap} if i % 2 else None,
                                  position=(2.0 * i - 3.0, 0.5, 0.3 * i), scale=0.8 + 0.1 * i,
                                  rotation=(0, 25 * i, 0)))
    scene.add(sc.AmbientLight(intensity=(0.6, 0.6, 0.6),
                              texture=tx.CylindricalTexture(_gradient_env(top=(1.5, 1.2, 1.0)))))
    cam = sc.PerspectiveCamera(field_of_view=55.0, position=(0, 3.5, -7.5))
    cam.look_at((0, 0.4, 0))
    scene.add(cam)
    return scene


def test_textured_tlas_matches_jax():
    """Tables, the megakernel's refusal and `interact` on the same
    instanced hits (the port's walk's, fed to both packages)."""
    jnp = _jnp()
    from echorenderer_tpu.evaluation import scene_ops as jso
    from echorenderer_tpu.ops.intersect import Hit as JHit
    from echorenderer_tpu.ops import megakernel as jmk

    from test_torch_instancing import _jprepare as jprepare_numpy_bvh
    from test_torch_instancing import _zero_area_edges_zeroed

    jscene = jprepare_numpy_bvh(textured_packs("jax"), instancing="tlas")
    tscene = tprepare(textured_packs("torch"), instancing="tlas", device="cpu")
    ref = _zero_area_edges_zeroed(flatten_jax(jscene))
    got = to_arrays(tscene)
    _assert_tables_equal(got, ref)
    np.testing.assert_array_equal(got["tex_atlas"], ref["tex_atlas"])
    assert tscene.tex_atlas.shape[0] == 4 and len(tscene.env_maps) == 1
    assert tmk.unsupported_reason(tscene) == "TLAS instancing"
    assert not jmk.supported(jscene)
    carried_t = from_jax_arrays(flatten_jax(jscene), device="cpu")
    n = 2048
    o, d = _camera_rays(carried_t, n, seed=6)
    hit = tso.trace(carried_t, torch.as_tensor(o), torch.as_tensor(d), torch.full((n,), 1e30),
                    torch.full((n,), -1, dtype=torch.int32))
    found = hit.prim.numpy() >= 0
    assert found.sum() > 200 and len(np.unique(hit.inst.numpy()[found])) >= 4
    jhit = JHit(*(jnp.asarray(x.numpy()) for x in hit))
    jc = jso.interact(jscene, jhit, jnp.asarray(o), jnp.asarray(d))
    tc = tso.interact(carried_t, hit, torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(tc.mat_id.numpy()[found], np.asarray(jc.mat_id)[found])
    # spheres only in the packs: sphere uv's polynomial tolerance (module doc)
    for label, got_v, want in (("albedo", tc.material.albedo, jc.material.albedo),
                               ("shade_normal", tc.shade_normal, jc.shade_normal)):
        np.testing.assert_allclose(got_v.numpy()[found], np.asarray(want)[found], rtol=1e-5,
                                   atol=1e-4, err_msg=label)
