"""PyTorch port: TLAS instancing against the JAX package.

- Prepare: `prepare_scene(..., instancing="tlas")` builds the JAX package's
  tables, table for table (integers exact, floats to rtol/atol 1e-6):
  instanced_grid(side=2), the nested-pack scene of tests/test_instancing.py,
  a mixed triangle/sphere pack of three chunks under rotations and scales,
  and an emissive pack with a swatch. The auto-bake rule, the O(pack)
  storage of 1,000 instances and `from_jax_arrays` carry over.
- The sphere test of rays in an instance's space (|d| = 1/scale: the full
  quadratic) against the JAX `_chunk_hits(..., unit_dir=False)`: t to
  SPHERE_RTOL (5e-5, the binned tests' sphere tolerance: XLA fuses
  multiply-adds in -b - sqrt(disc)), hits identical.
- Kernel 4, instanced (the plain walk here): `intersect_hier` /
  `occlude_hier` against the JAX functions, whose Pallas kernel runs in
  interpret mode, on the same tables and 4,096 rays, with and without
  per-instance ignores: prims and instances identical, t to rtol 1e-5
  (triangles) and SPHERE_RTOL (spheres), flags identical; triangle
  barycentrics to UV_ATOL (2e-4): the ray enters the instance's space
  before the triple products, and on the mixed pack's small mesh triangles
  both packages' float32 u, v lie up to 9e-5 from a float64 evaluation
  (measured), so they differ by as much from each other.
- Kernel 7 instanced, the binned traversal and the wavefront against the
  JAX package: tests/test_torch_instancing_binned.py.
- Shading: `interact`, `sample_light`, `area_light_pdf` and
  `hit_light_record` on the same instanced hits of an emissive scene (the
  port's walk's, fed to both packages), to rtol 1e-5; solid-angle pdfs,
  which divide by a cosine, to rtol 1e-4.
- The slice: TLAS against bake (tests/test_instancing.py's bound), the
  dispatch.
- The CUDA kernels are held to their plain versions on the card:

    python -m pytest --noconftest tests/test_torch_instancing.py -k cuda
"""

import numpy as np
import pytest
import torch

import echorenderer_tpu_torch.scene as tsc
from echorenderer_tpu_torch.evaluation import scene_ops as tscene_ops
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.ops import binned_trace as bt
from echorenderer_tpu_torch.ops import megakernel as tmk
from echorenderer_tpu_torch.ops import pallas_hier as ph
from echorenderer_tpu_torch.ops import pallas_intersect as tpi
from echorenderer_tpu_torch.ops.intersect import Hit
from echorenderer_tpu_torch.scene.convert import from_jax_arrays, to_arrays
from echorenderer_tpu_torch.scene.prepare import prepare_scene as tprepare


torch.set_num_threads(1)

SPHERE_RTOL = 5e-5
TRI_RTOL = 1e-5
UV_ATOL = 2e-4
N_RAYS = 4096


def _jax():
    import jax.numpy as jnp

    from echorenderer_tpu.evaluation import scene_ops as jso
    from echorenderer_tpu.ops import binned_trace as jbt
    from echorenderer_tpu.ops import pallas_hier as jph

    return jnp, jso, jbt, jph, _jprepare


def _jsc():
    """The JAX package's scene module (imported here: the card's machine,
    which runs the CUDA tests, has no jax)."""
    import echorenderer_tpu.scene as jsc

    return jsc


def _prep():
    import test_torch_prepare

    return test_torch_prepare


def _jprepare(scene, **kw):
    """The JAX package's prepare with its numpy BVH builder, the oracle of
    its C++ one (which picks other splits on near-equal SAH costs of the
    mesh; the port's builder is the numpy one, tests/test_torch_hier.py)."""
    import echorenderer_tpu.native as jnative
    from echorenderer_tpu.scene.prepare import prepare_scene

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "build_bvh_native", lambda *args: None)
        return prepare_scene(scene, **kw)


# ---------------------------------------------------------------------------
# scenes, built with either package's scene module `m`
# ---------------------------------------------------------------------------

_MESH = tscenes.sphere_grid_mesh(2, 8)  # 4 UV spheres, 512 triangles


def _two_spheres(m):
    pack = m.EntityPack()
    pack.add(m.SphereEntity(radius=0.5, material=m.Diffuse(albedo=(0.9, 0.2, 0.2))))
    pack.add(m.SphereEntity(radius=0.25, material=m.Diffuse(albedo=(0.2, 0.2, 0.9)),
                            position=(0, 0.9, 0)))
    return pack


def _nested(m):
    """tests/test_instancing.py's nested packs: an inner pack placed directly
    and inside an outer pack placed twice."""
    inner = _two_spheres(m)
    outer = m.EntityPack()
    outer.add(m.SphereEntity(radius=0.3, material=m.Diffuse(albedo=(0.9, 0.9, 0.2))))
    outer.add(m.PackInstance(inner, position=(0, 1.2, 0), scale=0.5))
    scene = m.Scene()
    scene.add(m.PackInstance(inner, position=(-3, 0, 0)))
    scene.add(m.PackInstance(outer, position=(0, 0, 0)))
    scene.add(m.PackInstance(outer, position=(3, 0, 0), scale=0.8))
    scene.add(m.AmbientLight(intensity=(1, 1, 1)))
    scene.add(m.PerspectiveCamera(position=(0, 0, -8)))
    return scene


# placements of the mixed pack: tests/test_binned_trace.py's three, then
# random ones
_PLACES = [((-1.6, 0, 0), 1.0, (0, 0, 0)), ((1.4, 0.2, 0.5), 0.6, (0, 40, 0)),
           ((0, -1.0, 1.0), 1.3, (25, 0, 10))]


def _mixed(m, count=3, seed=4):
    """A pack of a box, a sphere and a 512-triangle mesh (3 chunks), placed
    `count` times under rotations and scales, on a ground plane."""
    pack = m.EntityPack()
    pack.add(m.BoxEntity(size=(0.8, 0.6, 0.4), material=m.Diffuse(albedo=(0.8, 0.5, 0.2))))
    pack.add(m.SphereEntity(radius=0.35, material=m.Diffuse(albedo=(0.2, 0.6, 0.9)),
                            position=(0, 0.9, 0)))
    pack.add(m.MeshEntity(vertices=_MESH[0] * 0.15 + [0.2, -0.2, -0.5], faces=_MESH[1],
                          material=m.Diffuse(albedo=(0.6, 0.6, 0.6))))
    rs = np.random.RandomState(seed)
    places = list(_PLACES)
    while len(places) < count:
        places.append((tuple(rs.uniform(-4, 4, 3)), float(rs.uniform(0.5, 1.4)),
                       tuple(rs.uniform(-60, 60, 3))))
    scene = m.Scene()
    scene.add(m.PlaneEntity(size=(20, 20), position=(0, -2.5, 0),
                            material=m.Diffuse(albedo=(0.5, 0.5, 0.5))))
    for pos, s, rot in places[:count]:
        scene.add(m.PackInstance(pack, position=pos, scale=s, rotation=rot))
    scene.add(m.AmbientLight(intensity=(0.6, 0.7, 0.8)))
    cam = m.PerspectiveCamera(field_of_view=60, position=(0, 0.5, -7))
    cam.look_at((0, 0, 0))
    scene.add(cam)
    return scene


def _emissive(m):
    """An emissive sphere and an emissive quad in a pack with a diffuse
    sphere, placed twice (one swatch, scales 1 and 0.6), over a floor."""
    glow = m.Emissive(albedo=(4, 3, 2))
    grey = m.Diffuse(albedo=(0.7, 0.7, 0.7))
    pack = m.EntityPack()
    pack.add(m.SphereEntity(radius=0.3, material=glow, position=(0, 1.0, 0)))
    pack.add(m.PlaneEntity(size=(0.6, 0.6), material=m.Emissive(albedo=(1, 2, 3)),
                           position=(0, 1.6, 0), rotation=(180, 0, 0)))
    pack.add(m.SphereEntity(radius=0.5, material=grey))
    scene = m.Scene()
    scene.add(m.PlaneEntity(size=(12, 12), position=(0, -0.5, 0), material=grey))
    scene.add(m.PackInstance(pack, position=(-1.2, 0, 0), rotation=(0, 30, 0)))
    scene.add(m.PackInstance(pack, position=(1.2, 0, 0.4), scale=0.6,
                             material_swatch={grey: m.Diffuse(albedo=(0.2, 0.8, 0.3))}))
    cam = m.PerspectiveCamera(field_of_view=60, position=(0, 1.0, -5))
    cam.look_at((0, 0.3, 0))
    scene.add(cam)
    return scene


def _grid(m):
    if m is tsc:
        return tscenes.instanced_grid(side=2)
    from echorenderer_tpu.models import scenes as jscenes

    return jscenes.instanced_grid(side=2)


SCENES = {"grid": _grid, "nested": _nested, "mixed": _mixed, "emissive": _emissive}


def _pair(maker, instancing="tlas"):
    """The JAX scene and the port's, prepared from the same description."""
    return _jax()[4](maker(_jsc()), instancing=instancing), tprepare(maker(tsc),
                                                                 instancing=instancing,
                                                                 device="cpu")


@pytest.fixture(scope="module")
def mixed():
    jscene = _jax()[4](_mixed(_jsc()), instancing="tlas")
    return jscene, from_jax_arrays(_prep().flatten_jax(jscene), device="cpu")


def _scene_rays(scene, n, seed, spread=4.0):
    """Rays through an instanced scene: origins in its world box, half
    aimed at the instances' world boxes, a sixteenth dead, a quarter with a
    finite t_max."""
    rs = np.random.RandomState(seed)
    wcb = scene.hier_soa.binned_wcb.cpu().numpy()
    real = (wcb[:, 0] <= wcb[:, 3]) & (wcb[:, 3] < 1e6)  # not padding, nor the stand-in triangle
    lo, hi = wcb[real, 0:3].min(0), wcb[real, 3:6].max(0)
    o = rs.uniform(lo - spread, hi + spread, (n, 3)).astype(np.float32)
    aim = wcb[real][rs.randint(0, real.sum(), n)]
    tgt = rs.uniform(aim[:, 0:3], aim[:, 3:6]).astype(np.float32)
    d = np.where(rs.uniform(size=(n, 1)) < 0.5, tgt - o, rs.normal(size=(n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(n, np.inf, np.float32)
    finite = rs.uniform(size=n) < 0.25
    t_max[finite] = rs.uniform(0.5, 8.0, n)[finite]
    t_max[: n // 16] = 0.0
    return o, d, t_max


def _zero_area_edges_zeroed(tables):
    """The JAX tables with the edges of zero-area triangles zeroed in the
    chunk rows, as the port packs them (`pallas_intersect.pack_sorted_prims`;
    tests/test_torch_hier.py): the mesh's pole triangles."""
    out = dict(tables)
    chunks = np.array(tables["hier_soa.prim_chunks"])
    b, c = chunks[:, 3:6].transpose(0, 2, 1), chunks[:, 6:9].transpose(0, 2, 1)
    flat = (chunks[:, 9] < 0.5) & (np.cross(b, c) == 0.0).all(-1)
    chunks[:, 3:9] = np.where(flat[:, None, :], np.float32(0.0), chunks[:, 3:9])
    out["hier_soa.prim_chunks"] = chunks
    return out


def _assert_hits_close(got: Hit, ref, num_tris, uv_atol=UV_ATOL):
    """Identical prims and instances, t to TRI_RTOL / SPHERE_RTOL."""
    rp = np.asarray(ref.prim)
    np.testing.assert_array_equal(got.prim.numpy(), rp)
    np.testing.assert_array_equal(got.inst.numpy(), np.asarray(ref.inst))
    tri = (rp >= 0) & (rp < num_tris)
    sph = rp >= num_tris
    np.testing.assert_allclose(got.t.numpy()[tri], np.asarray(ref.t)[tri], rtol=TRI_RTOL)
    np.testing.assert_allclose(got.t.numpy()[sph], np.asarray(ref.t)[sph], rtol=SPHERE_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(got.uv.numpy()[tri], np.asarray(ref.uv)[tri], atol=uv_atol)


# ---------------------------------------------------------------------------
# prepare
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENES))
def test_tables_match_jax(name):
    jscene, tscene = _pair(SCENES[name])
    got = to_arrays(tscene)
    assert tscene.prim_soa is None and tscene.instances is not None
    assert {"instances.rows", "instances.mat_remap", "hier_soa.inst_f32",
            "hier_soa.binned_wcb"} <= got.keys()
    assert not any(k.startswith("prim_soa.") for k in got)
    _prep()._assert_tables_equal(got, _zero_area_edges_zeroed(_prep().flatten_jax(jscene)))
    assert tscene.hier_soa.instanced and tscene.hier_soa.stack_size <= ph.MAX_STACK
    assert all(t.device.type == "cpu" for t in tscene.instances[:3])


def test_nested_instances_expand():
    _, tscene = _pair(_nested)
    # root + inner (direct) + outer x2 + inner (nested) x2; one storage copy
    assert tscene.instances.num_instances == 6
    assert tscene.geometry.num_spheres == 3


def test_auto_bake_rule():
    # small: "auto" bakes, "tlas" keeps the TLAS
    baked = tprepare(tscenes.instanced_grid(side=2), device="cpu")
    assert baked.instances is None and baked.geometry.num_spheres == 8
    # tests/test_instancing.py's large auto scene stays TLAS (2,400 unrolled prims)
    pack = tsc.EntityPack()
    for i in range(40):
        pack.add(tsc.SphereEntity(radius=0.1, position=(i * 0.3, 0, 0)))
    scene = tsc.Scene()
    for i in range(60):
        scene.add(tsc.PackInstance(pack, position=(0, 0, i * 0.5)))
    scene.add(tsc.PerspectiveCamera(position=(0, 0, -5)))
    auto = tprepare(scene, device="cpu")
    assert auto.instances is not None and auto.geometry.num_spheres == 40
    assert tprepare(scene, instancing="bake", device="cpu").geometry.num_spheres == 2400


def _thousand(m):
    """tests/test_instancing.py's 1,000 placements of the two-sphere pack."""
    pack = _two_spheres(m)
    scene = m.Scene()
    rs = np.random.RandomState(7)
    for _ in range(1000):
        scene.add(m.PackInstance(pack, position=tuple(rs.uniform(-50, 50, 3)),
                                 scale=float(rs.uniform(0.5, 1.5))))
    scene.add(m.AmbientLight(intensity=(1, 1, 1)))
    scene.add(m.PerspectiveCamera(position=(0, 0, -120)))
    return scene


@pytest.fixture(scope="module")
def thousand():
    return tprepare(_thousand(tsc), instancing="tlas", device="cpu")


def test_thousand_instances_o_pack_memory(thousand):
    """1,000 placements prepare in O(pack) storage, with a TLAS deep enough
    to need most of the kernel's stack, and take the binned traversal."""
    assert thousand.geometry.num_spheres == 2 and thousand.geometry.num_triangles == 1
    assert thousand.instances.num_instances == 1001
    assert thousand.instances.rows.shape == (1001, 16)
    soa = thousand.hier_soa
    assert soa.num_chunks == 2 and soa.binned_g2c.shape[0] == 1001 * 16
    assert 20 <= soa.stack_size <= ph.MAX_STACK
    summary = tscene_ops.dispatch_summary(thousand)
    assert summary["accelerator"] == "binned" and summary["integrator"] == "wavefront"


def test_deep_tlas_walk(thousand):
    """The walk of the 1,000-instance TLAS against the binned traversal on
    the same rays: the same hits, instances and flags (band ties counted)."""
    o, d, t_max = _scene_rays(thousand, 1024, seed=3, spread=5.0)
    args = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
            torch.full((1024,), -1, dtype=torch.int32))
    walk = ph.intersect_hier(thousand.geometry, thousand.hier_soa, *args)
    binned = bt.trace_binned(thousand.geometry, thousand.hier_soa, *args)
    found = walk.prim.numpy() >= 0
    assert found.sum() > 100
    np.testing.assert_array_equal(binned.prim.numpy() >= 0, found)
    same = (binned.prim.numpy() == walk.prim.numpy()) & (binned.inst.numpy() == walk.inst.numpy())
    assert (~same[found]).sum() <= 2
    np.testing.assert_array_equal(binned.t.numpy()[same], walk.t.numpy()[same])
    np.testing.assert_array_equal(
        bt.occlude_binned(thousand.geometry, thousand.hier_soa, *args).numpy(),
        ph.occlude_hier(thousand.geometry, thousand.hier_soa, *args).numpy())


def test_from_jax_arrays_carries_instanced_scene(mixed):
    jscene, carried = mixed
    ref = _prep().flatten_jax(jscene)
    got = to_arrays(carried)
    _prep()._assert_tables_equal(got, ref)
    own = to_arrays(tprepare(_mixed(tsc), instancing="tlas", device="cpu"))
    assert got.keys() == own.keys()
    _prep()._assert_tables_equal(own, _zero_area_edges_zeroed(got))
    assert carried.instances.num_materials == jscene.instances.num_materials
    assert carried.hier_soa.root_code == jscene.hier_soa.root_code


def test_dispatch_summary_of_tlas_scene(mixed):
    _, tscene = mixed
    assert tscene.prim_soa is None
    summary = tscene_ops.dispatch_summary(tscene)
    assert summary["accelerator"] in ("hier-packet", "binned")
    assert summary["integrator"] == "wavefront"
    assert tmk.unsupported_reason(tscene) == "TLAS instancing" and not tmk.supported(tscene)
    assert not tscene_ops._use_hier(tscene) and not tscene_ops._use_binned(tscene)


# ---------------------------------------------------------------------------
# the ray-sphere test in an instance's space
# ---------------------------------------------------------------------------


def test_sphere_non_unit_directions_match_jax():
    jnp = _jax()[0]
    from echorenderer_tpu.ops.pallas_intersect import _chunk_hits as jhits

    rs = np.random.RandomState(12)
    p, n = 128, 512
    rows = np.zeros((10, p), np.float32)
    rows[0:3] = rs.uniform(-5, 5, (3, p))
    rows[3] = rs.uniform(0.2, 1.5, p)
    rows[9] = 1.0
    o = rs.uniform(-8, 8, (3, n)).astype(np.float32)
    o[:, : n // 4] = rows[0:3, : n // 4]  # from inside a sphere: findFar under an ignore
    d = rs.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0) * rs.uniform(0.4, 2.5, n).astype(np.float32)  # |d| = 1/scale
    ignore = np.where(np.arange(n) < n // 4, np.arange(n) % p, -1).astype(np.int32)
    t, _, _, ok = tpi._chunk_hits(torch.as_tensor(rows), 0, torch.as_tensor(np.concatenate([o, d])),
                                  torch.as_tensor(ignore), False, True, unit_dir=False)
    jt, _, _, _ = jhits([jnp.asarray(r[None]) for r in rows], 0.0,
                        *(jnp.asarray(x[None]) for x in (*o, *d)),
                        jnp.asarray(ignore[None].astype(np.float32)), False, True, unit_dir=False)
    jt = np.asarray(jt).T  # (n, p)
    jok = jt < 3e38
    np.testing.assert_array_equal(ok.numpy(), jok)
    np.testing.assert_allclose(t.numpy()[jok], jt[jok], rtol=SPHERE_RTOL, atol=1e-6)
    assert jok.sum() > 200
    # a unit direction gives the unit-direction formula's t
    u = d / np.linalg.norm(d, axis=0)
    ray = torch.as_tensor(np.concatenate([o, u]))
    a = tpi._chunk_hits(torch.as_tensor(rows), 0, ray, torch.as_tensor(ignore), False, True)
    b = tpi._chunk_hits(torch.as_tensor(rows), 0, ray, torch.as_tensor(ignore), False, True,
                        unit_dir=False)
    assert torch.equal(a[3], b[3])
    torch.testing.assert_close(a[0][a[3]], b[0][b[3]], rtol=SPHERE_RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# kernel 4 instanced: the walk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def walk_case(mixed):
    """The JAX walk's answers on 4,096 rays through the mixed scene, then
    again with every hit's (prim, instance) ignored."""
    jnp, _, _, jph, _ = _jax()
    jscene, tscene = mixed
    o, d, t_max = _scene_rays(tscene, N_RAYS, seed=5)
    ig = np.full(N_RAYS, -1, np.int32)
    jargs = [jnp.asarray(x) for x in (o, d, t_max, ig)]
    first = jph.intersect_hier(jscene.geometry, jscene.hier_soa, *jargs)
    ig2 = np.asarray(first.prim).astype(np.int32)
    ii2 = np.asarray(first.inst).astype(np.int32)
    second = jph.intersect_hier(jscene.geometry, jscene.hier_soa, *jargs[:3], jnp.asarray(ig2),
                                jnp.asarray(ii2))
    blocked = jph.occlude_hier(jscene.geometry, jscene.hier_soa, *jargs[:2],
                               jnp.asarray(np.minimum(t_max, 3.0)), jnp.asarray(ig2),
                               jnp.asarray(ii2))
    return dict(rays=(o, d, t_max), ig2=ig2, ii2=ii2, first=first, second=second,
                blocked=np.asarray(blocked))


def _targs(o, d, t_max, ig):
    return tuple(torch.as_tensor(x) for x in (o, d, t_max, ig))


def test_walk_matches_jax(mixed, walk_case):
    _, tscene = mixed
    o, d, t_max = walk_case["rays"]
    nt = tscene.geometry.num_triangles
    got = ph.intersect_hier(tscene.geometry, tscene.hier_soa,
                            *_targs(o, d, t_max, np.full(N_RAYS, -1, np.int32)))
    _assert_hits_close(got, walk_case["first"], nt)
    found = got.prim.numpy() >= 0
    assert found.sum() > 1000 and len(np.unique(got.inst.numpy()[found])) == 4
    assert (got.prim.numpy()[found] < nt).any() and (got.prim.numpy()[found] >= nt).any()


def test_walk_per_instance_ignore_matches_jax(mixed, walk_case):
    """Each ray again, ignoring its first hit's (prim, instance): the
    ignore holds only in that instance."""
    _, tscene = mixed
    o, d, t_max = walk_case["rays"]
    args = _targs(o, d, t_max, walk_case["ig2"])
    ii = torch.as_tensor(walk_case["ii2"])
    got = ph.intersect_hier(tscene.geometry, tscene.hier_soa, *args, ii)
    _assert_hits_close(got, walk_case["second"], tscene.geometry.num_triangles)
    first = walk_case["first"]
    tri = (np.asarray(first.prim) >= 0) & (np.asarray(first.prim) < tscene.geometry.num_triangles)
    again = (got.prim.numpy() == np.asarray(first.prim)) & (got.inst.numpy() == walk_case["ii2"])
    assert not (again & tri).any()
    blocked = ph.occlude_hier(tscene.geometry, tscene.hier_soa, *args[:2],
                              torch.as_tensor(np.minimum(t_max, 3.0)), args[3], ii)
    np.testing.assert_array_equal(blocked.numpy(), walk_case["blocked"])
    assert 0 < blocked.sum() < N_RAYS


# ---------------------------------------------------------------------------
# shading on instanced hits
# ---------------------------------------------------------------------------


def test_interact_and_lights_match_jax():
    jnp, jso, _, jph, jprepare = _jax()
    jscene = jprepare(_emissive(_jsc()), instancing="tlas")
    tscene = from_jax_arrays(_prep().flatten_jax(jscene), device="cpu")
    n = 2048
    o, d, t_max = _scene_rays(tscene, n, seed=21, spread=2.0)
    t_max[:] = np.inf
    ig = np.full(n, -1, np.int32)
    jhit = jph.intersect_hier(jscene.geometry, jscene.hier_soa,
                              *(jnp.asarray(x) for x in (o, d, t_max, ig)))
    thit = ph.intersect_hier(tscene.geometry, tscene.hier_soa, *_targs(o, d, t_max, ig))
    _assert_hits_close(thit, jhit, tscene.geometry.num_triangles)
    found = thit.prim.numpy() >= 0
    # both packages shade the same hits: the port's
    from echorenderer_tpu.ops.intersect import Hit as JHit

    jhit = JHit(*(jnp.asarray(x.numpy()) for x in thit))
    jc = jso.interact(jscene, jhit, jnp.asarray(o), jnp.asarray(d))
    tc = tscene_ops.interact(tscene, thit, torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(tc.mat_id.numpy()[found], np.asarray(jc.mat_id)[found])
    for name in ("point", "geo_normal", "shade_normal", "uv"):
        np.testing.assert_allclose(getattr(tc, name).numpy()[found],
                                   np.asarray(getattr(jc, name))[found], rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(tc.material.albedo.numpy()[found],
                               np.asarray(jc.material.albedo)[found])
    assert len(np.unique(tc.mat_id.numpy()[found])) >= 4  # swatch and emitters seen

    # forward MIS: the (prim, instance) light record and its area pdf
    jrec = jso.hit_light_record(jscene, jnp.maximum(jhit.prim, 0), jhit.inst)
    trec = tscene_ops.hit_light_record(tscene, torch.clamp(thit.prim, min=0), thit.inst)
    np.testing.assert_array_equal(trec.numpy()[found], np.asarray(jrec)[found])
    assert (trec.numpy()[found] >= 0).sum() > 20
    prev = np.zeros_like(o)
    jpdf = jso.area_light_pdf(jscene, jhit.prim, jnp.asarray(prev), jc.point, jc.geo_normal,
                              jnp.asarray(d), inst=jhit.inst)
    tpdf = tscene_ops.area_light_pdf(tscene, thit.prim, torch.as_tensor(prev), tc.point,
                                     tc.geo_normal, torch.as_tensor(d), inst=thit.inst)
    np.testing.assert_allclose(tpdf.numpy()[found], np.asarray(jpdf)[found], rtol=1e-4)

    # NEE toward every light record
    lights = tscene.lights.num_lights
    assert int(tscene.lights.emissive_inst.max()) == 2
    rec = np.arange(n, dtype=np.int32) % lights
    u2 = np.random.RandomState(3).uniform(size=(n, 2)).astype(np.float32)
    x = tc.point.numpy()
    js = jso.sample_light(jscene, jnp.asarray(rec), jnp.asarray(x), jnp.asarray(u2))
    ts = tscene_ops.sample_light(tscene, torch.as_tensor(rec), torch.as_tensor(x),
                                 torch.as_tensor(u2))
    for name in ("target_prim", "target_inst", "use_mis"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)
    for name in ("radiant", "incident", "travel", "pdf"):
        # a solid-angle pdf divides by the light's cosine: rtol 1e-4 near grazing
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-4 if name == "pdf" else 1e-5, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


def test_tlas_matches_bake_image():
    """tests/test_instancing.py's scene and bound, 16x16, 4 spp, bounce 3:
    the TLAS render against the baked one."""
    from echorenderer_tpu_torch.processes.render import _sample_frame

    scene = tsc.Scene()
    pack = _two_spheres(tsc)
    scene.add(tsc.PackInstance(pack, position=(-1.5, 0, 0)))
    scene.add(tsc.PackInstance(pack, position=(1.5, 0.2, 0), scale=0.7, rotation=(0, 40, 10)))
    scene.add(tsc.PackInstance(pack, position=(0, -1.2, 1.0), scale=1.3))
    scene.add(tsc.AmbientLight(intensity=(0.8, 0.9, 1.0)))
    cam = tsc.PerspectiveCamera(field_of_view=70, position=(0, 0.4, -4))
    cam.look_at((0, 0, 0))
    scene.add(cam)
    imgs = {}
    for mode in ("tlas", "bake"):
        prepared = tprepare(scene, instancing=mode, device="cpu")
        assert (prepared.instances is not None) == (mode == "tlas")
        imgs[mode] = _sample_frame(prepared, "path", (16, 16), 0, 0, 4, 3, 2.5)[0].numpy()
    scale = max(float(np.mean(imgs["bake"])), 1e-6)
    assert float(np.mean(np.abs(imgs["tlas"] - imgs["bake"]))) / scale < 0.02


# ---------------------------------------------------------------------------
# the CUDA kernels (skip without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the instanced CUDA kernels need an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("count", [3, 16])
def test_cuda_walk_matches_plain(cuda, count):
    scene = tprepare(_mixed(tsc, count=count), instancing="tlas", device=cuda)
    soa = scene.hier_soa
    o, d, t_max = _scene_rays(scene, 50_000, seed=7)
    rays = tpi.ray_columns(*(torch.as_tensor(x, device=cuda) for x in (o, d, t_max)))
    rs = np.random.RandomState(4)
    ig = torch.as_tensor(np.where(rs.uniform(size=50_000) < 0.3,
                                  rs.randint(0, soa.num_prims, 50_000), -1), device=cuda)
    ii = torch.as_tensor(rs.randint(0, count + 1, 50_000), device=cuda)
    sig, sii = ph._sorted_ignore(soa, ig), ph._ignore_inst(soa, ig, ii)
    got = ph.hier_trace(rays, sig, soa, sii)
    want = ph.hier_trace_plain(rays, sig, soa, sii)
    for name, k, p in zip("tpuvi", got, want):
        assert torch.equal(k, p), name
    assert torch.equal(ph.hier_occlude(rays, sig, soa, sii),
                       ph.hier_occlude_plain(rays, sig, soa, sii))
    assert ph.hier_trace.launches_instanced > 0


def _placed_twice(m):
    """The mixed pack placed 3 times, then its first placement once more:
    every hit in either copy has an exact (t, slot) tie in the other
    instance, which the lower instance wins."""
    scene = _mixed(m, count=3)
    first = next(c for c in scene.children if isinstance(c, m.PackInstance))
    scene.add(m.PackInstance(first.pack, position=first.position, rotation=first.rotation,
                             scale=first.transform.scale))
    return scene


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4099, 1000, 33])
def test_cuda_walk_edge_cases_match_plain(cuda, n):
    """The instanced walk's warp-cooperative leaf phase: exact ties across
    two instances of one placement, n not a multiple of 32 or of a block,
    dead lanes among live ones (a sixteenth of the rays, and every fifth
    lane of the rest), a warp of identical rays, per-instance ignores;
    bitwise against the plain walk."""
    scene = tprepare(_placed_twice(tsc), instancing="tlas", device=cuda)
    soa = scene.hier_soa
    o, d, t_max = _scene_rays(scene, n, seed=n)
    t_max[1::5] = 0.0
    o[-32:], d[-32:], t_max[-32:] = o[-1], d[-1], np.inf  # a warp of one ray, if n >= 64
    rays = tpi.ray_columns(*(torch.as_tensor(x, device=cuda) for x in (o, d, t_max)))
    rs = np.random.RandomState(n)
    ig = torch.as_tensor(np.where(rs.uniform(size=n) < 0.3, rs.randint(0, soa.num_prims, n), -1),
                         device=cuda)
    ii = torch.as_tensor(rs.randint(0, 5, n), device=cuda)
    sig, sii = ph._sorted_ignore(soa, ig), ph._ignore_inst(soa, ig, ii)
    want = ph.hier_trace_plain(rays, sig, soa, sii)
    got = ph.hier_trace(rays, sig, soa, sii)
    blocked = ph.hier_occlude(rays, sig, soa, sii)
    torch.cuda.synchronize()
    for name, k, p in zip("tpuvi", got, want):
        assert torch.equal(k, p), name
    assert torch.equal(blocked, ph.hier_occlude_plain(rays, sig, soa, sii))
    found = want[1] >= 0
    last = soa.inst_codes.numel() - 1  # the repeated placement: it never wins a tie
    assert not (want[4][found] == last).any()
