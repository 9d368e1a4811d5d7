"""PyTorch port: the chunk-tree walk of large scenes against the JAX package.

- Tables: `build_hier_soa` and the leaf_max=1 `build_bvh` over chunk boxes
  equal the JAX package's bit for bit.
- Kernel: `intersect_hier` / `occlude_hier` (the plain version on the CPU)
  against the JAX functions, whose Pallas kernel runs in interpret mode
  here. Prim ids and blocked flags must be identical. The port keeps the
  lexicographic least (t, sorted slot); the TPU kernel keeps, among equal t
  in two chunks, the chunk its packet visited first, so ids may differ
  only on such exact cross-chunk ties, which are counted and must be 0 on
  these seeds. t agrees to rtol 1e-5; triangle barycentrics to atol 1e-5,
  for the reason tests/test_torch_intersect.py gives (cancellation in the
  triple products, which XLA may fuse).
- The hier plain version equals the dense plain version bit for bit, on
  rays and on a whole render: the tie rule makes the result independent
  of the visit order.
- prepare / convert carry the tables; the slice renders as the JAX
  wavefront does with its ECHO_NO_BINNED dispatch (tests/test_torch_path.py's
  tolerances), through the walk alone and through the binned dispatch
  (first wave on the walk, the rest binned); the liveness cascade leaves
  sums and counters bitwise equal.
- The CUDA kernels are held to their plain versions on the card:

    python -m pytest --noconftest tests/test_torch_hier.py -k cuda
"""

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.aggregation.bvh import build_bvh, geometry_bounds
from echorenderer_tpu_torch.evaluation import scene_ops as tscene_ops
from echorenderer_tpu_torch.evaluation import wavefront as twave
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.ops import intersect as tint
from echorenderer_tpu_torch.ops import pallas_hier as ph
from echorenderer_tpu_torch.ops import pallas_intersect as tpi
from echorenderer_tpu_torch.scene.convert import from_jax_arrays, to_arrays
from echorenderer_tpu_torch.scene.prepare import prepare_scene as tprepare

from test_torch_intersect import _geometry_np, _rays

torch.set_num_threads(1)

GEOMETRIES = [(500, 100), (600, 0), (0, 600)]
IDS = ["mixed", "tris-only", "spheres-only"]
HIER_FIELDS = ("prim_chunks", "chunk_bounds", "bounds", "codes", "order", "inv_order")


def _jax():
    import jax.numpy as jnp

    from echorenderer_tpu.ops import intersect as jint
    from echorenderer_tpu.ops import pallas_hier as jph

    return jnp, jint, jph


def _both(num_tris, num_spheres, seed=0, order_seed=9):
    """The same geometry and random prim order in both packages' hier
    tables (as tests/test_pallas_hier.py builds them)."""
    jnp, jint, jph = _jax()
    g = _geometry_np(num_tris, num_spheres, seed=seed)
    perm = np.random.RandomState(order_seed).permutation(num_tris + num_spheres)
    jgeom = jint.FlatGeometry(**{k: jnp.asarray(v) for k, v in g.items()})
    tgeom = tint.FlatGeometry(**{k: torch.as_tensor(v) for k, v in g.items()})
    return jgeom, jph.build_hier_soa(jgeom, perm), tgeom, ph.build_hier_soa(g, perm)


def _ray_args(o, d, t_max, ignore):
    jnp = _jax()[0]
    return ((jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jnp.asarray(ignore)),
            (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
             torch.as_tensor(ignore)))


@pytest.mark.parametrize("num_tris,num_spheres", GEOMETRIES, ids=IDS)
def test_tables_match_jax(num_tris, num_spheres):
    _, jsoa, _, tsoa = _both(num_tris, num_spheres)
    assert tsoa.num_chunks >= 2
    for name in HIER_FIELDS:
        got, want = getattr(tsoa, name).numpy(), np.asarray(getattr(jsoa, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("root_code", "stack_size", "num_tris", "num_prims", "instanced"):
        assert getattr(tsoa, name) == getattr(jsoa, name), name


def test_chunk_tree_bvh_matches_jax():
    """The leaf_max=1 SAH tree the chunk tree is built from, over random
    chunk boxes."""
    from echorenderer_tpu.aggregation.bvh import build_bvh as jbuild

    rs = np.random.RandomState(4)
    lo = rs.uniform(-50, 50, (300, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.1, 6.0, (300, 3)).astype(np.float32)
    host: dict = {}
    jbuild(lo, hi, leaf_max=1, host_out=host)
    got = build_bvh(lo, hi, leaf_max=1)
    for name in ("child_min", "child_max", "child_code", "prim_order"):
        np.testing.assert_array_equal(getattr(got, name), host[name], err_msg=name)
    assert got.root_code == host["root_code"]


def _cross_chunk_ties(t_got, p_got, t_ref, p_ref):
    """Rays whose two answers are different prims at exactly equal t."""
    return int(((p_got != p_ref) & (t_got == t_ref)).sum())


@pytest.mark.parametrize("num_tris,num_spheres", GEOMETRIES, ids=IDS)
def test_trace_matches_jax(num_tris, num_spheres):
    jgeom, jsoa, tgeom, tsoa = _both(num_tris, num_spheres)
    p = num_tris + num_spheres
    jargs, targs = _ray_args(*_rays(256, p))
    ref = _jax()[2].intersect_hier(jgeom, jsoa, *jargs)
    got = ph.intersect_hier(tgeom, tsoa, *targs)
    ref_prim, ref_t = np.asarray(ref.prim), np.asarray(ref.t)
    assert _cross_chunk_ties(got.t.numpy(), got.prim.numpy(), ref_t, ref_prim) == 0
    np.testing.assert_array_equal(got.prim.numpy(), ref_prim)
    assert (ref_prim >= 0).sum() > 5  # the rays do hit things
    np.testing.assert_allclose(got.t.numpy(), ref_t, rtol=1e-5, atol=1e-6)
    tri = (ref_prim >= 0) & (ref_prim < num_tris)
    np.testing.assert_allclose(got.uv.numpy()[tri], np.asarray(ref.uv)[tri], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got.inst.numpy(), np.zeros(256, np.int32))


@pytest.mark.parametrize("num_tris,num_spheres", GEOMETRIES, ids=IDS)
def test_occlude_matches_jax(num_tris, num_spheres):
    jgeom, jsoa, tgeom, tsoa = _both(num_tris, num_spheres, seed=3, order_seed=4)
    jargs, targs = _ray_args(*_rays(256, num_tris + num_spheres, seed=5))
    ref = np.asarray(_jax()[2].occlude_hier(jgeom, jsoa, *jargs))
    got = ph.occlude_hier(tgeom, tsoa, *targs).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(got)


def test_ignore_and_findfar():
    """As test_hier_ignore_and_findfar: an ignored triangle is never hit
    again; a ray from a sphere's center ignoring that sphere exits through
    its own far root. Both packages agree on every ray."""
    jnp, _, jph = _jax()
    jgeom, jsoa, tgeom, tsoa = _both(600, 0, seed=7, order_seed=8)
    o, d, _, _ = _rays(128, 600, seed=9)
    jo, jd, to, td = jnp.asarray(o), jnp.asarray(d), torch.as_tensor(o), torch.as_tensor(d)
    first = ph.intersect_hier(tgeom, tsoa, to, td, float("inf"), torch.full((128,), -1))
    ig = torch.clamp(first.prim, min=0)
    second = ph.intersect_hier(tgeom, tsoa, to, td, float("inf"), ig)
    assert not bool(((second.prim == first.prim) & (first.prim >= 0)).any())
    ref = jph.intersect_hier(jgeom, jsoa, jo, jd, jnp.inf, jnp.asarray(ig.numpy()))
    np.testing.assert_array_equal(second.prim.numpy(), np.asarray(ref.prim))

    jgeom, jsoa, tgeom, tsoa = _both(500, 100, seed=11, order_seed=12)
    g = _geometry_np(500, 100, seed=11)
    centers, radii = g["sph_center"][:64], g["sph_radius"][:64]
    d = np.tile(np.asarray([1.0, 0.0, 0.0], np.float32), (64, 1))
    ig = (500 + np.arange(64)).astype(np.int32)
    h = ph.intersect_hier(tgeom, tsoa, torch.as_tensor(centers), torch.as_tensor(d),
                          float("inf"), torch.as_tensor(ig))
    own = h.prim.numpy() == ig
    np.testing.assert_allclose(h.t.numpy()[own], radii[own], rtol=1e-4)
    assert own.mean() > 0.5  # most rays exit through their own sphere
    ref = jph.intersect_hier(jgeom, jsoa, jnp.asarray(centers), jnp.asarray(d), jnp.inf,
                             jnp.asarray(ig))
    np.testing.assert_array_equal(h.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(h.t.numpy(), np.asarray(ref.t), rtol=1e-5)


@pytest.mark.parametrize("num_tris,num_spheres", [(3000, 500), (4000, 0), (0, 2500)],
                         ids=["mixed", "tris-only", "spheres-only"])
def test_hier_equals_dense(num_tris, num_spheres):
    """Same tables order (the BVH leaf order), same rays: the walk and the
    dense chunk stream return the same t, prim, u, v and flags, bit for bit."""
    g = _geometry_np(num_tris, num_spheres, seed=21)
    bmin, bmax = geometry_bounds(g)
    order = build_bvh(bmin, bmax).prim_order
    hsoa = ph.build_hier_soa(g, order)
    dsoa = tpi.build_prim_soa(g, order=order)
    assert hsoa.num_chunks >= 8
    o, d, t_max, ignore = _rays(3000, num_tris + num_spheres, seed=22)
    rays = tpi.ray_columns(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    ig = torch.as_tensor(ignore)
    hit = ph.hier_trace(rays, ph._sorted_ignore(hsoa, ig), hsoa)
    ref = tpi.dense_trace(rays, tpi._sorted_ignore(dsoa, ig), dsoa)
    for name, a, b in zip("tpuv", hit, ref):
        assert torch.equal(a, b), name
    assert int((hit[1] >= 0).sum()) > 100
    assert torch.equal(ph.hier_occlude(rays, ph._sorted_ignore(hsoa, ig), hsoa),
                       tpi.dense_occlude(rays, tpi._sorted_ignore(dsoa, ig), dsoa))


def test_zero_area_triangle_never_hits():
    """A triangle with two equal edges (two vertices at a pole of one of
    sphere_grid(250_000)'s UV spheres) leaves a determinant residue of
    3.7e-9 in unfused float32 ops, above the 1e-12 threshold, and the
    ray-prim test reports a hit at t = 128 far outside it. Packing zeroes
    such edges, so no kernel reports it: the dense kernel did for a ray
    whose 128-ray block entered that chunk, the walk did not."""
    g = _geometry_np(600, 0, seed=2)
    g["tri_v0"] += np.float32(1000.0)  # the rest lie far off the ray
    g["tri_v0"][5] = [75.26449584960938, 0.38700640201568604, 47.76449203491211]
    g["tri_e1"][5] = g["tri_e2"][5] = [-0.264495849609375, -0.07440298795700073,
                                       -0.2644920349121094]
    o = torch.tensor([[55.0, 88.0, -66.0]])
    d = torch.tensor([[0.12314312160015106, -0.6176579594612122, 0.7767459750175476]])
    rows = torch.zeros((10, 1))
    rows[0:3, 0], rows[3:6, 0], rows[6:9, 0] = (torch.as_tensor(g[k][5]) for k in
                                                ("tri_v0", "tri_e1", "tri_e2"))
    ray = tpi.ray_columns(o, d, float("inf"))
    t, _, _, ok = tpi._chunk_hits(rows, 0, ray, torch.tensor([-1], dtype=torch.int32), True,
                                  False)
    assert bool(ok[0, 0]) and float(t[0, 0]) == 128.0  # the residue's phantom hit
    tgeom = tint.FlatGeometry(**{k: torch.as_tensor(v) for k, v in g.items()})
    ig = torch.tensor([-1])
    assert int(tpi.intersect_pallas(tgeom, tpi.build_prim_soa(g), o, d, float("inf"), ig)
               .prim[0]) == -1
    soa = ph.build_hier_soa(g, np.arange(600))
    assert int(ph.intersect_hier(tgeom, soa, o, d, float("inf"), ig).prim[0]) == -1
    assert not bool(ph.occlude_hier(tgeom, soa, o, d, float("inf"), ig)[0])


def test_wrapper_rejects_bad_inputs():
    g = _geometry_np(600, 0)
    soa = ph.build_hier_soa(g, np.arange(600))
    rays, ig = torch.zeros((7, 10)), torch.full((10,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        ph.hier_trace(rays, ig.long(), soa)
    with pytest.raises(ValueError, match="float32"):
        ph.hier_occlude(rays.double(), ig, soa)
    with pytest.raises(ValueError, match="stack"):
        ph.hier_trace(rays, ig, soa._replace(stack_size=ph.MAX_STACK + 1))
    # instanced tables are ported; they need each ignore's instance
    with pytest.raises(ValueError, match="ign_inst"):
        ph.hier_occlude(rays, ig, soa._replace(instanced=True))


# ---------------------------------------------------------------------------
# scenes, preparation and the slice
# ---------------------------------------------------------------------------


def _jax_sphere_grid(n_tris):
    from benchmarks.scene_throughput import build_scene

    return build_scene(n_tris)


def test_sphere_grid_matches_benchmark_scene():
    jscene, tscene = _jax_sphere_grid(3000), tscenes.sphere_grid(3000)
    jmesh, tmesh = jscene.children[0], tscene.children[0]
    np.testing.assert_array_equal(np.asarray(tmesh.vertices), np.asarray(jmesh.vertices))
    np.testing.assert_array_equal(np.asarray(tmesh.faces), np.asarray(jmesh.faces))
    jcam, tcam = jscene.children[-1], tscene.children[-1]
    np.testing.assert_array_equal(tcam.transform.matrix(), jcam.transform.matrix())
    assert tcam.field_of_view == jcam.field_of_view
    assert len(tscenes.sphere_grid(1_000_000).children[0].faces) == 1_002_528


@pytest.fixture(scope="module")
def grid_pair():
    """sphere_grid(20_000) (over HIER_BUILD_MIN prims, so both packages
    build the chunk tree) prepared by each package. The JAX side builds its
    BVH with its numpy builder, the oracle of its C++ one: on this mesh the
    C++ build (-march=native) picks other splits on near-equal SAH costs,
    and the port's builder is the numpy one."""
    import echorenderer_tpu.native as jnative
    from echorenderer_tpu.scene.prepare import prepare_scene as jprepare

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "build_bvh_native", lambda *args: None)
        jscene = jprepare(_jax_sphere_grid(20_000))
    tscene = tprepare(tscenes.sphere_grid(20_000), device="cpu")
    return jscene, tscene


def _zero_area_edges_zeroed(tables):
    """The JAX tables with the edges of zero-area triangles zeroed, as the
    port packs them (`pallas_intersect.pack_sorted_prims`): sphere_grid's
    pole triangles."""
    out = dict(tables)
    rows = np.concatenate([tables[f"prim_soa.{k}"] for k in
                           ("bx", "by", "bz", "cx", "cy", "cz", "is_sphere")], 0)
    flat = (rows[6] < 0.5) & (np.cross(rows[0:3].T, rows[3:6].T) == 0.0).all(-1)
    for k in ("bx", "by", "bz", "cx", "cy", "cz"):
        out[f"prim_soa.{k}"] = np.where(flat[None], np.float32(0.0), tables[f"prim_soa.{k}"])
    chunks = np.array(tables["hier_soa.prim_chunks"])
    b, c = chunks[:, 3:6].transpose(0, 2, 1), chunks[:, 6:9].transpose(0, 2, 1)
    flat = (chunks[:, 9] < 0.5) & (np.cross(b, c) == 0.0).all(-1)
    chunks[:, 3:9] = np.where(flat[:, None, :], np.float32(0.0), chunks[:, 3:9])
    out["hier_soa.prim_chunks"] = chunks
    return out


def test_prepare_builds_hier_tables_like_jax(grid_pair):
    from test_torch_prepare import _assert_tables_equal, flatten_jax

    jscene, tscene = grid_pair
    assert tscene.hier_soa is not None and jscene.hier_soa is not None
    ref = _zero_area_edges_zeroed(flatten_jax(jscene))
    got = to_arrays(tscene)
    assert {f"hier_soa.{k}" for k in HIER_FIELDS + ("root_code", "stack_size")} <= got.keys()
    for key in [k for k in got if k.startswith("hier_soa.")]:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    _assert_tables_equal(got, ref)
    assert not np.array_equal(ref["hier_soa.prim_chunks"],
                              np.asarray(jscene.hier_soa.prim_chunks))  # pole triangles
    carried = from_jax_arrays(ref, device="cpu")
    np.testing.assert_array_equal(to_arrays(carried)["hier_soa.prim_chunks"],
                                  ref["hier_soa.prim_chunks"])
    for name in ("root_code", "stack_size", "num_tris", "num_prims", "instanced"):
        assert getattr(carried.hier_soa, name) == getattr(tscene.hier_soa, name), name
    # under HIER_TRACE_MIN padded prims the dense kernels keep the scene
    assert tscene_ops.dispatch_summary(tscene)["accelerator"] == "dense-stream"


def test_slice_matches_jax(grid_pair, monkeypatch):
    """The wavefront on sphere_grid(20_000), 16x16, 2 spp, bounce 4, on
    identical tables: the JAX side through the chunk-tree walk, as its
    ECHO_NO_BINNED dispatch runs it; the port through its large-scene
    dispatch (the first wave on the walk, every later one binned) and
    through the walk alone, both held to the JAX sums; and the port's walk
    render equals its dense render bit for bit."""
    import jax.numpy as jnp

    from echorenderer_tpu.evaluation import scene_ops as jscene_ops
    from echorenderer_tpu.evaluation.wavefront import sample_frame_wavefront as jwavefront
    from echorenderer_tpu_torch.ops import binned_trace as bt
    from test_torch_prepare import flatten_jax

    jscene, _ = grid_pair
    monkeypatch.setattr(jscene_ops, "_use_hier", lambda scene: True)
    monkeypatch.setattr(jscene_ops, "_use_binned", lambda scene: False)
    tscene = from_jax_arrays(flatten_jax(jscene), device="cpu")
    n, res = 256, (16, 16)
    pid = np.arange(n, dtype=np.uint32)
    pxy = np.stack([pid % res[0], pid // res[0]], -1).astype(np.int32)
    kw = dict(bounce_limit=4, survivability=2.5)
    a, a2 = jwavefront(jscene, jnp.asarray(pid), jnp.asarray(pxy), res, 11, jnp.uint32(0), 2,
                       **kw)
    a, a2 = np.asarray(a), np.asarray(a2)
    assert a.sum() > 0
    args = (torch.as_tensor(pid.astype(np.int64)), torch.as_tensor(pxy), res, 11, 0, 2)
    launches = ph.hier_trace.launches, ph.hier_occlude.launches
    calls = {"hier": 0}
    walk = ph._walk

    def counted(*a_, **k_):
        calls["hier"] += 1
        return walk(*a_, **k_)

    def close_to_jax(s, s2):
        np.testing.assert_allclose(s, a, atol=2e-3, rtol=2e-3)
        np.testing.assert_allclose(s2, a2, atol=4e-2, rtol=2e-3)
        np.testing.assert_allclose(s.mean(0), a.mean(0), atol=1e-5, rtol=1e-5)

    monkeypatch.setattr(ph, "_walk", counted)
    monkeypatch.setattr(tscene_ops, "HIER_TRACE_MIN", 0)
    assert tscene_ops.dispatch_summary(tscene)["accelerator"] == "binned"
    bt.reset_stats()
    s, s2 = twave.sample_frame_wavefront(tscene, *args, **kw)
    assert calls["hier"] == 2 and bt.STATS["calls"] > 0  # the first wave, then binned
    close_to_jax(s.numpy(), s2.numpy())

    with tscene_ops.walk_only():
        assert tscene_ops.dispatch_summary(tscene)["accelerator"] == "hier-packet"
        b, b2 = twave.sample_frame_wavefront(tscene, *args, **kw)
    assert calls["hier"] > 2
    assert (ph.hier_trace.launches, ph.hier_occlude.launches) == launches  # CPU: no kernel
    b, b2 = b.numpy(), b2.numpy()
    close_to_jax(b, b2)

    monkeypatch.setattr(tscene_ops, "HIER_TRACE_MIN", 2 ** 30)
    assert tscene_ops.dispatch_summary(tscene)["accelerator"] == "dense-stream"
    c, c2 = twave.sample_frame_wavefront(tscene, *args, **kw)
    assert np.array_equal(b, c.numpy()) and np.array_equal(b2, c2.numpy())


def test_cascade_is_bitwise_invisible(monkeypatch):
    """The liveness cascade (engaged here from 512 lanes, floor 64) leaves
    every lane's sums and all six counters and the iteration count as the
    single full-width loop gives them."""
    scene = tprepare(tscenes.cornell_box(), device="cpu")
    res = (96, 96)
    n = res[0] * res[1]
    pid = torch.arange(n, dtype=torch.int64)
    pxy = torch.stack([pid % res[0], pid // res[0]], dim=-1).to(torch.int32)
    kw = dict(bounce_limit=4, survivability=2.5, return_stats=True)
    monkeypatch.setattr(twave, "WAVE_CASCADE_MIN", 2 ** 30)
    assert twave.cascade_widths(n) == []
    s, q, stats = twave.run_wavefront(scene, pid, pxy, res, 3, 0, 2, **kw)
    monkeypatch.setattr(twave, "WAVE_CASCADE_MIN", 512)
    monkeypatch.setattr(twave, "WAVE_CASCADE_FLOOR", 64)
    assert twave.cascade_widths(n) == [3072, 1024]
    cs, cq, cstats = twave.run_wavefront(scene, pid, pxy, res, 3, 0, 2, **kw)
    assert torch.equal(s, cs) and torch.equal(q, cq)
    assert stats == cstats
    assert stats["Sample/Completed"] + stats["Sample/Rejected"] == 2 * n


def test_cascade_widths_of_a_1080p_frame():
    """The JAX package's schedule at bench.py's 1920x1080 frame."""
    assert twave.cascade_widths(1920 * 1080) == [519168, 130048, 32768]
    assert twave.cascade_widths(2 ** 18 - 1) == []


# ---------------------------------------------------------------------------
# the CUDA kernels (skip without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the hier CUDA kernels need an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("num_tris,num_spheres", [(3000, 500), (4000, 0), (0, 2500)],
                         ids=["mixed", "tris-only", "spheres-only"])
def test_cuda_kernels_match_plain(cuda, num_tris, num_spheres):
    g = _geometry_np(num_tris, num_spheres, seed=21)
    bmin, bmax = geometry_bounds(g)
    order = build_bvh(bmin, bmax).prim_order
    soa = ph.build_hier_soa(g, order, device=cuda)
    o, d, t_max, ignore = _rays(50_000, num_tris + num_spheres, seed=3)
    rays = tpi.ray_columns(torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda),
                           torch.as_tensor(t_max, device=cuda))
    ig = ph._sorted_ignore(soa, torch.as_tensor(ignore, device=cuda))
    kt = ph.hier_trace(rays, ig, soa)
    pt = ph.hier_trace_plain(rays, ig, soa)
    torch.cuda.synchronize()
    for name, k, p in zip("tpuv", kt, pt):
        assert torch.equal(k, p), name
    assert torch.equal(ph.hier_occlude(rays, ig, soa), ph.hier_occlude_plain(rays, ig, soa))
