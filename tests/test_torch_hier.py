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


def test_tables_must_be_16_byte_aligned():
    """The walk copies chunk records into shared memory by a bulk
    asynchronous copy, which needs a 16-byte-aligned source: a contiguous
    view of the chunks at an unaligned offset is refused on every device."""
    g = _geometry_np(600, 0)
    soa = ph.build_hier_soa(g, np.arange(600))
    flat = torch.empty(soa.prim_chunks.numel() + 1)
    shifted = flat[1:].view(soa.prim_chunks.shape).copy_(soa.prim_chunks)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    bad = soa._replace(prim_chunks=shifted)
    rays, ig = torch.zeros((7, 10)), torch.full((10,), -1, dtype=torch.int32)
    for fn in (ph.hier_trace, ph.hier_occlude):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(rays, ig, bad)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ph.check_tables(bad)
    ph.check_tables(soa)


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


# ---------------------------------------------------------------------------
# the warp-cooperative leaf phase of csrc/hier_walk.cuh: a model of it (on
# the CPU), and the CUDA walk's edge cases (on the card)
# ---------------------------------------------------------------------------

LANES = 32  # a warp
NO_SLOT = 2 ** 31 - 1  # the leaf phase's "no hit" slot and instance


def _leaf_phase_model(rays, ig, soa, any_hit, ign_inst=None, seed=0):
    """A model of the CUDA walk's leaf phase over the chunks the plain walk
    enters (`_walk(visits=...)`): the rays in groups of 32 (a warp); each
    group's (ray, chunk, instance) leaves in a seeded random order, grouped
    by chunk; each chunk's 256 prims split over 32 lanes as (member, prim)
    pairs, lane j testing prims j, 32 + j, ..., 224 + j of a member's ray in
    its current space and keeping the least t by a strict <, then a 5-level
    xor butterfly on (t, slot, instance) and the member's merge under the
    walk's tie rule; an any-hit member is blocked by any lane's hit before
    its t_max. Returns what hier_trace_plain / hier_occlude_plain return."""
    visits = []
    ph._walk(rays, ig, soa, any_hit, ign_inst, visits=visits)
    n = rays.shape[1]
    inst_on = soa.instanced
    has_tri, has_sph = soa.num_tris > 0, soa.num_prims > soa.num_tris
    if visits:
        leaves = torch.stack([torch.cat([v[k] for v in visits]).long() for k in range(3)], 1)
    else:
        leaves = torch.zeros((0, 3), dtype=torch.long)
    best_t = rays[6].clone()
    best_p = torch.full((n,), -1, dtype=torch.int32)
    best_u = torch.zeros(n)
    best_v = torch.zeros(n)
    best_i = torch.zeros(n, dtype=torch.int32)
    blocked = torch.zeros(n, dtype=torch.bool)
    lanes = torch.arange(LANES)
    rs = np.random.RandomState(seed)
    for g0 in range(0, n, LANES):
        mine = leaves[(leaves[:, 0] >= g0) & (leaves[:, 0] < g0 + LANES)]
        mine = mine[torch.as_tensor(rs.permutation(len(mine)), dtype=torch.long)]
        for c in dict.fromkeys(mine[:, 1].tolist()):  # distinct chunks, in visit order
            group = mine[mine[:, 1] == c]
            m, inst = group[:, 0], group[:, 2]
            k_n = len(m)
            o, d, igm = rays[0:3, m], rays[3:6, m], ig[m]
            if inst_on:
                inside = inst >= 0
                o_l, d_l = ph.to_instance(soa.inst_f32, inst.clamp(min=0).to(torch.int32), o, d)
                o, d = torch.where(inside, o_l, o), torch.where(inside, d_l, d)
                igm = torch.where(ign_inst[m] == inst, igm, -1)
            rows = soa.prim_chunks[c, :10, None, :].expand(10, k_n, ph.HCHUNK)
            base = torch.full((k_n,), c * ph.HCHUNK, dtype=torch.int32)
            t, u, v, ok = tpi._chunk_hits(rows, base, torch.cat([o, d]), igm, has_tri, has_sph,
                                          unit_dir=not inst_on)
            if any_hit:
                blocked[m[(ok & (t < rays[6, m][:, None])).any(dim=1)]] = True
                continue
            bt = torch.full((k_n, LANES), float("inf"))
            bs = torch.full((k_n, LANES), NO_SLOT, dtype=torch.int64)
            bu, bv = torch.zeros(k_n, LANES), torch.zeros(k_n, LANES)
            for step in range(ph.HCHUNK // LANES):
                k = LANES * step + lanes
                take = ok[:, k] & (t[:, k] < bt)
                bt = torch.where(take, t[:, k], bt)
                bs = torch.where(take, c * ph.HCHUNK + k, bs)
                bu = torch.where(take, u[:, k], bu)
                bv = torch.where(take, v[:, k], bv)
            bi = torch.where(bs < NO_SLOT, inst[:, None], NO_SLOT)
            for off in (16, 8, 4, 2, 1):
                q = lanes ^ off
                qt, qs, qi = bt[:, q], bs[:, q], bi[:, q]
                take = (qt < bt) | ((qt == bt) & ((qs < bs) | ((qs == bs) & (qi < bi))))
                bt, bs, bi = torch.where(take, qt, bt), torch.where(take, qs, bs), torch.where(
                    take, qi, bi)
                bu, bv = torch.where(take, bu[:, q], bu), torch.where(take, bv[:, q], bv)
            assert (bs == bs[:, :1]).all() and (bt == bt[:, :1]).all()  # every lane agrees
            for j in range(k_n):
                if bs[j, 0] == NO_SLOT:
                    continue
                r, tj, sj, ij = int(m[j]), bt[j, 0], int(bs[j, 0]), int(bi[j, 0])
                cur_p = int(best_p[r])
                if tj < best_t[r] or (tj == best_t[r] and cur_p >= 0 and (
                        sj < cur_p or (inst_on and sj == cur_p and ij < int(best_i[r])))):
                    best_t[r], best_p[r], best_i[r] = tj, sj, ij
                    best_u[r], best_v[r] = bu[j, 0], bv[j, 0]
    if any_hit:
        return blocked
    return (best_t, best_p, best_u, best_v) + ((best_i,) if inst_on else ())


def _tied_soup(num_tris, num_spheres, seed=0):
    """tests/test_torch_intersect.py's soup with exact copies of its first
    quarter of triangles and of spheres, in a random prim order (the copies
    sit in other chunks), and rays: half aimed at a copied prim from a
    random origin (an exact t tie between two slots, mostly in two chunks),
    half `_rays`' random ones, with a sixteenth of the aimed ones dead.
    Returns (tables, rays, sorted ignores, each sorted slot's copy's or
    original's slot, -1 for the rest)."""
    g = _geometry_np(num_tris, num_spheres, seed=seed)
    nt, ns = num_tris // 4, num_spheres // 4
    g = {k: np.concatenate([v, v[: nt if k.startswith("tri_") else ns]]) for k, v in g.items()}
    n_tri = num_tris + nt
    p = n_tri + num_spheres + ns
    twin = np.full(p, -1)
    twin[:nt], twin[num_tris:n_tri] = num_tris + np.arange(nt), np.arange(nt)
    twin[n_tri:n_tri + ns] = n_tri + num_spheres + np.arange(ns)
    twin[n_tri + num_spheres:] = n_tri + np.arange(ns)
    soa = ph.build_hier_soa(g, np.random.RandomState(seed + 1).permutation(p))
    twin_of_prim = torch.as_tensor(twin)[soa.order.long()]
    twin_slot = torch.where(twin_of_prim >= 0, soa.inv_order[twin_of_prim.clamp(min=0)].long(),
                            -1)
    rs = np.random.RandomState(seed + 2)
    n_aim = 256
    centers = np.concatenate([g["tri_v0"][:nt] + (g["tri_e1"][:nt] + g["tri_e2"][:nt]) / 3.0,
                              g["sph_center"][:ns]])
    tgt = centers[rs.randint(0, nt + ns, n_aim)]
    o = rs.uniform(-12, 12, (n_aim, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(n_aim, np.inf, np.float32)
    t_max[rs.uniform(size=n_aim) < 1 / 16] = 0.0
    ro, rd, rt, ri = _rays(256, p, seed=seed + 3)
    o, d = np.concatenate([o, ro]), np.concatenate([d, rd])
    t_max, ignore = np.concatenate([t_max, rt]), np.concatenate([np.full(n_aim, -1, np.int32), ri])
    rays = tpi.ray_columns(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    return soa, rays, ph._sorted_ignore(soa, torch.as_tensor(ignore)), twin_slot


def _tied_instances():
    """tests/test_torch_instancing.py's mixed pack placed 3 times, then its
    first placement once more: every hit in either copy has an exact
    (t, slot) tie in the other instance. Rays as that file makes them, with
    per-instance ignores."""
    import echorenderer_tpu_torch.scene as tsc
    from test_torch_instancing import _mixed, _scene_rays

    scene = _mixed(tsc, count=3)
    first = next(c for c in scene.children if isinstance(c, tsc.PackInstance))
    scene.add(tsc.PackInstance(first.pack, position=first.position, rotation=first.rotation,
                               scale=first.transform.scale))
    prepared = tprepare(scene, instancing="tlas", device="cpu")
    soa = prepared.hier_soa
    o, d, t_max = _scene_rays(prepared, 512, seed=9)
    rs = np.random.RandomState(10)
    ignore = np.where(rs.uniform(size=512) < 0.3, rs.randint(0, soa.num_prims, 512), -1)
    ii = torch.as_tensor(rs.randint(0, 5, 512).astype(np.int32))
    ig = torch.as_tensor(ignore.astype(np.int32))
    rays = tpi.ray_columns(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    return soa, rays, ph._sorted_ignore(soa, ig), ph._ignore_inst(soa, ig, ii)


@pytest.mark.parametrize("num_tris,num_spheres", GEOMETRIES + [(None, None)],
                         ids=IDS + ["instanced"])
def test_leaf_phase_model_matches_plain(num_tris, num_spheres):
    """The leaf phase's grouping, split and reduction give the plain walk's
    answers bit for bit, on rays with forced exact ties (across chunks;
    instanced: across two instances of one placement)."""
    if num_tris is None:
        soa, rays, ig, ii = _tied_instances()
    else:
        (soa, rays, ig, twin), ii = _tied_soup(num_tris, num_spheres, seed=17), None
    want = ph.hier_trace_plain(rays, ig, soa, ii)
    for seed in (0, 1):
        got = _leaf_phase_model(rays, ig, soa, False, ii, seed=seed)
        for name, a, b in zip("tpuvi", got, want):
            assert torch.equal(a, b), name
        assert torch.equal(_leaf_phase_model(rays, ig, soa, True, ii, seed=seed),
                           ph.hier_occlude_plain(rays, ig, soa, ii))
    found = want[1] >= 0
    assert found.sum() > 100
    if num_tris is None:  # the later copy of the placement never wins a tie
        tie = soa.inst_codes.numel() - 1
        assert (want[4][found] == 0).any() and not (want[4][found] == tie).any()
    else:  # a hit on a copied prim (or its copy) ignoring neither: the lower slot
        slot = want[1][found & (ig < 0)].long()
        tied = twin[slot] >= 0
        assert tied.sum() > 20 and (slot[tied] < twin[slot][tied]).all()


@pytest.mark.parametrize("num_tris,num_spheres", GEOMETRIES + [(None, None)],
                         ids=IDS + ["instanced"])
def test_leaf_phase_model_matches_jax(num_tris, num_spheres):
    """The same model against the JAX package's intersect_hier /
    occlude_hier (the Pallas kernel in interpret mode) on the same tables
    and rays, with this file's and tests/test_torch_instancing.py's
    tolerances."""
    if num_tris is None:
        from test_torch_instancing import _assert_hits_close, _jprepare, _jsc, _mixed, _prep
        from test_torch_instancing import _scene_rays

        jnp, _, jph = _jax()
        jscene = _jprepare(_mixed(_jsc()), instancing="tlas")
        tscene = from_jax_arrays(_prep().flatten_jax(jscene), device="cpu")
        soa = tscene.hier_soa
        o, d, t_max = _scene_rays(tscene, 512, seed=12)
        ignore = np.full(512, -1, np.int32)
        jargs = [jnp.asarray(x) for x in (o, d, t_max, ignore)]
        ref = jph.intersect_hier(jscene.geometry, jscene.hier_soa, *jargs)
        ref_blocked = np.asarray(jph.occlude_hier(jscene.geometry, jscene.hier_soa, *jargs))
        geom = tscene.geometry
    else:
        jgeom, jsoa, geom, soa = _both(num_tris, num_spheres)
        o, d, t_max, ignore = _rays(256, num_tris + num_spheres)  # test_trace_matches_jax's
        jargs, _ = _ray_args(o, d, t_max, ignore)
        ref = _jax()[2].intersect_hier(jgeom, jsoa, *jargs)
        ref_blocked = np.asarray(_jax()[2].occlude_hier(jgeom, jsoa, *jargs))
    targs = [torch.as_tensor(x) for x in (o, d, t_max, ignore)]
    rays = tpi.ray_columns(*targs[:3])
    ig = ph._sorted_ignore(soa, targs[3])
    ii = ph._ignore_inst(soa, targs[3], None)
    t, p, u, v, *inst = _leaf_phase_model(rays, ig, soa, False, ii, seed=3)
    prim = torch.where(p >= 0, soa.order[torch.clamp(p, min=0)], -1).to(torch.int32)
    found = prim >= 0
    got = tint.Hit(t=torch.where(found, t, tint.INF), prim=prim, uv=torch.stack([u, v], -1),
                   inst=torch.where(found, inst[0], 0) if inst else torch.zeros_like(prim))
    blocked = _leaf_phase_model(rays, ig, soa, True, ii, seed=3).numpy()
    np.testing.assert_array_equal(blocked, ref_blocked)
    if num_tris is None:
        _assert_hits_close(got, ref, geom.num_triangles)
        return
    ref_prim, ref_t = np.asarray(ref.prim), np.asarray(ref.t)
    assert _cross_chunk_ties(got.t.numpy(), got.prim.numpy(), ref_t, ref_prim) == 0
    np.testing.assert_array_equal(got.prim.numpy(), ref_prim)
    assert (ref_prim >= 0).sum() > 5
    np.testing.assert_allclose(got.t.numpy(), ref_t, rtol=1e-5, atol=1e-6)
    tri = (ref_prim >= 0) & (ref_prim < num_tris)
    np.testing.assert_allclose(got.uv.numpy()[tri], np.asarray(ref.uv)[tri], rtol=1e-5,
                               atol=1e-5)


CLUSTER_GAP = 12.0  # between cluster centres, along x


def _clusters(n_chunks, copies=False, seed=0):
    """Clusters of 240 small triangles and 16 small spheres about (12 k, 0,
    0), ordered so that chunk k holds cluster k: a ray along +z through a
    cluster enters its chunk alone. With `copies`, chunk k + n_chunks / 2
    repeats chunk k prim for prim: every hit has an exact (t) tie at a
    higher slot in another chunk."""
    rs = np.random.RandomState(seed)
    nt, ns = 240, 16
    k_n = n_chunks // 2 if copies else n_chunks
    at = lambda m: np.repeat(np.stack([CLUSTER_GAP * np.arange(k_n), np.zeros(k_n),
                                       np.zeros(k_n)], -1), m, 0)
    g = _geometry_np(k_n * nt, k_n * ns, seed=seed)
    g["tri_v0"] = (at(nt) + rs.uniform(-1.0, 1.0, (k_n * nt, 3))).astype(np.float32)
    g["tri_e1"] = rs.uniform(-0.4, 0.4, (k_n * nt, 3)).astype(np.float32)
    g["tri_e2"] = rs.uniform(-0.4, 0.4, (k_n * nt, 3)).astype(np.float32)
    g["sph_center"] = (at(ns) + rs.uniform(-1.0, 1.0, (k_n * ns, 3))).astype(np.float32)
    g["sph_radius"] = rs.uniform(0.05, 0.25, k_n * ns).astype(np.float32)
    if copies:
        g = {k: np.concatenate([v, v]) for k, v in g.items()}
    t_all = n_chunks * nt
    order = np.concatenate([np.concatenate([np.arange(k * nt, (k + 1) * nt),
                                            t_all + np.arange(k * ns, (k + 1) * ns)])
                            for k in range(n_chunks)])
    return g, order


def _at_clusters(which, seed=0, jitter=0.8):
    """Rays along +z (tilted a little) through the clusters `which`, from
    z = -6, with t_max infinite."""
    rs = np.random.RandomState(seed)
    n = len(which)
    o = np.stack([CLUSTER_GAP * np.asarray(which, np.float32), np.zeros(n, np.float32),
                  np.full(n, -6.0, np.float32)], -1)
    o[:, :2] += rs.uniform(-jitter, jitter, (n, 2)).astype(np.float32)
    d = np.concatenate([rs.uniform(-0.05, 0.05, (n, 2)), np.ones((n, 1))], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, np.full(n, np.inf, np.float32), np.full(n, -1, np.int32)


def _kernel_equals_plain(dev, soa, o, d, t_max, ignore):
    """hier_trace / hier_occlude against their plain versions, bitwise;
    returns the plain trace."""
    rays = tpi.ray_columns(*(torch.as_tensor(x, device=dev) for x in (o, d, t_max)))
    ig = ph._sorted_ignore(soa, torch.as_tensor(ignore, device=dev))
    want = ph.hier_trace_plain(rays, ig, soa)
    got = ph.hier_trace(rays, ig, soa)
    blocked = ph.hier_occlude(rays, ig, soa)
    torch.cuda.synchronize()
    for name, k, p in zip("tpuv", got, want):
        assert torch.equal(k, p), name
    assert torch.equal(blocked, ph.hier_occlude_plain(rays, ig, soa))
    return want


@pytest.mark.cuda
def test_cuda_warp_in_one_chunk(cuda):
    """Every lane of every warp enters the same chunk (one leaf-phase group
    of 32), with and without identical rays."""
    g, order = _clusters(8)
    soa = ph.build_hier_soa(g, order, device=cuda)
    o, d, t_max, ig = _at_clusters([5] * 96)
    o[64:], d[64:] = o[64], d[64]  # the third warp: 32 identical rays
    want = _kernel_equals_plain(cuda, soa, o, d, t_max, ig)
    assert (want[1] // ph.HCHUNK == 5).sum() > 48


@pytest.mark.cuda
def test_cuda_warp_in_32_chunks(cuda):
    """The 32 lanes of a warp enter 32 different chunks (32 groups of one,
    32 copies in a row through one stage)."""
    g, order = _clusters(40)
    soa = ph.build_hier_soa(g, order, device=cuda)
    which = list(range(32)) + list(range(39, 7, -1))
    o, d, t_max, ig = _at_clusters(which, jitter=0.3)
    want = _kernel_equals_plain(cuda, soa, o, d, t_max, ig)
    hit = want[1] >= 0
    assert len(set((want[1][hit] // ph.HCHUNK).tolist())) >= 32


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 1000])
def test_cuda_ray_counts_off_the_warp(cuda, n):
    """n not a multiple of 32 or of a block: the lanes past the last ray
    walk dead rays with their warp."""
    g, order = _clusters(12)
    soa = ph.build_hier_soa(g, order, device=cuda)
    rs = np.random.RandomState(n)
    o, d, t_max, ig = _at_clusters(rs.randint(0, 12, n), seed=n)
    d[::3] = rs.normal(size=(len(d[::3]), 3)).astype(np.float32)  # a third wander
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _kernel_equals_plain(cuda, soa, o, d, t_max, ig)


@pytest.mark.cuda
def test_cuda_dead_lanes_among_live(cuda):
    """t_max <= 0 (no work) on every other lane, and on whole warps."""
    g, order = _clusters(12)
    soa = ph.build_hier_soa(g, order, device=cuda)
    rs = np.random.RandomState(2)
    o, d, t_max, ig = _at_clusters(rs.randint(0, 12, 512), seed=2)
    t_max[::2] = rs.choice([0.0, -1.0, -np.inf], 256)
    t_max[1::4] = rs.uniform(4.0, 8.0, 128)  # finite: ends inside the cluster
    t_max[256:320] = 0.0
    ig[::5] = rs.randint(0, len(order), len(ig[::5]))
    want = _kernel_equals_plain(cuda, soa, o, d, t_max, ig)
    assert (want[1][::2] == -1).all() and (want[1] >= 0).sum() > 100


@pytest.mark.cuda
def test_cuda_exact_ties_across_chunks(cuda):
    """Chunks k and k + 6 hold the same prims: every hit ties in t across
    two chunks, and the lower slot wins (as the plain walk keeps it)."""
    g, order = _clusters(12, copies=True)
    soa = ph.build_hier_soa(g, order, device=cuda)
    rs = np.random.RandomState(3)
    o, d, t_max, ig = _at_clusters(rs.randint(0, 6, 1024), seed=3)
    want = _kernel_equals_plain(cuda, soa, o, d, t_max, ig)
    hit = want[1] >= 0
    assert hit.sum() > 300 and (want[1][hit] < 6 * ph.HCHUNK).all()
