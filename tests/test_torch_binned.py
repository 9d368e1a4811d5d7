"""PyTorch port: the binned traversal of large scenes against the JAX package.

- Traversal: `trace_binned` / `occlude_binned` against the JAX functions,
  whose three Pallas kernels run in interpret mode here, on the same
  geometry, prim order and rays (n a multiple of 1024, so the JAX package
  takes its fused engine, the port's at any n). Prim ids and blocked flags
  must be identical; triangle t agrees to rtol 1e-5 and sphere t to
  SPHERE_RTOL (both atol 1e-6: a ray starting just inside a sphere cancels
  in -b - sqrt(disc)); triangle barycentrics to atol 1e-5, for the reason
  tests/test_torch_intersect.py gives.
- Cases: mixed, triangles only, spheres only; ignores and findFar; occlude at
  t_max 0.5, 2 and 1e30; the straggler cascade (CASCADE_MIN patched down in
  both packages) and the capped order's overflow (ORD_CAP patched to 2),
  for trace and occlude.
- The plain kernels against the JAX pieces: `setup_rank_plain` against
  `_setup_rank`, `select_plain` against `_run_select` (bitwise), and
  `seg_keys_plain` (through one round's pair packing) against
  `_pack_and_intersect`: equal keys but exactly where the two packages' t
  of the same prim lie on two sides of a band edge, which happens at the
  rate their ulp difference predicts.
- Binned against the port's chunk-tree walk: the same hits, but where two
  prims' t fall in one band (2^-15 relative), where binned may keep the
  other one.
- The refill: `refill` on CPU tensors takes `refill_plain`, and both equal
  a numpy version of its contract bit for bit (ksup 4, 8 and 16, capped and
  uncapped orders, rays that overflow their order or leave a box at t 0,
  best_t 0, finite or infinite); `_Walk.round` hands its keys to select;
  bad inputs raise.
- The wavefront: on a large scene the first iteration is coherent (the
  walk), the rest binned; below the threshold the flag changes no bit.
- The CUDA kernels, the refill kernel among them (and one refill launch a
  round), are held to their plain versions on the card:

    python -m pytest --noconftest tests/test_torch_binned.py -k cuda
"""

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.evaluation import scene_ops as tscene_ops
from echorenderer_tpu_torch.evaluation import wavefront as twave
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.ops import binned_trace as bt
from echorenderer_tpu_torch.ops import intersect as tint
from echorenderer_tpu_torch.ops import pallas_hier as ph
from echorenderer_tpu_torch.ops.pallas_hier import HCHUNK
from echorenderer_tpu_torch.ops import pallas_intersect as tpi
from echorenderer_tpu_torch.scene.prepare import prepare_scene as tprepare
from echorenderer_tpu_torch.utils import diagnostics

from test_torch_intersect import _geometry_np, _rays

torch.set_num_threads(1)

N = 1024
# sphere t against the JAX package: -b - sqrt(b*b - c) cancels for a small
# sphere seen from afar, and XLA evaluates it with fused multiply-adds where
# the port rounds op by op (measured 1.6e-5 on one ray of 3072)
SPHERE_RTOL = 5e-5
GEOMETRIES = {"mixed": (500, 100), "tris-only": (600, 0), "spheres-only": (0, 600)}


def _jax():
    import jax.numpy as jnp

    from echorenderer_tpu.ops import binned_trace as jbt
    from echorenderer_tpu.ops import intersect as jint
    from echorenderer_tpu.ops import pallas_hier as jph

    return jnp, jbt, jint, jph


def _both(num_tris, num_spheres, seed=0, order_seed=9):
    """The same geometry and random prim order in both packages' hier
    tables (as tests/test_torch_hier.py builds them)."""
    jnp, _, jint, jph = _jax()
    g = _geometry_np(num_tris, num_spheres, seed=seed)
    perm = np.random.RandomState(order_seed).permutation(num_tris + num_spheres)
    jgeom = jint.FlatGeometry(**{k: jnp.asarray(v) for k, v in g.items()})
    tgeom = tint.FlatGeometry(**{k: torch.as_tensor(v) for k, v in g.items()})
    return jgeom, jph.build_hier_soa(jgeom, perm), tgeom, ph.build_hier_soa(g, perm)


def _grid_soup(num_tris, num_spheres, seed):
    """Small prims in a 20x20x20 box, in BVH order: tight chunk boxes, many
    supers, rays that pass several."""
    from echorenderer_tpu_torch.aggregation.bvh import build_bvh, geometry_bounds

    g = _geometry_np(num_tris, num_spheres, seed=seed)
    g["tri_e1"] *= 0.3
    g["tri_e2"] *= 0.3
    bmin, bmax = geometry_bounds(g)
    return g, build_bvh(bmin, bmax).prim_order


def _both_grid(num_tris=11000, num_spheres=1000, seed=31):
    jnp, _, jint, jph = _jax()
    g, order = _grid_soup(num_tris, num_spheres, seed)
    jgeom = jint.FlatGeometry(**{k: jnp.asarray(v) for k, v in g.items()})
    tgeom = tint.FlatGeometry(**{k: torch.as_tensor(v) for k, v in g.items()})
    return g, jgeom, jph.build_hier_soa(jgeom, order), tgeom, ph.build_hier_soa(g, order)


def _args(o, d, t_max, ignore):
    jnp = _jax()[0]
    return (tuple(jnp.asarray(x) for x in (o, d, t_max, ignore)),
            tuple(torch.as_tensor(x) for x in (o, d, t_max, ignore)))


def _assert_hits_equal(got, ref_prim, ref_t, ref_uv, num_tris):
    np.testing.assert_array_equal(got.prim.numpy(), ref_prim)
    tri = (ref_prim >= 0) & (ref_prim < num_tris)
    np.testing.assert_allclose(got.t.numpy()[~tri], ref_t[~tri], rtol=SPHERE_RTOL, atol=1e-6)
    np.testing.assert_allclose(got.t.numpy()[tri], ref_t[tri], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.uv.numpy()[tri], ref_uv[tri], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.inst.numpy(), np.zeros(len(ref_prim), np.int32))


def _band(t):
    return np.asarray(t, np.float32).view(np.int32) & ~0xFF


def _assert_band_ties_only(got, ref):
    """Binned (got) against the walk (ref): the same rays hit; where the
    prims differ both t lie in one band. Returns the count of such rays."""
    gp, rp = got.prim.numpy(), ref.prim.numpy()
    np.testing.assert_array_equal(gp >= 0, rp >= 0)
    same = gp == rp
    np.testing.assert_array_equal(got.t.numpy()[same], ref.t.numpy()[same])
    np.testing.assert_array_equal(got.uv.numpy()[same], ref.uv.numpy()[same])
    diff = ~same
    np.testing.assert_array_equal(_band(got.t.numpy()[diff]), _band(ref.t.numpy()[diff]))
    return int(diff.sum())


# ---------------------------------------------------------------------------
# the traversal against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=list(GEOMETRIES))
def soup(request):
    nt, ns = GEOMETRIES[request.param]
    jgeom, jsoa, tgeom, tsoa = _both(nt, ns)
    o, d, t_max, ignore = _rays(N, nt + ns)
    jargs, targs = _args(o, d, t_max, ignore)
    ref = _jax()[1].trace_binned(jgeom, jsoa, *jargs)
    return dict(nt=nt, jgeom=jgeom, jsoa=jsoa, tgeom=tgeom, tsoa=tsoa, rays=(o, d, t_max, ignore),
                ref=ref)


def test_trace_matches_jax(soup):
    got = bt.trace_binned(soup["tgeom"], soup["tsoa"], *_args(*soup["rays"])[1])
    ref = soup["ref"]
    _assert_hits_equal(got, np.asarray(ref.prim), np.asarray(ref.t), np.asarray(ref.uv), soup["nt"])
    assert (got.prim.numpy() >= 0).sum() > 50  # the rays do hit things


def test_matches_hier_walk(soup):
    targs = _args(*soup["rays"])[1]
    got = bt.trace_binned(soup["tgeom"], soup["tsoa"], *targs)
    walk = ph.intersect_hier(soup["tgeom"], soup["tsoa"], *targs)
    assert _assert_band_ties_only(got, walk) == 0


def test_occlude_matches_jax():
    jnp, jbt, _, _ = _jax()
    jgeom, jsoa, tgeom, tsoa = _both(500, 100, seed=7, order_seed=8)
    o, d, _, ignore = _rays(N, 600, seed=9)
    for t_max in (0.5, 2.0, 1e30):
        tm = np.full(N, t_max, np.float32)
        jargs, targs = _args(o, d, tm, ignore)
        want = np.asarray(jbt.occlude_binned(jgeom, jsoa, *jargs))
        got = bt.occlude_binned(tgeom, tsoa, *targs).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < N
        np.testing.assert_array_equal(got, ph.occlude_hier(tgeom, tsoa, *targs).numpy())


def test_ignore_and_findfar():
    """An ignored triangle is never hit again; a ray from a sphere's center
    ignoring that sphere exits through its own far root. Both packages
    agree on every ray."""
    jnp, jbt, _, _ = _jax()
    jgeom, jsoa, tgeom, tsoa = _both(500, 100, seed=3, order_seed=4)
    o, d, _, _ = _rays(N, 600, seed=5)
    inf = np.full(N, np.inf, np.float32)
    first = bt.trace_binned(tgeom, tsoa, *_args(o, d, inf, np.full(N, -1, np.int32))[1])
    ig = np.maximum(first.prim.numpy(), 0).astype(np.int32)
    jargs, targs = _args(o, d, inf, ig)
    second = bt.trace_binned(tgeom, tsoa, *targs)
    tri = (first.prim.numpy() >= 0) & (first.prim.numpy() < 500)
    assert not (second.prim.numpy() == first.prim.numpy())[tri].any()
    ref = jbt.trace_binned(jgeom, jsoa, *jargs)
    _assert_hits_equal(second, np.asarray(ref.prim), np.asarray(ref.t), np.asarray(ref.uv), 500)

    g = _geometry_np(500, 100, seed=3)
    sph = np.arange(N) % 100
    dx = np.tile(np.asarray([1.0, 0.0, 0.0], np.float32), (N, 1))
    ig = (500 + sph).astype(np.int32)
    jargs, targs = _args(g["sph_center"][sph], dx, inf, ig)
    h = bt.trace_binned(tgeom, tsoa, *targs)
    own = h.prim.numpy() == ig
    np.testing.assert_allclose(h.t.numpy()[own], g["sph_radius"][sph][own], rtol=1e-4)
    assert own.mean() > 0.5  # most rays exit through their own sphere
    ref = jbt.trace_binned(jgeom, jsoa, *jargs)
    _assert_hits_equal(h, np.asarray(ref.prim), np.asarray(ref.t), np.asarray(ref.uv), 500)


@pytest.fixture(scope="module")
def grid():
    return _both_grid()


# the straggler cascade at 2048 rays (the mid stage and the final loop)
# with the capped order's overflow (ORD_CAP 2 of 3 supers: parked rays
# finish in a compaction stage) and narrow pops; the JAX package takes k
# and k_straggler as arguments, the port as module constants
CASCADE_N = 2048
CASCADE_PATCH = dict(CASCADE_MIN=CASCADE_N, ORD_CAP=2)
CASCADE_K = dict(K=2, K_STRAGGLER=4)


@pytest.fixture(scope="module")
def cascade(grid):
    """The JAX package's trace (t_max from `_rays`) and occlude (t_max 2)
    of one ray set through the patched cascade, compiled once for the
    module. The patches hold for a ray count no other test uses, so the JAX
    jit cache cannot serve a trace made before or after them."""
    jnp, jbt, _, _ = _jax()
    g, jgeom, jsoa, _, _ = grid
    o, d, t_max, ignore = _rays(CASCADE_N, g["tri_v0"].shape[0] + g["sph_center"].shape[0],
                                seed=53)
    o *= 0.8
    t_occ = np.full(CASCADE_N, 2.0, np.float32)
    kw = dict(k=CASCADE_K["K"], k_straggler=CASCADE_K["K_STRAGGLER"])
    with pytest.MonkeyPatch.context() as mp:
        for name, value in CASCADE_PATCH.items():
            mp.setattr(jbt, name, value)
        ref = jbt.trace_binned(jgeom, jsoa, *_args(o, d, t_max, ignore)[0], **kw)
        blocked = np.asarray(jbt.occlude_binned(jgeom, jsoa, *_args(o, d, t_occ, ignore)[0], **kw))
    return dict(trace=_args(o, d, t_max, ignore)[1], occlude=_args(o, d, t_occ, ignore)[1],
                ref=ref, blocked=blocked)


def _patch_cascade(monkeypatch, tsoa):
    for name, value in {**CASCADE_PATCH, **CASCADE_K}.items():
        monkeypatch.setattr(bt, name, value)
    assert -(-tsoa.num_chunks // bt.SUP) > 2  # several supers: the cap binds


def test_cascade_and_capped_order_match_jax(grid, cascade, monkeypatch):
    """Closest hit through the patched cascade in both packages, and
    against the port's walk."""
    g, _, _, tgeom, tsoa = grid
    _patch_cascade(monkeypatch, tsoa)
    targs, ref = cascade["trace"], cascade["ref"]
    diagnostics.reset_counts()
    bt.STATS["misses"] = 0
    got = bt.trace_binned(tgeom, tsoa, *targs)
    assert diagnostics.counts()["binned.rounds"] > 3 and int(bt.STATS["misses"]) == 0
    num_tris = g["tri_v0"].shape[0]
    _assert_hits_equal(got, np.asarray(ref.prim), np.asarray(ref.t), np.asarray(ref.uv), num_tris)
    assert (got.prim.numpy() >= 0).sum() > CASCADE_N // 4
    assert _assert_band_ties_only(got, ph.intersect_hier(tgeom, tsoa, *targs)) < CASCADE_N // 100


def test_cascade_occlude_matches_jax(grid, cascade, monkeypatch):
    """Any hit below t_max 2 through the patched cascade: the blocked
    flags of the JAX package and of the port's walk."""
    _, _, _, tgeom, tsoa = grid
    _patch_cascade(monkeypatch, tsoa)
    targs = cascade["occlude"]
    diagnostics.reset_counts()
    blocked = bt.occlude_binned(tgeom, tsoa, *targs)
    assert diagnostics.counts()["binned.rounds"] > 3
    np.testing.assert_array_equal(blocked.numpy(), cascade["blocked"])
    assert torch.equal(blocked, ph.occlude_hier(tgeom, tsoa, *targs))
    assert 0 < int(blocked.sum()) < CASCADE_N


def test_wide_super_table_takes_the_row_sort(grid, monkeypatch):
    """Past SETUP_MAX_PAD supers the order comes from one PyTorch row sort,
    uncapped, as the JAX package's fallback: the same hits."""
    g, _, _, tgeom, tsoa = grid
    o, d, t_max, ignore = _rays(N, 12000, seed=71)
    targs = _args(o * 0.8, d, t_max, ignore)[1]
    want = bt.trace_binned(tgeom, tsoa, *targs)
    calls = []
    monkeypatch.setattr(bt, "setup_rank", lambda *a: calls.append(a))
    monkeypatch.setattr(bt, "SETUP_MAX_PAD", 4)
    got = bt.trace_binned(tgeom, tsoa, *targs)
    assert calls == []
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int((got.prim >= 0).sum()) > N // 4


# ---------------------------------------------------------------------------
# the plain kernels against the JAX pieces
# ---------------------------------------------------------------------------


def test_setup_rank_plain_matches_jax(grid):
    jnp, jbt, _, _ = _jax()
    g, _, _, _, tsoa = grid
    tb = bt._Tables(tsoa.chunk_bounds)
    o, d, t_max, _ = _rays(N, 10, seed=7)
    limit = np.minimum(t_max, np.float32(bt._INF))
    rays = tpi.ray_columns(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(limit))
    for cap in (None, 2):
        got = bt.setup_rank_plain(rays, tb.sup_cb, tb.sbits, cap).numpy()
        want = np.asarray(jbt._setup_rank(jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(tb.sup_cb.numpy()), jnp.asarray(limit),
                                          tb.sbits, cap=cap))
        np.testing.assert_array_equal(got, want)
        assert got.shape == (8 if cap is None else 2, N)
    assert (got != bt._INT_INF).sum() > N // 2


def test_select_plain_matches_jax():
    jnp, jbt, _, _ = _jax()
    rs = np.random.RandomState(3)
    for w, k in ((67, 4), (143, 16), (287, 32)):
        cbits = 12
        density = rs.uniform(0.0, 0.15, N)  # some rays hold fewer than k keys
        cand = np.where(rs.uniform(size=(w, N)) < density,
                        rs.randint(0, 2**31 - 1, (w, N)), bt._INT_INF).astype(np.int32)
        nk = np.where(rs.uniform(size=(w - k + 1, N)) < density,
                      rs.randint(0, 2**31 - 1, (w - k + 1, N)), bt._INT_INF).astype(np.int32)
        best_t = np.where(rs.uniform(size=N) < 0.3, np.float32(bt._INF),
                          rs.uniform(0, 1e30, N)).astype(np.float32)
        refill = rs.uniform(size=N) < 0.5
        jcand = jnp.asarray(cand.reshape(w, N // 1024, 8, 128).transpose(1, 0, 2, 3))
        j_new, j_pop, j_live, j_mink = jbt._run_select(jcand, jnp.asarray(nk), jnp.asarray(best_t),
                                                       jnp.asarray(refill), k, cbits)
        tcand = torch.as_tensor(cand)
        pop, live, mink = bt.select_plain(tcand, torch.as_tensor(nk), torch.as_tensor(best_t),
                                          torch.as_tensor(refill), k, cbits)
        np.testing.assert_array_equal(
            tcand.numpy(), np.asarray(j_new).transpose(1, 0, 2, 3).reshape(w, N))
        np.testing.assert_array_equal(pop.numpy(), np.asarray(j_pop))
        np.testing.assert_array_equal(live.numpy(), np.asarray(j_live))
        np.testing.assert_array_equal(mink.numpy(), np.asarray(j_mink))
        assert 0 < (pop.numpy() != bt._INT_INF).mean() < 1


def test_seg_keys_plain_matches_jax(grid):
    """One round's pairs through the port's packing (sort, record gather,
    `seg_keys`) and the JAX package's `_pack_and_intersect` (sort, segment
    rows, the keyed `_seg_kernel`): the same prim on every found pair, and
    equal keys except exactly where the two packages' t of that prim lie on
    two sides of a band edge. The JAX t comes from its `_chunk_hits` under
    jit, which reproduces the kernel's band on every pair. The two t differ
    by a few ulps (XLA fuses multiply-adds where the port rounds op by op),
    and a band edge falls between two t that are d ulps apart with
    probability d / 256, so about sum(d) / 256 keys differ (measured 8 of
    618, expected 7.4)."""
    import jax

    from echorenderer_tpu.ops import pallas_intersect as jpi

    jnp, jbt, _, _ = _jax()
    g, _, jsoa, tgeom, tsoa = grid
    k = 4
    p = g["tri_v0"].shape[0] + g["sph_center"].shape[0]
    o, d, t_max, ignore = _rays(N, p, seed=11)
    c = tsoa.num_chunks
    best_t = np.minimum(np.where(t_max > 0, t_max, 0), np.float32(bt._INF)).astype(np.float32)
    # each ray's k nearest chunks it enters, -1 past them
    tn = bt._slab_all(torch.as_tensor(o), torch.as_tensor(d), tsoa.chunk_bounds,
                      torch.as_tensor(best_t))
    near = torch.sort(tn, dim=1)
    sel = torch.where(near.values[:, :k] < bt._INF, near.indices[:, :k], -1).T.numpy()
    sel = np.ascontiguousarray(sel.astype(np.int32))
    ign = ph._sorted_ignore(tsoa, torch.as_tensor(ignore))
    walk = bt._Walk(tpi.ray_columns(torch.as_tensor(o), torch.as_tensor(d),
                                    torch.as_tensor(best_t)), ign, tsoa, False)
    got = walk.pairs(torch.as_tensor(sel), walk.rays, torch.as_tensor(best_t), walk.ign_f).numpy()
    want = np.asarray(jbt._pack_and_intersect(
        jnp.asarray(sel), jnp.asarray(o), jnp.asarray(d), jnp.asarray(best_t),
        jnp.asarray(ign.numpy().astype(np.float32)), jsoa.prim_chunks, c, True, True,
        -(-(k * N) // 1024) * 1024))
    found = want != bt._INT_INF
    assert found.sum() > 500
    np.testing.assert_array_equal(got == bt._INT_INF, ~found)
    np.testing.assert_array_equal(got[found] & 0xFF, want[found] & 0xFF)  # the same prim

    # both packages' t of each found pair's prim
    kk, rr = np.nonzero(found)
    ch, j = sel[kk, rr], want[found] & 0xFF
    slot = ch * HCHUNK + j
    ign_r = ign.numpy()[rr]
    rows = tsoa.prim_chunks[torch.as_tensor(ch).long(), :10, torch.as_tensor(j).long()]
    t_port, _, _, ok = (x[:, 0] for x in tpi._chunk_hits(
        rows.T[:, :, None], torch.as_tensor(slot, dtype=torch.int32), walk.rays[:, rr],
        torch.as_tensor(ign_r), True, True))
    assert bool(ok.all())
    # JAX: pair i's prim in column i of one (10, 1, M) block, so its ignore
    # is i where the ray ignores that prim
    m = len(rr)
    block = jnp.asarray(np.asarray(jsoa.prim_chunks)[ch, :10, j].T[:, None, :])
    ign_col = np.where(ign_r == slot, np.arange(m), -2).astype(np.float32)[None]
    cols = [jnp.asarray(a[rr][None]) for a in (*o.T, *d.T)]
    hits = jax.jit(lambda b, *r: jpi._chunk_hits(b, 0.0, *r, True, True)[0])
    t_jax = np.diagonal(np.asarray(hits(block, *cols, jnp.asarray(ign_col)))).astype(np.float32)
    bits_port, bits_jax = t_port.numpy().view(np.int32), t_jax.view(np.int32)
    np.testing.assert_array_equal(bits_jax & ~0xFF, want[found] & ~0xFF)

    differ = (got != want)[found]
    np.testing.assert_array_equal(differ, (bits_port & ~0xFF) != (bits_jax & ~0xFF))
    expected = np.abs(bits_port.astype(np.int64) - bits_jax).sum() / 256
    assert differ.sum() <= 2 * expected + 3


# ---------------------------------------------------------------------------
# the refill
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def refill_soup():
    """A grid soup of 172 chunks: 11 supers, so an order capped at 3 overflows."""
    g, order = _grid_soup(40000, 4000, seed=5)
    return ph.build_hier_soa(g, order)


def _refill_inputs(cb, n, ksup, cap, mode, seed):
    """The arguments of one refill over the chunk boxes cb (C, 6), on the
    CPU: n random rays (zero, denormal, negative-zero and sub-clamp
    direction components among them), their super order from
    `setup_rank_plain` (capped at `cap`), cursors from 0 to past the order,
    best_t 0, finite, _INF or inf, do_refill on every ray ("all"), on none
    or on about half ("mixed"), random next_sup. Every 13th ray starts on
    the far corner of a chunk's box and leaves it (its exit t exactly 0),
    that chunk's super put at its cursor."""
    tb = bt._Tables(cb)
    o, d, t_max, _ = _rays(n, 1, seed=seed)
    rs = np.random.RandomState(seed + 1)
    edge = np.arange(4, n, 13)
    chunk = rs.randint(0, cb.shape[0], edge.size)
    o[edge] = tb.base.numpy().reshape(-1, 6, bt.SUP)[chunk // bt.SUP, 3:, chunk % bt.SUP]
    d[edge] = np.abs(d[edge])
    d[::5, 0] = 0.0
    d[1::7, 1] = 1e-40
    d[2::9, 2] = -0.0
    d[3::11, 0] = -3e-13
    rays = tpi.ray_columns(*(torch.as_tensor(x) for x in (o, d, t_max)))
    sup_ord = bt.setup_rank_plain(rays, tb.sup_cb, tb.sbits, cap).numpy().copy()
    best = np.where(rs.uniform(size=n) < 0.7, rs.uniform(0.0, 40.0, n),
                    rs.choice([0.0, bt._INF, np.inf], n)).astype(np.float32)
    refill = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
              "mixed": rs.uniform(size=n) < 0.5}[mode]
    cursor = rs.randint(0, sup_ord.shape[0] + ksup + 2, n).astype(np.int32)
    inside = cursor[edge] < sup_ord.shape[0]
    sup_ord[cursor[edge][inside], edge[inside]] = chunk[inside] // bt.SUP  # entry t 0
    best[edge] = 10.0
    next_sup = rs.randint(0, 2**31 - 1, n).astype(np.int32)
    return (rays, torch.as_tensor(sup_ord), torch.as_tensor(cursor), torch.as_tensor(best),
            torch.as_tensor(refill), torch.as_tensor(next_sup), tb.base, ksup, tb.sbits, tb.cbits)


def _on(device, args):
    return tuple(x.to(device) if isinstance(x, torch.Tensor) else x for x in args)


def _refill_ref(rays, sup_ord, cursor, best_t, do_refill, next_sup, base, ksup, sbits, cbits):
    """The refill's contract ray by ray in numpy float32 (one op a
    rounding, NaN-propagating min and max), independent of the port."""
    f32 = np.float32
    r, so, cur, bt_, dr, nx, b = (x.numpy() for x in (rays, sup_ord, cursor, best_t, do_refill,
                                                       next_sup, base))
    w_ord, n = so.shape
    capped = w_ord < b.shape[0]
    keys = np.full((ksup * bt.SUP, n), bt._INT_INF, np.int32)
    cur_out, next_out = cur.copy(), nx.copy()
    for i in range(n):
        if dr[i]:
            o, d = r[0:3, i], r[3:6, i]
            with np.errstate(all="ignore"):
                inv = np.where(np.abs(d) < f32(1e-12), np.where(d < 0, f32(-1e12), f32(1e12)),
                               f32(1.0) / d).astype(f32)
            for j in range(ksup):
                p = cur[i] + j
                key = so[p, i] if p < w_ord else bt._INT_INF
                if key == bt._INT_INF or not np.int32(key & -(1 << sbits)).view(f32) < bt_[i]:
                    continue
                s = key & ((1 << sbits) - 1)
                box = b[s].reshape(6, bt.SUP)
                with np.errstate(all="ignore"):
                    t0 = (box[:3] - o[:, None]) * inv[:, None]
                    t1 = (box[3:] - o[:, None]) * inv[:, None]
                    tn = np.max(np.minimum(t0, t1), axis=0)
                    tf = np.min(np.maximum(t0, t1), axis=0)
                ok = (tn <= tf) & (tf > 0) & (tn < bt_[i]) & (tn < f32(bt._INF))
                tb = np.where(tn > 0, tn, f32(0.0)).astype(f32).view(np.int32)
                keys[j * bt.SUP:(j + 1) * bt.SUP, i] = np.where(
                    ok, (tb & -(1 << cbits)) | (s * bt.SUP + np.arange(bt.SUP)), bt._INT_INF)
            p = cur[i] + ksup
            next_out[i] = so[p, i] if p < w_ord else so[w_ord - 1, i] if capped else bt._INT_INF
            cur_out[i] = cur[i] + ksup
        if capped:
            cur_out[i] = min(cur_out[i], w_ord)
    return keys, cur_out, next_out


def _assert_refill_equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy() if isinstance(g, torch.Tensor) else g,
                                      w.cpu().numpy() if isinstance(w, torch.Tensor) else w)


@pytest.mark.parametrize("cap", (None, 3), ids=("uncapped", "capped"))
@pytest.mark.parametrize("ksup", (4, 8, 16))
def test_refill_matches_its_contract(refill_soup, ksup, cap):
    """`refill` on CPU tensors takes `refill_plain`; both equal the
    contract's numpy version bit for bit on rays that overflow their
    order, miss every box or meet best_t 0, finite or infinite."""
    args = _refill_inputs(refill_soup.chunk_bounds, 300, ksup, cap, "mixed", seed=ksup)
    got = bt.refill(*args)
    want = bt.refill_plain(*args)
    _assert_refill_equal(got, want)
    _assert_refill_equal(got, _refill_ref(*args))
    assert got[0].shape == (ksup * bt.SUP, 300)
    assert int((got[0] != bt._INT_INF).sum()) > 50
    if cap:  # some refilling rays overflow the capped order and park
        over = args[4] & (args[2] + ksup >= args[1].shape[0])
        assert int(over.sum()) > 10 and int(got[1].max()) == args[1].shape[0]


@pytest.mark.parametrize("mode", ("all", "none"))
def test_refill_all_or_no_rays(refill_soup, mode):
    args = _refill_inputs(refill_soup.chunk_bounds, 200, 8, 3, mode, seed=41)
    got = bt.refill(*args)
    _assert_refill_equal(got, _refill_ref(*args))
    if mode == "none":
        assert bool((got[0] == bt._INT_INF).all()) and torch.equal(got[2], args[5])


@pytest.mark.parametrize("n", (0, 1))
def test_refill_edge_widths(refill_soup, n):
    args = _refill_inputs(refill_soup.chunk_bounds, n, 8, 3, "all", seed=43)
    got = bt.refill(*args)
    assert got[0].shape == (8 * bt.SUP, n) and got[1].shape == got[2].shape == (n,)
    _assert_refill_equal(got, bt.refill_plain(*args))
    _assert_refill_equal(got, _refill_ref(*args))


@pytest.mark.parametrize("ksup", (4, 16))
def test_round_takes_the_refill(refill_soup, monkeypatch, ksup):
    """`_Walk.round` hands select the refill's keys and keeps its cursor
    and next super, round after round."""
    soa = refill_soup
    o, d, t_max, ignore = _rays(512, soa.num_prims, seed=ksup)
    rays = tpi.ray_columns(*(torch.as_tensor(x) for x in (o * 0.8, d, t_max)))
    w = bt._Walk(rays, ph._sorted_ignore(soa, torch.as_tensor(ignore)), soa, False)
    n = rays.shape[1]
    st = w.start(rays, rays[6], torch.full((n,), bt._INT_INF, dtype=torch.int32),
                 torch.full((n,), -1, dtype=torch.int32), w.order(rays, 3), ksup, bt.K)
    st["ign_f"], st["ii_f"] = w.ign_f, None
    handed, real = [], bt.select

    def select(cand, new_keys, *a):
        handed.append(new_keys.clone())
        return real(cand, new_keys, *a)

    monkeypatch.setattr(bt, "select", select)
    for _ in range(3):
        want = bt.refill_plain(st["rays"], st["sup_ord"], st["cursor"], st["best_t"],
                               st["do_refill"], st["next_sup"], w.tb.base, ksup, w.tb.sbits,
                               w.tb.cbits)
        st = w.round(st, bt.K, ksup)
        _assert_refill_equal((handed[-1], st["cursor"], st["next_sup"]), want)
    assert int((handed[0] != bt._INT_INF).sum()) > 100


REFILL_BAD = {
    "rays dtype": (dict(rays=lambda a: a.double()), "float32"),
    "order width": (dict(sup_ord=lambda a: a[:, :-1].contiguous()), "sup_ord"),
    "cursor dtype": (dict(cursor=lambda a: a.long()), "cursor"),
    "flag dtype": (dict(do_refill=lambda a: a.to(torch.uint8)), "do_refill"),
    "base width": (dict(base=lambda a: a[:, :95].contiguous()), "base"),
    "ksup": (dict(ksup=lambda a: 0), "ksup"),
    "sbits": (dict(sbits=lambda a: 2), "sbits"),
    "mixed devices": (dict(next_sup=lambda a: a.to("meta")), "one device"),
}


@pytest.mark.parametrize("case", list(REFILL_BAD))
def test_refill_rejects_bad_inputs(refill_soup, case):
    names = ("rays", "sup_ord", "cursor", "best_t", "do_refill", "next_sup", "base", "ksup",
             "sbits", "cbits")
    args = dict(zip(names, _refill_inputs(refill_soup.chunk_bounds, 16, 4, None, "mixed", 47)))
    change, match = REFILL_BAD[case]
    for name, fn in change.items():
        args[name] = fn(args[name])
    with pytest.raises(ValueError, match=match):
        bt.refill(**args)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def test_wrappers_reject_bad_inputs():
    rays = torch.zeros((7, 16))
    sup = torch.zeros((3, 6))
    with pytest.raises(ValueError, match="float32"):
        bt.setup_rank(rays.double(), sup, 2)
    with pytest.raises(ValueError, match="sup_cb"):
        bt.setup_rank(rays, torch.zeros((3, 5)), 2)
    with pytest.raises(ValueError, match="at most"):
        bt.setup_rank(rays, torch.zeros((600, 6)), 10)
    cand = torch.zeros((7, 16), dtype=torch.int32)
    nk = torch.zeros((4, 16), dtype=torch.int32)
    ok = dict(best_t=torch.zeros(16), do_refill=torch.zeros(16, dtype=torch.bool), k=4, cbits=12)
    pop, live, mink = bt.select(cand, nk, **ok)
    assert pop.shape == (4, 16) and live.dtype == torch.int32
    with pytest.raises(ValueError, match="new_keys"):
        bt.select(cand, nk[:3], **ok)
    with pytest.raises(ValueError, match="int32"):
        bt.select(cand.long(), nk, **ok)
    with pytest.raises(ValueError, match="bool"):
        bt.select(cand, nk, **dict(ok, do_refill=torch.zeros(16)))
    chunks = torch.zeros((2, 16, 256))
    with pytest.raises(ValueError, match="int32"):
        bt.seg_keys(torch.zeros((5, 8)), torch.zeros(5), chunks, True, False)
    with pytest.raises(ValueError, match="contiguous"):
        bt.seg_keys(torch.zeros((8, 5)).T, torch.zeros(5, dtype=torch.int32), chunks, True, False)
    with pytest.raises(ValueError, match="one device"):
        bt.seg_keys(torch.zeros((5, 8)), torch.zeros(5, dtype=torch.int32, device="meta"),
                    chunks, True, False)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bt.seg_keys(torch.zeros((5, 8), device="meta"),
                    torch.zeros(5, dtype=torch.int32, device="meta"),
                    torch.zeros((2, 16, 256), device="meta"), True, False)
    soa = ph.build_hier_soa(_geometry_np(600, 0), np.arange(600))
    # instanced packs are ported; they need their binned tables
    with pytest.raises(ValueError, match="binned tables"):
        bt.trace_binned(None, soa._replace(instanced=True), torch.zeros((4, 3)),
                        torch.ones((4, 3)), float("inf"), torch.full((4,), -1))


# ---------------------------------------------------------------------------
# the wavefront's dispatch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def large():
    return tprepare(tscenes.sphere_grid(17_000), device="cpu")


def _frame(scene, res=(8, 8), count=2):
    n = res[0] * res[1]
    pid = torch.arange(n, dtype=torch.int64)
    pxy = torch.stack([pid % res[0], pid // res[0]], dim=-1).to(torch.int32)
    return twave.run_wavefront(scene, pid, pxy, res, 5, 0, count, bounce_limit=4,
                               return_stats=True)


def _spy(monkeypatch, drop_flag=False):
    """Records the `coherent` flag of every scene_ops.trace/occlude call;
    with drop_flag, passes every call on as not coherent."""
    calls = []
    for name in ("trace", "occlude"):
        fn = getattr(tscene_ops, name)

        def spied(*a, coherent=False, _fn=fn, _name=name):
            calls.append((_name, coherent))
            return _fn(*a, coherent=coherent and not drop_flag)

        monkeypatch.setattr(tscene_ops, name, spied)
    return calls


def test_wavefront_first_wave_is_coherent(large, monkeypatch):
    """Over the threshold, iteration 0's trace and shadow rays take the
    walk and every later wave the binned traversal."""
    monkeypatch.setattr(tscene_ops, "HIER_TRACE_MIN", 0)
    assert tscene_ops.dispatch_summary(large)["accelerator"] == "binned"
    walks = []
    walk = ph._walk

    def counted(*a, **k):
        walks.append(a[0].shape[1])
        return walk(*a, **k)

    monkeypatch.setattr(ph, "_walk", counted)
    calls = _spy(monkeypatch)
    diagnostics.reset_counts()
    s, q, stats = _frame(large)
    iters = stats["Loop/Iterations"]
    assert iters >= 3 and calls[:2] == [("trace", True), ("occlude", True)]
    assert calls[2:] == [("trace", False), ("occlude", False)] * (iters - 1)
    assert len(walks) == 2 and diagnostics.counts()["binned.calls"] == 2 * (iters - 1)
    assert bool(torch.isfinite(s).all()) and float(s.sum()) > 0
    assert [diagnostics.counts()[f"launches.binned_{k}"]  # CPU: no kernel
            for k in ("setup", "select", "seg", "seg_exact")] == [0, 0, 0, 0]


def test_peel_is_bitwise_invisible_below_threshold(large, monkeypatch):
    """Under the threshold the coherent flag picks nothing: the frame with
    the first wave marked equals the frame with no wave marked, bit for bit."""
    assert tscene_ops.dispatch_summary(large)["accelerator"] == "dense-stream"
    s, q, stats = _frame(large)
    calls = _spy(monkeypatch, drop_flag=True)
    s2, q2, stats2 = _frame(large)
    assert calls[0] == ("trace", True)
    assert torch.equal(s, s2) and torch.equal(q, q2) and stats == stats2


# ---------------------------------------------------------------------------
# the CUDA kernels (skip without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the binned CUDA kernels need an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda):
    g, order = _grid_soup(30000, 3000, seed=5)
    soa = ph.build_hier_soa(g, order, device=cuda)
    tb = bt._Tables(soa.chunk_bounds)
    o, d, t_max, ignore = _rays(100_000, 33000, seed=6)
    rays = tpi.ray_columns(*(torch.as_tensor(x, device=cuda) for x in (o, d, t_max)))
    for cap in (None, 32, 3):
        assert torch.equal(bt.setup_rank(rays, tb.sup_cb, tb.sbits, cap),
                           bt.setup_rank_plain(rays, tb.sup_cb, tb.sbits, cap))
    rs = np.random.RandomState(7)
    n = rays.shape[1]
    for w, k in ((67, 4), (287, 32)):
        cand = torch.as_tensor(np.where(rs.uniform(size=(w, n)) < 0.2,
                                        rs.randint(0, 2**30, (w, n)), bt._INT_INF).astype(np.int32),
                               device=cuda)
        nk = torch.as_tensor(rs.randint(0, 2**31 - 1, (w - k + 1, n)).astype(np.int32), device=cuda)
        best_t = torch.as_tensor(rs.uniform(0, 1e30, n).astype(np.float32), device=cuda)
        refill = torch.as_tensor(rs.uniform(size=n) < 0.5, device=cuda)
        c2 = cand.clone()
        got = bt.select(cand, nk, best_t, refill, k, 12)
        want = bt.select_plain(c2, nk, best_t, refill, k, 12)
        assert torch.equal(cand, c2) and all(torch.equal(a, b) for a, b in zip(got, want))
    chunk = torch.as_tensor(np.sort(rs.randint(0, soa.num_chunks, n)).astype(np.int32),
                            device=cuda)
    rec = torch.stack([rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
                       ph._sorted_ignore(soa, torch.as_tensor(ignore, device=cuda)).float()],
                      1).contiguous()
    got = bt.seg_keys(rec, chunk, soa.prim_chunks, True, True)
    assert torch.equal(got, bt.seg_keys_plain(rec, chunk, soa.prim_chunks, True, True))
    assert int((got != bt._INT_INF).sum()) > 100


@pytest.mark.cuda
def test_cuda_refill_matches_plain(cuda):
    """The refill kernel against `refill_plain` on the card, bit for bit on
    keys, cursor and next super: ksup 4, 8 and 16, capped and uncapped
    orders, every ray, none or half refilling, widths 0, 1, off the block
    and large, and an instanced pack's tables (world boxes, global chunks)."""
    g, order = _grid_soup(40000, 4000, seed=5)
    inst = tprepare(tscenes.instanced_grid(side=3), instancing="tlas", device="cpu")
    found = {}
    for label, cb in (("flat", ph.build_hier_soa(g, order).chunk_bounds),
                      ("instanced", inst.hier_soa.binned_wcb)):
        for ksup in (4, 8, 16):
            for cap in (None, 3):
                for mode, n in (("mixed", 0), ("mixed", 1), ("all", 1000), ("none", 1000),
                                ("mixed", 4099), ("mixed", 200_000)):
                    args = _on(cuda, _refill_inputs(cb, n, ksup, cap, mode, seed=ksup + n))
                    got = bt.refill(*args)
                    want = bt.refill_plain(*args)
                    _assert_refill_equal(got, want)
                    found[label] = found.get(label, 0) + int((got[0] != bt._INT_INF).sum())
    assert found["flat"] > 100_000 and found["instanced"] > 10_000


@pytest.mark.cuda
def test_cuda_refill_one_launch_a_round(cuda, monkeypatch):
    """One refill launch a round over a card traversal whose cascade runs
    all three stages (ksup 4, 8 and 16), and its hits bit for bit those of
    the same traversal on the plain refill."""
    g, order = _grid_soup(40000, 4000, seed=5)
    soa = ph.build_hier_soa(g, order, device=cuda)
    n = bt.CASCADE_MIN + 4096
    o, d, t_max, ignore = _rays(n, soa.num_prims, seed=17)
    targs = [torch.as_tensor(x, device=cuda) for x in (o * 0.8, d, t_max, ignore)]
    diagnostics.reset_counts()
    got = bt.trace_binned(None, soa, *targs)
    blocked = bt.occlude_binned(None, soa, *targs)
    counts = diagnostics.counts()
    assert counts["launches.binned_refill"] == counts["binned.rounds"] > 2 * bt.FULL_ROUNDS
    monkeypatch.setattr(bt, "refill", bt.refill_plain)
    want = bt.trace_binned(None, soa, *targs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(blocked, bt.occlude_binned(None, soa, *targs))
    assert int((got.prim >= 0).sum()) > n // 4
