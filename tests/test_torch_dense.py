"""PyTorch port: the dense trace/occlude kernels' per-ray culling and their
warp's lane split (csrc/dense_intersect.cu).

- The plain versions (`dense_trace_plain` / `dense_occlude_plain`, which
  cull per ray as the kernels do) against the JAX package's
  `intersect_pallas` / `occlude_pallas`, whose Pallas kernels cull by
  1,024-ray blocks and run in interpret mode here, on about 5,000 prims in
  BVH order (more than 32 chunks, so the superchunk level runs) and rays
  that mix a coherent camera tile with incoherent ones. Tolerances as in
  tests/test_torch_intersect.py: ids and flags identical, t rtol 1e-5, u/v
  rtol 1e-5 plus atol 1e-5. Two differences are allowed, each on at most
  1 ray in 200, where the port must then return what the JAX
  package's unculled `intersect_linear` / `occlude_linear` return: the JAX
  kernels enter a box only while its entry t is below the limit, with none
  of the port's 2^-12 slack (`CULL_MARGIN`), so they can lose a hit that
  grazes a box; and the JAX kernel in interpret mode rounds a near-tangent
  sphere's quadratic, whose terms cancel, otherwise than intersect_linear.
- A torch replay of the kernels' warps (`_warp_model`): rays in groups of
  32, each lane's superchunk and chunk box tests against its own limit, the
  ballot, and for a ballot of at most `coop_max` rays the (member, prim)
  pairs over 32 lanes with a 5-level xor butterfly on (t, slot) and the
  member's merge, for a denser one a lane a ray over the whole chunk. It
  must equal the plain versions bitwise on exact ties across chunks, on
  ignores and on dead rays, at every crossover.
- On the card (`cuda`-marked, skipped without one): the kernels against
  the plain versions bitwise, on a 42k-prim soup, on ballots of one lane
  and of 32, on ray counts off the warp and at the crossover:

    python -m pytest --noconftest tests/test_torch_dense.py -k cuda
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.aggregation.bvh import build_bvh, geometry_bounds
from echorenderer_tpu_torch.ops import intersect as tint
from echorenderer_tpu_torch.ops import pallas_intersect as tpi

from test_torch_intersect import _geometry_np, _rays

torch.set_num_threads(1)

LANES = 32  # a warp
NO_SLOT = 2 ** 31 - 1  # the butterfly's "no hit" slot
SOURCE = Path(tpi.__file__).resolve().parents[1] / "csrc" / "dense_intersect.cu"
# the kernels' crossover: ballots of at most this many rays spread their tests
COOP_MAX = int(re.search(r"constexpr int kCoopMax = (\d+);", SOURCE.read_text()).group(1))

SOUPS = [(4000, 1000), (5000, 0), (0, 4500)]  # 40, 40 and 36 chunks
SOUP_IDS = ["mixed", "tris-only", "spheres-only"]


def _camera_tile(side, eye, target, seed):
    """A side x side pinhole tile of rays from `eye` towards `target` (a
    40-degree field), row-major as a tile of the wavefront's lane order,
    t_max infinite, no ignores."""
    rs = np.random.RandomState(seed)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    px = (np.arange(side * side) % side + rs.uniform(size=side * side)) / side - 0.5
    py = (np.arange(side * side) // side + rs.uniform(size=side * side)) / side - 0.5
    span = np.tan(np.radians(20.0)) * 2.0
    d = fwd + span * (px[:, None] * right + py[:, None] * up)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(np.asarray(eye, np.float32), d.shape).copy()
    n = side * side
    return o, d, np.full(n, np.inf, np.float32), np.full(n, -1, np.int32)


def _soup_rays(p, seed=1):
    """A 32x32 camera tile into the soup's box, then 1,024 incoherent rays
    (`_rays`: a quarter ignore a prim, an eighth are dead, t_max finite or
    infinite)."""
    cam = _camera_tile(32, (0.0, 4.0, -25.0), (0.0, 0.0, 0.0), seed)
    rnd = _rays(1024, p, seed=seed)
    return tuple(np.concatenate([a, b]) for a, b in zip(cam, rnd))


def _bvh_soup(num_tris, num_spheres, seed=0):
    """The random soup of tests/test_torch_intersect.py in BVH leaf order."""
    g = _geometry_np(num_tris, num_spheres, seed=seed)
    order = build_bvh(*geometry_bounds(g)).prim_order
    return g, np.asarray(order)


def _jax():
    import jax.numpy as jnp

    from echorenderer_tpu.ops import intersect as jint
    from echorenderer_tpu.ops import pallas_intersect as jpi

    return jnp, jint, jpi


def _both(num_tris, num_spheres):
    jnp, jint, jpi = _jax()
    g, order = _bvh_soup(num_tris, num_spheres)
    jgeom = jint.FlatGeometry(**{k: jnp.asarray(v) for k, v in g.items()})
    tgeom = tint.FlatGeometry(**{k: torch.as_tensor(v) for k, v in g.items()})
    tsoa = tpi.build_prim_soa(g, order=order)
    assert tsoa.n_chunks > tpi.SC_FACTOR and tsoa.n_super > 1
    return jgeom, jpi.build_prim_soa(jgeom, order=order), tgeom, tsoa


def _same_but_grazing(got, ref, linear):
    """Hold the port's ids or flags `got` to the JAX kernels' `ref`: equal on
    every ray but at most 1 in 200, and on those equal to the JAX package's
    unculled answer `linear()` (a grazing hit the JAX kernels' slack-free
    cull lost). Returns the mask of rays where got == ref."""
    same = got == ref
    if not same.all():
        assert (~same).sum() <= len(same) // 200, f"{(~same).sum()} rays differ"
        np.testing.assert_array_equal(got[~same], linear()[~same])
    return same


@pytest.mark.parametrize("num_tris,num_spheres", SOUPS, ids=SOUP_IDS)
def test_trace_matches_jax_beyond_32_chunks(num_tris, num_spheres):
    jnp, jint, jpi = _jax()
    jgeom, jsoa, tgeom, tsoa = _both(num_tris, num_spheres)
    o, d, t_max, ignore = _soup_rays(num_tris + num_spheres)
    ref = jpi.intersect_pallas(jgeom, jsoa, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t_max), jnp.asarray(ignore))
    got = tpi.intersect_pallas(tgeom, tsoa, torch.as_tensor(o), torch.as_tensor(d),
                               torch.as_tensor(t_max), torch.as_tensor(ignore))
    ref_prim, got_prim = np.asarray(ref.prim), got.prim.numpy()
    lin = jint.intersect_linear(jgeom, *(jnp.asarray(x) for x in (o, d, t_max, ignore)))
    same = _same_but_grazing(got_prim, ref_prim, lambda: np.asarray(lin.prim))
    assert (ref_prim[:1024] >= 0).sum() > 200 and (ref_prim[1024:] >= 0).sum() > 100
    got_t, ref_t = got.t.numpy(), np.asarray(ref.t)
    # a near-tangent sphere hit cancels in its quadratic, and the JAX kernel
    # (interpret mode) rounds it otherwise than the JAX package's
    # intersect_linear, which the port matches: at most 1 ray in 200
    off = same & ~np.isclose(got_t, ref_t, rtol=1e-5, atol=1e-6)
    assert off.sum() <= len(off) // 200 and (ref_prim[off] >= num_tris).all()
    np.testing.assert_allclose(got_t[off], np.asarray(lin.t)[off], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_t[same & ~off], ref_t[same & ~off], rtol=1e-5, atol=1e-6)
    tri = same & (ref_prim >= 0) & (ref_prim < num_tris)
    np.testing.assert_allclose(got.uv.numpy()[tri], np.asarray(ref.uv)[tri], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_tris,num_spheres", SOUPS, ids=SOUP_IDS)
def test_occlude_matches_jax_beyond_32_chunks(num_tris, num_spheres):
    jnp, jint, jpi = _jax()
    jgeom, jsoa, tgeom, tsoa = _both(num_tris, num_spheres)
    o, d, t_max, ignore = _soup_rays(num_tris + num_spheres, seed=2)
    t_max[: 1024: 3] = 12.0  # camera rays that stop inside the soup
    ref = np.asarray(jpi.occlude_pallas(jgeom, jsoa, jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(t_max), jnp.asarray(ignore)))
    got = tpi.occlude_pallas(tgeom, tsoa, torch.as_tensor(o), torch.as_tensor(d),
                             torch.as_tensor(t_max), torch.as_tensor(ignore)).numpy()
    _same_but_grazing(got, ref, lambda: np.asarray(jint.occlude_linear(
        jgeom, *(jnp.asarray(x) for x in (o, d, t_max, ignore)))))
    assert 100 < got.sum() < len(got) - 100


# ---------------------------------------------------------------------------
# the kernels' warps, replayed in torch
# ---------------------------------------------------------------------------


def _warp_model(rays, ig, soa, any_hit, coop_max):
    """A replay of csrc/dense_intersect.cu's warps: rays padded with dead ones
    to whole warps of 32 lanes; superchunk by superchunk, each lane's box
    tests against its own limit (its best t; any hit: t_max, -1 once
    blocked); for each chunk the warp's ballot; a ballot of at most
    `coop_max` rays splits each member's 128 tests over the lanes (lane j
    prims j, 32 + j, 64 + j, 96 + j, a strict < in that order), reduces the
    lexicographic least (t, slot) by a 5-level xor butterfly and merges it
    into the member's best (a smaller t, or an equal t with a lower slot);
    a denser ballot runs a lane a ray over the whole chunk with strict-less
    updates. Returns what dense_trace_plain / dense_occlude_plain return."""
    n = rays.shape[1]
    (rays_p, ig_p), = list(tpi._slices(rays, ig))  # whole warps of dead padding
    n_pad = rays_p.shape[1]
    w = n_pad // LANES
    has_tri, has_sph = soa.num_tris > 0, soa.num_prims > soa.num_tris
    n_chunks, n_super = soa.n_chunks, soa.n_super
    cs = tpi.PRIM_BLOCK if n_chunks > 1 else soa.padded
    inv = [tpi._safe_inv(rays_p[k]) for k in (3, 4, 5)]
    tmax = rays_p[6].view(w, LANES)
    best_t = tmax.clone()
    best_p = torch.full((w, LANES), -1, dtype=torch.int32)
    best_u, best_v = torch.zeros(w, LANES), torch.zeros(w, LANES)
    blocked = torch.zeros(w, LANES, dtype=torch.bool)
    lanes = torch.arange(LANES)

    def limit():
        return torch.where(blocked, -1.0, tmax) if any_hit else best_t

    def reach(table, j, lim):
        return tpi._box_reach(table, j, rays_p, inv, lim.reshape(-1)).view(w, LANES)

    for s in range(n_super if n_super > 1 else 1):
        ls = limit()
        sc = ls > 0.0
        if n_super > 1:
            sc = sc & reach(soa.super_bounds, s, ls)
        for j in range(s * tpi.SC_FACTOR, min(n_chunks, (s + 1) * tpi.SC_FACTOR)):
            lj = limit()
            want = sc & (lj > 0.0)
            if n_chunks > 1:
                want = want & reach(soa.chunk_bounds, j, lj)
            if not want.any():
                continue
            base = j * tpi.PRIM_BLOCK
            t, u, v, ok = tpi._chunk_hits(soa.rows[:, base: base + cs], base, rays_p, ig_p,
                                          has_tri, has_sph)
            t, u, v, ok = (x.view(w, LANES, cs) for x in (t, u, v, ok))
            if any_hit:
                ok = ok & (t < tmax[:, :, None])
            coop = (want.sum(1) <= coop_max)[:, None] & want  # members of sparse ballots
            dense = ~(want.sum(1) <= coop_max)[:, None] & want  # lanes of dense ballots
            # dense ballots: a lane a ray, slot by slot
            for k in range(cs):
                if any_hit:
                    blocked |= dense & ok[:, :, k]
                    continue
                take = dense & ok[:, :, k] & (t[:, :, k] < best_t)
                best_t = torch.where(take, t[:, :, k], best_t)
                best_p = torch.where(take, base + k, best_p)
                best_u = torch.where(take, u[:, :, k], best_u)
                best_v = torch.where(take, v[:, :, k], best_v)
            # sparse ballots: (warp, member, lane) pairs, member m's prim 32 q + lane
            steps = -(-cs // LANES)
            if any_hit:
                hit = torch.zeros(w, LANES, dtype=torch.bool)
                for q in range(steps):
                    k = LANES * q + lanes
                    valid = k < cs
                    kk = k.clamp(max=cs - 1)
                    step_hit = (ok[:, :, kk] & valid).any(dim=2)  # the ballot over the lanes
                    hit |= step_hit  # (a member stops at its first such step)
                blocked |= coop & hit
                continue
            bt = torch.full((w, LANES, LANES), float("inf"))
            bs = torch.full((w, LANES, LANES), NO_SLOT, dtype=torch.int64)
            bu, bv = torch.zeros(w, LANES, LANES), torch.zeros(w, LANES, LANES)
            for q in range(steps):
                k = LANES * q + lanes
                valid = k < cs
                kk = k.clamp(max=cs - 1)
                tk = t[:, :, kk]
                take = valid & ok[:, :, kk] & (tk < bt)
                bt = torch.where(take, tk, bt)
                bs = torch.where(take, base + k, bs)
                bu = torch.where(take, u[:, :, kk], bu)
                bv = torch.where(take, v[:, :, kk], bv)
            for off in (16, 8, 4, 2, 1):
                o_ = lanes ^ off
                ot, os_ = bt[:, :, o_], bs[:, :, o_]
                take = (ot < bt) | ((ot == bt) & (os_ < bs))
                bt, bs = torch.where(take, ot, bt), torch.where(take, os_, bs)
            assert (bt == bt[:, :, :1]).all() and (bs == bs[:, :, :1]).all()  # lanes agree
            wt, ws = bt[:, :, 0], bs[:, :, 0]
            src = ((ws - base) & (LANES - 1)).clamp(min=0)[:, :, None]
            wu, wv = torch.gather(bu, 2, src)[:, :, 0], torch.gather(bv, 2, src)[:, :, 0]
            found = coop & (ws != NO_SLOT)
            take = found & ((wt < best_t) | ((wt == best_t) & (best_p >= 0) & (ws < best_p)))
            best_t = torch.where(take, wt, best_t)
            best_p = torch.where(take, ws.to(torch.int32), best_p)
            best_u = torch.where(take, wu, best_u)
            best_v = torch.where(take, wv, best_v)
    if any_hit:
        return blocked.reshape(-1)[:n]
    return tuple(x.reshape(-1)[:n] for x in (best_t, best_p, best_u, best_v))


CLUSTER_GAP = 12.0  # between cluster centres, along x


def _clusters(n_chunks, copies=False, seed=0):
    """Clusters of 112 small triangles and 16 small spheres about (12 k, 0,
    0), ordered so that chunk k holds cluster k: a ray along +z through a
    cluster enters its chunk alone. With `copies`, chunk k + n_chunks / 2
    repeats chunk k prim for prim: every hit has an exact (t) tie at a
    higher slot in another chunk. Returns (geometry, order)."""
    rs = np.random.RandomState(seed)
    nt, ns = 112, 16
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


def _tied_clusters(seed=3):
    """40 chunks (2 superchunks), chunk k + 20 a copy of chunk k; 640 rays:
    warps of rays through one cluster, through scattered clusters, ignoring a
    copied prim, dead (t_max 0, -1, -inf) or stopping inside a cluster, and
    the last 96 incoherent. Returns (soa, rays, sorted ignores, the sorted
    slot of each slot's copy)."""
    g, order = _clusters(40, copies=True, seed=seed)
    soa = tpi.build_prim_soa(g, order=order)
    half = 20 * tpi.PRIM_BLOCK
    slots = torch.arange(soa.padded)
    twin = torch.where(slots < half, slots + half, slots - half)
    rs = np.random.RandomState(seed)
    which = np.concatenate([np.full(64, 7), np.full(32, 19), rs.randint(0, 20, 448)])
    o, d, t_max, ignore = _at_clusters(which, seed=seed)
    t_max[96::7] = rs.choice([0.0, -1.0, -np.inf], len(t_max[96::7]))
    t_max[97::11] = rs.uniform(5.0, 7.0, len(t_max[97::11]))
    ignore[98::5] = rs.randint(0, soa.num_prims, len(ignore[98::5]))
    ro, rd, rt, ri = _rays(96, soa.num_prims, seed=seed)
    ro = ro * [25.0 / 12.0, 0.2, 0.5] + [228.0, 0.0, 0.0]
    o, d = np.concatenate([o, ro.astype(np.float32)]), np.concatenate([d, rd])
    t_max, ignore = np.concatenate([t_max, rt]), np.concatenate([ignore, ri])
    rays = tpi.ray_columns(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    return soa, rays, tpi._sorted_ignore(soa, torch.as_tensor(ignore)), twin


def _soup_case():
    g, order = _bvh_soup(2600, 900, seed=5)  # 28 chunks: one superchunk
    soa = tpi.build_prim_soa(g, order=order)
    o, d, t_max, ignore = _soup_rays(soa.num_prims, seed=6)
    rays = tpi.ray_columns(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    return soa, rays, tpi._sorted_ignore(soa, torch.as_tensor(ignore)), None


@pytest.mark.parametrize("coop_max", [0, 1, COOP_MAX, LANES],
                         ids=["all-dense", "g1", "kCoopMax", "all-spread"])
@pytest.mark.parametrize("case", ["tied-clusters", "bvh-soup"])
def test_warp_model_matches_plain(case, coop_max):
    """The kernels' ballots, lane split and butterfly give the plain walk's
    answers bit for bit, whatever the crossover."""
    soa, rays, ig, twin = _tied_clusters() if case == "tied-clusters" else _soup_case()
    want = tpi.dense_trace_plain(rays, ig, soa)
    got = _warp_model(rays, ig, soa, False, coop_max)
    for name, a, b in zip("tpuv", got, want):
        assert torch.equal(a, b), name
    assert torch.equal(_warp_model(rays, ig, soa, True, coop_max),
                       tpi.dense_occlude_plain(rays, ig, soa))
    found = want[1] >= 0
    assert found.sum() > 200
    assert (rays[6] <= 0)[~found].any() and not found[rays[6] <= 0].any()  # dead rays
    if twin is not None:  # a hit on a copied prim ignoring neither copy: the lower slot
        slot = want[1][found & (ig < 0)].long()
        assert len(slot) > 100 and (slot < twin[slot]).all()


def test_plain_culls_per_ray():
    """A ray tests only the chunks whose boxes (and superchunk's) it enters
    before its own best t, whatever its warp-mates reach: each ray's visits
    are the same alone as in a batch, and a ray through one cluster tests
    that cluster's chunk and its copy's, not its warp-mates' chunks."""
    soa, rays, ig, _ = _tied_clusters()
    visits = []
    tpi._walk(*next(tpi._slices(rays, ig)), soa, False, visits=visits)
    tested = torch.zeros(rays.shape[1] + 31, soa.n_chunks, dtype=torch.bool)
    for idx, j in visits:
        tested[idx, j] = True
    tested = tested[: rays.shape[1]]
    for i in (0, 70, 130, 200, 555):
        alone = []
        tpi._walk(rays[:, i: i + 1].contiguous(), ig[i: i + 1].contiguous(), soa, False,
                  visits=alone)
        assert sorted(j for _, j in alone) == torch.nonzero(tested[i]).squeeze(1).tolist()
    # rays 0-63 go through cluster 7 (chunks 7 and 27), rays 64-95 through 19 (19, 39)
    assert tested[:64].any(dim=0).nonzero().squeeze(1).tolist() == [7, 27]
    assert tested[64:96].any(dim=0).nonzero().squeeze(1).tolist() == [19, 39]
    # a scattered warp: each ray tests at most its own cluster's two chunks
    assert (tested[96:544].sum(dim=1) <= 2).all()
    assert tested[96:544].any(dim=0).sum() > 30


def test_plain_pads_to_whole_warps():
    """The plain version pads a ray count off the warp with dead rays: any
    count gives the rays' own results."""
    soa, rays, ig, _ = _tied_clusters()
    full = tpi.dense_trace_plain(rays, ig, soa)
    occ = tpi.dense_occlude_plain(rays, ig, soa)
    for n in (1, 31, 33, 100):
        part = tpi.dense_trace_plain(rays[:, :n].contiguous(), ig[:n].contiguous(), soa)
        for a, b in zip(part, full):
            assert torch.equal(a, b[:n])
        assert torch.equal(tpi.dense_occlude_plain(rays[:, :n].contiguous(), ig[:n].contiguous(),
                                                   soa), occ[:n])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the dense CUDA kernels need an NVIDIA GPU")
    return torch.device("cuda")


def _kernel_equals_plain(soa, rays, ig):
    """dense_trace / dense_occlude against their plain versions, bitwise;
    returns the plain trace."""
    want = tpi.dense_trace_plain(rays, ig, soa)
    got = tpi.dense_trace(rays, ig, soa)
    blocked = tpi.dense_occlude(rays, ig, soa)
    torch.cuda.synchronize()
    for name, k, p in zip("tpuv", got, want):
        assert torch.equal(k, p), name
    assert torch.equal(blocked, tpi.dense_occlude_plain(rays, ig, soa))
    return want


def _on(dev, soa, o, d, t_max, ignore):
    """(tables, ray columns, sorted ignores) on `dev` from numpy rays."""
    soa = soa._replace(**{k: getattr(soa, k).to(dev) for k in
                          ("rows", "chunk_bounds", "super_bounds", "order", "inv_order")})
    rays = tpi.ray_columns(*(torch.as_tensor(x, device=dev) for x in (o, d, t_max)))
    return soa, rays, tpi._sorted_ignore(soa, torch.as_tensor(ignore, device=dev))


def _synthetic_42k(rs):
    """40,000 small triangles and 2,000 spheres scattered in a 40x10x40 box
    (chip_smoke.synthetic_scene), in BVH order."""
    t, s = 40_000, 2_000
    g = _geometry_np(t, s, seed=11)
    g["tri_v0"] = (rs.uniform(-20, 20, (t, 3)) * [1, 0.25, 1] + [0, 5, 0]).astype(np.float32)
    g["tri_e1"] = rs.uniform(-0.6, 0.6, (t, 3)).astype(np.float32)
    g["tri_e2"] = rs.uniform(-0.6, 0.6, (t, 3)).astype(np.float32)
    g["sph_center"] = (rs.uniform(-20, 20, (s, 3)) * [1, 0.25, 1] + [0, 5, 0]).astype(np.float32)
    g["sph_radius"] = rs.uniform(0.1, 0.5, s).astype(np.float32)
    bmin, bmax = geometry_bounds(g)
    order = build_bvh(bmin, bmax).prim_order
    return tpi.build_prim_soa(g, order=order,
                              packed=tpi.pack_sorted_prims(g, order, bounds=(bmin, bmax)))


@pytest.mark.cuda
def test_cuda_42k_soup(cuda):
    """A camera tile and 2^16 incoherent rays against the 42k-prim soup."""
    rs = np.random.RandomState(2024)
    soa = _synthetic_42k(rs)
    cam = _camera_tile(128, (0.0, 5.0, -40.0), (0.0, 5.0, 0.0), 1)
    rnd = _rays(2 ** 16, soa.num_prims, seed=12)
    rnd = (rnd[0] * [20.0 / 12.0, 0.25, 20.0 / 12.0] + [0.0, 5.0, 0.0],) + rnd[1:]
    args = [np.concatenate([a, b]).astype(a.dtype) for a, b in zip(cam, rnd)]
    want = _kernel_equals_plain(*_on(cuda, soa, *args))
    assert (want[1] >= 0).sum() > 2 ** 14


@pytest.mark.cuda
@pytest.mark.parametrize("members", [1, 32])
def test_cuda_ballot_of_one_and_of_32(cuda, members):
    """Every warp's ballot holds `members` rays through one cluster (the
    rest dead); the third warp's rays are identical."""
    g, order = _clusters(40)
    soa = tpi.build_prim_soa(g, order=order)
    o, d, t_max, ig = _at_clusters(np.full(128, 5), seed=members)
    o[64:96], d[64:96] = o[64], d[64]
    lane = np.arange(128) % LANES
    t_max[lane >= members] = 0.0
    want = _kernel_equals_plain(*_on(cuda, soa, o, d, t_max, ig))
    assert (want[1] >= 0).sum() >= members * 2


@pytest.mark.cuda
@pytest.mark.parametrize("g", [COOP_MAX, COOP_MAX + 1])
def test_cuda_at_the_crossover(cuda, g):
    """Ballots of exactly kCoopMax rays (spread over the lanes) and of one
    more (a lane a ray), all through one chunk, exact ties included."""
    gm, order = _clusters(40, copies=True)
    soa = tpi.build_prim_soa(gm, order=order)
    o, d, t_max, ig = _at_clusters(np.full(256, 5), seed=g)
    t_max[np.arange(256) % LANES >= g] = -1.0
    want = _kernel_equals_plain(*_on(cuda, soa, o, d, t_max, ig))
    assert (want[1] >= 0).sum() > g


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 127, 129, 1000])
def test_cuda_ray_counts_off_the_warp(cuda, n):
    """n not a multiple of 32 or of a block: the lanes past the last ray
    walk dead rays with their warp."""
    g, order = _clusters(40)
    soa = tpi.build_prim_soa(g, order=order)
    rs = np.random.RandomState(n)
    o, d, t_max, ig = _at_clusters(rs.randint(0, 40, n), seed=n)
    d[::3] = rs.normal(size=(len(d[::3]), 3)).astype(np.float32)  # a third wander
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _kernel_equals_plain(*_on(cuda, soa, o, d, t_max, ig))


@pytest.mark.cuda
def test_cuda_ties_ignores_and_dead_rays(cuda):
    """The replay's tied clusters on the card: exact ties across chunks,
    ignores, dead rays, rays stopping inside a cluster."""
    soa, rays, ig, _ = _tied_clusters()
    soa = soa._replace(**{k: getattr(soa, k).to(cuda) for k in
                          ("rows", "chunk_bounds", "super_bounds", "order", "inv_order")})
    _kernel_equals_plain(soa, rays.to(cuda), ig.to(cuda))
