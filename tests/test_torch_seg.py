"""PyTorch port: the seg kernel's grouping of pairs into runs (csrc/binned.cu
`seg_kernel`, kernel 7 of the JAX package's binned traversal).

The CUDA kernel takes the chunk-sorted pair list a warp tile at a time
(kSegTile consecutive pairs), walks each tile's runs of one chunk, and tests
a run's pairs in batches of 32: a full batch one pair a lane over all 256
prims in slot order, a short batch (fewer than 32 pairs left in the run) the
whole warp per member, lane i on prims 4i .. 4i + 3 and 128 + 4i .. 131 + 4i,
then a min of the keys or a xor butterfly of the least (t, slot), u and v
from the winner's lane. Pairs without a valid chunk get their sentinels. `_seg_model` replays
that logic in torch (the prim tests are the plain version's `_chunk_hits`),
and the tests hold it:

- bitwise to `seg_keys_plain` / `seg_hits_plain`, keyed and exact, flat and
  instanced, for the kernel's tile and a wider one, on pair lists built to
  take every branch: runs of 1, 2, 31, 32, 33 and 300 pairs, runs that
  straddle tiles, dead pairs inside a run, an all-dead tail, M = 0, exact
  equal-t ties between two slots of one chunk (copied prims), and, on an
  instanced list, two global chunks of different instances that map to one
  pack chunk with the ray's ignore in only one of them;
- against the JAX package's `_pack_and_intersect` (the Pallas kernel in
  interpret mode), keyed and exact, on tests/test_torch_binned.py's and
  tests/test_torch_binned_exact.py's flat and instanced rounds, with the
  tolerances those files state.

The CUDA kernel is held bitwise to the plain versions on the same lists on
the card:

    python -m pytest --noconftest tests/test_torch_seg.py -k cuda
"""

import collections

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.ops import binned_trace as bt
from echorenderer_tpu_torch.ops import pallas_hier as ph
from echorenderer_tpu_torch.ops import pallas_intersect as tpi
from echorenderer_tpu_torch.ops.pallas_hier import HCHUNK
from echorenderer_tpu_torch.utils import diagnostics

import test_torch_binned as tb
import test_torch_binned_exact as tbe
from test_torch_binned import grid  # noqa: F401  (the fixture, for the JAX comparison)

torch.set_num_threads(1)

LANES = 32
TILE = 32  # csrc/binned.cu's kSegTile: consecutive pairs a warp takes
NO_SLOT = 2**31 - 1
# a short batch's split of a chunk: step s gives lane i prim LANE_PRIMS[s][i]
# (prims 4i .. 4i + 3, then 128 + 4i .. 131 + 4i: one 16-byte load a row)
LANE_PRIMS = [HCHUNK // 2 * half + 4 * torch.arange(LANES) + i
              for half in range(2) for i in range(4)]
KINDS = {"mixed": (True, True), "tris-only": (True, False), "spheres-only": (False, True)}
# the branches every adversarial list must take
BRANCHES = ("full batch", "short batch", "dead run", "dead pair", "straddle", "runs in a tile",
            "dead tile")


def _seg_model(rec, chunk, prim_chunks, has_tri, has_sph, inst=None, keyed=True, tile=TILE,
               seen=None):
    """The CUDA seg kernel's tiles, runs, batches and reductions, in torch:
    the keys (M,) int32, or the exact (t, prim, u, v). `seen` counts the
    branches taken."""
    seen = collections.Counter() if seen is None else seen
    m = rec.shape[0]
    n_chunks = prim_chunks.shape[0] if inst is None else inst[0].shape[0]
    keys = torch.full((m,), bt._INT_INF, dtype=torch.int32)
    out = torch.zeros((4, m))
    lanes = torch.arange(LANES)
    chunk = chunk.long()
    for begin in range(0, m, tile):
        end = min(begin + tile, m)
        s = begin
        seen["straddle"] += bool(begin and chunk[begin] == chunk[begin - 1])
        runs = 0
        while s < end:
            c = int(chunk[s])
            other = torch.nonzero(chunk[s + 1:end] != c)
            e = s + 1 + int(other[0]) if other.numel() else end
            runs += 1
            if not 0 <= c < n_chunks:  # sentinels only
                seen["dead run"] += 1
                seen["dead tile"] += s == begin and e == end
                out[:, s:e] = torch.stack([rec[s:e, 6], torch.full((e - s,), -1.0),
                                           torch.zeros(e - s), torch.zeros(e - s)])
                s = e
                continue
            pc, ii = c, None
            if inst is not None:
                g2c, g2i, inst_f32 = inst
                pc, ii = int(g2c[c]), int(g2i[c])
            base = pc * HCHUNK
            for b in range(s, e, LANES):
                nb = min(LANES, e - b)
                r = rec[b:b + nb]
                ray, ign = r[:, 0:6].T, r[:, 7]
                if inst is not None:
                    which = torch.full((nb,), ii, dtype=torch.int32)
                    ray = torch.cat(ph.to_instance(inst_f32, which, r[:, 0:3].T, r[:, 3:6].T))
                    ign = torch.where(r[:, 8] == float(ii), ign, -1.0)
                live = r[:, 6] > 0.0
                seen["dead pair"] += int((~live).sum())
                rows = prim_chunks[pc, :10, None, :].expand(10, nb, HCHUNK)
                t, u, v, ok = tpi._chunk_hits(rows, torch.full((nb,), base, dtype=torch.int32),
                                              ray, ign.to(torch.int32), has_tri, has_sph,
                                              unit_dir=inst is None)
                tmax = r[:, 6:7]
                hit = ok & (t < tmax) & (t < bt._INF)
                key = torch.where(hit, (bt._bits(t) & -(1 << bt._PBITS))
                                  | torch.arange(HCHUNK, dtype=torch.int32), bt._INT_INF)
                if nb == LANES:  # one pair a lane, its 256 prims in slot order
                    seen["full batch"] += 1
                    k_out = key.amin(1)
                    bt_, bs = tmax[:, 0].clone(), torch.full((nb,), -1)
                    bu, bv = torch.zeros(nb), torch.zeros(nb)
                    for j in range(HCHUNK):  # strict <: an equal t keeps the lower slot
                        take = hit[:, j] & (t[:, j] < bt_)
                        bt_ = torch.where(take, t[:, j], bt_)
                        bs = torch.where(take, base + j, bs)
                        bu = torch.where(take, u[:, j], bu)
                        bv = torch.where(take, v[:, j], bv)
                else:  # the whole warp per member: lane i on prims 4i.., 128 + 4i..
                    seen["short batch"] += 1
                    lane_key = torch.full((nb, LANES), bt._INT_INF, dtype=torch.int32)
                    lt = tmax.expand(nb, LANES).clone()
                    ls = torch.full((nb, LANES), NO_SLOT)
                    lu, lv = torch.zeros(nb, LANES), torch.zeros(nb, LANES)
                    for k in LANE_PRIMS:  # (LANES,) prims, each lane's in slot order
                        lane_key = torch.minimum(lane_key, key[:, k])
                        take = hit[:, k] & (t[:, k] < lt)
                        lt = torch.where(take, t[:, k], lt)
                        ls = torch.where(take, k, ls)
                        lu = torch.where(take, u[:, k], lu)
                        lv = torch.where(take, v[:, k], lv)
                    k_out = lane_key.amin(1)  # __reduce_min_sync
                    for off in (16, 8, 4, 2, 1):
                        q = lanes ^ off
                        ot, os_ = lt[:, q], ls[:, q]
                        take = (ot < lt) | ((ot == lt) & (os_ < ls))
                        lt, ls = torch.where(take, ot, lt), torch.where(take, os_, ls)
                    assert (lt == lt[:, :1]).all() and (ls == ls[:, :1]).all()  # every lane agrees
                    found = ls[:, 0] != NO_SLOT
                    src = ((ls[:, 0] >> 2) & (LANES - 1))[:, None]  # the winner's lane
                    bt_ = torch.where(found, lt[:, 0], tmax[:, 0])
                    bs = torch.where(found, base + ls[:, 0], -1)
                    bu = torch.where(found, lu.gather(1, src)[:, 0], 0.0)
                    bv = torch.where(found, lv.gather(1, src)[:, 0], 0.0)
                keys[b:b + nb] = torch.where(live, k_out, bt._INT_INF)
                out[:, b:b + nb] = torch.where(
                    live[None], torch.stack([bt_, bs.to(torch.float32), bu, bv]),
                    torch.stack([tmax[:, 0], torch.full((nb,), -1.0), torch.zeros(nb),
                                 torch.zeros(nb)]))
            s = e
        seen["runs in a tile"] += runs > 1
    return keys if keyed else tuple(out)


# ---------------------------------------------------------------------------
# adversarial pair lists
# ---------------------------------------------------------------------------


def _chunks(n_chunks, seed):
    """(C, 16, HCHUNK) prim rows: 200 triangles, 40 spheres and 16 empty
    slots a chunk, and 24 (source, copy) slot pairs a chunk, the copy at a
    higher slot of the same chunk (an exact t tie). Returns (rows, copies
    (C, 24, 2))."""
    rs = np.random.RandomState(seed)
    rows = np.zeros((n_chunks, 16, HCHUNK), np.float32)
    nt, ns = 200, 40
    rows[:, 0:3, :nt] = rs.uniform(-5, 5, (n_chunks, 3, nt))
    rows[:, 3:9, :nt] = rs.uniform(-1.5, 1.5, (n_chunks, 6, nt))
    rows[:, 0:3, nt:nt + ns] = rs.uniform(-5, 5, (n_chunks, 3, ns))
    rows[:, 3, nt:nt + ns] = rs.uniform(0.2, 0.8, (n_chunks, ns))
    rows[:, 9, nt:nt + ns] = 1.0
    copies = np.zeros((n_chunks, 24, 2), np.int64)
    for c in range(n_chunks):
        src = rs.choice(nt + ns, 24, replace=False)
        dst = rs.choice(np.arange(nt + ns), 24, replace=False)
        src, dst = np.minimum(src, dst), np.maximum(src, dst)
        keep = src != dst
        src, dst = src[keep], dst[keep]
        rows[c, :, dst] = rows[c, :, src]
        copies[c, :len(src)] = np.stack([src, dst], 1)
        copies[c, len(src):] = copies[c, 0]
    return torch.as_tensor(rows), copies


def _targets(rows, c, j):
    """Aim points, in the rows' own space, of prims j of chunks c: a
    triangle's centroid, a sphere's center."""
    p = rows[c, :, j].numpy().astype(np.float64)  # (n, 16)
    tri = p[:, 9] < 0.5
    cen = p[:, 0:3].copy()
    cen[tri] += (p[tri, 3:6] + p[tri, 6:9]) / 3.0
    return cen


RUNS = [1, 2, 31, 32, 33, 300, 1, 5, 64, 17, 3, 40, 2, 1, 96, 7]
N_FLAT = len(RUNS)  # chunks of the flat list, one run each


def _pair_list(rows, copies, n_valid, seed, inst=None, dead_tail=70):
    """Records (M, 8) or (M, 9) and chunk ids (M,) of RUNS' runs (of chunks
    0, 1, ...), then `dead_tail` dead pairs
    (chunk n_valid, t_max 0, ignores -2, as `_Walk.pairs` writes them). A
    third of the pairs aim at a copied prim (an exact tie), a fifth ignore
    the prim they aim at, a fifteenth are dead (t_max 0), a sixth have a
    t_max below their aim. With `inst` = (g2c, g2i, A, b) the chunks are
    global: the ray aims at the prim placed by its instance (world = A^-1
    (p - b)), and column 8 holds the ignore's instance: the run's own, or
    on every second pair the other instance of a shared pack chunk."""
    rs = np.random.RandomState(seed)
    c_of = np.concatenate([np.full(n, g) for g, n in enumerate(RUNS)])
    m = len(c_of)
    pc = c_of if inst is None else inst[0][c_of]
    j = rs.randint(0, 240, m)
    tie = rs.uniform(size=m) < 0.35
    pick = rs.randint(0, 24, m)
    j = np.where(tie, copies[pc, pick, 0], j)
    aim = _targets(rows, pc, j) + rs.uniform(-0.05, 0.05, (m, 3))
    if inst is not None:
        _, g2i, a_mat, b_vec = inst
        ii = g2i[c_of]
        aim = np.einsum("mij,mj->mi", np.linalg.inv(a_mat[ii]), aim - b_vec[ii])
    away = rs.normal(size=(m, 3))
    away /= np.linalg.norm(away, axis=1, keepdims=True)
    dist = rs.uniform(3.0, 12.0, m)
    o = aim + away * dist[:, None]
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rs.uniform(size=m) < 1 / 6, rs.uniform(0.5, 6.0, m), bt._INF)
    t_max = np.where(rs.uniform(size=m) < 1 / 15, 0.0, t_max)
    ign = np.where(rs.uniform(size=m) < 0.2, pc * HCHUNK + j, -1)
    cols = [o, d, t_max[:, None], ign[:, None]]
    if inst is not None:
        own = inst[1][c_of]
        other = np.array([inst[1][np.flatnonzero((inst[0] == p) & (inst[1] != i))[0]]
                          if ((inst[0] == p) & (inst[1] != i)).any() else i
                          for p, i in zip(pc, own)])
        cols.append(np.where(np.arange(m) % 2 == 0, own, other)[:, None])
    rec = np.concatenate(cols, 1).astype(np.float32)
    dead = np.zeros((dead_tail, rec.shape[1]), np.float32)
    dead[:, 7:] = -2.0
    rec = np.concatenate([rec, dead])
    c_all = np.concatenate([c_of, np.full(dead_tail, n_valid)]).astype(np.int32)
    return torch.as_tensor(rec).contiguous(), torch.as_tensor(c_all)


def _flat_case(seed=0):
    """RUNS' runs over the 16 chunks, one each, then the dead tail."""
    rows, copies = _chunks(N_FLAT, seed)
    rec, chunk = _pair_list(rows, copies, N_FLAT, seed + 1)
    return rec, chunk, rows, None


def _rotation(rs):
    q, _ = np.linalg.qr(rs.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _instanced_case(seed=0):
    """6 pack chunks placed by 4 instances as 16 global chunks (RUNS' runs,
    one each): every pack chunk lies in two or three instances, pack chunk
    2 in global chunks 2 (instance 0), 4 (instance 1) and 12 (instance
    3)."""
    rs = np.random.RandomState(seed)
    rows, copies = _chunks(6, seed)
    g2c = np.array([0, 1, 2, 3, 2, 3, 4, 5, 0, 1, 4, 5, 2, 3, 0, 1])
    g2i = np.repeat(np.arange(4), 4)
    # instance space from world: A = R / s, b (o' = A o + b)
    a_mat = np.stack([_rotation(rs) / rs.uniform(0.5, 2.0) for _ in range(4)])
    b_vec = rs.uniform(-3, 3, (4, 3))
    rec, chunk = _pair_list(rows, copies, len(g2c), seed + 1, inst=(g2c, g2i, a_mat, b_vec))
    inst_f32 = torch.as_tensor(np.concatenate([a_mat.reshape(4, 9), b_vec], 1)
                               .astype(np.float32).reshape(-1))
    inst = (torch.as_tensor(g2c, dtype=torch.int32), torch.as_tensor(g2i, dtype=torch.int32),
            inst_f32)
    return rec, chunk, rows, inst


def _assert_bitwise(got, want):
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _hits_of(keys):
    return int((keys != bt._INT_INF).sum())


@pytest.mark.parametrize("tile", [TILE, 4 * TILE])
@pytest.mark.parametrize("kind", list(KINDS))
def test_model_matches_plain_flat(kind, tile):
    """Every branch of the kernel's grouping, flat, against the plain
    versions bit for bit: keys, and (t, prim, u, v)."""
    rec, chunk, rows, _ = _flat_case()
    kinds = KINDS[kind]
    seen = collections.Counter()
    keys = _seg_model(rec, chunk, rows, *kinds, tile=tile, seen=seen)
    _assert_bitwise(keys, bt.seg_keys_plain(rec, chunk, rows, *kinds))
    exact = _seg_model(rec, chunk, rows, *kinds, keyed=False, tile=tile)
    _assert_bitwise(exact, bt.seg_hits_plain(rec, chunk, rows, *kinds))
    assert all(seen[b] for b in BRANCHES), seen
    assert _hits_of(keys) > 400


@pytest.mark.parametrize("tile", [TILE, 4 * TILE])
def test_model_matches_plain_instanced(tile):
    rec, chunk, rows, inst = _instanced_case()
    seen = collections.Counter()
    keys = _seg_model(rec, chunk, rows, True, True, inst, tile=tile, seen=seen)
    _assert_bitwise(keys, bt.seg_keys_plain(rec, chunk, rows, True, True, inst))
    exact = _seg_model(rec, chunk, rows, True, True, inst, keyed=False, tile=tile)
    _assert_bitwise(exact, bt.seg_hits_plain(rec, chunk, rows, True, True, inst))
    assert all(seen[b] for b in BRANCHES), seen
    assert _hits_of(keys) > 400


def test_lists_force_ties_and_instance_ignores():
    """The lists hold what they claim: found pairs whose winner has an
    exact t tie at another slot of its chunk (the lower slot wins, keyed
    and exact), and on the instanced list pairs of the two global chunks of
    one pack chunk whose ignore holds in one and not the other."""
    rec, chunk, rows, _ = _flat_case()
    t, p, _, _ = bt.seg_hits_plain(rec, chunk, rows, True, True)
    found = p >= 0
    slot = p[found].long()
    pc, j = slot // HCHUNK, slot % HCHUNK
    same = (rows[pc, :10, :] == rows[pc, :10, j][:, :, None]).all(1)  # (n, HCHUNK)
    twin = (same.sum(1) > 1) & (rec[found, 7] < 0)  # a copied prim, nothing ignored
    assert int(twin.sum()) > 30
    assert bool((same.long().argmax(1)[twin] == j[twin]).all())  # the lowest copy won
    keys = bt.seg_keys_plain(rec, chunk, rows, True, True)
    assert torch.equal((keys[found][twin] & 0xFF).long(), j[twin])

    rec, chunk, rows, inst = _instanced_case()
    g2c, g2i, _ = inst
    live = chunk < g2c.shape[0]
    c = chunk.long().clamp(max=g2c.shape[0] - 1)
    ignoring = live & (rec[:, 7] >= 0)
    holds = ignoring & (rec[:, 8] == g2i[c].float())
    for g in (2, 4):  # pack chunk 2 in instances 0 and 1
        assert int((holds & (chunk == g)).sum()) and int((ignoring & ~holds & (chunk == g)).sum())
    assert int(holds.sum()) > 50 and int((ignoring & ~holds).sum()) > 50


def test_empty_and_all_dead():
    """M = 0, and a list of dead pairs alone: sentinels, no test."""
    rows, _ = _chunks(2, 3)
    identity = torch.cat([torch.eye(3).flatten(), torch.zeros(3)])
    for inst in (None, (torch.arange(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                        identity)):
        width = 8 if inst is None else 9
        rec = torch.zeros((0, width))
        chunk = torch.zeros(0, dtype=torch.int32)
        assert _seg_model(rec, chunk, rows, True, True, inst).shape == (0,)
        _assert_bitwise(bt.seg_keys(rec, chunk, rows, True, True, inst=inst),
                        _seg_model(rec, chunk, rows, True, True, inst))
        rec = torch.zeros((77, width))
        rec[:, 6] = torch.linspace(-1.0, 0.0, 77)
        chunk = torch.full((77,), 2, dtype=torch.int32)
        seen = collections.Counter()
        exact = _seg_model(rec, chunk, rows, True, True, inst, keyed=False, seen=seen)
        _assert_bitwise(exact, bt.seg_hits_plain(rec, chunk, rows, True, True, inst))
        assert seen["dead tile"] == 3 and not seen["full batch"] + seen["short batch"]
        assert torch.equal(_seg_model(rec, chunk, rows, True, True, inst),
                           torch.full((77,), bt._INT_INF, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------


class _Modelled:
    """While open, `seg_keys` and `seg_hits` (what `_Walk.pairs` launches)
    run `_seg_model`."""

    def __enter__(self):
        self._saved = bt.seg_keys, bt.seg_hits
        bt.seg_keys = lambda rec, chunk, pcs, tri, sph, inst=None: _seg_model(
            rec, chunk, pcs, tri, sph, inst)
        bt.seg_hits = lambda rec, chunk, pcs, tri, sph, inst=None: _seg_model(
            rec, chunk, pcs, tri, sph, inst, keyed=False)
        return self

    def __exit__(self, *exc):
        bt.seg_keys, bt.seg_hits = self._saved


def test_model_keys_match_jax_flat(grid):  # noqa: F811
    """tests/test_torch_binned.py's comparison of one round's keys with
    `_pack_and_intersect`, the model in the kernel's place."""
    with _Modelled():
        tb.test_seg_keys_plain_matches_jax(grid)


@pytest.fixture(scope="module")
def exact_flat():
    """tests/test_torch_binned_exact.py's flat round, through the model."""
    jnp, jbt, _, _ = tb._jax()
    g, _, jsoa, _, tsoa = tb._both_grid()
    o, d, t_max, ignore = tb._rays(tbe.N, g["tri_v0"].shape[0] + g["sph_center"].shape[0],
                                   seed=11)
    rays = tpi.ray_columns(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    walk = bt._Walk(rays, ph._sorted_ignore(tsoa, torch.as_tensor(ignore)), tsoa, False)

    def jax_call(sel, best_t, ign_f, m_pad):
        return jbt._pack_and_intersect(
            jnp.asarray(sel), jnp.asarray(o), jnp.asarray(d), jnp.asarray(best_t),
            jnp.asarray(ign_f), jsoa.prim_chunks, tsoa.num_chunks, True, True, m_pad,
            keyed=False)

    with _Modelled():
        return tbe._case(walk, tsoa.chunk_bounds, tbe.K, jax_call)


@pytest.fixture(scope="module")
def exact_instanced():
    """tests/test_torch_binned_exact.py's instanced round, through the
    model; also the JAX package's keys of the same pairs."""
    from echorenderer_tpu_torch.scene.convert import from_jax_arrays

    from test_torch_instancing import _jax as _jax_inst
    from test_torch_instancing import _jsc, _mixed, _prep, _scene_rays

    jnp, _, jbt, _, jprepare = _jax_inst()
    jscene = jprepare(_mixed(_jsc(), count=16), instancing="tlas")
    tscene = from_jax_arrays(_prep().flatten_jax(jscene), device="cpu")
    soa, jsoa = tscene.hier_soa, jscene.hier_soa
    o, d, t_max = _scene_rays(tscene, tbe.N, seed=9)
    rs = np.random.RandomState(2)
    ig = np.where(rs.uniform(size=tbe.N) < 0.25,
                  rs.randint(0, tscene.geometry.num_primitives, tbe.N), -1).astype(np.int32)
    ii = rs.randint(0, tscene.instances.num_instances, tbe.N).astype(np.int32)
    rays = tpi.ray_columns(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    ign = torch.as_tensor(ig)
    ign_inst = ph._ignore_inst(soa, ign, torch.as_tensor(ii), missing=0)
    walk = bt._Walk(rays, ph._sorted_ignore(soa, ign), soa, False, ign_inst)
    inst = dict(g2c=jsoa.binned_g2c, g2i=jsoa.binned_g2i, inst_f32=jsoa.inst_f32,
                ign_inst=jnp.asarray(ign_inst.numpy()))

    def jax_call(sel, best_t, ign_f, m_pad, keyed=False):
        return jbt._pack_and_intersect(
            jnp.asarray(sel), jnp.asarray(o), jnp.asarray(d), jnp.asarray(best_t),
            jnp.asarray(ign_f), jsoa.prim_chunks, soa.binned_g2c.shape[0], True, True, m_pad,
            keyed=keyed, inst=inst)

    with _Modelled():
        case = tbe._case(walk, soa.binned_wcb, tbe.K_INSTANCED, jax_call)
    m_pad = -(-(case["sel"].size) // 1024) * 1024
    case["jax_keys"] = np.asarray(jax_call(case["sel"], case["best_t"], walk.ign_f.numpy(),
                                           m_pad, keyed=True))
    return case


def test_model_exact_matches_jax_flat(exact_flat):
    tbe._assert_matches_jax(exact_flat, tbe.UV_ATOL, 20)
    tbe._assert_band_of_keyed(exact_flat)


def test_model_exact_matches_jax_instanced(exact_instanced):
    tbe._assert_matches_jax(exact_instanced, tbe.UV_ATOL_INSTANCED, 0)
    tbe._assert_band_of_keyed(exact_instanced)


def test_model_keys_match_jax_instanced(exact_instanced):
    """The model's keys of the instanced round against the JAX package's:
    the same hit or miss and the same prim on every pair; a key may differ
    only by one band, where the two packages' t of that prim lie on two
    sides of a band edge (tests/test_torch_binned.py's reason: a few ulps,
    XLA's fused multiply-adds), which a handful of pairs may do."""
    got, want = exact_instanced["keys"], exact_instanced["jax_keys"]
    found = want != bt._INT_INF
    assert found.sum() > 100
    np.testing.assert_array_equal(got != bt._INT_INF, found)
    np.testing.assert_array_equal(got[found] & 0xFF, want[found] & 0xFF)
    step = np.abs((got[found] >> bt._PBITS).astype(np.int64) - (want[found] >> bt._PBITS))
    assert step.max() <= 1 and (step > 0).sum() <= 0.02 * found.sum() + 3


# ---------------------------------------------------------------------------
# the CUDA kernel on the same lists (skip without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the binned CUDA kernels need an NVIDIA GPU")
    return torch.device("cuda")


def _on(dev, case):
    rec, chunk, rows, inst = case
    move = lambda x: x.to(dev).contiguous()
    return move(rec), move(chunk), move(rows), None if inst is None else tuple(map(move, inst))


def _held_to_plain(rec, chunk, rows, kinds, inst):
    keys = bt.seg_keys(rec, chunk, rows, *kinds, inst=inst)
    _assert_bitwise(keys, bt.seg_keys_plain(rec, chunk, rows, *kinds, inst))
    _assert_bitwise(bt.seg_hits(rec, chunk, rows, *kinds, inst=inst),
                    bt.seg_hits_plain(rec, chunk, rows, *kinds, inst))
    return keys


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
def test_cuda_runs_match_plain_flat(cuda, kind):
    diagnostics.reset_counts()
    keys = _held_to_plain(*_on(cuda, _flat_case())[:3], KINDS[kind], None)
    assert _hits_of(keys) > 400
    n = diagnostics.counts()
    assert n["launches.binned_seg"] == n["launches.binned_seg_exact"] == 1


@pytest.mark.cuda
def test_cuda_runs_match_plain_instanced(cuda):
    rec, chunk, rows, inst = _on(cuda, _instanced_case())
    diagnostics.reset_counts()
    keys = _held_to_plain(rec, chunk, rows, (True, True), inst)
    assert _hits_of(keys) > 400 and diagnostics.counts()["launches.binned_seg_instanced"] == 1


@pytest.mark.cuda
def test_cuda_runs_shifted_and_dead(cuda):
    """The flat list shifted by every offset of a tile (its runs meet the
    warps' tiles at each phase), a list of dead pairs alone, and M = 0."""
    rec, chunk, rows, _ = _on(cuda, _flat_case(seed=4))
    for shift in range(1, TILE):
        _held_to_plain(rec[shift:].contiguous(), chunk[shift:].contiguous(), rows,
                       (True, True), None)
    dead = torch.zeros((77, 8), device=cuda)
    dead[:, 6] = torch.linspace(-1.0, 0.0, 77, device=cuda)
    _held_to_plain(dead, torch.full((77,), N_FLAT, dtype=torch.int32, device=cuda), rows,
                   (True, True), None)
    diagnostics.reset_counts()
    empty = bt.seg_keys(torch.zeros((0, 8), device=cuda),
                        torch.zeros(0, dtype=torch.int32, device=cuda), rows, True, True)
    assert empty.shape == (0,) and diagnostics.counts()["launches.binned_seg"] == 0
