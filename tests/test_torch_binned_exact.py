"""PyTorch port: kernel 7's exact variant (`_seg_kernel(keyed=False)`,
reached through `_pack_and_intersect(..., keyed=False)`) against the JAX
package, whose Pallas kernel runs in interpret mode here.

One round's (ray, chunk) pairs (each ray's k nearest chunks it enters,
-1 past them; k = 4 flat, 16 instanced) go through the port's `_Walk.pairs(..., keyed=False)` (pair
sort, record gather, `seg_hits`, results back in pair order) and through
the JAX function, on the same tables, rays and sorted-slot ignores:

- flat, on tests/test_torch_binned.py's mixed grid soup (11,000 triangles
  and 1,000 spheres in BVH order, 1,024 rays): the same prim (a float
  sorted slot, -1 where nothing is found) on every pair; t to rtol 1e-5 on
  triangles and SPHERE_RTOL on spheres (atol 1e-6; the JAX package's fused
  multiply-adds, tests/test_torch_binned.py gives the reason), and on the
  pairs without a hit exactly (t_max, 0 for a dead pair); u and v to atol
  1e-5 (the stated triangle-barycentric deviation, cancellation in the
  triple products, tests/test_torch_intersect.py);
- instanced, on the scene of tests/test_torch_instancing_binned.py's
  `binned_case` (a mixed pack placed 16 times, 272 global chunks) with
  per-instance ignores, the JAX call given `inst=dict(g2c, g2i, inst_f32,
  ign_inst)` from its scene's `hier_soa` as `trace_binned` builds it: the
  same, barycentrics at the stated instanced atol 2e-4 (both packages sit
  up to 9e-5 from float64 on small mesh triangles);
- the exact results against the keyed ones of the same pairs (the port's
  plain versions): the same hit or miss on every pair, the key's band
  (bits & ~0xFF) equal to bits(t) & ~0xFF on every found pair, the prims
  equal but for two hits in one band (counted, at most a few).

The CUDA form is held bitwise to `seg_hits_plain`, flat and instanced, and
to the keyed kernel's band, on the card:

    python -m pytest --noconftest tests/test_torch_binned_exact.py -k cuda
"""

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.ops import binned_trace as bt
from echorenderer_tpu_torch.ops import pallas_hier as ph
from echorenderer_tpu_torch.ops import pallas_intersect as tpi
from echorenderer_tpu_torch.ops.pallas_hier import HCHUNK
from echorenderer_tpu_torch.utils import diagnostics

from test_torch_binned import SPHERE_RTOL, _both_grid, _grid_soup, _jax
from test_torch_intersect import _rays

torch.set_num_threads(1)

N = 1024
K = 4
K_INSTANCED = 16  # the world chunk boxes overlap: a ray's nearest 4 rarely hold its hit
TRI_RTOL = 1e-5
UV_ATOL = 1e-5
UV_ATOL_INSTANCED = 2e-4


def _nearest_chunks(rays, boxes, k):
    """Each ray's k nearest boxes it enters before its t_max, (k, N) int32,
    -1 past them."""
    tn = bt._slab_all(rays[0:3].T, rays[3:6].T, boxes, rays[6])
    near = torch.sort(tn, dim=1)
    sel = torch.where(near.values[:, :k] < bt._INF, near.indices[:, :k], -1).T
    return sel.to(torch.int32).contiguous()


def _case(walk, boxes, k, jax_call):
    """One round's pairs, each ray's k nearest chunks, through the port
    (exact and keyed) and the JAX exact call `jax_call(sel, best_t, ign_f,
    m_pad)`."""
    sel = _nearest_chunks(walk.rays, boxes, k)
    best_t = walk.rays[6]
    args = (sel, walk.rays, best_t, walk.ign_f, walk.ii_f)
    got = [x.numpy() for x in walk.pairs(*args, keyed=False)]
    keys = walk.pairs(*args).numpy()
    m_pad = -(-(k * walk.rays.shape[1]) // 1024) * 1024
    want = [np.asarray(x) for x in jax_call(sel.numpy(), best_t.numpy(), walk.ign_f.numpy(), m_pad)]
    return dict(got=got, keys=keys, want=want, sel=sel.numpy(), best_t=best_t.numpy(),
                soa=walk.soa)


@pytest.fixture(scope="module")
def flat():
    jnp, jbt, _, _ = _jax()
    g, _, jsoa, _, tsoa = _both_grid()
    o, d, t_max, ignore = _rays(N, g["tri_v0"].shape[0] + g["sph_center"].shape[0], seed=11)
    rays = tpi.ray_columns(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    walk = bt._Walk(rays, ph._sorted_ignore(tsoa, torch.as_tensor(ignore)), tsoa, False)

    def jax_call(sel, best_t, ign_f, m_pad):
        return jbt._pack_and_intersect(
            jnp.asarray(sel), jnp.asarray(o), jnp.asarray(d), jnp.asarray(best_t),
            jnp.asarray(ign_f), jsoa.prim_chunks, tsoa.num_chunks, True, True, m_pad,
            keyed=False)

    return _case(walk, tsoa.chunk_bounds, K, jax_call)


@pytest.fixture(scope="module")
def instanced():
    from echorenderer_tpu_torch.scene.convert import from_jax_arrays

    from test_torch_instancing import _jax as _jax_inst
    from test_torch_instancing import _jsc, _mixed, _prep, _scene_rays

    jnp, _, jbt, _, jprepare = _jax_inst()
    jscene = jprepare(_mixed(_jsc(), count=16), instancing="tlas")
    tscene = from_jax_arrays(_prep().flatten_jax(jscene), device="cpu")
    soa, jsoa = tscene.hier_soa, jscene.hier_soa
    o, d, t_max = _scene_rays(tscene, N, seed=9)
    rs = np.random.RandomState(2)
    ig = np.where(rs.uniform(size=N) < 0.25, rs.randint(0, tscene.geometry.num_primitives, N),
                  -1).astype(np.int32)
    ii = rs.randint(0, tscene.instances.num_instances, N).astype(np.int32)
    rays = tpi.ray_columns(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max))
    ign = torch.as_tensor(ig)
    ign_inst = ph._ignore_inst(soa, ign, torch.as_tensor(ii), missing=0)
    walk = bt._Walk(rays, ph._sorted_ignore(soa, ign), soa, False, ign_inst)
    # the instanced arguments as trace_binned builds them
    inst = dict(g2c=jsoa.binned_g2c, g2i=jsoa.binned_g2i, inst_f32=jsoa.inst_f32,
                ign_inst=jnp.asarray(ign_inst.numpy()))

    def jax_call(sel, best_t, ign_f, m_pad):
        return jbt._pack_and_intersect(
            jnp.asarray(sel), jnp.asarray(o), jnp.asarray(d), jnp.asarray(best_t),
            jnp.asarray(ign_f), jsoa.prim_chunks, soa.binned_g2c.shape[0], True, True, m_pad,
            keyed=False, inst=inst)

    return _case(walk, soa.binned_wcb, K_INSTANCED, jax_call)


def _assert_matches_jax(case, uv_atol, min_spheres):
    (t, p, u, v), (jt, jp, ju, jv) = case["got"], case["want"]
    np.testing.assert_array_equal(p, jp)
    found = jp >= 0
    assert found.sum() > 100 and (~found).sum() > 300
    # no hit: t stays the pair's t_max (0 for a dead pair), u = v = 0
    np.testing.assert_array_equal(t[~found], jt[~found])
    np.testing.assert_array_equal(np.stack([u, v])[:, ~found], 0.0)
    np.testing.assert_array_equal(t[case["sel"] < 0], 0.0)
    sph = np.zeros_like(found)
    slots = jp[found].astype(np.int64)
    sph[found] = case["soa"].prim_chunks[:, 9, :].reshape(-1).numpy()[slots] > 0.5
    tri = found & ~sph
    assert tri.sum() > 20 and sph.sum() >= min_spheres
    np.testing.assert_allclose(t[tri], jt[tri], rtol=TRI_RTOL, atol=1e-6)
    np.testing.assert_allclose(t[sph], jt[sph], rtol=SPHERE_RTOL, atol=1e-6)
    np.testing.assert_allclose(np.stack([u, v])[:, tri], np.stack([ju, jv])[:, tri],
                               rtol=0, atol=uv_atol)
    np.testing.assert_array_equal(np.stack([u, v])[:, sph], 0.0)


def _assert_band_of_keyed(case):
    """Exact against keyed on the same pairs; returns the within-band ties."""
    (t, p, _, _), keys = case["got"], case["keys"]
    found = keys != bt._INT_INF
    np.testing.assert_array_equal(p >= 0, found)
    bits = t.view(np.int32)
    np.testing.assert_array_equal(bits[found] & ~0xFF, keys[found] & ~0xFF)
    ties = (p[found].astype(np.int64) % HCHUNK) != (keys[found] & 0xFF)
    assert ties.sum() <= 3
    return int(ties.sum())


def test_exact_pairs_match_jax(flat):
    _assert_matches_jax(flat, UV_ATOL, 20)


def test_exact_instanced_pairs_match_jax(instanced):
    _assert_matches_jax(instanced, UV_ATOL_INSTANCED, 0)  # its pairs' hits are triangles


@pytest.mark.parametrize("case", ["flat", "instanced"])
def test_exact_agrees_with_keyed(case, request):
    _assert_band_of_keyed(request.getfixturevalue(case))


def test_seg_hits_plain_ties_and_dead_pairs():
    """Two prims of one chunk hit at the same t: the lower sorted slot wins
    (the JAX kernel's min over pid); a dead pair and an invalid chunk keep
    (t_max, -1, 0, 0)."""
    chunks = torch.zeros((2, 16, HCHUNK))
    for slot in (7, 3):  # the same triangle twice, in slots 3 and 7 of chunk 1
        chunks[1, 0:3, slot] = torch.tensor([-0.5, -0.5, 2.0])
        chunks[1, 3:6, slot] = torch.tensor([2.0, 0.0, 0.0])
        chunks[1, 6:9, slot] = torch.tensor([0.0, 2.0, 0.0])
    rec = torch.tensor([[0, 0, 0, 0, 0, 1, 10.0, -1],
                        [0, 0, 0, 0, 0, 1, 10.0, HCHUNK + 3],  # ignores slot 3
                        [0, 0, 0, 0, 0, 1, 0.0, -1],           # dead
                        [0, 0, 0, 0, 0, 1, 10.0, -1],          # invalid chunk
                        [0, 0, 0, 0, 0, 1, 1.5, -1]])          # t_max below the hit
    chunk = torch.tensor([1, 1, 1, 5, 1], dtype=torch.int32)
    t, p, u, v = bt.seg_hits(rec, chunk, chunks, True, False)
    assert p.tolist() == [HCHUNK + 3, HCHUNK + 7, -1, -1, -1]
    assert t.tolist() == [2.0, 2.0, 0.0, 10.0, 1.5]
    assert u.tolist() == [0.25, 0.25, 0, 0, 0] and v.tolist() == [0.25, 0.25, 0, 0, 0]
    keys = bt.seg_keys(rec, chunk, chunks, True, False)
    assert keys.tolist() == [(bt._bits(t[:1]).item() & ~0xFF) | 3,
                             (bt._bits(t[:1]).item() & ~0xFF) | 7] + [bt._INT_INF] * 3


def test_seg_hits_rejects_bad_inputs():
    chunks = torch.zeros((2, 16, HCHUNK))
    with pytest.raises(ValueError, match="int32"):
        bt.seg_hits(torch.zeros((5, 8)), torch.zeros(5), chunks, True, False)
    with pytest.raises(ValueError, match=r"\(M, 9\)"):
        bt.seg_hits(torch.zeros((5, 8)), torch.zeros(5, dtype=torch.int32), chunks, True, False,
                    inst=(torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                          torch.zeros(12)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        bt.seg_hits(torch.zeros((5, 8), device="meta"),
                    torch.zeros(5, dtype=torch.int32, device="meta"),
                    torch.zeros((2, 16, HCHUNK), device="meta"), True, False)


# ---------------------------------------------------------------------------
# the CUDA kernel (skip without a card)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the binned CUDA kernels need an NVIDIA GPU")
    return torch.device("cuda")


def _held_to_plain_and_keyed(rec, chunk, chunks, kinds, inst=None):
    got = bt.seg_hits(rec, chunk, chunks, *kinds, inst=inst)
    want = bt.seg_hits_plain(rec, chunk, chunks, *kinds, inst)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    keys = bt.seg_keys(rec, chunk, chunks, *kinds, inst=inst)
    found = keys != bt._INT_INF
    assert torch.equal(got[1] >= 0, found) and int(found.sum()) > 1000
    assert torch.equal(bt._bits(got[0])[found] & -256, keys[found] & -256)


@pytest.mark.cuda
def test_cuda_exact_matches_plain(cuda):
    g, order = _grid_soup(30000, 3000, seed=5)
    soa = ph.build_hier_soa(g, order, device=cuda)
    o, d, t_max, ignore = _rays(100_000, 33000, seed=6)
    rays = tpi.ray_columns(*(torch.as_tensor(x, device=cuda) for x in (o, d, t_max)))
    rs = np.random.RandomState(7)
    chunk = torch.as_tensor(np.sort(rs.randint(0, soa.num_chunks, rays.shape[1])).astype(np.int32),
                            device=cuda)
    rec = torch.stack([rays[0], rays[1], rays[2], rays[3], rays[4], rays[5], rays[6],
                       ph._sorted_ignore(soa, torch.as_tensor(ignore, device=cuda)).float()],
                      1).contiguous()
    diagnostics.reset_counts()
    _held_to_plain_and_keyed(rec, chunk, soa.prim_chunks, (True, True))
    assert diagnostics.counts()["launches.binned_seg_exact"] == 1


@pytest.mark.cuda
def test_cuda_exact_instanced_matches_plain(cuda):
    import echorenderer_tpu_torch.scene as tsc
    from echorenderer_tpu_torch.scene.prepare import prepare_scene

    from test_torch_instancing import _mixed, _scene_rays

    scene = prepare_scene(_mixed(tsc, count=16), instancing="tlas", device=cuda)
    soa = scene.hier_soa
    m = 100_000
    o, d, t_max = _scene_rays(scene, m, seed=8)
    rs = np.random.RandomState(5)
    g = torch.as_tensor(np.sort(rs.randint(0, soa.binned_g2c.shape[0], m)).astype(np.int32),
                        device=cuda)
    ign = rs.randint(-1, soa.num_prims, m).astype(np.float32)
    ign_inst = rs.randint(-1, 17, m).astype(np.float32)
    rec = torch.as_tensor(np.concatenate([o, d, np.minimum(t_max, bt._INF)[:, None],
                                          ign[:, None], ign_inst[:, None]], 1),
                          device=cuda).contiguous()
    diagnostics.reset_counts()
    _held_to_plain_and_keyed(rec, g, soa.prim_chunks, (True, True),
                             (soa.binned_g2c, soa.binned_g2i, soa.inst_f32))
    assert diagnostics.counts()["launches.binned_seg_exact_instanced"] == 1
