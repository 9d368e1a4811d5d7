"""PyTorch port: TLAS instancing through the binned traversal and the
wavefront, against the JAX package (the scenes and helpers of
tests/test_torch_instancing.py).

- Kernel 7, instanced (the plain seg kernel inside the port's driver):
  `trace_binned` / `occlude_binned` against the JAX functions (their three
  kernels interpreted) on an instanced scene above the binned threshold:
  prims and instances identical but for counted band ties (two hits in one
  2^-15 band), t and barycentrics as the walk's tests hold them, flags
  identical; against the port's own walk (equal (prim, instance): t, u, v
  bitwise); one pair's key against `_chunk_hits` directly.
- The slice: the wavefront's per-sample sums on an instanced scene against
  the JAX wavefront (tests/test_torch_path.py's tolerances); the binned
  dispatch (the first wave on the walk) against the walk alone.
- The CUDA seg kernel is held to its plain version on the card:

    python -m pytest --noconftest tests/test_torch_instancing_binned.py -k cuda
"""

import numpy as np
import pytest
import torch

import echorenderer_tpu_torch.scene as tsc
from echorenderer_tpu_torch.evaluation import scene_ops as tscene_ops
from echorenderer_tpu_torch.ops import binned_trace as bt
from echorenderer_tpu_torch.ops import pallas_hier as ph
from echorenderer_tpu_torch.ops import pallas_intersect as tpi
from echorenderer_tpu_torch.ops.intersect import Hit
from echorenderer_tpu_torch.scene.convert import from_jax_arrays
from echorenderer_tpu_torch.scene.prepare import prepare_scene as tprepare

from test_torch_instancing import (_assert_hits_close, _jax, _jsc, _mixed, _prep, _scene_rays,
                                   _targs, cuda, mixed)

torch.set_num_threads(1)


def _band(t):
    return np.asarray(t, np.float32).view(np.int32) & ~0xFF


@pytest.fixture(scope="module")
def binned_case():
    """The mixed pack placed 16 times: 17 instances x 16 global chunks, above
    the binned threshold; the JAX traversal's answers on 1,024 rays."""
    jnp, _, jbt, _, jprepare = _jax()
    jscene = jprepare(_mixed(_jsc(), count=16), instancing="tlas")
    tscene = from_jax_arrays(_prep().flatten_jax(jscene), device="cpu")
    n = 1024
    o, d, t_max = _scene_rays(tscene, n, seed=9)
    rs = np.random.RandomState(2)
    ig = np.where(rs.uniform(size=n) < 0.25, rs.randint(0, tscene.geometry.num_primitives, n),
                  -1).astype(np.int32)
    ii = rs.randint(0, tscene.instances.num_instances, n).astype(np.int32)
    jargs = [jnp.asarray(x) for x in (o, d, t_max, ig)]
    ref = jbt.trace_binned(jscene.geometry, jscene.hier_soa, *jargs, jnp.asarray(ii))
    blocked = jbt.occlude_binned(jscene.geometry, jscene.hier_soa, *jargs[:2],
                                 jnp.asarray(np.minimum(t_max, 4.0)), jargs[3], jnp.asarray(ii))
    return dict(tscene=tscene, rays=(o, d, t_max, ig), ii=ii, ref=ref,
                blocked=np.asarray(blocked))


def test_binned_matches_jax(binned_case):
    tscene = binned_case["tscene"]
    assert tscene_ops._use_binned_instanced(tscene)
    o, d, t_max, ig = binned_case["rays"]
    ii = torch.as_tensor(binned_case["ii"])
    got = bt.trace_binned(tscene.geometry, tscene.hier_soa, *_targs(o, d, t_max, ig), ii)
    ref = binned_case["ref"]
    gp, rp = got.prim.numpy(), np.asarray(ref.prim)
    np.testing.assert_array_equal(gp >= 0, rp >= 0)
    same = (gp == rp) & (got.inst.numpy() == np.asarray(ref.inst))
    # a differing (prim, instance) is a band tie: both t in one 2^-15 band
    np.testing.assert_array_equal(_band(got.t.numpy()[~same]), _band(np.asarray(ref.t)[~same]))
    assert (~same).sum() <= 2
    keep = torch.as_tensor(same & (rp >= 0))
    _assert_hits_close(Hit(got.t[keep], got.prim[keep], got.uv[keep], got.inst[keep]),
                       Hit(np.asarray(ref.t)[keep.numpy()], rp[keep.numpy()],
                           np.asarray(ref.uv)[keep.numpy()], np.asarray(ref.inst)[keep.numpy()]),
                       tscene.geometry.num_triangles)
    assert int(keep.sum()) > 300 and len(np.unique(got.inst.numpy()[keep.numpy()])) > 8
    blocked = bt.occlude_binned(tscene.geometry, tscene.hier_soa,
                                *_targs(o, d, np.minimum(t_max, 4.0), ig), ii)
    np.testing.assert_array_equal(blocked.numpy(), binned_case["blocked"])


def test_binned_matches_walk(binned_case):
    """The port's binned traversal against its walk: the same hits; equal
    (prim, instance) give bitwise equal t, u, v (the recovery re-tests the
    winner in its instance's space as the walk does)."""
    tscene = binned_case["tscene"]
    o, d, t_max, ig = binned_case["rays"]
    args = _targs(o, d, t_max, ig) + (torch.as_tensor(binned_case["ii"]),)
    got = bt.trace_binned(tscene.geometry, tscene.hier_soa, *args)
    walk = ph.intersect_hier(tscene.geometry, tscene.hier_soa, *args)
    np.testing.assert_array_equal(got.prim.numpy() >= 0, walk.prim.numpy() >= 0)
    same = (got.prim == walk.prim) & (got.inst == walk.inst)
    assert int((~same).sum()) <= 2
    for a, b in ((got.t, walk.t), (got.uv, walk.uv)):
        assert torch.equal(a[same], b[same])


def test_seg_keys_plain_instanced_matches_direct_test():
    """The instanced plain seg kernel of one pair equals the pack chunk's
    prims tested in the instance's space by `_chunk_hits` directly."""
    scene = tprepare(_mixed(tsc), instancing="tlas", device="cpu")
    soa = scene.hier_soa
    o, d, t_max = _scene_rays(scene, 256, seed=13)
    g = torch.as_tensor(np.random.RandomState(1).randint(0, soa.binned_g2c.shape[0], 256),
                        dtype=torch.int32)
    rec = torch.cat([torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max)[:, None],
                     torch.full((256, 1), -1.0), torch.full((256, 1), -1.0)], 1).contiguous()
    keys = bt.seg_keys(rec, g, soa.prim_chunks, True, True,
                       inst=(soa.binned_g2c, soa.binned_g2i, soa.inst_f32))
    c, inst = soa.binned_g2c[g.long()], soa.binned_g2i[g.long()]
    lo, ld = ph.to_instance(soa.inst_f32, inst, rec[:, 0:3].T, rec[:, 3:6].T)
    t, _, _, ok = tpi._chunk_hits(soa.prim_chunks[c.long(), :10].permute(1, 0, 2),
                                  c * ph.HCHUNK, torch.cat([lo, ld]),
                                  torch.full((256,), -1, dtype=torch.int32), True, True,
                                  unit_dir=False)
    ok &= (t < rec[:, 6:7]) & (rec[:, 6:7] > 0)
    want = torch.where(ok, (t.view(torch.int32) & -256) | torch.arange(256, dtype=torch.int32),
                       bt._INT_INF).amin(1)
    assert torch.equal(keys, want) and int((keys != bt._INT_INF).sum()) > 10



def test_wavefront_matches_jax(mixed):
    """The wavefront on the mixed scene, 16x16, 2 spp, bounce 3, on
    identical tables: per-sample sums as tests/test_torch_path.py holds
    them."""
    import jax.numpy as jnp

    from echorenderer_tpu.evaluation.wavefront import sample_frame_wavefront as jwavefront
    from echorenderer_tpu_torch.evaluation.wavefront import sample_frame_wavefront

    jscene, tscene = mixed
    n, res = 256, (16, 16)
    pid = np.arange(n, dtype=np.uint32)
    pxy = np.stack([pid % res[0], pid // res[0]], -1).astype(np.int32)
    kw = dict(bounce_limit=3, survivability=2.5)
    a, a2 = jwavefront(jscene, jnp.asarray(pid), jnp.asarray(pxy), res, 11, jnp.uint32(0), 2,
                       **kw)
    b, b2 = sample_frame_wavefront(tscene, torch.as_tensor(pid.astype(np.int64)),
                                   torch.as_tensor(pxy), res, 11, 0, 2, **kw)
    a, a2 = np.asarray(a), np.asarray(a2)
    b, b2 = b.numpy(), b2.numpy()
    assert a.sum() > 0
    np.testing.assert_allclose(b, a, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(b2, a2, atol=4e-2, rtol=2e-3)
    np.testing.assert_allclose(b.mean(0), a.mean(0), atol=1e-5, rtol=1e-5)


def test_binned_dispatch_renders(binned_case, monkeypatch):
    """Over the binned threshold the first wave walks and every later one
    takes the instanced binned traversal; with it patched off, the walk
    alone: the two renders agree to the megakernel's tolerance."""
    from echorenderer_tpu_torch.processes.render import _sample_frame

    tscene = binned_case["tscene"]
    assert tscene_ops.dispatch_summary(tscene)["accelerator"] == "binned"
    bt.reset_stats()
    s, q = _sample_frame(tscene, "path", (8, 8), 0, 0, 2, 3, 2.5)
    assert bt.STATS["calls"] > 0
    monkeypatch.setattr(tscene_ops, "_use_binned_instanced", lambda scene: False)
    assert tscene_ops.dispatch_summary(tscene)["accelerator"] == "hier-packet"
    bt.reset_stats()
    s2, q2 = _sample_frame(tscene, "path", (8, 8), 0, 0, 2, 3, 2.5)
    assert bt.STATS["calls"] == 0
    assert bool(torch.isfinite(s).all()) and float(s.sum()) > 0
    # the recovery re-tests the winner as the walk does: the sums differ
    # only on the pixels of band-tie rays
    assert int(((s != s2) | (q != q2)).any(dim=-1).sum()) <= 2


@pytest.mark.cuda
def test_cuda_seg_matches_plain(cuda):
    scene = tprepare(_mixed(tsc, count=16), instancing="tlas", device=cuda)
    soa = scene.hier_soa
    m = 100_000
    o, d, t_max = _scene_rays(scene, m, seed=8)
    rs = np.random.RandomState(5)
    g = torch.as_tensor(np.sort(rs.randint(0, soa.binned_g2c.shape[0], m)).astype(np.int32),
                        device=cuda)
    ign = rs.randint(-1, soa.num_prims, m).astype(np.float32)
    ign_inst = rs.randint(-1, 17, m).astype(np.float32)
    rec = torch.as_tensor(np.concatenate([o, d, t_max[:, None], ign[:, None], ign_inst[:, None]],
                                         1), device=cuda).contiguous()
    inst = (soa.binned_g2c, soa.binned_g2i, soa.inst_f32)
    got = bt.seg_keys(rec, g, soa.prim_chunks, True, True, inst=inst)
    want = bt.seg_keys_plain(rec, g, soa.prim_chunks, True, True, inst)
    assert torch.equal(got, want) and int((want != bt._INT_INF).sum()) > 1000
    assert bt.LAUNCHES_INSTANCED["seg"] > 0
