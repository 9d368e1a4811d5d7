"""PyTorch port: the dense trace/occlude (plain PyTorch versions on the
CPU) against the JAX package's `intersect_pallas` / `occlude_pallas`, which
run their Pallas kernels in interpret mode here. Prim ids and blocked
flags must be identical and t agrees to rtol 1e-5. The barycentrics u, v
lie in [0, 1] and come out of scalar triple products that cancel; XLA's
CPU code may fuse their multiply-adds where PyTorch rounds every op, so a
one-ulp difference grows there: they are held to rtol 1e-5 plus atol 1e-5
(about 80 ulps of 1). The CUDA kernels are held to their plain versions on the card:
identical ids and flags, t/u/v to rtol 1e-6. The JAX package is imported
inside the tests that use it, so that the CUDA tests also run where only
PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_intersect.py -k cuda
"""

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.ops import intersect as tint
from echorenderer_tpu_torch.ops import pallas_intersect as tpi

torch.set_num_threads(1)

GEOMETRIES = [
    (40, 20, False),  # single chunk, mixed types
    (50, 0, False),  # tris only
    (0, 30, False),  # spheres only
    (200, 100, True),  # 3 chunks: culling + reorder
]
IDS = ["mixed-1chunk", "tris-only", "spheres-only", "multichunk-reorder"]


def _geometry_np(num_tris, num_spheres, seed=0):
    """The same random soup as tests/test_pallas_intersect.py."""
    rs = np.random.RandomState(seed)
    z3 = np.zeros((num_tris, 3), np.float32)
    z2 = np.zeros((num_tris, 2), np.float32)
    return dict(
        tri_v0=rs.uniform(-10, 10, (num_tris, 3)).astype(np.float32),
        tri_e1=rs.uniform(-1, 1, (num_tris, 3)).astype(np.float32),
        tri_e2=rs.uniform(-1, 1, (num_tris, 3)).astype(np.float32),
        tri_n0=z3, tri_n1=z3, tri_n2=z3, tri_uv0=z2, tri_uv1=z2, tri_uv2=z2,
        tri_mat=np.zeros(num_tris, np.int32),
        sph_center=rs.uniform(-10, 10, (num_spheres, 3)).astype(np.float32),
        sph_radius=rs.uniform(0.3, 1.5, num_spheres).astype(np.float32),
        sph_mat=np.zeros(num_spheres, np.int32),
    )


def _rays(n, num_prims, seed=1):
    """Random rays; a quarter ignore a random prim (findFar on spheres),
    an eighth are dead (t_max <= 0), the rest reach t_max in (0, 40] or
    infinity."""
    rs = np.random.RandomState(seed)
    o = rs.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ignore = np.where(rs.uniform(size=n) < 0.25, rs.randint(0, num_prims, n), -1).astype(np.int32)
    t_max = rs.uniform(0.0, 40.0, n).astype(np.float32)
    t_max[rs.uniform(size=n) < 0.5] = np.inf
    t_max[: n // 8] = rs.choice([0.0, -1.0], n // 8)
    return o, d, t_max, ignore


def _jax():
    import jax.numpy as jnp

    from echorenderer_tpu.ops import intersect as jint
    from echorenderer_tpu.ops import pallas_intersect as jpi

    return jnp, jint, jpi


def _both(num_tris, num_spheres, order):
    jnp, jint, jpi = _jax()
    g = _geometry_np(num_tris, num_spheres)
    p = num_tris + num_spheres
    perm = np.random.RandomState(9).permutation(p) if order else None
    jgeom = jint.FlatGeometry(**{k: jnp.asarray(v) for k, v in g.items()})
    tgeom = tint.FlatGeometry(**{k: torch.as_tensor(v) for k, v in g.items()})
    return (jgeom, jpi.build_prim_soa(jgeom, order=perm),
            tgeom, tpi.build_prim_soa(g, order=perm), p)


@pytest.mark.parametrize("num_tris,num_spheres,order", GEOMETRIES, ids=IDS)
def test_trace_matches_jax(num_tris, num_spheres, order):
    jnp, _, jpi = _jax()
    jgeom, jsoa, tgeom, tsoa, p = _both(num_tris, num_spheres, order)
    o, d, t_max, ignore = _rays(1000, p)
    ref = jpi.intersect_pallas(jgeom, jsoa, jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t_max), jnp.asarray(ignore))
    got = tpi.intersect_pallas(tgeom, tsoa, torch.as_tensor(o), torch.as_tensor(d),
                               torch.as_tensor(t_max), torch.as_tensor(ignore))
    ref_prim = np.asarray(ref.prim)
    np.testing.assert_array_equal(got.prim.numpy(), ref_prim)
    assert (ref_prim >= 0).sum() > 5  # the rays do hit things
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=1e-6)
    tri = (ref_prim >= 0) & (ref_prim < num_tris)
    np.testing.assert_allclose(got.uv.numpy()[tri], np.asarray(ref.uv)[tri], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("num_tris,num_spheres,order", GEOMETRIES, ids=IDS)
def test_occlude_matches_jax(num_tris, num_spheres, order):
    jnp, _, jpi = _jax()
    jgeom, jsoa, tgeom, tsoa, p = _both(num_tris, num_spheres, order)
    o, d, t_max, ignore = _rays(1000, p, seed=2)
    ref = np.asarray(jpi.occlude_pallas(jgeom, jsoa, jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(t_max), jnp.asarray(ignore)))
    got = tpi.occlude_pallas(tgeom, tsoa, torch.as_tensor(o), torch.as_tensor(d),
                             torch.as_tensor(t_max), torch.as_tensor(ignore)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(got)


def test_linear_matches_jax():
    """Scenes under 32 prims take the linear broadcast in both packages."""
    jnp, jint, _ = _jax()
    g = _geometry_np(12, 8, seed=4)
    o, d, t_max, ignore = _rays(512, 20, seed=5)
    jgeom = jint.FlatGeometry(**{k: jnp.asarray(v) for k, v in g.items()})
    tgeom = tint.FlatGeometry(**{k: torch.as_tensor(v) for k, v in g.items()})
    jargs = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), jnp.asarray(ignore))
    targs = (torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
             torch.as_tensor(ignore))
    ref = jint.intersect_linear(jgeom, *jargs)
    got = tint.intersect_linear(tgeom, *targs)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tint.occlude_linear(tgeom, *targs).numpy(),
                                  np.asarray(jint.occlude_linear(jgeom, *jargs)))


def test_wrapper_rejects_bad_inputs():
    tsoa = tpi.build_prim_soa(_geometry_np(40, 20))
    rays = torch.zeros((7, 10))
    with pytest.raises(ValueError):
        tpi.dense_trace(rays, torch.zeros(10, dtype=torch.int64), tsoa)
    with pytest.raises(ValueError):
        tpi.dense_occlude(rays.double(), torch.zeros(10, dtype=torch.int32), tsoa)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the dense CUDA kernels need an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("num_tris,num_spheres,order", GEOMETRIES, ids=IDS)
def test_cuda_kernels_match_plain(cuda, num_tris, num_spheres, order):
    g = _geometry_np(num_tris, num_spheres)
    p = num_tris + num_spheres
    perm = np.random.RandomState(9).permutation(p) if order else None
    soa = tpi.build_prim_soa(g, order=perm, device=cuda)
    o, d, t_max, ignore = _rays(50_000, p, seed=3)
    rays = tpi.ray_columns(torch.as_tensor(o, device=cuda), torch.as_tensor(d, device=cuda),
                           torch.as_tensor(t_max, device=cuda))
    ig = tpi._sorted_ignore(soa, torch.as_tensor(ignore, device=cuda))
    kt = tpi.dense_trace(rays, ig, soa)
    pt = tpi.dense_trace_plain(rays, ig, soa)
    torch.cuda.synchronize()
    assert torch.equal(kt[1], pt[1])
    for k, p_ in zip(kt[::2] + kt[3:], pt[::2] + pt[3:]):
        torch.testing.assert_close(k, p_, rtol=1e-6, atol=0.0)
    assert torch.equal(tpi.dense_occlude(rays, ig, soa), tpi.dense_occlude_plain(rays, ig, soa))
