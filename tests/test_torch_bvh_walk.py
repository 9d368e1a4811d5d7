"""PyTorch port: the stack BVH walk (`aggregation/bvh.intersect_bvh`,
`occlude_bvh`, `FlatBVH.num_nodes`), the JAX package's "bvh-lockstep"
accelerator, against the JAX package's walk and against the port's dense
plain versions, on one soup of triangles and spheres with an exact
duplicate sphere (ties), zero-edge degenerate triangles and rays that
ignore a prim (findFar on spheres), stop at a finite t_max or are dead.

Tolerances. Against the JAX walk on the same tree: prim ids and blocked
flags identical, t to rtol 1e-5 (atol 1e-6) and triangle u, v to rtol 1e-5
plus atol 1e-5, as tests/test_torch_intersect.py holds the dense kernels
(XLA's CPU code may fuse the multiply-adds of its sums). Against
`dense_trace_plain` / `dense_occlude_plain`: blocked flags identical; prim
ids identical except on exact t ties, where the walk keeps the first prim
it tests (t < best_t strictly) and the dense walk the least sorted slot: a
differing id must have a t bitwise equal to the dense one and belong to
the duplicate pair (the pair shares a leaf here, whose slots both walks
test in slot order, so no id differs on these rays); t to rtol 1e-6 (on
these rays bitwise: both compute Moller-Trumbore and the sphere roots in
the same op order). Degenerate triangles
have a zero edge, so their determinant is exactly 0 in every form (the
dense packing zeroes the edges of any zero-area triangle, which the JAX
walk does not, so a collinear triangle's rounding residue would separate
them by design).
"""

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.aggregation import bvh as tbvh
from echorenderer_tpu_torch.ops import intersect as tint
from echorenderer_tpu_torch.ops import pallas_intersect as tpi

torch.set_num_threads(1)

JAX_TOL = dict(rtol=1e-5, atol=1e-6)
UV_TOL = dict(rtol=1e-5, atol=1e-5)
DENSE_RTOL = 1e-6
NUM_TRIS, NUM_SPHERES = 300, 120
DUP = (NUM_TRIS + 7, NUM_TRIS + NUM_SPHERES - 1)  # sphere 7 and its exact copy


def _soup(seed=0):
    rs = np.random.RandomState(seed)
    t, s = NUM_TRIS, NUM_SPHERES
    z3 = np.zeros((t, 3), np.float32)
    z2 = np.zeros((t, 2), np.float32)
    g = dict(
        tri_v0=rs.uniform(-10, 10, (t, 3)).astype(np.float32),
        tri_e1=rs.uniform(-1.5, 1.5, (t, 3)).astype(np.float32),
        tri_e2=rs.uniform(-1.5, 1.5, (t, 3)).astype(np.float32),
        tri_n0=z3, tri_n1=z3, tri_n2=z3, tri_uv0=z2, tri_uv1=z2, tri_uv2=z2,
        tri_mat=np.zeros(t, np.int32),
        sph_center=rs.uniform(-10, 10, (s, 3)).astype(np.float32),
        sph_radius=rs.uniform(0.3, 1.5, s).astype(np.float32),
        sph_mat=np.zeros(s, np.int32),
    )
    g["tri_e1"][:6] = 0.0  # degenerate: a point-like or a segment triangle
    g["tri_e2"][:3] = 0.0
    i, j = DUP[0] - t, DUP[1] - t
    g["sph_center"][j], g["sph_radius"][j] = g["sph_center"][i], g["sph_radius"][i]
    return g


def _rays(g, n=4096, seed=1):
    """Random rays; a quarter ignore a random prim, half stop at a finite
    t_max, an eighth are dead; 512 start inside a sphere and ignore it, and
    256 aim at the duplicate pair."""
    rs = np.random.RandomState(seed)
    p = NUM_TRIS + NUM_SPHERES
    o = rs.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    ignore = np.where(rs.uniform(size=n) < 0.25, rs.randint(0, p, n), -1)
    t_max = np.where(rs.uniform(size=n) < 0.5, np.inf, rs.uniform(0.5, 30.0, n))
    t_max[: n // 8] = rs.choice([0.0, -1.0], n // 8)
    inside = slice(n // 8, n // 8 + 512)  # findFar: from inside the ignored sphere
    k = rs.randint(0, NUM_SPHERES, 512)
    o[inside] = g["sph_center"][k] + rs.uniform(-0.2, 0.2, (512, 3)) * g["sph_radius"][k, None]
    ignore[inside] = NUM_TRIS + k
    aim = slice(n - 256, n)  # at the duplicate pair: exact ties
    c = g["sph_center"][DUP[0] - NUM_TRIS]
    d[aim] = c + rs.uniform(-0.3, 0.3, (256, 3)) - o[aim]
    ignore[aim], t_max[aim] = -1, np.inf
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32), t_max.astype(np.float32), ignore.astype(np.int32)


@pytest.fixture(scope="module")
def scene():
    g = _soup()
    tree = tbvh.build_bvh(*tbvh.geometry_bounds(g))
    geom = tint.FlatGeometry(**{k: torch.as_tensor(v) for k, v in g.items()})
    rays = _rays(g)
    targs = tuple(torch.as_tensor(a) for a in rays)
    on_cpu = tbvh.on_device(tree, "cpu")
    hit = tbvh.intersect_bvh(geom, on_cpu, *targs)
    blocked = tbvh.occlude_bvh(geom, on_cpu, *targs)
    return dict(g=g, tree=tree, geom=geom, rays=rays, targs=targs, hit=hit, blocked=blocked)


def _jax_walk(scene):
    import jax.numpy as jnp

    from echorenderer_tpu.aggregation import bvh as jbvh
    from echorenderer_tpu.ops import intersect as jint

    tree = scene["tree"]
    jtree = jbvh.FlatBVH(child_min=jnp.asarray(tree.child_min),
                         child_max=jnp.asarray(tree.child_max),
                         child_code=jnp.asarray(tree.child_code),
                         prim_order=jnp.asarray(tree.prim_order),
                         root_code=jnp.asarray(tree.root_code, jnp.int32))
    jgeom = jint.FlatGeometry(**{k: jnp.asarray(v) for k, v in scene["g"].items()})
    jargs = tuple(jnp.asarray(a) for a in scene["rays"])
    return jbvh.intersect_bvh(jgeom, jtree, *jargs), jbvh.occlude_bvh(jgeom, jtree, *jargs)


def test_walk_matches_jax(scene):
    ref, ref_blocked = _jax_walk(scene)
    hit = scene["hit"]
    ref_prim = np.asarray(ref.prim)
    np.testing.assert_array_equal(hit.prim.numpy(), ref_prim)
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t), **JAX_TOL)
    tri = (ref_prim >= 0) & (ref_prim < NUM_TRIS)
    np.testing.assert_allclose(hit.uv.numpy()[tri], np.asarray(ref.uv)[tri], **UV_TOL)
    np.testing.assert_array_equal(scene["blocked"].numpy(), np.asarray(ref_blocked))
    # the rays exercise what they are meant to
    o, d, t_max, ignore = scene["rays"]
    n = len(o)
    assert 0.2 < (ref_prim >= 0).mean() < 0.9
    far = ref_prim[n // 8: n // 8 + 512]
    # findFar: most reach the exit interface (the rest stop at a prim inside
    # the sphere, or at their t_max first)
    assert (far == ignore[n // 8: n // 8 + 512]).mean() > 0.75
    assert np.isfinite(t_max).sum() > n // 3 and (t_max <= 0).sum() == n // 8
    assert not np.isin(ref_prim, np.arange(6)).any()  # degenerate triangles never hit


def _dense(scene):
    g, tree = scene["g"], scene["tree"]
    order = tree.prim_order
    soa = tpi.build_prim_soa(g, order=order, packed=tpi.pack_sorted_prims(g, order))
    o, d, t_max, ignore = scene["targs"]
    rays, ig = tpi.ray_columns(o, d, t_max), tpi._sorted_ignore(soa, ignore)
    t, slot, _, _ = tpi.dense_trace_plain(rays, ig, soa)
    prim = torch.where(slot >= 0, soa.order[torch.clamp(slot, min=0)], -1)
    return soa, t, prim, tpi.dense_occlude_plain(rays, ig, soa)


def test_walk_matches_dense_plain(scene):
    soa, t, prim, blocked = _dense(scene)
    assert soa.n_chunks > 1  # the dense walk culls and reorders
    hit = scene["hit"]
    assert torch.equal(scene["blocked"], blocked)
    found = hit.prim >= 0
    assert torch.equal(found, prim >= 0)
    differ = hit.prim != prim
    # exact t ties: the walk keeps its first-tested prim, the dense walk the
    # least sorted slot; here only the duplicate sphere pair ties
    assert torch.equal(hit.t[differ], t[differ])
    pair = set(DUP)
    assert all({int(a), int(b)} == pair for a, b in zip(hit.prim[differ], prim[differ]))
    on_pair = np.isin(hit.prim.numpy(), DUP)
    assert on_pair.sum() > 100  # the aimed rays reach the pair
    torch.testing.assert_close(hit.t[found], t[found], rtol=DENSE_RTOL, atol=0.0)


def test_occlude_is_a_hit_before_t_max(scene):
    """The any-hit walk, which stops each lane at its first blocker, flags
    exactly the rays whose closest hit lies before their t_max."""
    _, _, t_max, _ = scene["targs"]
    hit = scene["hit"]
    assert torch.equal(scene["blocked"], (hit.prim >= 0) & (hit.t < t_max))
    assert 0 < int(scene["blocked"].sum()) < len(t_max)


@pytest.mark.parametrize("n_prims", [1, 4, 5, 97, 420])
def test_num_nodes_matches_jax(n_prims):
    from echorenderer_tpu.aggregation import bvh as jbvh

    rs = np.random.RandomState(n_prims)
    lo = rs.uniform(-5, 5, (n_prims, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.1, 1.0, (n_prims, 3)).astype(np.float32)
    tree = tbvh.build_bvh(lo, hi)
    ref = jbvh.build_bvh(lo, hi)
    assert tree.num_nodes == ref.num_nodes == tree.child_code.shape[0]
    assert tbvh.on_device(tree, "cpu").num_nodes == tree.num_nodes
    if n_prims > tbvh.LEAF_MAX:
        assert tree.num_nodes >= -(-n_prims // tbvh.LEAF_MAX) - 1
    else:
        assert tree.num_nodes == 1  # a single-leaf tree keeps one node


@pytest.mark.cuda
def test_cuda_walk_matches_dense_kernels():
    """On the card the walk runs as plain PyTorch on CUDA tensors and is
    held to the dense kernels by the same rule."""
    if not torch.cuda.is_available():
        pytest.skip("the dense CUDA kernels need an NVIDIA GPU")
    dev = torch.device("cuda")
    g = _soup()
    tree = tbvh.build_bvh(*tbvh.geometry_bounds(g))
    geom = tint.FlatGeometry(**{k: torch.as_tensor(v, device=dev) for k, v in g.items()})
    o, d, t_max, ignore = (torch.as_tensor(a, device=dev) for a in _rays(g, n=65536, seed=3))
    hit = tbvh.intersect_bvh(geom, tbvh.on_device(tree, dev), o, d, t_max, ignore)
    soa = tpi.build_prim_soa(g, order=tree.prim_order,
                             packed=tpi.pack_sorted_prims(g, tree.prim_order), device=dev)
    rays, ig = tpi.ray_columns(o, d, t_max), tpi._sorted_ignore(soa, ignore)
    t, slot, _, _ = tpi.dense_trace(rays, ig, soa)
    prim = torch.where(slot >= 0, soa.order[torch.clamp(slot, min=0)], -1)
    differ = hit.prim != prim
    assert torch.equal(hit.t[differ], t[differ])
    found = hit.prim >= 0
    torch.testing.assert_close(hit.t[found], t[found], rtol=DENSE_RTOL, atol=0.0)
    assert torch.equal(tbvh.occlude_bvh(geom, tbvh.on_device(tree, dev), o, d, t_max, ignore),
                       tpi.dense_occlude(rays, ig, soa))
