"""PyTorch port: the small modules under the path tracer against the JAX
package — Welford/Chan accumulator, CDF-inversion distributions, colors,
vector frames and camera ray spawning (all three camera kinds) — on the
same numpy inputs, to rtol 1e-5 and atol 1e-6. Distribution indices are
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echorenderer_tpu.scene.prepare import PackedCamera as JPackedCamera
from echorenderer_tpu.scene.cameras import spawn_rays as jspawn
from echorenderer_tpu.utils import accumulator as jacc
from echorenderer_tpu.utils import colors as jcolors
from echorenderer_tpu.utils import distributions as jdist
from echorenderer_tpu.utils import vec as jvec
from echorenderer_tpu_torch.scene import cameras as tcam
from echorenderer_tpu_torch.scene.prepare import PackedCamera as TPackedCamera
from echorenderer_tpu_torch.utils import accumulator as tacc
from echorenderer_tpu_torch.utils import colors as tcolors
from echorenderer_tpu_torch.utils import distributions as tdist
from echorenderer_tpu_torch.utils import vec as tvec

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_accumulator_matches_jax():
    rs = np.random.RandomState(0)
    n = 257
    jt, tt = jacc.create((n,)), tacc.create((n,))
    for _ in range(3):  # single samples, one of them non-finite
        s = rs.exponential(1.0, (n, 3)).astype(np.float32)
        s[5] = np.nan
        jt, tt = jacc.add(jt, jnp.asarray(s)), tacc.add(tt, torch.as_tensor(s))
    for k in (4.0, 8.0):  # pre-reduced batches (Chan merge)
        x = rs.exponential(1.0, (int(k), n, 3)).astype(np.float32)
        jt = jacc.add_many(jt, jnp.asarray(x.sum(0)), jnp.asarray((x * x).sum(0)), k)
        tt = tacc.add_many(tt, torch.as_tensor(x.sum(0)), torch.as_tensor((x * x).sum(0)), k)
    for field in ("mean", "m2", "count"):
        _close(getattr(tt, field), getattr(jt, field))
    _close(tacc.variance(tt), jacc.variance(jt))
    _close(tacc.noise(tt), jacc.noise(jt))
    _close(tacc.max_noise(tt), jacc.max_noise(jt))


def test_distribution_1d_matches_jax():
    rs = np.random.RandomState(1)
    w = rs.exponential(1.0, 37)
    w[[3, 4, 20]] = 0.0  # zero-weight bins are never picked
    u = rs.uniform(0, 1, 4096).astype(np.float32)
    ji, jp, jr = jdist.build_1d(w).sample(jnp.asarray(u))
    ti, tp, tr = tdist.build_1d(w).sample(torch.as_tensor(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tp, jp)
    _close(tr, jr)
    assert not np.isin(ti.numpy(), [3, 4, 20]).any()


def test_distribution_2d_matches_jax():
    rs = np.random.RandomState(2)
    w = rs.exponential(1.0, (9, 17))
    w[4] = 0.0  # an empty row
    u2 = rs.uniform(0, 1, (2048, 2)).astype(np.float32)
    jd, td = jdist.build_2d(w), tdist.build_2d(w)
    jy, jx, jp, jr = jd.sample(jnp.asarray(u2))
    ty, tx, tp, tr = td.sample(torch.as_tensor(u2))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    _close(tp, jp)
    _close(tr, jr)
    _close(td.pmf_of(ty, tx), jd.pmf_of(jy, jx))


def test_colors_match_jax():
    rgb = np.random.RandomState(3).uniform(-0.1, 1.5, (512, 3)).astype(np.float32)
    _close(tcolors.luminance(torch.as_tensor(rgb)), jcolors.luminance(jnp.asarray(rgb)))
    _close(tcolors.srgb_encode(torch.as_tensor(rgb)), jcolors.srgb_encode(jnp.asarray(rgb)))
    _close(tcolors.srgb_decode(torch.as_tensor(rgb)), jcolors.srgb_decode(jnp.asarray(rgb)))


def test_vec_frames_match_jax():
    rs = np.random.RandomState(4)
    n = rs.normal(size=(1024, 3)).astype(np.float32)
    n[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 0, 0]]  # poles and a zero vector
    v = rs.normal(size=(1024, 3)).astype(np.float32)
    tn, jn = tvec.normalize(torch.as_tensor(n)), jvec.normalize(jnp.asarray(n))
    _close(tn, jn)
    tt, tb = tvec.orthonormal_frame(tn[4:])
    jt, jb = jvec.orthonormal_frame(jn[4:])
    _close(tt, jt)
    _close(tb, jb)
    loc = tvec.to_local(torch.as_tensor(v[4:]), tt, tb, tn[4:])
    _close(loc, jvec.to_local(jnp.asarray(v[4:]), jt, jb, jn[4:]))
    _close(tvec.to_world(loc, tt, tb, tn[4:]), v[4:])


CAMERAS = {
    "perspective": lambda: tcam.PerspectiveCamera(field_of_view=50.0, position=(1, 2, -6)),
    "perspective_dof": lambda: tcam.PerspectiveCamera(
        field_of_view=40.0, lens_radius=0.2, focal_distance=5.0, position=(0, 1, -5)),
    "orthographic": lambda: tcam.OrthographicCamera(width=3.0, position=(0, 2, -4)),
    "cylindrical": lambda: tcam.CylindricalCamera(position=(0.5, 1, 0)),
}


@pytest.mark.parametrize("kind", list(CAMERAS))
def test_spawn_rays_matches_jax(kind):
    cam = CAMERAS[kind]().look_at((0.3, 0.8, 1.0))
    packed = cam.pack(cam.transform.matrix())
    fields = ("position", "rotation", "forward_length", "lens_radius", "focal_distance")
    jc = JPackedCamera(packed["kind"], *(jnp.asarray(packed[f]) for f in fields))
    tc = TPackedCamera(packed["kind"], *(torch.as_tensor(packed[f]) for f in fields))
    rs = np.random.RandomState(5)
    res = (40, 24)
    pxy = np.stack([rs.randint(0, res[0], 960), rs.randint(0, res[1], 960)], -1).astype(np.int32)
    shift, lens = (rs.uniform(0, 1, (960, 2)).astype(np.float32) for _ in range(2))
    jo, jd = jspawn(jc, jnp.asarray(pxy), jnp.asarray(shift), jnp.asarray(lens), res)
    to, td = tcam.spawn_rays(tc, torch.as_tensor(pxy), torch.as_tensor(shift),
                             torch.as_tensor(lens), res)
    _close(to, jo)
    _close(td, jd)



def test_inst_or_zero_matches_jax():
    """`Hit.inst_or_zero`: zeros like `prim` where the accelerator reports
    no instance, else `inst` itself."""
    from echorenderer_tpu.ops import intersect as jint
    from echorenderer_tpu_torch.ops import intersect as tint

    prim = np.array([3, -1, 7], np.int32)
    hit = tint.Hit(t=torch.zeros(3), prim=torch.as_tensor(prim), uv=torch.zeros(3, 2))
    ref = jint.Hit(t=jnp.zeros(3), prim=jnp.asarray(prim), uv=jnp.zeros((3, 2)))
    np.testing.assert_array_equal(hit.inst_or_zero.numpy(), np.asarray(ref.inst_or_zero))
    inst = torch.tensor([1, 0, 2], dtype=torch.int32)
    assert hit._replace(inst=inst).inst_or_zero is inst
