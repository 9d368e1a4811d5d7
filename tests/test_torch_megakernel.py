"""PyTorch port: the fused path-tracing megakernel (ops/megakernel.py,
csrc/megakernel.cu) against the JAX package's `sample_frame_mega`.

On the CPU the port's `sample_frame_mega` runs its plain version, which is
the port's wavefront; the JAX megakernel runs its Pallas kernel in
interpret mode, as tests/test_megakernel.py runs it. Both are fed the same
prepared tables (`from_jax_arrays`) and held to test_megakernel.py's
tolerances: per-sample sums atol/rtol 2e-3, sums of squares atol 4e-2,
mean images 1e-5 (float reduction order is the only difference). The
envelope (`supported`, `unsupported_reason`) and the packed tables
(`_build_tables`, bit for bit but for the four sums over light powers in
the camera row, two ulps apart) match the JAX package's, textured scenes
included (their texture tables: tests/test_torch_textures.py). The CUDA kernel is
held to its plain version on the card (these tests skip without one):

    python -m pytest --noconftest tests/test_torch_megakernel.py -k cuda
"""

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.evaluation.scene_ops import dispatch_summary
from echorenderer_tpu_torch.evaluation.wavefront import sample_frame_wavefront
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.ops import megakernel as tmk
from echorenderer_tpu_torch.processes.render import _sample_frame
from echorenderer_tpu_torch.scene import OrthographicCamera
from echorenderer_tpu_torch.scene.prepare import prepare_scene as tprepare
from echorenderer_tpu_torch.utils import diagnostics

torch.set_num_threads(1)

ENVELOPE = {
    "cornell": lambda m: m.cornell_box(),
    "sphere_field(12)": lambda m: m.sphere_field(12),
    "sphere_field(80)": lambda m: m.sphere_field(80),
    "sphere_field(300)": lambda m: m.sphere_field(300),  # 384 padded: BVH-sorted slots
    "material_ball": lambda m: m.material_ball(),
    "many_lights(96)": lambda m: m.many_lights(96),
    "sphere_field(2200)": lambda m: m.sphere_field(2200),
    # textured scenes (tests/test_torch_textures.py), inside the envelope
    # and, with a fifth texture, outside; an env map, outside
    "textured": lambda m: _textured("textured", m),
    "textured showcase": lambda m: _textured("showcase", m),
    "textured sphere_texture": lambda m: _textured("sphere_texture", m),
    "textured rough_normal": lambda m: _textured("rough_normal", m),
    "textured five_textures": lambda m: _textured("five_textures", m),
    "hdr_environment": lambda m: m.hdr_environment(resolution=(16, 8)),
}


def _textured(name, m):
    """A test_torch_textures scene, built with the package of the scenes
    module `m`."""
    import test_torch_textures

    pkg = "torch" if m.__name__.startswith("echorenderer_tpu_torch") else "jax"
    return test_torch_textures.SCENES[name](pkg)


def _jax():
    from echorenderer_tpu.models import scenes as jscenes
    from echorenderer_tpu.ops import megakernel as jmk
    from echorenderer_tpu.scene.prepare import prepare_scene as jprepare

    return jscenes, jmk, jprepare


def _carried(name):
    """The JAX scene and the port's scene built from the same tables."""
    from echorenderer_tpu_torch.scene.convert import from_jax_arrays

    from test_torch_prepare import flatten_jax

    jscenes, _, jprepare = _jax()
    jscene = jprepare(ENVELOPE[name](jscenes))
    return jscene, from_jax_arrays(flatten_jax(jscene), device="cpu")


@pytest.mark.parametrize("name", list(ENVELOPE))
def test_envelope_matches_jax(name):
    jscenes, jmk, jprepare = _jax()
    jscene = jprepare(ENVELOPE[name](jscenes))
    tscene = tprepare(ENVELOPE[name](tscenes), device="cpu")
    assert tmk.supported(tscene) == jmk.supported(jscene)
    assert tmk.unsupported_reason(tscene) == jmk.unsupported_reason(jscene)


def test_non_perspective_camera_is_outside():
    scene = tscenes.material_ball()
    for child in list(scene.children):
        if hasattr(child, "field_of_view"):
            scene.children.remove(child)
    scene.add(OrthographicCamera())
    assert tmk.unsupported_reason(tprepare(scene, device="cpu")) == "non-perspective camera"


@pytest.mark.parametrize("name", ["cornell", "sphere_field(80)", "sphere_field(300)",
                                  "material_ball", "many_lights(96)", "textured",
                                  "textured showcase", "textured sphere_texture",
                                  "textured rough_normal"])
def test_tables_match_jax(name):
    _, jmk, _ = _jax()
    jscene, tscene = _carried(name)
    jt = jmk._build_tables(jscene)
    tt = tmk._build_tables(tscene)
    labels = ("spT", "matT", "lightT", "epackT", "treeT", "tlT")
    for label, j, t in zip(labels, jt[:6], tt[:6]):
        if j is None:
            assert t is None, label
            continue
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=label)
    # the texel table, None untextured (the JAX kernel's is (0, 0)), value
    # for value: the JAX kernel's channel-major (3R, A*R) bf16 rows
    # (c * R + x, a * R + y) against the port's (A, R, R, 4) atlas
    tex = np.asarray(jt[6]).astype(np.float32)
    assert (tt[6] is None) == (tex.size == 0)
    if tt[6] is not None:
        a_count, res = tscene.tex_atlas.shape[:2]
        assert tt[0].shape[0] == tmk.SP_ROWS + tmk.SP_TEX_ROWS
        assert tt[1].shape[0] == tmk.MT_ROWS + tmk.MT_TEX_ROWS
        np.testing.assert_array_equal(
            tt[6][..., :3].numpy(), tex.reshape(3, res, a_count, res).transpose(2, 3, 1, 0))
        args = tmk._kernel_args(tscene, torch.arange(64), torch.zeros((64, 2), dtype=torch.int32),
                                (8, 8), 0, 0, 1, 4, None)
        static = jt[8]
        assert args.ints[15:] == [a_count, res, int(static["has_ntex"]), int(static["has_rtex"])]
        assert args.ptrs[13] == tscene.tex_atlas.data_ptr()
    # the camera row bit for bit, except its four sums over the light
    # powers, which each framework reduces in its own order: two ulps
    cam, jcam = tt[7].numpy(), np.asarray(jt[7])
    sums = [tmk.C_AMB_PMF, tmk.C_TOTAL_POWER, tmk.C_P_INF, tmk.C_SUM_INF]
    rest = np.setdiff1d(np.arange(tmk.C_LEN), sums)
    np.testing.assert_array_equal(cam[rest], jcam[rest], err_msg="cam_row")
    np.testing.assert_allclose(cam[sums], jcam[sums], rtol=3e-7, atol=0, err_msg="cam_row sums")
    assert (tt[4] is not None) == (tscene.lights.tree is not None)
    assert tt[4] is not None or name != "many_lights(96)"


@pytest.fixture
def same_intersector(monkeypatch):
    # the JAX wavefront (inside the JAX sample_frame_mega's own tests) and
    # the port's plain version both take the dense chunk intersector
    from echorenderer_tpu.evaluation import scene_ops as jscene_ops

    monkeypatch.setattr(jscene_ops, "_use_pallas", lambda scene: scene.prim_soa is not None)


def _lanes(n=1024, res=(32, 32)):
    pid = np.arange(n, dtype=np.uint32)
    pxy = np.stack([pid % res[0], pid // res[0]], -1).astype(np.int32)
    return pid, pxy, res


@pytest.mark.parametrize("name,seed", [("material_ball", 11), ("many_lights(96)", 7)])
def test_mega_matches_jax_mega(same_intersector, name, seed):
    """Seed 7 on many_lights(96): see tests/test_torch_light_tree.py (a
    silhouette hit that a one-ulp camera difference flips under seed 11)."""
    import jax.numpy as jnp

    _, jmk, _ = _jax()
    jscene, tscene = _carried(name)
    pid, pxy, res = _lanes()
    kw = dict(bounce_limit=3, survivability=2.5)
    a, a2 = jmk.sample_frame_mega(jscene, jnp.asarray(pid), jnp.asarray(pxy), res, seed,
                                  jnp.uint32(0), 2, **kw)
    before = diagnostics.counts()["launches.mega"]
    b, b2 = tmk.sample_frame_mega(tscene, torch.as_tensor(pid.astype(np.int64)),
                                  torch.as_tensor(pxy), res, seed, 0, 2, **kw)
    assert diagnostics.counts()["launches.mega"] == before  # CPU: the plain version
    a, a2, b, b2 = np.asarray(a), np.asarray(a2), b.numpy(), b2.numpy()
    assert a.sum() > 0
    np.testing.assert_allclose(b, a, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(b2, a2, atol=4e-2, rtol=2e-3)
    np.testing.assert_allclose(b.mean(0), a.mean(0), atol=1e-5, rtol=1e-5)


def test_cpu_dispatch_takes_the_wavefront():
    scene = tprepare(tscenes.sphere_field(12), device="cpu")
    assert tmk.supported(scene)
    summary = dispatch_summary(scene)
    assert (summary["integrator"], summary["integrator_reason"]) == ("wavefront", "not on CUDA")
    pid, pxy, res = _lanes(256, (16, 16))
    before = diagnostics.counts()["launches.mega"]
    a, _ = sample_frame_wavefront(scene, torch.as_tensor(pid.astype(np.int64)),
                                  torch.as_tensor(pxy), res, 3, 0, 2, bounce_limit=3)
    b, _ = tmk.sample_frame_mega_plain(scene, torch.as_tensor(pid.astype(np.int64)),
                                       torch.as_tensor(pxy), res, 3, 0, 2, bounce_limit=3)
    s, _ = _sample_frame(scene, "path", res, 3, 0, 2, 3, 2.5)
    assert diagnostics.counts()["launches.mega"] == before
    assert torch.equal(a, b) and a.sum() > 0 and s.shape == (256, 3)


def test_kernel_args_layout():
    """The host side of a launch: K slots, 32-bit words and settings in
    the order of csrc/megakernel.cu's C interface."""
    scene = tprepare(tscenes.many_lights(96), device="cpu")
    n = 1000
    pid = torch.arange(n) + 2 ** 32 - 500  # wraps past 2^32
    pxy = torch.stack([pid % 40, (pid // 40) % 25], -1)
    args = tmk._kernel_args(scene, pid, pxy, (40, 25), 2 ** 32 - 1, 2 ** 32 - 3, 8, 16, 3)
    assert len(args.ptrs) == 14 and len(args.ints) == 19
    n_, n_lanes, k, count, bounce, width, height, seed = args.ints[:8]
    assert (n_, n_lanes, k, count, bounce, width, height, seed) == (n, 334, 3, 8, 16, 40, 25, -1)
    pid32, pxy32, s0 = args.tensors[8:11]
    assert pid32.dtype == torch.int32 and int(pid32[0]) == -500 and int(pid32[-1]) == 499
    assert s0.shape == (n,) and int(s0[0]) == -3
    assert torch.equal(pxy32, pxy.to(torch.int32))
    padded, has_tri, has_sph, present, n_lights, n_e, depth = args.ints[8:15]
    assert args.ints[15:] == [0, 0, 0, 0] and args.ptrs[13] == 0  # untextured
    assert padded == scene.prim_soa.padded and (has_tri, has_sph) == (1, 1)
    assert present == sum(1 << t for t in scene.materials.present)
    assert (n_lights, n_e, depth) == (96, 96, scene.lights.tree.max_depth)
    sp = args.tensors[1]
    assert sp.shape == (scene.prim_soa.padded, tmk.SP_ROWS) and sp.is_contiguous()
    assert args.s_sum.shape == (n, 3)


def test_kernel_args_check_the_atlas():
    """A launch takes the atlas as (A, R, R, 4) float32 and refuses other."""
    scene = tprepare(_textured("textured", tscenes), device="cpu")
    pid = torch.arange(16)
    pxy = torch.stack([pid % 4, pid // 4], -1)
    assert tmk._kernel_args(scene, pid, pxy, (4, 4), 0, 0, 1, 4, None).ints[15] == 2
    bad = scene._replace(tex_atlas=scene.tex_atlas.double())
    with pytest.raises(ValueError, match="atlas"):
        tmk._kernel_args(bad, pid, pxy, (4, 4), 0, 0, 1, 4, None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the megakernel needs an NVIDIA GPU")
    return torch.device("cuda")


def _card_lanes(dev, n=1024, res=(32, 32)):
    pid, pxy, res = _lanes(n, res)
    return torch.as_tensor(pid.astype(np.int64), device=dev), torch.as_tensor(pxy, device=dev), res


@pytest.mark.parametrize("name", ["cornell", "sphere_field(80)", "sphere_field(300)",
                                  "material_ball", "many_lights(96)", "textured",
                                  "textured rough_normal"])
@pytest.mark.cuda
def test_cuda_kernel_matches_plain(cuda, name):
    scene = tprepare(ENVELOPE[name](tscenes), device=cuda)
    pid, pxy, res = _card_lanes(cuda)
    kw = dict(bounce_limit=3, survivability=2.5)
    counts = lambda: (diagnostics.counts()["launches.mega"],
                      diagnostics.counts()["launches.mega_textured"])
    before = counts()
    a, a2 = tmk.sample_frame_mega(scene, pid, pxy, res, 11, 0, 2, **kw)
    b, b2 = tmk.sample_frame_mega_plain(scene, pid, pxy, res, 11, 0, 2, **kw)
    torch.cuda.synchronize()
    textured = scene.tex_atlas.shape[0] > 0
    assert counts() == (before[0] + (not textured), before[1] + textured)
    a, a2, b, b2 = (x.cpu().numpy() for x in (a, a2, b, b2))
    assert np.isfinite(a).all() and a.sum() > 0
    np.testing.assert_allclose(a, b, atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(a2, b2, atol=4e-2, rtol=2e-3)
    np.testing.assert_allclose(a.mean(0), b.mean(0), atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_cuda_k_slots_bitwise(cuda):
    scene = tprepare(tscenes.sphere_field(80), device=cuda)
    pid, pxy, res = _card_lanes(cuda, 2048, (64, 32))
    kw = dict(bounce_limit=6, survivability=2.5)
    a, a2 = tmk.sample_frame_mega(scene, pid, pxy, res, 7, 0, 4, k_slots=1, **kw)
    b, b2 = tmk.sample_frame_mega(scene, pid, pxy, res, 7, 0, 4, k_slots=4, **kw)
    c, _ = tmk.sample_frame_mega(scene, pid[:1500], pxy[:1500], res, 7, 0, 4, k_slots=3, **kw)
    assert torch.equal(a, b) and torch.equal(a2, b2)
    assert torch.equal(a[:1500], c)


@pytest.mark.cuda
def test_cuda_outside_envelope_raises(cuda):
    scene = tprepare(tscenes.sphere_field(2200), device=cuda)
    pid, pxy, res = _card_lanes(cuda, 64, (8, 8))
    with pytest.raises(ValueError, match="envelope"):
        tmk.sample_frame_mega(scene, pid, pxy, res, 0, 0, 1)
