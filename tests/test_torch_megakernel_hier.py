"""PyTorch port: the megakernel's chunk-tree form (ops/megakernel.py with
`hier=True`, csrc/megakernel.cu's `mega_kernel<false, true>`) against the
JAX package's fat-chunk megakernel (`sample_frame_mega(..., hier=True)`).

- Envelope: `supported_hier` agrees with the JAX package's on scenes with
  and without chunk-tree tables, textured, env-mapped, instanced and
  orthographic; `unsupported_hier_reason` names each refusal.
- Tables: the per-slot shading table equals rows 16-32 of the JAX
  package's fat chunks (`_build_fat_chunks`), value for value, and the
  chunk tensor the launch takes equals rows 0-15.
- Sums: on the CPU the port runs the plain version (the wavefront with
  every wave on the chunk-tree walk), held to the JAX kernel in interpret
  mode on tests/test_megakernel.py's case (sphere_field(300, seed=7),
  32x32, 2 spp, bounce 3) with its tolerances: sums atol/rtol 2e-3, sums of
  squares atol 4e-2 / rtol 2e-3.
- Dispatch: the JAX package's ECHO_MEGA_HIER gate (`_use_mega_hier`), off
  by default; CPU scenes take the wavefront.
- The CUDA kernel is held to its plain version on the card (these tests
  skip without one):

    python -m pytest --noconftest tests/test_torch_megakernel_hier.py -k cuda
"""

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch.aggregation.bvh import build_bvh, geometry_bounds
from echorenderer_tpu_torch.evaluation import scene_ops as tscene_ops
from echorenderer_tpu_torch.evaluation import wavefront as twave
from echorenderer_tpu_torch.models import scenes as tscenes
from echorenderer_tpu_torch.ops import megakernel as tmk
from echorenderer_tpu_torch.ops import pallas_hier as ph
from echorenderer_tpu_torch.scene.prepare import PreparedScene
from echorenderer_tpu_torch.scene.prepare import prepare_scene as tprepare

torch.set_num_threads(1)

TOL = dict(sum_atol=2e-3, sum_rtol=2e-3, sq_atol=4e-2, sq_rtol=2e-3)


def _jax():
    from echorenderer_tpu.models import scenes as jscenes
    from echorenderer_tpu.ops import megakernel as jmk
    from echorenderer_tpu.scene.prepare import prepare_scene as jprepare

    return jscenes, jmk, jprepare


def _jax_with_hier(jscene):
    """Chunk-tree tables built directly, as tests/test_megakernel.py's
    test_mega_hier_matches_dense builds them."""
    from echorenderer_tpu.aggregation.bvh import build_bvh as jbvh
    from echorenderer_tpu.aggregation.bvh import geometry_bounds as jbounds
    from echorenderer_tpu.ops.pallas_hier import build_hier_soa as jbuild

    geom = {k: np.asarray(v) for k, v in jscene.geometry._asdict().items()}
    return jscene._replace(hier_soa=jbuild(jscene.geometry,
                                           np.asarray(jbvh(*jbounds(geom)).prim_order)))


def _with_hier(scene):
    """The port's scene with its chunk-tree tables built directly (prepare
    builds them from 16,384 prims on)."""
    geom = {k: v.cpu().numpy() for k, v in scene.geometry._asdict().items()}
    order = build_bvh(*geometry_bounds(geom)).prim_order
    return scene._replace(hier_soa=ph.build_hier_soa(geom, order, device=scene.device))


def _classes(m):
    """The scene and texture classes of the package of scenes module `m`."""
    if m is tscenes:
        import echorenderer_tpu_torch.scene as scene_mod
        import echorenderer_tpu_torch.textures as tex_mod
    else:
        import echorenderer_tpu.scene as scene_mod
        import echorenderer_tpu.textures.procedural as tex_mod
    return scene_mod, tex_mod


def _field(m):
    return m.sphere_field(300, seed=7)


def _field_textured(m, scene=None):
    """sphere_field(300) (or `scene`) and a cloud-textured plane above it."""
    sc, tx = _classes(m)
    scene = _field(m) if scene is None else scene
    scene.add(sc.PlaneEntity(size=(4, 4), position=(0, 6, 0),
                             material=sc.Diffuse(albedo=tx.CloudTexture(scale=4.0, seed=5))))
    return scene


def _field_sky(m):
    """sphere_field(300) under hdr_environment()'s sky (an env map)."""
    sc, _ = _classes(m)
    sky = next(e for e in m.hdr_environment(resolution=(16, 8)).children
               if getattr(e, "texture", None) is not None)
    scene = _field(m)
    scene.add(sc.AmbientLight(intensity=(0.5, 0.5, 0.5), texture=sky.texture))
    return scene


def _field_orthographic(m):
    sc, _ = _classes(m)
    scene = _field(m)
    for child in list(scene.children):
        if hasattr(child, "field_of_view"):
            scene.children.remove(child)
    scene.add(sc.OrthographicCamera())
    return scene


# name: (scene maker over a scenes module, chunk-tree tables built, TLAS,
# the port's reason)
ENVELOPE = {
    "sphere_field(300) with tables": (_field, True, False, None),
    "sphere_field(300)": (_field, False, False, "no chunk-tree tables"),
    "textured": (_field_textured, True, False,
                 "textures (the chunk-tree form has no texture stage)"),
    "hdr_environment sky": (_field_sky, True, False,
                            "environment map (importance sampling is wavefront-only)"),
    "instanced_grid(2)": (lambda m: m.instanced_grid(side=2), False, True, "TLAS instancing"),
    "orthographic": (_field_orthographic, True, False, "non-perspective camera"),
}


@pytest.mark.parametrize("name", list(ENVELOPE))
def test_envelope_matches_jax(name):
    jscenes, jmk, jprepare = _jax()
    maker, tables, tlas, reason = ENVELOPE[name]
    kw = dict(instancing="tlas") if tlas else {}
    jscene = jprepare(maker(jscenes), **kw)
    tscene = tprepare(maker(tscenes), device="cpu", **kw)
    if tables:
        jscene, tscene = _jax_with_hier(jscene), _with_hier(tscene)
    assert (jscene.hier_soa is None) == (tscene.hier_soa is None)
    assert tmk.supported_hier(tscene) == jmk.supported_hier(jscene)
    assert tmk.unsupported_hier_reason(tscene) == reason
    assert tmk.supported_hier(tscene) == (reason is None)


@pytest.fixture(scope="module")
def field_pair():
    """sphere_field(300, seed=7) with chunk-tree tables in both packages."""
    jscenes, _, jprepare = _jax()
    jscene = _jax_with_hier(jprepare(jscenes.sphere_field(300, seed=7)))
    tscene = _with_hier(tprepare(tscenes.sphere_field(300, seed=7), device="cpu"))
    return jscene, tscene


def test_tables_match_jax_fat_chunks(field_pair):
    _, jmk, _ = _jax()
    jscene, tscene = field_pair
    fat = np.asarray(jmk._build_fat_chunks(jscene))  # (C, 40, HCHUNK)
    soa = tscene.hier_soa
    spT = tmk._build_tables(tscene, hier=True)[0]
    assert spT.shape == (tmk.SP_ROWS, soa.padded)
    per_chunk = spT.numpy().reshape(tmk.SP_ROWS, soa.num_chunks, ph.HCHUNK).transpose(1, 0, 2)
    np.testing.assert_array_equal(per_chunk, fat[:, 16:16 + tmk.SP_ROWS])
    np.testing.assert_array_equal(soa.prim_chunks.numpy(), fat[:, 0:16])
    args = tmk._kernel_args(tscene, torch.arange(16), torch.zeros((16, 2), dtype=torch.int32),
                            (4, 4), 0, 0, 1, 3, None, hier=True)
    assert args.hier_ptrs[0] == soa.prim_chunks.data_ptr()
    # this scene's prim_soa keeps the same BVH order: the dense form's table
    # is the same one, on fewer padding slots
    dense = tmk._build_tables(tscene)[0]
    assert torch.equal(tscene.prim_soa.order, soa.order)
    assert torch.equal(spT[:, :soa.num_prims], dense[:, :soa.num_prims])


@pytest.fixture(scope="module")
def jax_sums(field_pair):
    """The JAX fat-chunk megakernel in interpret mode (about 20 s here)."""
    import jax.numpy as jnp

    _, jmk, _ = _jax()
    pid, pxy, res = _lanes()
    a, a2 = jmk.sample_frame_mega(field_pair[0], jnp.asarray(pid), jnp.asarray(pxy), res, 11,
                                  jnp.uint32(0), 2, bounce_limit=3, survivability=2.5,
                                  hier=True)
    return np.asarray(a), np.asarray(a2)


def _lanes(n=1024, res=(32, 32)):
    pid = np.arange(n, dtype=np.uint32)
    pxy = np.stack([pid % res[0], pid // res[0]], -1).astype(np.int32)
    return pid, pxy, res


def test_sums_match_jax(field_pair, jax_sums, monkeypatch):
    """The port's sample_frame_mega(hier=True) on the CPU runs the plain
    version, every wave on the walk; it equals the dense plain version bit
    for bit (the walk's tie rule) and the JAX kernel within its
    tolerances."""
    tscene = field_pair[1]
    pid, pxy, res = _lanes()
    args = (torch.as_tensor(pid.astype(np.int64)), torch.as_tensor(pxy), res, 11, 0, 2)
    kw = dict(bounce_limit=3, survivability=2.5)
    walks = {"n": 0}
    walk = ph._walk

    def counted(*a, **k):
        walks["n"] += 1
        return walk(*a, **k)

    monkeypatch.setattr(ph, "_walk", counted)
    before = tmk.sample_frame_mega.launches_hier
    b, b2 = tmk.sample_frame_mega(tscene, *args, hier=True, **kw)
    assert tmk.sample_frame_mega.launches_hier == before  # CPU: the plain version
    assert walks["n"] > 0
    calls = walks["n"]
    c, c2 = tmk.sample_frame_mega(tscene, *args, **kw)  # the dense plain version
    assert walks["n"] == calls
    assert torch.equal(b, c) and torch.equal(b2, c2)
    a, a2 = jax_sums
    b, b2 = b.numpy(), b2.numpy()
    assert a.sum() > 0
    np.testing.assert_allclose(b, a, atol=TOL["sum_atol"], rtol=TOL["sum_rtol"])
    np.testing.assert_allclose(b2, a2, atol=TOL["sq_atol"], rtol=TOL["sq_rtol"])


def test_walk_only_routes_every_wave_to_the_walk(field_pair):
    scene = field_pair[1]
    assert not tscene_ops._use_hier(scene) and not tscene_ops._use_binned(scene)
    assert tscene_ops.dispatch_summary(scene)["accelerator"] == "dense-stream"
    with tscene_ops.walk_only():
        assert tscene_ops._use_hier(scene) and not tscene_ops._use_binned(scene)
        assert tscene_ops.dispatch_summary(scene)["accelerator"] == "hier-packet"
        with tscene_ops.walk_only():
            pass
        assert tscene_ops._use_hier(scene)
    assert not tscene_ops._use_hier(scene)


class _OnCard(PreparedScene):
    """A CPU scene that reports the card as its device: the dispatch's
    decisions without a card (nothing may launch on it)."""

    __slots__ = ()

    @property
    def device(self):
        return torch.device("cuda")


@pytest.fixture(scope="module")
def large_field():
    """sphere_grid(20_000) (20,096 padded prims: outside the dense
    envelope), with the chunk-tree tables prepare builds."""
    scene = tprepare(tscenes.sphere_grid(20_000), device="cpu")
    assert not tmk.supported(scene) and tmk.supported_hier(scene)
    return scene


@pytest.mark.parametrize("gate", [None, "1"])
def test_dispatch_gate(large_field, field_pair, monkeypatch, gate):
    """ECHO_MEGA_HIER sends a CUDA scene outside the dense envelope and
    inside the chunk-tree form's to that form, and nothing else: a scene
    inside the dense envelope keeps the dense form, CPU scenes and stats
    renders the wavefront. Without it the dispatch is unchanged."""
    if gate is None:
        monkeypatch.delenv("ECHO_MEGA_HIER", raising=False)
    else:
        monkeypatch.setenv("ECHO_MEGA_HIER", gate)
    on = gate is not None
    card = _OnCard(*large_field)
    summary = tscene_ops.dispatch_summary(card)
    assert tscene_ops._use_mega_hier(card) == on
    if on:
        assert (summary["integrator"], summary["integrator_reason"]) == (
            "megakernel-hier", "ECHO_MEGA_HIER fat-chunk kernel")
    else:
        assert (summary["integrator"], summary["integrator_reason"]) == (
            "wavefront", f"prims > {tmk.MEGA_PRIM_LIMIT}")
    assert tscene_ops.dispatch_summary(card, return_stats=True)["integrator"] == "wavefront"
    assert tscene_ops.dispatch_summary(_OnCard(*field_pair[1]))["integrator"] == "megakernel"
    for cpu_scene in (large_field, field_pair[1]):
        assert not tscene_ops._use_mega_hier(cpu_scene)
    assert tscene_ops.dispatch_summary(large_field)["integrator_reason"] == "not on CUDA"
    # the wavefront's entry routes the gated scene to the chunk-tree form
    seen = []
    monkeypatch.setattr(tmk, "sample_frame_mega",
                        lambda *a, **k: seen.append(k["hier"]) or (None, None))
    monkeypatch.setattr(twave, "run_wavefront", lambda *a, **k: seen.append("wavefront"))
    twave.sample_frame_wavefront(card, torch.arange(4), torch.zeros((4, 2)), (2, 2), 0, 0, 1)
    assert seen == ([True] if on else ["wavefront"])


def test_dispatch_keeps_textured_and_tlas_scenes_on_the_wavefront(monkeypatch):
    """Under the gate, scenes outside both envelopes (sphere_grid(20_000)
    under a textured plane, a TLAS scene) still take the wavefront."""
    monkeypatch.setenv("ECHO_MEGA_HIER", "1")
    textured = _OnCard(*tprepare(_field_textured(tscenes, tscenes.sphere_grid(20_000)),
                                 device="cpu"))
    tlas = _OnCard(*tprepare(tscenes.instanced_grid(side=2), instancing="tlas", device="cpu"))
    for scene, reason in ((textured, "textures"), (tlas, "TLAS instancing")):
        assert not tmk.supported(scene) and not tscene_ops._use_mega_hier(scene)
        assert tscene_ops.dispatch_summary(scene)["integrator"] == "wavefront"
        assert tmk.unsupported_hier_reason(scene).startswith(reason)


def test_kernel_args_hier_layout():
    """The host side of a chunk-tree launch: no prim rows, the tree's
    tables, shading rows and emitters' prim ids in the tree's slots, on
    many_lights(256) (282 prims, two chunks, a light tree; many_lights(96)
    has 122 prims, one chunk, and a chunk tree needs two)."""
    scene = _with_hier(tprepare(tscenes.many_lights(256), device="cpu"))
    soa = scene.hier_soa
    n = 100
    pid = torch.arange(n)
    pxy = torch.stack([pid % 10, pid // 10], -1)
    args = tmk._kernel_args(scene, pid, pxy, (10, 10), 5, 0, 4, 16, None, hier=True)
    assert args.ptrs[0] == 0 and len(args.ptrs) == 14 and len(args.ints) == 19
    assert args.hier_ptrs == [soa.prim_chunks.data_ptr(), soa.bounds.data_ptr(),
                              soa.codes.data_ptr()]
    assert args.ints[8] == soa.padded and args.ints[9:11] == [1, 1]
    sp, ep = args.tensors[1], args.tensors[4]
    assert sp.shape == (soa.padded, tmk.SP_ROWS)
    order = soa.order.long()
    np.testing.assert_array_equal(sp[:soa.num_prims, 12].numpy(),
                                  scene.shade_pack[order, 18].numpy())  # material ids
    eprim = scene.lights.emissive_prim.long()
    np.testing.assert_array_equal(ep[:eprim.numel(), 17].numpy(),
                                  soa.inv_order[eprim].float().numpy())
    assert torch.equal(order[ep[:eprim.numel(), 17].long()], eprim)
    dense = tmk._kernel_args(scene, pid, pxy, (10, 10), 5, 0, 4, 16, None)
    assert dense.hier_ptrs is None and dense.ptrs[0] == scene.prim_soa.rows.data_ptr()


def test_kernel_args_check_the_stack(field_pair):
    scene = field_pair[1]
    deep = scene._replace(hier_soa=scene.hier_soa._replace(stack_size=ph.MAX_STACK + 1))
    pid = torch.arange(4)
    with pytest.raises(ValueError, match="stack"):
        tmk._kernel_args(deep, pid, torch.zeros((4, 2), dtype=torch.int32), (2, 2), 0, 0, 1, 3,
                         None, hier=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the megakernel's chunk-tree form needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_hier_matches_plain(cuda):
    """~20,000 prims: prepare builds chunk-tree tables, the wavefront takes
    the dense kernels; the kernel's chunk-tree form equals its plain
    version (the wavefront on the walk) bit for bit."""
    scene = tprepare(tscenes.sphere_grid(20_000), device=cuda)
    assert scene.hier_soa is not None and tmk.supported_hier(scene)
    assert tscene_ops.dispatch_summary(scene)["accelerator"] == "dense-stream"
    pid, pxy, res = _lanes(4096, (64, 64))
    pid = torch.as_tensor(pid.astype(np.int64), device=cuda)
    pxy = torch.as_tensor(pxy, device=cuda)
    kw = dict(bounce_limit=4, survivability=2.5)
    before = tmk.sample_frame_mega.launches_hier
    a, a2 = tmk.sample_frame_mega(scene, pid, pxy, res, 11, 0, 2, hier=True, **kw)
    b, b2 = tmk.sample_frame_mega_plain(scene, pid, pxy, res, 11, 0, 2, hier=True, **kw)
    torch.cuda.synchronize()
    assert tmk.sample_frame_mega.launches_hier == before + 1
    assert bool(torch.isfinite(a).all()) and float(a.sum()) > 0
    assert torch.equal(a, b) and torch.equal(a2, b2)


@pytest.mark.cuda
def test_cuda_hier_outside_envelope_raises(cuda):
    scene = tprepare(tscenes.sphere_field(300), device=cuda)  # no chunk-tree tables
    pid = torch.arange(64, device=cuda)
    pxy = torch.stack([pid % 8, pid // 8], -1).to(torch.int32)
    with pytest.raises(ValueError, match="chunk-tree form's envelope: no chunk-tree tables"):
        tmk.sample_frame_mega(scene, pid, pxy, (8, 8), 0, 0, 1, hier=True)


@pytest.mark.cuda
@pytest.mark.parametrize("bounce_limit,k_slots", [(0, 1), (3, 3)])
def test_cuda_hier_lanes_finish_apart(cuda, bounce_limit, k_slots):
    """The lanes of a warp end their paths at different bounces, bounce 0
    among them (Russian roulette at survivability 0.6; a bounce limit of 0
    ends every path there), and their pixel slots at different times
    (1,000 pixels: not a multiple of 32 or of the block; with 3 slots the
    last lanes have one slot fewer); a finished lane walks dead rays with
    its warp until the warp is done. Bitwise against the plain version."""
    scene = tprepare(tscenes.sphere_grid(20_000), device=cuda)
    pid, pxy, res = _lanes(1000, (40, 25))
    pid = torch.as_tensor(pid.astype(np.int64), device=cuda)
    pxy = torch.as_tensor(pxy, device=cuda)
    kw = dict(bounce_limit=bounce_limit, survivability=0.6)
    a, a2 = tmk.sample_frame_mega(scene, pid, pxy, res, 5, 0, 3, hier=True, k_slots=k_slots, **kw)
    b, b2 = tmk.sample_frame_mega_plain(scene, pid, pxy, res, 5, 0, 3, hier=True, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(a).all()) and float(a.sum()) > 0
    assert torch.equal(a, b) and torch.equal(a2, b2)
