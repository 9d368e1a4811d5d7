"""PyTorch port: the .echo loader (io/echo_dsl.py, io/echo_registry.py)
and the CLI (terminal.py) against the JAX package's, in one process.

- The cases of tests/test_echo_dsl.py on the port: tokenizer, literal
  coercion (colors through the port's `utils.colors.parse_color`, equal to
  JAX's), construction, links, lexical scope, errors, profiles, the
  PackInstance swatch syntax; the constructed objects equal JAX's.
- scenes/cornell.echo and scenes/showcase.echo constructed by both
  packages: equal prepared tables and equal profiles.
- The cases of tests/test_cli.py on the port's terminal, and a tiny .echo
  rendered through `terminal.main([..., "--device", "cpu"])`: the images
  it writes read back bitwise equal to an in-process render.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from echorenderer_tpu.io.echo_dsl import EchoSource as JEchoSource
from echorenderer_tpu_torch.io.echo_dsl import EchoSource, coerce_literal, tokenize
from echorenderer_tpu_torch.scene.convert import to_arrays
from echorenderer_tpu_torch.scene.prepare import prepare_scene as tprepare
from echorenderer_tpu_torch.terminal import _parse_outputs, build_argparser, load_profile
from test_torch_io import jprepare_numpy_bvh
from test_torch_prepare import _assert_tables_equal, flatten_jax

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

DOC = """
# a small but representative scene
:scene = new Scene
{
    :gray = new Pure("hdr(0.75 0.75 0.75)")
    :matte = new Diffuse { .Albedo = link gray .Roughness = "0.3" }

    .Add(new PlaneEntity { .Material = link matte .Size = "32 24" })
    .Add(new SphereEntity
    {
        .Material = new Dielectric { .Albedo = link gray .RefractiveIndex = "1.5" }
        .Radius = "1" .Position = "-3 1 -2"
    })
    .Add(new PointLight { .Intensity = "hdr(10 10 10)" .Position = "0 6 -7" })
    .Add(new AmbientLight { .Intensity = "hdr(0.1 0.1 0.12)" })
    .Add(new PerspectiveCamera { .Name = "main" .FieldOfView = "110" .Position = "0 3 -6" .Rotation = "30 0 0" })
}

:raw = new RenderProfile
{
    .Scene = link scene
    .Resolution = "64 48"
    .EvaluationProfiles =
    [
        new EvaluationProfile { .Evaluator = new PathTracedEvaluator .LayerName = "main" .NoiseThreshold = "0.02" }
        new EvaluationProfile { .Evaluator = new AlbedoEvaluator .LayerName = "albedo" }
    ]
    .CompositionLayers = [ new ToneMapper { .Curve = "aces" } ]
}
"""


def _state(obj, seen=None):
    """An object graph as comparable data: class names, attributes,
    arrays by value; a texture by its pixels."""
    seen = set() if seen is None else seen
    if isinstance(obj, (list, tuple)):
        return [_state(o, seen) for o in obj]
    if isinstance(obj, dict):
        return {repr(_state(k, seen)): _state(v, seen) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return (str(obj.dtype), obj.shape, obj.tobytes())
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if not hasattr(obj, "__dict__"):
        return obj
    if id(obj) in seen:
        return ("link", type(obj).__name__)
    seen.add(id(obj))
    out = {"__type__": type(obj).__name__}
    if hasattr(obj, "data") and callable(obj.data) and not hasattr(obj, "children"):
        out["data"] = _state(np.asarray(obj.data()), seen)
    for k, v in sorted(vars(obj).items()):
        if k.startswith("_"):
            continue
        out[k] = _state(v, seen)
    return out


class TestTokenizer:
    def test_comments_stripped(self):
        toks = tokenize("# hello\n:a = new Scene # trailing\n")
        assert [k for k, _, _ in toks] == ["decl", "punct", "word", "word"]

    def test_strings_and_members(self):
        toks = tokenize('.Albedo = "hdr(1 2 3)"')
        assert toks[0] == ("member", ".Albedo", 1)
        assert toks[2][0] == "string"


class TestLiterals:
    def test_bool_number_vector(self):
        assert coerce_literal("True") is True
        assert coerce_literal("1.5") == 1.5
        np.testing.assert_allclose(coerce_literal("0 6 -7"), [0, 6, -7])

    def test_colors_match_jax(self):
        from echorenderer_tpu.utils.colors import parse_color as jparse
        from echorenderer_tpu_torch.utils.colors import parse_color

        np.testing.assert_allclose(coerce_literal("hdr(1 2 3)")[:3], [1, 2, 3])
        np.testing.assert_allclose(coerce_literal("rgb(255 0 0)")[:3], [1, 0, 0], atol=1e-5)
        for text in ("#FF00FF", "#F0F", "#8", "0x11223344", "##abcd", "rgb(12, 200, 90)",
                     "rgb(128)", "hdr(0.5)", "hdr(1 2 3 0.5)", "rgb(1 2 3 4)"):
            got, want = parse_color(text), jparse(text)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), text
        with pytest.raises(ValueError):
            parse_color("#12345")

    def test_path_passthrough(self):
        assert coerce_literal("bunny.obj") == "bunny.obj"


class TestConstruction:
    def test_scene_graph_matches_jax(self):
        from echorenderer_tpu_torch.scene import Scene
        from echorenderer_tpu_torch.scene.materials import Dielectric, Diffuse

        scene = EchoSource(DOC).construct("scene")
        assert isinstance(scene, Scene)
        kinds = [type(c).__name__ for c in scene.children]
        assert kinds == [
            "PlaneEntity", "SphereEntity", "PointLight", "AmbientLight", "PerspectiveCamera",
        ]
        sphere, plane = scene.children[1], scene.children[0]
        assert isinstance(sphere.material, Dielectric)
        assert sphere.material.refractive_index == 1.5
        np.testing.assert_allclose(sphere.position, [-3, 1, -2])
        assert isinstance(plane.material, Diffuse)
        assert plane.material.roughness == pytest.approx(0.3)
        np.testing.assert_allclose(plane.material.constant_albedo(), [0.75] * 3)
        assert _state(scene) == _state(JEchoSource(DOC).construct("scene"))

    def test_links_alias_same_object(self):
        src = EchoSource(DOC)
        assert src.construct("raw").scene is src.construct("scene")

    def test_render_profile(self):
        from echorenderer_tpu_torch.processes.composition import ToneMapper

        prof = EchoSource(DOC).construct("raw")
        assert prof.resolution == (64, 48)
        assert [e.evaluator for e in prof.evaluations] == ["path", "albedo"]
        assert prof.evaluations[0].noise_threshold == pytest.approx(0.02)
        assert isinstance(prof.composition[0], ToneMapper)
        jprof = JEchoSource(DOC).construct("raw")
        assert _state(prof.evaluations) == _state(jprof.evaluations)
        assert _state(prof.composition) == _state(jprof.composition)

    def test_construct_first_by_type(self):
        from echorenderer_tpu_torch.processes.render import RenderProfile

        assert isinstance(EchoSource(DOC).construct_first(RenderProfile), RenderProfile)

    def test_lexical_scope_inner_overrides(self):
        doc = """
        :c = new Pure("hdr(1 0 0)")
        :outer = new Scene
        {
            :c = new Pure("hdr(0 1 0)")
            .Add(new PlaneEntity { .Material = new Diffuse { .Albedo = link c } })
        }
        """
        scene = EchoSource(doc).construct("outer")
        np.testing.assert_allclose(scene.children[0].material.constant_albedo(), [0, 1, 0])

    def test_unknown_type_raises(self):
        with pytest.raises(KeyError):
            EchoSource(":x = new NotAThing").construct("x")

    def test_syntax_error_reports_line(self):
        with pytest.raises(SyntaxError):
            EchoSource(":x = = new Scene")

    def test_parse_prepare_render_tiny(self):
        """.echo text -> scene -> prepared -> 1 albedo frame, on the CPU."""
        from echorenderer_tpu_torch.processes.render import render

        prof = EchoSource(DOC).construct("raw")
        prof.resolution = (16, 12)
        prof.evaluations = (prof.evaluations[1],)  # albedo only: cheap
        out = render(tprepare(prof.scene, prof.camera_name, device="cpu"), prof)
        assert out["albedo"].shape == (12, 16, 3) and np.isfinite(out["albedo"]).all()


SWATCH = """
:red = new Diffuse { .Albedo = "0.9 0.1 0.1" }
:green = new Diffuse { .Albedo = "0.1 0.9 0.1" }
:pack = new EntityPack
{
    .Add(new SphereEntity { .Material = link red .Radius = "0.6" })
}
:sw = new MaterialSwatch { .Map(link red link green) }
:scene = new Scene
{
    .Add(new PackInstance { .Pack = link pack .Position = "-1.2 0 0" })
    .Add(new PackInstance { .Pack = link pack .Swatch = link sw .Position = "1.2 0 0" })
    .Add(new AmbientLight { .Intensity = "0.01 0.01 0.01" })
    .Add(new PerspectiveCamera { .Position = "0 0 -4" .FieldOfView = "70" })
}
"""


@pytest.mark.parametrize("method", ["Map", "Set"])
def test_pack_instance_swatch_syntax(tmp_path, method):
    """PackInstance + MaterialSwatch: two placements of one pack, the second
    overriding red -> green (.Set is the reference's spelling, .Map this
    dialect's alias); TLAS tables equal JAX's, and the albedo frame."""
    from echorenderer_tpu.scene.entities import Scene as JScene
    from echorenderer_tpu_torch.processes.render import EvaluationProfile, RenderProfile, render
    from echorenderer_tpu_torch.scene.entities import Scene

    f = tmp_path / "swatch.echo"
    f.write_text(SWATCH.replace(".Map(", f".{method}("))
    prepared = tprepare(EchoSource(str(f)).construct_first(Scene), instancing="tlas",
                        device="cpu")
    assert prepared.instances is not None and prepared.geometry.num_spheres == 1
    jscene = JEchoSource(str(f)).construct_first(JScene)
    from echorenderer_tpu.scene.prepare import prepare_scene as jprepare

    _assert_tables_equal(to_arrays(prepared), flatten_jax(jprepare(jscene, instancing="tlas")))
    prof = RenderProfile(resolution=(48, 24),
                         evaluations=(EvaluationProfile(evaluator="albedo", layer_name="a"),))
    img = render(prepared, prof)["a"]
    left, right = img[:, :24], img[:, 24:]
    assert (left[..., 0] > 0.5).any() and not (left[..., 1] > 0.5).any()
    assert (right[..., 1] > 0.5).any() and not (right[..., 0] > 0.5).any()


@pytest.mark.parametrize("name", ["cornell.echo", "showcase.echo"])
def test_scene_files_match_jax(name):
    """The repo's .echo files: the Scene and every profile, constructed by
    both packages, give equal prepared tables and equal profiles."""
    from echorenderer_tpu.scene.entities import Scene as JScene
    from echorenderer_tpu_torch.scene.entities import Scene

    path = REPO / "scenes" / name
    src, jsrc = EchoSource(path), JEchoSource(path)
    scene = src.construct_first(Scene)
    assert len(scene.children) > 2
    tables = to_arrays(tprepare(scene, device="cpu"))
    ref = flatten_jax(jprepare_numpy_bvh(jsrc.construct_first(JScene)))
    _assert_tables_equal(tables, ref)
    for key in ("tex_atlas", "mat_pack", "prim_soa.bx"):
        assert tables[key].tobytes() == np.asarray(ref[key]).tobytes(), key
    assert tables["tex_atlas"].shape[0] >= 2  # Pure albedos and textures are atlas slices
    for decl in ("fast", "standard"):
        prof, jprof = src.construct(decl), jsrc.construct(decl)
        assert prof.scene is scene
        for field in ("resolution", "camera_name", "seed"):
            assert getattr(prof, field) == getattr(jprof, field), (decl, field)
        assert _state(prof.evaluations) == _state(jprof.evaluations), decl
        assert _state(prof.composition) == _state(jprof.composition), decl


class TestArgs:
    def test_defaults(self):
        args = build_argparser().parse_args([])
        assert args.profile is None and args.scene is None and args.device == "cuda"
        assert _parse_outputs(args.output) == [("main", "render.png")]

    def test_output_forms(self):
        assert _parse_outputs(["foo.png"]) == [("main", "foo.png")]
        assert _parse_outputs(["albedo=a.exr", "main=m.png"]) == [
            ("albedo", "a.exr"), ("main", "m.png")]

    def test_builtin_scene_profile(self):
        args = build_argparser().parse_args(
            ["--scene", "cornell_box", "-q", "0.5", "-r", "320x180", "--seed", "7"])
        prof = load_profile(args)
        assert prof.scene is not None
        assert prof.resolution == (320, 180) and prof.seed == 7
        assert [e.layer_name for e in prof.evaluations] == ["albedo", "main", "normal_depth"]

    def test_unknown_scene_exits(self):
        with pytest.raises(SystemExit):
            load_profile(build_argparser().parse_args(["--scene", "not_a_scene"]))

    def test_echo_profile_loading(self, tmp_path):
        p = tmp_path / "t.echo"
        p.write_text(TINY)
        prof = load_profile(build_argparser().parse_args(["-p", str(p), "--no-compose"]))
        assert prof.resolution == (64, 48)
        assert prof.scene is not None and prof.composition == ()

    def test_resolution_and_camera_override(self):
        args = build_argparser().parse_args(
            ["--scene", "material_ball", "-r", "100x50", "--camera", "main"])
        prof = load_profile(args)
        assert prof.resolution == (100, 50) and prof.camera_name == "main"


TINY = """
:scene = new Scene
{
    .Add(new SphereEntity { .Material = new Diffuse { .Albedo = "0.8 0.3 0.2" } })
    .Add(new AmbientLight { .Intensity = "0.6 0.7 0.9" })
    .Add(new PerspectiveCamera { .Position = "0 0 -4" })
}
:prof = new RenderProfile
{
    .Scene = link scene
    .Resolution = "64 48"
    .EvaluationProfiles =
    [
        new EvaluationProfile { .Evaluator = new PathTracedEvaluator .LayerName = "main" .MaxEpoch = "2" }
        new EvaluationProfile { .Evaluator = new AlbedoEvaluator .LayerName = "a" }
    ]
    .CompositionLayers = [ new ToneMapper { .Curve = "aces" } ]
}
"""


def test_cli_renders_echo_on_cpu(tmp_path, capsys):
    """terminal.main on the CPU: the files it writes read back bitwise equal
    to the same profile rendered in-process; a missing layer is named."""
    from echorenderer_tpu_torch import terminal
    from echorenderer_tpu_torch.io import images
    from echorenderer_tpu_torch.processes.render import render

    p = tmp_path / "t.echo"
    p.write_text(TINY)
    exr, png, pfm = tmp_path / "m.exr", tmp_path / "m.png", tmp_path / "a.pfm"
    argv = ["-p", str(p), "-r", "12x8", "--device", "cpu", "-o", f"main={exr}",
            "-o", f"main={png}", "-o", f"a={pfm}", "-o", f"nope={tmp_path / 'x.png'}"]
    assert terminal.main(argv) == 0
    err = capsys.readouterr().err
    assert "dispatch: wavefront (not on CUDA)" in err and "no layer 'nope'" in err
    assert "SAH builds:" in err and "saved main" in err
    prof = load_profile(build_argparser().parse_args(["-p", str(p), "-r", "12x8"]))
    out = render(tprepare(prof.scene, prof.camera_name, device="cpu"), prof)
    assert images.load(exr).tobytes() == out["main"].tobytes()
    assert png.read_bytes() == images.encode_png(out["main"])
    assert images.load(pfm).tobytes() == out["a"].tobytes()
    assert out["main"].shape == (8, 12, 3) and np.isfinite(out["main"]).all()
