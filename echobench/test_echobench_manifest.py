"""Every BENCHMARK.json entry resolves to its files by name, and a new
traffic mix, cell and metric are picked up from files alone."""

import json
import shutil

import pytest

from echobench import manifest, run

BENCH = manifest.load(run.ROOT)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    cell = manifest.cell(run.ROOT, name, BENCH)
    assert cell.config["name"] == {w["name"]: w for w in BENCH["workloads"]}[name]["config"]
    assert cell.traffic["entry"] in ("render_layer", "render")
    assert {"rel_err", "off_share"} <= set(cell.check["limits"])
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    assert all(m["moves"] in reported for m in cell.per_layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(manifest.reader(run.ROOT, metric, BENCH))


def test_every_config_file_names_its_config():
    for c in BENCH["configs"]:
        data = json.loads((run.ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]


def test_files_alone_add_a_cell_a_mix_and_a_metric(tmp_path):
    """A copy gains a traffic mix, a cell, its check and a per-layer metric
    as new files and new entries; the harness runs it unchanged."""
    shutil.copytree(run.ROOT / "echobench", tmp_path / "echobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "echobench"
    (d / "traffic" / "tiny.json").write_text(json.dumps({
        "entry": "render_layer", "loop": "closed", "clients": 1, "resolution": [16, 8],
        "profile": {"evaluator": "path", "samples_per_epoch": 2, "min_epoch": 1,
                    "max_epoch": 1, "adaptive": False, "bounce_limit": 3,
                    "survivability": 2.5}}))
    (d / "checks" / "field80.tiny.json").write_text(json.dumps(
        {"layer": "main", "pixels_per_image": 32, "off_tol": 0.01,
         "limits": {"rel_err": 1e-3, "off_share": 0.05}}))
    (d / "metrics" / "images_done.py").write_text(
        "def read(run):\n    return float(len(run.images))\n")
    bench["workloads"].append({"name": "field80.tiny", "config": "sphere_field_80",
                               "traffic": "tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "images_done", "unit": "images", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "setup_s", "workloads": ["field80.tiny"]})
    for m in bench["per_layer"]:
        if m["name"] == "prepare_s":
            m["workloads"].append("field80.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.cell(tmp_path, "field80.tiny")
    assert cell.traffic["resolution"] == [16, 8]
    assert [m["name"] for m in cell.per_layer] == ["prepare_s", "images_done"]
    result = run.measure(cell, 2**33 + 5, 0.2, True, "cpu", tmp_path, json.loads(
        (tmp_path / "BENCHMARK.json").read_text()))
    assert result["correct"]
    assert result["metrics"]["images_done"]["value"] >= 1
    assert list(result)[-1] == "check"


GENERATOR = '''
from echobench.scenes import SceneSpec


def make(radius):
    spec = SceneSpec()
    spec.entity("PlaneEntity", spec.material("Diffuse", albedo=(0.5, 0.5, 0.5)),
                size=(20, 20), position=(0, 0, 0))
    spec.entity("SphereEntity", spec.material("Conductor", albedo=(0.9, 0.6, 0.3),
                                              roughness=0.2), radius=radius, position=(-1, 1, 0))
    spec.entity("SphereEntity", spec.material("Emissive", albedo=(4.0, 3.0, 2.0)),
                radius=0.5, position=(1.5, 0.5, 1))
    spec.light("AmbientLight", intensity=(0.2, 0.2, 0.3))
    spec.camera = dict(kind="PerspectiveCamera", field_of_view=50.0, position=(0, 2, -6),
                       lens_radius=0.0, target=(0, 0.8, 0))
    return spec
'''


def test_files_alone_add_a_configuration_with_a_new_scene(tmp_path):
    """A copy gains a scene generator, a configuration and a cell on it as
    new files and new entries; the harness builds the scene for the port
    and the reference and runs the cell unchanged."""
    shutil.copytree(run.ROOT / "echobench", tmp_path / "echobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "echobench"
    (d / "generators" / "two_spheres.py").write_text(GENERATOR)
    (d / "configs" / "two_spheres.json").write_text(json.dumps({
        "name": "two_spheres", "source": "a test", "generator": "two_spheres",
        "args": {"radius": 1.0}, "reduced": []}))
    (d / "checks" / "two.image8.json").write_text(json.dumps(
        {"layer": "main", "pixels_per_image": 40, "off_tol": 0.01,
         "limits": {"rel_err": 1e-3, "off_share": 0.05}}))
    (d / "traffic" / "small8.json").write_text(json.dumps({
        "entry": "render_layer", "loop": "closed", "clients": 1, "resolution": [20, 12],
        "profile": {"evaluator": "path", "samples_per_epoch": 8, "min_epoch": 1,
                    "max_epoch": 1, "adaptive": False, "bounce_limit": 4,
                    "survivability": 2.5}}))
    bench["configs"].append({"name": "two_spheres", "source": "a test",
                             "file": "echobench/configs/two_spheres.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "two.image8", "config": "two_spheres",
                               "traffic": "small8", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "mspps":
            m["workloads"].append("two.image8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.cell(tmp_path, "two.image8")
    spec = cell.scene()
    assert [e["kind"] for e in spec.entities] == ["PlaneEntity", "SphereEntity", "SphereEntity"]
    result = run.measure(cell, 2**34 + 3, 0.2, False, "cpu", tmp_path, bench)
    assert result["correct"], result["check"]
    assert {"mspps", "setup_s"} <= set(result["metrics"])
    assert result["check"]["rel_err"]["value"] < 1e-5


@pytest.mark.parametrize("name", [w["traffic"] for w in BENCH["workloads"]
                                  if w["name"] == "field80.standard"])
def test_the_standard_mix_states_the_ports_profile(name):
    """The reference's parameters of a render mix are the ones the port's
    standard profile sets at the mix's quality."""
    from echorenderer_tpu_torch.processes.render import standard_path_traced_profile

    traffic = json.loads((run.ROOT / "echobench" / "traffic" / f"{name}.json").read_text())
    prof = standard_path_traced_profile(traffic["quality"], tuple(traffic["resolution"]))
    albedo, path, normal_depth = prof.evaluations
    want = {k: getattr(path, k) for k in traffic["profile"]}
    assert traffic["profile"] == want and path.adaptive
    assert albedo.evaluator == "albedo" and normal_depth.evaluator == "normal_depth"
    assert traffic["aov_samples"] == albedo.samples_per_epoch == normal_depth.samples_per_epoch


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_lists_its_cells(metric):
    """Each per-layer metric names the cells it is read in, and each of them
    reports the end-to-end metric it moves, so a cell added later never
    owes it a reading."""
    m = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    cells = {w["name"] for w in BENCH["workloads"]}
    assert m["workloads"] and set(m["workloads"]) <= cells
    for name in m["workloads"]:
        assert m["moves"] in {e["name"] for e in manifest.cell(run.ROOT, name, BENCH).end_to_end}


REFERENCE = '''
from . import flat, tracer

CALLS = []


def flatten(spec):
    CALLS.append("flatten")
    return flat.flatten(spec)


class Reference(tracer.Reference):
    def __init__(self, scene, device, dtype):
        CALLS.append("Reference")
        super().__init__(scene, device, dtype)
'''


def test_a_configuration_brings_its_own_reference(tmp_path):
    """A configuration file that names "reference" is checked by that module
    of reference/, added as a file; one that names none by reference/flat.py
    and reference/tracer.py, as before."""
    from echobench import check
    from echobench.reference import tracer

    shutil.copytree(run.ROOT / "echobench", tmp_path / "echobench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    d = tmp_path / "echobench"
    (d / "reference" / "counted.py").write_text(REFERENCE)
    config = json.loads((run.ROOT / "echobench" / "configs" / "sphere_field_80.json").read_text())
    (d / "configs" / "field_counted.json").write_text(json.dumps(
        dict(config, name="field_counted", reference="counted")))
    (d / "checks" / "counted.image256.json").write_text(
        (d / "checks" / "field80.image256.json").read_text())
    bench["configs"].append({"name": "field_counted", "source": "a test",
                             "file": "echobench/configs/field_counted.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "counted.image256", "config": "field_counted",
                               "traffic": "image256", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    plain = manifest.cell(tmp_path, "field80.image256", bench)
    assert plain.reference is None
    cell = manifest.cell(tmp_path, "counted.image256", bench)
    assert cell.reference.__name__ == "echobench.reference.counted"
    assert type(check.build_reference(plain.scene(), "cpu")) is tracer.Reference
    assert isinstance(check.build_reference(cell.scene(), "cpu", module=cell.reference),
                      cell.reference.Reference)
    cell.reference.CALLS.clear()
    cell.traffic = dict(cell.traffic, resolution=[16, 8],
                        profile=dict(cell.traffic["profile"], samples_per_epoch=4))
    result = run.measure(cell, 2**33 + 17, 0.2, False, "cpu", tmp_path, bench)
    assert result["correct"], result["check"]
    assert cell.reference.CALLS == ["flatten", "Reference"]
