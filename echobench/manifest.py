"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of "workloads") joins a configuration file (the "file" of
its "configs" entry), whose scene generator is generators/<generator>.py
and whose plain reference is reference/<reference>.py where the file names
one ("reference"; check.py's default where it does not), a traffic mix
(traffic/<traffic>.json) and its check (checks/<cell>.json);
a metric's reader is metrics/<metric>.py, or, where there is none, the
reader of the name's part before its first dot (metrics/<base>.py), so
that `device_idle_pct.frames` and `device_idle_pct.standard` share one.
Adding a configuration, a scene, a cell, a mix or a metric adds files and
entries; no code here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list
    generator: object  # the configuration's generators/<generator>.py `make`
    reference: object = None  # its reference/<reference>.py module; None: check.py's default

    def scene(self):
        """The scene spec of the cell's configuration, from its generator."""
        return self.generator(**self.config.get("args", {}))


def _load(path: Path, name: str):
    """The file at `path` as the module `name`, registered in sys.modules
    as an import would be (a dataclass needs it)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str, e2e_names: set | None) -> bool:
    """An end-to-end metric (e2e_names None) without "workloads" is in
    every cell; a per-layer one, in every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def cell(root: Path, name: str, bench: dict | None = None) -> Cell:
    root = Path(root)
    bench = bench or load(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
    w = by_name[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / bench["paths"][0]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, None)]
    names = {m["name"] for m in e2e}
    config = json.loads((root / cfg["file"]).read_text())
    generator = config["generator"]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        check=json.loads((bench_dir / "checks" / f"{name}.json").read_text()),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"] if _applies(m, name, names)],
        generator=_load(bench_dir / "generators" / f"{generator}.py",
                        f"echobench_generator_{generator}").make,
        # a module of the echobench.reference package: it may import flat and tracer
        reference=(_load(bench_dir / "reference" / f"{config['reference']}.py",
                         f"echobench.reference.{config['reference']}")
                   if "reference" in config else None),
    )


def reader(root: Path, metric: str, bench: dict | None = None):
    """The `read(run)` function of metrics/<metric>.py, else of
    metrics/<the name's part before its first dot>.py."""
    bench = bench or load(root)
    folder = Path(root) / bench["paths"][0] / "metrics"
    path = folder / f"{metric}.py"
    if not path.exists():
        path = folder / f"{metric.split('.', 1)[0]}.py"
    return _load(path, f"echobench_metric_{path.stem}").read
