"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names, by `ast` and in sys.modules at a run's end; and the
measuring path fails without a card rather than falling back."""

import json
import subprocess
import sys
import types

import pytest

from echobench import imports, run


def test_no_file_of_the_benchmark_imports_jax():
    assert imports.imported_by(run.ROOT / "echobench") == []


def test_top_level_names_compare_whole(monkeypatch, tmp_path):
    assert imports.top("echorenderer_tpu_torch.ops.megakernel") == "echorenderer_tpu_torch"
    monkeypatch.setitem(sys.modules, "echorenderer_tpu_torch_x", types.ModuleType("x"))
    assert "echorenderer_tpu_torch_x" not in imports.loaded()
    monkeypatch.setitem(sys.modules, "echorenderer_tpu.scene", types.ModuleType("scene"))
    assert "echorenderer_tpu.scene" in imports.loaded()
    (tmp_path / "a.py").write_text("import jax.numpy as jnp\nfrom echorenderer_tpu import x\n"
                                   "import echorenderer_tpu_torch\nfrom . import jax\n")
    assert [m for _, m in imports.imported_by(tmp_path)] == ["jax.numpy", "echorenderer_tpu"]


def test_a_run_loads_no_jax_module():
    """A whole run (tiny, on the CPU) in a fresh process: sys.modules at its
    end holds no forbidden name."""
    code = (
        "import json, sys\n"
        "from echobench import imports, manifest, run\n"
        "c = manifest.cell(run.ROOT, 'field80.image256')\n"
        "c.traffic = dict(c.traffic, resolution=[16, 8],"
        " profile=dict(c.traffic['profile'], samples_per_epoch=2, bounce_limit=3))\n"
        "c.check = dict(c.check, pixels_per_image=16)\n"
        "r = run.measure(c, 3, 0.1, False, 'cpu')\n"
        "print(json.dumps([r['correct'], imports.loaded(), sorted({m.split('.')[0]"
        " for m in sys.modules})]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout.splitlines()[-1]
    correct, found, tops = json.loads(out)
    assert correct and found == []
    assert "echorenderer_tpu_torch" in tops and "echorenderer_tpu" not in tops


def test_without_a_card_the_run_fails_and_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "field80.image256", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_an_unknown_cell_fails():
    with pytest.raises(KeyError):
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"])
