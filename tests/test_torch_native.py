"""PyTorch port: the C++ SAH BVH builder (csrc/bvh_builder.cpp through
native/) bitwise against its plain version, the numpy builder
(aggregation/bvh.build_bvh_numpy): random boxes, sphere_grid(20_000)'s
prim boxes and its chunk boxes, at leaf_max 1 and 4, and a single prim;
every output array and the root. Also: prepare_scene takes the C++
builder, no g++ on PATH falls back to numpy with one warning, and a failed
compile raises with the compiler's output. Skips only without g++."""

import logging
import shutil

import numpy as np
import pytest
import torch

from echorenderer_tpu_torch import native
from echorenderer_tpu_torch.aggregation import bvh
from echorenderer_tpu_torch.models import scenes
from echorenderer_tpu_torch.scene import prepare as prep

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")


def _boxes(n, seed=0):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-50, 50, (n, 3)).astype(np.float32)
    e = rs.uniform(0.01, 1.0, (n, 3)).astype(np.float32)
    return c - e, c + e


def _assert_same_tree(a, b):
    assert a.root_code == b.root_code
    for name in ("child_min", "child_max", "child_code", "prim_order"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


@pytest.fixture(scope="module")
def grid_boxes():
    """sphere_grid(20_000)'s prim boxes and chunk boxes, as prepare_scene
    hands them to build_bvh (prims at LEAF_MAX, chunks at leaf_max=1)."""
    seen = []
    real = bvh.build_bvh

    def record(lo, hi, leaf_max=bvh.LEAF_MAX):
        seen.append((np.array(lo), np.array(hi), leaf_max))
        return real(lo, hi, leaf_max)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prep, "build_bvh", record)
        from echorenderer_tpu_torch.ops import pallas_hier

        mp.setattr(pallas_hier, "build_bvh", record)
        scene = prep.prepare_scene(scenes.sphere_grid(20_000), device="cpu")
    assert scene.hier_soa is not None and [s[2] for s in seen] == [bvh.LEAF_MAX, 1]
    return seen


@pytest.mark.parametrize("leaf_max", [1, 4])
@pytest.mark.parametrize("case", ["random", "grid_prims", "grid_chunks", "single"])
def test_native_matches_numpy(grid_boxes, case, leaf_max):
    if case == "random":
        lo, hi = _boxes(3000, seed=leaf_max)
    elif case == "single":
        lo, hi = _boxes(1)
    else:
        lo, hi, _ = grid_boxes[0 if case == "grid_prims" else 1]
    calls = bvh.build_bvh.native_calls
    got = bvh.build_bvh(lo, hi, leaf_max)
    assert bvh.build_bvh.native_calls == calls + 1
    _assert_same_tree(got, bvh.build_bvh_numpy(lo, hi, leaf_max))
    assert sorted(got.prim_order.tolist()) == list(range(lo.shape[0]))
    if case == "single":
        assert got.root_code < 0 and got.child_code.tolist() == [[got.root_code] * 2]


def test_prepare_takes_native_builder():
    native_calls, numpy_calls = bvh.build_bvh.native_calls, bvh.build_bvh.numpy_calls
    prep.prepare_scene(scenes.cornell_box(), device="cpu")
    assert bvh.build_bvh.native_calls == native_calls + 1
    assert bvh.build_bvh.numpy_calls == numpy_calls
    assert native.library_path().exists()


def test_no_compiler_falls_back_to_numpy_with_one_warning(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_missing", False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    logger = logging.getLogger("echo.native")
    logger.addHandler(handler)
    lo, hi = _boxes(200, seed=3)
    numpy_calls = bvh.build_bvh.numpy_calls
    try:
        first = bvh.build_bvh(lo, hi)
        second = bvh.build_bvh(lo, hi)
    finally:
        logger.removeHandler(handler)
    assert bvh.build_bvh.numpy_calls == numpy_calls + 2
    assert [r.getMessage() for r in records] == [
        "no g++ on PATH: the SAH BVH build runs in numpy (much slower for large meshes)"]
    _assert_same_tree(first, second)


def test_failed_compile_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_missing", False)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-include", "no_such_header.h"])
    with pytest.raises(RuntimeError, match="no_such_header.h"):
        bvh.build_bvh(*_boxes(10))
    assert not list(tmp_path.rglob("*.so"))
