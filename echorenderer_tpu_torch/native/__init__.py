"""Native (C++) host components, loaded through ctypes (counterpart of
echorenderer_tpu/native).

The host-side hot path of scene preparation, the SAH BVH build, is C++
(csrc/bvh_builder.cpp), compiled with g++ at first use into
_build/<key>/libechonative.so, where the key hashes the source and the
flags (the directory is listed in .gitignore). `-ffp-contract=off` keeps
the SAH sums unfused, so the builder chooses the numpy builder's splits
bit for bit (aggregation/bvh.build_bvh_numpy, its plain version).

Without g++ on PATH, `load()` logs one warning and returns None, and
`build_bvh` takes the numpy builder. Where g++ exists, a build or load
that fails raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "bvh_builder.cpp"
BUILD_ROOT = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC"]

_lib = None
_missing = False  # no g++ on PATH: warned once, numpy from then on
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libechonative.so"


def _compile(cxx: str, lib: Path):
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name} (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: another process may load it meanwhile


def load():
    """The native library (compiled on first use), or None when no g++ is
    on PATH."""
    global _lib, _missing
    with _lock:
        if _lib is not None or _missing:
            return _lib
        cxx = shutil.which("g++")
        if cxx is None:
            from ..utils import diagnostics

            diagnostics.get_logger("native").warning(
                "no g++ on PATH: the SAH BVH build runs in numpy (much slower for large meshes)")
            _missing = True
            return None
        lib_path = library_path()
        if not lib_path.exists():
            _compile(cxx, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        lib.build_bvh_sah.restype = ctypes.c_int32
        lib.build_bvh_sah.argtypes = [ctypes.c_int32, fp, fp, ctypes.c_int32, fp, fp, ip, ip, ip]
        _lib = lib
        return _lib


def build_bvh_native(aabb_min: np.ndarray, aabb_max: np.ndarray, leaf_max: int):
    """SAH build via the C++ builder. Returns the flattened arrays
    (child_min, child_max, child_code, prim_order, root_code) as numpy, or
    None when no g++ is on PATH."""
    lib = load()
    if lib is None:
        return None
    n = int(aabb_min.shape[0])
    amin = np.ascontiguousarray(aabb_min, np.float32)
    amax = np.ascontiguousarray(aabb_max, np.float32)
    cap = max(n, 1)
    child_min = np.zeros((cap, 2, 3), np.float32)
    child_max = np.zeros((cap, 2, 3), np.float32)
    child_code = np.zeros((cap, 2), np.int32)
    prim_order = np.zeros(n, np.int32)
    node_count = ctypes.c_int32(0)

    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    root = lib.build_bvh_sah(
        n,
        amin.ctypes.data_as(fp),
        amax.ctypes.data_as(fp),
        int(leaf_max),
        child_min.ctypes.data_as(fp),
        child_max.ctypes.data_as(fp),
        child_code.ctypes.data_as(ip),
        prim_order.ctypes.data_as(ip),
        ctypes.byref(node_count),
    )
    k = max(int(node_count.value), 1)
    if node_count.value == 0:  # single leaf: the numpy builder's degenerate node
        child_code[0] = (root, root)
    return (
        child_min[:k].copy(),
        child_max[:k].copy(),
        child_code[:k].copy(),
        prim_order,
        int(root),
    )
