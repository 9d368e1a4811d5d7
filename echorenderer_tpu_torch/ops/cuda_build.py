"""Build and load the port's CUDA kernels (csrc/*.cu).

Every source in csrc/ is compiled by nvcc for sm_90a into a shared library
with a plain C interface, loaded with ctypes. One call to `build()` starts
one nvcc per source, all at once, and waits for them; the libraries land in
_build/<key>/ (listed in .gitignore), where the key hashes every source and
header of csrc/ together with the flags, so an edit to a shared header
rebuilds every library that could include it. Nothing is built at import:
the first kernel launch (or `build()`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
# -fmad=false: every float op rounds on its own, as in the plain PyTorch
# versions the kernels are held to; no fast-math (IEEE division, accurate
# sqrtf/sinf/cosf are nvcc's defaults)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]


class Build(NamedTuple):
    path: Path
    seconds: float  # nvcc wall time; 0 when the library was already built
    ptxas: str  # nvcc -Xptxas -v report (registers, spills, shared memory per kernel)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")
    return found


# one build at a time in a process: two threads (a scheduler's and the
# caller's) would otherwise write the same _build/<key>/ files
_lock = threading.RLock()


def build() -> dict[str, Build]:
    """Compile every csrc/*.cu that is not built yet, in parallel.
    Returns {source stem: Build}."""
    with _lock:
        return _build()


def _build() -> dict[str, Build]:
    out_dir = BUILD_ROOT / _key()
    out_dir.mkdir(parents=True, exist_ok=True)
    done: dict[str, Build] = {}
    running = []
    for src in sources():
        lib = out_dir / f"lib{src.stem}.so"
        log = out_dir / f"{src.stem}.ptxas.log"
        if lib.exists():
            done[src.stem] = Build(lib, 0.0, log.read_text() if log.exists() else "")
            continue
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((src.stem, lib, log, tmp, proc, time.perf_counter()))
    failed = []
    for stem, lib, log, tmp, proc, t0 in running:
        _, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {stem}.cu ({proc.returncode}):\n{err}")
            continue
        log.write_text(err)
        os.replace(tmp, lib)
        done[stem] = Build(lib, seconds, err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


_libs: dict[str, ctypes.CDLL] = {}


def load(stem: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<stem>.cu's library, built on first use."""
    with _lock:
        if stem not in _libs:
            _libs[stem] = ctypes.CDLL(str(build()[stem].path))
        return _libs[stem]
