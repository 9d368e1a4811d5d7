"""The repo's offline tools (counterparts of tools/*.py), run as modules on
the card unless `--device cpu` is given:

    python -m echorenderer_tpu_torch.tools.train_denoiser [--steps 20000] [--out PATH]
    python -m echorenderer_tpu_torch.tools.gen_reference_stats --out DIR [--spp 256]
    python -m echorenderer_tpu_torch.tools.showcase_renders --out DIR

Each writes only where the caller points it (or under the package's
_build/ directory): never the committed weights, tests/fixtures/ or
docs/renders/.
"""

from __future__ import annotations

import os

import torch

from ..benchmarks.plucker_micro import card_line  # noqa: F401 (the tools' card line)

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)
BUILD_DIR = os.path.join(PACKAGE, "_build")
# committed files no tool overwrites: both packages' weights, the test
# fixtures (the denoiser's eval pairs, the tile statistics) and the docs' renders
PROTECTED_DIRS = tuple(os.path.join(REPO, *parts) for parts in (
    ("echorenderer_tpu_torch", "data"), ("echorenderer_tpu", "data"), ("tests", "fixtures"),
    ("docs", "renders"),
))


def require_device(device: str) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises (the
    tools never fall back to the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for --device {device} (--device cpu runs on the CPU)")
    return dev


def check_writable(path) -> str:
    """`path`, absolute; raises ValueError when it lies in a committed
    directory of PROTECTED_DIRS."""
    real = os.path.realpath(path)
    for d in PROTECTED_DIRS:
        if real == os.path.realpath(d) or real.startswith(os.path.realpath(d) + os.sep):
            raise ValueError(f"refusing to write {path}: {d} holds committed files")
    return real


