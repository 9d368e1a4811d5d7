"""The benchmark loads neither JAX nor the JAX package.

A module counts by its top-level name, the part before the first dot,
compared whole: `echorenderer_tpu_torch` (the port) is allowed,
`echorenderer_tpu` (the JAX package) is not."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "echorenderer_tpu"})


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded() -> list:
    """Forbidden modules in this process's sys.modules."""
    return sorted(m for m in list(sys.modules) if top(m) in FORBIDDEN)


def imported_by(root: Path) -> list:
    """(file, module) of every forbidden import statement in the .py files
    under `root`."""
    found = []
    for path in sorted(Path(root).rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            found += [(str(path), n) for n in names if top(n) in FORBIDDEN]
    return found
