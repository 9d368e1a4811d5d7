"""Tile orderings for progressive display.

Rebuild of the reference tile patterns (Processes/Evaluation/ITilePattern.cs:
OrderedPattern, ScrambledPattern, SpiralPattern, CheckerboardPattern,
HilbertCurvePattern). On TPU tiles don't schedule work — XLA owns the whole
frame — but progressive preview (live viewer, GUI analogue) still reveals
tiles in these orders, so the component keeps its reference semantics:
every pattern yields a permutation of the tile grid.
"""

from __future__ import annotations

import numpy as np


def tile_grid(resolution, tile_size: int = 16) -> tuple[int, int]:
    w, h = resolution
    return -(-w // tile_size), -(-h // tile_size)


def lane_order(resolution, tile_size: int = 32) -> tuple[np.ndarray, np.ndarray]:
    """Tile-major lane permutation for the wavefront: lane i renders pixel
    perm[i], so every 1024-lane kernel block covers a compact ~32x32 pixel
    tile instead of a thin scanline strip. Compact blocks are the packet
    coherence the hierarchical traversal (ops/pallas_hier.py) culls by —
    worth 2-5x trace throughput on large scenes. Per-pixel results are
    unchanged (draws key on pixel_id), so images are bit-identical to scan
    order after the inv[] gather-back.

    Returns (perm, inv): perm (n,) lane -> pixel id, inv (n,) pixel -> lane.
    """
    w, h = resolution
    ids = np.arange(w * h, dtype=np.int64)
    px, py = ids % w, ids // w
    ntx = -(-w // tile_size)
    key = ((py // tile_size) * ntx + (px // tile_size)) * (tile_size * tile_size) + (
        py % tile_size
    ) * tile_size + (px % tile_size)
    perm = np.argsort(key, kind="stable").astype(np.uint32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(w * h, dtype=np.uint32)
    return perm, inv


def ordered(nx: int, ny: int) -> np.ndarray:
    """Row-major scan (reference OrderedPattern)."""
    ys, xs = np.mgrid[0:ny, 0:nx]
    return np.stack([xs.ravel(), ys.ravel()], -1)


def scrambled(nx: int, ny: int, seed: int = 0) -> np.ndarray:
    """Deterministic shuffle (reference ScrambledPattern)."""
    tiles = ordered(nx, ny)
    rs = np.random.RandomState(seed)
    return tiles[rs.permutation(len(tiles))]


def spiral(nx: int, ny: int) -> np.ndarray:
    """Center-out spiral (reference SpiralPattern): tiles sorted by
    ring distance from the grid center, angle-ordered within a ring."""
    tiles = ordered(nx, ny).astype(np.float64)
    c = np.asarray([(nx - 1) / 2.0, (ny - 1) / 2.0])
    d = tiles - c
    ring = np.maximum(np.abs(d[:, 0]), np.abs(d[:, 1])).round(6)
    ang = np.arctan2(d[:, 1], d[:, 0])
    order = np.lexsort((ang, ring))
    return ordered(nx, ny)[order]


def checkerboard(nx: int, ny: int) -> np.ndarray:
    """Even-parity tiles first, then odd (reference CheckerboardPattern)."""
    tiles = ordered(nx, ny)
    parity = (tiles[:, 0] + tiles[:, 1]) % 2
    return np.concatenate([tiles[parity == 0], tiles[parity == 1]], 0)


def _hilbert_d2xy(order: int, d: np.ndarray):
    """Vectorized Hilbert curve index -> (x, y) on a 2^order grid."""
    x = np.zeros_like(d)
    y = np.zeros_like(d)
    t = d.copy()
    s = 1
    while s < (1 << order):
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        # rotate
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f, y_f = x.copy(), y.copy()
        x = np.where(swap, y_f, x)
        y = np.where(swap, x_f, y)
        x = np.where(flip, s - 1 - x, x)
        y = np.where(flip, s - 1 - y, y)
        x = x + s * rx
        y = y + s * ry
        t //= 4
        s *= 2
    return x, y


def hilbert(nx: int, ny: int) -> np.ndarray:
    """Hilbert curve order (reference HilbertCurvePattern); tiles outside
    the (possibly non-square) grid are skipped."""
    order = max(1, int(np.ceil(np.log2(max(nx, ny)))))
    n = 1 << order
    d = np.arange(n * n)
    x, y = _hilbert_d2xy(order, d)
    keep = (x < nx) & (y < ny)
    return np.stack([x[keep], y[keep]], -1)


PATTERNS = {
    "ordered": ordered,
    "scrambled": scrambled,
    "spiral": spiral,
    "checkerboard": checkerboard,
    "hilbert": hilbert,
}
