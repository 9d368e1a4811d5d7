"""Procedural content: simplex noise, fractional Brownian motion, clouds,
color gradients (the port's copy of echorenderer_tpu/textures/procedural.py,
which is numpy only). Generated textures are baked on the host and become
ordinary grids, and atlas slices, on the device.
"""

from __future__ import annotations

import numpy as np

from .grids import CacheableTexture

_GRAD2 = np.asarray(
    [[1, 1], [-1, 1], [1, -1], [-1, -1], [1, 0], [-1, 0], [0, 1], [0, -1]],
    np.float32,
)

_F2 = 0.5 * (np.sqrt(3.0) - 1.0)
_G2 = (3.0 - np.sqrt(3.0)) / 6.0


def _perm(seed: int) -> np.ndarray:
    rs = np.random.RandomState(seed)
    p = np.arange(256, dtype=np.int32)
    rs.shuffle(p)
    return np.concatenate([p, p])


def simplex_noise(x: np.ndarray, y: np.ndarray, seed: int = 0) -> np.ndarray:
    """2D simplex noise in [-1, 1], vectorized over arrays."""
    perm = _perm(seed)
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)

    s = (x + y) * _F2
    i = np.floor(x + s).astype(np.int64)
    j = np.floor(y + s).astype(np.int64)
    t = (i + j) * _G2
    x0 = x - (i - t)
    y0 = y - (j - t)

    upper = x0 > y0
    i1 = np.where(upper, 1, 0)
    j1 = np.where(upper, 0, 1)

    x1 = x0 - i1 + _G2
    y1 = y0 - j1 + _G2
    x2 = x0 - 1.0 + 2.0 * _G2
    y2 = y0 - 1.0 + 2.0 * _G2

    ii = (i & 255).astype(np.int64)
    jj = (j & 255).astype(np.int64)
    g0 = _GRAD2[perm[ii + perm[jj]] & 7]
    g1 = _GRAD2[perm[ii + i1 + perm[jj + j1]] & 7]
    g2 = _GRAD2[perm[ii + 1 + perm[jj + 1]] & 7]

    def corner(gx, xx, yy):
        tt = 0.5 - xx * xx - yy * yy
        tt = np.maximum(tt, 0.0)
        t4 = tt * tt * tt * tt
        return t4 * (gx[..., 0] * xx + gx[..., 1] * yy)

    n = corner(g0, x0, y0) + corner(g1, x1, y1) + corner(g2, x2, y2)
    return (70.0 * n).astype(np.float32)


def fbm_noise(x, y, octaves: int = 6, lacunarity: float = 2.0, gain: float = 0.5, seed: int = 0):
    """Fractional Brownian motion over simplex octaves
    (reference FractionalBrownianMotion.cs)."""
    total = np.zeros(np.broadcast(np.asarray(x), np.asarray(y)).shape, np.float32)
    amp = 1.0
    freq = 1.0
    norm = 0.0
    for o in range(octaves):
        total += amp * simplex_noise(np.asarray(x) * freq, np.asarray(y) * freq, seed + o)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / max(norm, 1e-9)


class Gradient:
    """Piecewise-linear color ramp keyed on [0,1] (reference Gradient.cs)."""

    def __init__(self, stops):
        """stops: list of (t, color) pairs, t ascending in [0, 1]."""
        stops = sorted(stops, key=lambda s: s[0])
        self.ts = np.asarray([t for t, _ in stops], np.float32)
        cols = []
        for _, c in stops:
            c = np.asarray(c, np.float32).reshape(-1)
            if c.shape[0] == 3:
                c = np.append(c, 1.0)
            cols.append(c)
        self.colors = np.stack(cols, 0)

    def __call__(self, t):
        t = np.clip(np.asarray(t, np.float32), self.ts[0], self.ts[-1])
        idx = np.clip(np.searchsorted(self.ts, t, side="right") - 1, 0, len(self.ts) - 2)
        t0 = self.ts[idx]
        t1 = self.ts[idx + 1]
        f = ((t - t0) / np.maximum(t1 - t0, 1e-9))[..., None]
        return self.colors[idx] * (1 - f) + self.colors[idx + 1] * f


class CloudTexture(CacheableTexture):
    """FBM cloud pattern mapped through a color gradient
    (reference Textures/Generative/CloudTexture.cs)."""

    def __init__(self, scale=4.0, octaves=6, seed=0,
                 gradient=None, resolution=(256, 256), **kw):
        grad = gradient or Gradient([(0.0, (0.1, 0.2, 0.4)), (1.0, (1.0, 1.0, 1.0))])

        def fn(u, v):
            n = fbm_noise(u * scale, v * scale, octaves=octaves, seed=seed)
            return grad(0.5 * (n + 1.0))

        super().__init__(fn, resolution=resolution, **kw)
        self.scale = scale
        self.octaves = octaves
        self.seed = seed
