"""Directional (environment) textures with importance sampling (counterpart
of echorenderer_tpu/textures/directional.py).

  - CylindricalTexture: an equirectangular map; `prepare` builds a
    luminance * sin(theta) 2D CDF so `sample` draws directions in
    proportion to energy; the pdf turns bin mass into solid-angle density.
  - Cubemap: six faces, resampled into one equirectangular grid.
  - ColorfulDirectionalTexture: an octant test pattern.

`prepare(device)` returns a `PreparedDirectional` of tensors on that
device, with evaluate/sample/pdf/mean_luminance/average: the contract of
evaluation/scene_ops.py's env-light code.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.distributions import Distribution2D, build_2d
from .grids import CLAMP, PreparedGrid, Texture, rgba


def _dir_to_equirect_uv(d):
    """Direction -> (u, v): u = azimuth / 2pi (atan2(x, z)), v = polar
    angle / pi measured from -y (v=0 is down, v=1 is up)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    u = torch.atan2(x, z) * (0.5 / math.pi) + 0.5
    v = torch.arccos(torch.clamp(-y, -1.0, 1.0)) / math.pi
    return u, v


def _equirect_uv_to_dir(u, v):
    phi = (u - 0.5) * (2.0 * math.pi)
    theta = v * math.pi  # from -y
    sin_t = torch.sin(theta)
    return torch.stack([sin_t * torch.sin(phi), -torch.cos(theta), sin_t * torch.cos(phi)],
                       dim=-1)


class PreparedDirectional(NamedTuple):
    """Equirectangular env map + its energy CDF."""

    grid: PreparedGrid  # (H, W, 4)
    dist: Distribution2D  # over the (H, W) luminance * sin bins
    mean_lum: torch.Tensor  # () scalar

    def evaluate(self, d: torch.Tensor) -> torch.Tensor:
        """Radiance along the (normalized) directions d (..., 3) -> (..., 3)."""
        u, v = _dir_to_equirect_uv(d)
        return self.grid.sample_uv(torch.stack([u, v], dim=-1))[..., :3]

    def sample(self, u2: torch.Tensor):
        """u2 (..., 2) -> (direction (..., 3), solid-angle pdf (...))."""
        h, w = self.dist.shape
        iy, ix, pmf, remap = self.dist.sample(u2)
        v = (iy.to(torch.float32) + remap[..., 0]) / h
        u = (ix.to(torch.float32) + remap[..., 1]) / w
        d = _equirect_uv_to_dir(u, v)
        sin_t = torch.sqrt(torch.clamp(1.0 - d[..., 1] ** 2, min=1e-8))
        # bin mass -> solid angle: each bin spans (2pi/W)(pi/H) sin(theta)
        pdf = pmf * (h * w) / (2.0 * math.pi * math.pi * sin_t)
        return d, pdf

    def pdf(self, d: torch.Tensor) -> torch.Tensor:
        """Solid-angle pdf of `sample` returning direction d."""
        h, w = self.dist.shape
        u, v = _dir_to_equirect_uv(d)
        iy = torch.clamp((v * h).to(torch.int32), 0, h - 1)
        ix = torch.clamp((u * w).to(torch.int32), 0, w - 1)
        pmf = self.dist.pmf_of(iy, ix)
        sin_t = torch.sqrt(torch.clamp(1.0 - d[..., 1] ** 2, min=1e-8))
        return pmf * (h * w) / (2.0 * math.pi * math.pi * sin_t)

    def mean_luminance(self):
        return self.mean_lum

    def average(self) -> torch.Tensor:
        """Mean radiance over the sphere (solid-angle weighted)."""
        texels = self.grid.texels
        h = texels.shape[0]
        theta = (torch.arange(h, dtype=torch.float32, device=texels.device) + 0.5) / h * math.pi
        weights = torch.sin(theta)[:, None, None]
        total = torch.sum(texels[..., :3] * weights, dim=(0, 1))
        return total / torch.clamp(torch.sum(weights) * texels.shape[1], min=1e-9)


class CylindricalTexture(Texture):
    """Equirectangular environment texture (host). Wraps any Texture or
    array; `prepare` bakes the grid and its importance CDF."""

    def __init__(self, source, **kw):
        kw.setdefault("wrap", "repeat")
        super().__init__(**kw)
        self.source = source
        self._prepared_dir: dict[str, PreparedDirectional] = {}

    def data(self):
        if isinstance(self.source, Texture):
            return self.source.data()
        return np.asarray(self.source, np.float32)

    def prepare(self, device="cpu") -> PreparedDirectional:
        key = str(torch.device(device))
        if key not in self._prepared_dir:
            texels = rgba(self.data())
            h, w = texels.shape[0], texels.shape[1]
            lum = (0.212671 * texels[..., 0] + 0.715160 * texels[..., 1]
                   + 0.072169 * texels[..., 2])
            theta = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi
            weights = lum * np.sin(theta)[:, None]
            sin_sum = float(np.sin(theta).sum()) * w
            mean_lum = float(weights.sum() / max(sin_sum, 1e-9))
            grid = PreparedGrid(texels=torch.as_tensor(texels, device=device), wrap=self.wrap,
                                filter=self.filter, wrap_v=CLAMP)  # poles must not wrap
            self._prepared_dir[key] = PreparedDirectional(
                grid=grid, dist=build_2d(weights, device=device),
                mean_lum=torch.tensor(mean_lum, dtype=torch.float32, device=device),
            )
        return self._prepared_dir[key]


def _octant_dirs(resolution):
    """Unit directions at the texel centres of a (W, H) equirectangular grid."""
    w, h = resolution
    u = (np.arange(w, dtype=np.float32) + 0.5) / w
    v = (np.arange(h, dtype=np.float32) + 0.5) / h
    uu, vv = np.meshgrid(u, v)
    phi = (uu - 0.5) * 2.0 * np.pi
    theta = vv * np.pi
    return np.stack(
        [np.sin(theta) * np.sin(phi), -np.cos(theta), np.sin(theta) * np.cos(phi)], axis=-1
    )


class Cubemap(Texture):
    """Six-face environment map, resampled into one equirectangular grid at
    prepare time so the device path stays a single gather; face order
    +x, -x, +y, -y, +z, -z."""

    def __init__(self, faces, resolution=(512, 256), **kw):
        super().__init__(**kw)
        self.faces = faces
        self.resolution = tuple(resolution)
        self._equirect = None

    def data(self):
        if self._equirect is None:
            d = _octant_dirs(self.resolution)
            ax, ay, az = np.abs(d[..., 0]), np.abs(d[..., 1]), np.abs(d[..., 2])
            face = np.where(
                (ax >= ay) & (ax >= az),
                np.where(d[..., 0] > 0, 0, 1),
                np.where(ay >= az, np.where(d[..., 1] > 0, 2, 3), np.where(d[..., 2] > 0, 4, 5)),
            )
            out = np.zeros(d.shape[:-1] + (4,), np.float32)
            prepared = []
            for f in self.faces:
                arr = f.data() if isinstance(f, Texture) else np.asarray(f, np.float32)
                if arr.shape[-1] == 3:
                    arr = np.concatenate([arr, np.ones_like(arr[..., :1])], -1)
                prepared.append(arr)
            # face-local (s, t) per cube-face convention
            x, y, z = d[..., 0], d[..., 1], d[..., 2]
            configs = [
                (0, -z, y, ax), (1, z, y, ax),
                (2, x, -z, ay), (3, x, z, ay),
                (4, x, y, az), (5, -x, y, az),
            ]
            for fid, s, t, major in configs:
                m = face == fid
                if not m.any():
                    continue
                arr = prepared[fid]
                fh, fw = arr.shape[:2]
                su = np.clip((s[m] / np.maximum(major[m], 1e-9) + 1) / 2, 0, 1 - 1e-7)
                tv = np.clip((t[m] / np.maximum(major[m], 1e-9) + 1) / 2, 0, 1 - 1e-7)
                out[m] = arr[(tv * fh).astype(np.int64), (su * fw).astype(np.int64)]
            self._equirect = out
        return self._equirect

    def prepare(self, device="cpu") -> PreparedDirectional:
        return CylindricalTexture(self.data(), wrap="repeat").prepare(device)


class ColorfulDirectionalTexture(Texture):
    """Octant-colored test pattern: the color channels encode the sign
    octant of the direction."""

    def __init__(self, resolution=(128, 64), **kw):
        super().__init__(**kw)
        self.resolution = tuple(resolution)

    def data(self):
        d = _octant_dirs(self.resolution)
        rgb = (d > 0).astype(np.float32) * 0.75 + 0.25
        return np.concatenate([rgb, np.ones_like(rgb[..., :1])], -1)

    def prepare(self, device="cpu") -> PreparedDirectional:
        return CylindricalTexture(self.data()).prepare(device)
