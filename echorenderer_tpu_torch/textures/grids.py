"""Discrete textures: host descriptions + device sampling (counterpart of
echorenderer_tpu/textures/grids.py).

A `Texture` maps uv in [0,1)^2 to RGBA; grids add wrap modes
(clamp/repeat/mirror) and filters (point/bilinear). Host objects hold numpy
data; `prepare(device)` returns a `PreparedGrid` of tensors on that device
whose `sample_uv` is a branchless batched gather.

The renderer itself samples materials' textures from the prepared scene's
atlas (scene/prepare.py, evaluation/scene_ops._sample_atlas); PreparedGrid
serves env maps (textures/directional.py) and direct lookups.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CLAMP = 0
REPEAT = 1
MIRROR = 2

FILTER_POINT = 0
FILTER_BILINEAR = 1

_WRAPS = {"clamp": CLAMP, "repeat": REPEAT, "mirror": MIRROR}
_FILTERS = {"point": FILTER_POINT, "bilinear": FILTER_BILINEAR}


def _wrap_index(i: torch.Tensor, n: int, mode: int) -> torch.Tensor:
    """Wrap integer texel indices into [0, n) (floor-mod, as Python's %)."""
    if mode == REPEAT:
        return torch.remainder(i, n)
    if mode == MIRROR:
        period = torch.remainder(i, 2 * n)
        return torch.where(period < n, period, 2 * n - 1 - period)
    return torch.clamp(i, 0, n - 1)


class PreparedGrid(NamedTuple):
    """Device texture: (H, W, 4) texels + wrap/filter modes. wrap_v
    defaults to wrap (equirectangular maps repeat in u and clamp in v, so
    the poles do not blend across)."""

    texels: torch.Tensor  # (H, W, 4) linear RGBA
    wrap: int  # u axis
    filter: int
    wrap_v: int = -1  # v axis; -1 = same as wrap

    @property
    def _wrap_v(self) -> int:
        return self.wrap if self.wrap_v < 0 else self.wrap_v

    def sample_uv(self, uv: torch.Tensor) -> torch.Tensor:
        """uv (..., 2) -> RGBA (..., 4). v=0 is the bottom row."""
        h, w = self.texels.shape[0], self.texels.shape[1]
        u = uv[..., 0] * w - 0.5
        v = uv[..., 1] * h - 0.5
        if self.filter == FILTER_POINT:
            iu = _wrap_index(torch.floor(u + 0.5).long(), w, self.wrap)
            iv = _wrap_index(torch.floor(v + 0.5).long(), h, self._wrap_v)
            return self.texels[iv, iu]
        u0 = torch.floor(u).long()
        v0 = torch.floor(v).long()
        fu = (u - u0)[..., None]
        fv = (v - v0)[..., None]
        u0w = _wrap_index(u0, w, self.wrap)
        u1w = _wrap_index(u0 + 1, w, self.wrap)
        v0w = _wrap_index(v0, h, self._wrap_v)
        v1w = _wrap_index(v0 + 1, h, self._wrap_v)
        t00 = self.texels[v0w, u0w]
        t01 = self.texels[v0w, u1w]
        t10 = self.texels[v1w, u0w]
        t11 = self.texels[v1w, u1w]
        top = t00 * (1.0 - fu) + t01 * fu
        bot = t10 * (1.0 - fu) + t11 * fu
        return top * (1.0 - fv) + bot * fv


def rgba(data) -> np.ndarray:
    """(H, W), (H, W, 1), (H, W, 3) or (H, W, 4) data -> (H, W, 4) float32
    RGBA (gray repeated, alpha 1 where missing)."""
    texels = np.asarray(data, np.float32)
    if texels.ndim == 2:
        texels = texels[..., None]
    if texels.shape[-1] == 1:
        texels = np.repeat(texels, 3, axis=-1)
    if texels.shape[-1] == 3:
        texels = np.concatenate([texels, np.ones_like(texels[..., :1])], axis=-1)
    return texels


class Texture:
    """Base host texture. Subclasses implement `data()` -> (H, W, 4) numpy
    RGBA, or override `prepare`/`average` wholesale."""

    def __init__(self, wrap="repeat", filter="bilinear"):
        self.wrap = _WRAPS[wrap] if isinstance(wrap, str) else int(wrap)
        self.filter = _FILTERS[filter] if isinstance(filter, str) else int(filter)
        self._prepared: dict[str, PreparedGrid] = {}

    def data(self) -> np.ndarray:
        raise NotImplementedError

    def prepare(self, device="cpu") -> PreparedGrid:
        key = str(torch.device(device))
        if key not in self._prepared:
            self._prepared[key] = PreparedGrid(
                texels=torch.as_tensor(rgba(self.data()), device=device),
                wrap=self.wrap, filter=self.filter,
            )
        return self._prepared[key]

    def average(self) -> np.ndarray:
        """Mean RGBA (used for emissive power and material interning)."""
        d = np.asarray(self.data(), np.float32)
        mean = d.reshape(-1, d.shape[-1]).mean(axis=0)
        if mean.shape[0] == 3:
            mean = np.append(mean, 1.0)
        return mean.astype(np.float32)

    def sample_uv(self, uv):
        """Host-side convenience sampling (the renderer gathers the atlas)."""
        return self.prepare().sample_uv(torch.as_tensor(np.asarray(uv, np.float32)))


class ArrayGrid(Texture):
    """A texture over an explicit (H, W, C) array. Row 0 is the bottom of
    the image."""

    def __init__(self, array, **kw):
        super().__init__(**kw)
        self._array = np.asarray(array, np.float32)

    def data(self):
        return self._array


TextureGrid = ArrayGrid  # the reference's name


class ImportGrid(Texture):
    """Lazily imported image texture (reference ImportGrid.cs); `srgb=True`
    decodes gamma on load, except for the float formats."""

    def __init__(self, path, srgb=True, **kw):
        super().__init__(**kw)
        self.path = str(path)
        self.srgb = bool(srgb)
        self._loaded = None

    def data(self):
        if self._loaded is None:
            from ..io.images import load_image

            img = load_image(self.path)
            floats = (".hdr", ".exr", ".fpi", ".pfm", ".npy")
            if self.srgb and not self.path.lower().endswith(floats):
                rgb = np.asarray(img[..., :3], np.float32)
                lin = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
                img = np.concatenate([lin, img[..., 3:]], axis=-1) if img.shape[-1] == 4 else lin
            self._loaded = np.asarray(img, np.float32)
        return self._loaded


class Pure(Texture):
    """Constant color texture."""

    def __init__(self, color, **kw):
        kw.setdefault("filter", "point")
        super().__init__(**kw)
        c = np.asarray(color, np.float32).reshape(-1)
        if c.shape[0] == 1:
            c = np.repeat(c, 3)
        if c.shape[0] == 3:
            c = np.append(c, 1.0)
        self.color = c.astype(np.float32)

    def data(self):
        return np.broadcast_to(self.color, (1, 1, 4)).copy()

    def average(self):
        return self.color


class GradientTexture(Texture):
    """Linear gradient between two colors along an axis (0 = u, 1 = v)."""

    def __init__(self, start=(0, 0, 0), end=(1, 1, 1), axis=0, resolution=256, **kw):
        super().__init__(**kw)
        self.start = np.asarray(start, np.float32)
        self.end = np.asarray(end, np.float32)
        self.axis = int(axis)
        self.resolution = int(resolution)

    def data(self):
        t = np.linspace(0.0, 1.0, self.resolution, dtype=np.float32)
        ramp = self.start[None, :] * (1 - t[:, None]) + self.end[None, :] * t[:, None]
        if ramp.shape[-1] == 3:
            ramp = np.concatenate([ramp, np.ones_like(ramp[..., :1])], -1)
        if self.axis == 0:
            return np.broadcast_to(ramp[None, :, :], (1, self.resolution, 4)).copy()
        return np.broadcast_to(ramp[:, None, :], (self.resolution, 1, 4)).copy()


class CacheableTexture(Texture):
    """Evaluates a Python function f(u, v) -> color on a grid once and
    caches it."""

    def __init__(self, fn, resolution=(256, 256), **kw):
        super().__init__(**kw)
        self.fn = fn
        self.resolution = tuple(resolution)

    def data(self):
        w, h = self.resolution
        u = (np.arange(w, dtype=np.float32) + 0.5) / w
        v = (np.arange(h, dtype=np.float32) + 0.5) / h
        uu, vv = np.meshgrid(u, v)
        return rgba(self.fn(uu, vv))
