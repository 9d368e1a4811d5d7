"""Counter-based sample streams and sample mappings: a frozen copy of
echorenderer_tpu_torch/utils/rng.py (the JAX package's R2 lattice with an
Owen index shuffle and value scramble). Every draw is a pure hash of
(seed, pixel, sample, dimension), so the reference draws what the port
draws for the same sample of the same pixel. 32-bit words travel as int64
tensors holding values in [0, 2**32)."""

from __future__ import annotations

import math

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_ALPHA_1D = int(np.uint32(round(0.6180339887498949 * 2**32)))
_ALPHA_2X = int(np.uint32(round(0.7548776662466927 * 2**32)))
_ALPHA_2Y = int(np.uint32(round(0.5698402909980532 * 2**32) & 0xFFFFFFFF))


def _mul(a, b):
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _mix(x):
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _hash(*parts):
    h = None
    for p in parts:
        h_mul = 0x9E3779B9 * 0x85EBCA6B & MASK32 if h is None else _mul(h, 0x85EBCA6B)
        h = _mix((p + h_mul) & MASK32)
    return h


def _uniform(bits):
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _bit_reverse(x):
    x = ((x << 16) | (x >> 16)) & MASK32
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    return x


def _owen(bits, key):
    x = _bit_reverse(bits)
    x = x ^ _mul(x, 0x3D20ADEA)
    x = (x + key) & MASK32
    x = _mul(x, (key >> 16) | 1)
    x = x ^ _mul(x, 0x05526C56)
    x = x ^ _mul(x, 0x53A22864)
    return _bit_reverse(x)


class Stream:
    """Per-lane (seed, pixel, sample) words, int64 tensors of one shape;
    draws come out in `dtype`."""

    def __init__(self, seed, pixel, sample, dtype=torch.float32):
        self.seed, self.pixel, self.sample, self.dtype = seed, pixel, sample, dtype

    def _keys(self, dim: int):
        ks = _hash(self.seed, self.pixel, _mul(torch.full_like(self.pixel, dim & MASK32), 4))
        return ks, _mix(ks ^ 0xA511E9B3), _mix(ks ^ 0x63D83595)

    def next_1d(self, dim: int):
        ks, kv, _ = self._keys(dim)
        idx = _owen(self.sample, ks)
        return _uniform(_owen(_mul(idx, _ALPHA_1D), kv)).to(self.dtype)

    def next_2d(self, dim: int):
        ks, kx, ky = self._keys(dim)
        idx = _owen(self.sample, ks)
        ux = _uniform(_owen(_mul(idx, _ALPHA_2X), kx))
        uy = _uniform(_owen(_mul(idx, _ALPHA_2Y), ky))
        return torch.stack([ux, uy], dim=-1).to(self.dtype)


def uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def concentric_disk(u):
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    r_big = torch.abs(ox) > torch.abs(oy)
    r = torch.where(r_big, ox, oy)
    one = torch.ones_like(ox)
    ratio = torch.where(
        r_big,
        torch.where(ox != 0.0, oy / torch.where(ox == 0.0, one, ox), 0.0),
        torch.where(oy != 0.0, ox / torch.where(oy == 0.0, one, oy), 0.0),
    )
    theta = torch.where(r_big, (math.pi / 4.0) * ratio, (math.pi / 2.0) - (math.pi / 4.0) * ratio)
    zero = (ox == 0.0) & (oy == 0.0)
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return torch.stack([x, y], dim=-1)


def cosine_hemisphere(u):
    d = concentric_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def uniform_triangle(u):
    s = torch.sqrt(torch.clamp(u[..., 0], min=0.0))
    return torch.stack([1.0 - s, u[..., 1] * s], dim=-1)
