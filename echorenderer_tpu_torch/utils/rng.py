"""Deterministic counter-based random sampling (counterpart of
echorenderer_tpu/utils/rng.py).

Every random value is a pure hash of (seed, pixel_id, sample_id, dim): the
same R2 lattice, per-(pixel, dim) Owen index shuffle and value scramble as
the JAX package, bit for bit, so any lane on any device regenerates the
same draws.

PyTorch has no usable uint32 arithmetic on every device (the CPU build
lacks `>>`, `<<` and `+` for it), so 32-bit words travel as int64 tensors
holding values in [0, 2**32). Every shift, add and multiply masks back to
32 bits; the multiply splits one operand into 16-bit halves so no
intermediate product leaves the int64 range (no signed overflow).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF

# R2 additive recurrence constants (Roberts 2018) in 32-bit fixed point
_ALPHA_1D = int(np.uint32(round(0.6180339887498949 * 2**32)))
_ALPHA_2X = int(np.uint32(round(0.7548776662466927 * 2**32)))
_ALPHA_2Y = int(np.uint32(round(0.5698402909980532 * 2**32) & 0xFFFFFFFF))


def as_u32(x, device=None) -> torch.Tensor:
    """Any int tensor/array/python int -> int64 tensor of 32-bit words."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.as_tensor(np.asarray(x, np.int64) & MASK32, device=device)


def _mul(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for 32-bit words a, b (int64 tensors or ints)."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """Strong 32-bit finalizer (lowbias32-style avalanche)."""
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_u32(*parts, device=None) -> torch.Tensor:
    """Combine any number of 32-bit words (tensors or ints) into one."""
    h = None
    for p in parts:
        p = as_u32(p, device)
        h_mul = 0x9E3779B9 * 0x85EBCA6B & MASK32 if h is None else _mul(h, 0x85EBCA6B)
        h = _mix((p + h_mul) & MASK32)
    return h


def u32_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """32-bit word -> float32 in [0, 1) from its top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _bit_reverse(x: torch.Tensor) -> torch.Tensor:
    x = ((x << 16) | (x >> 16)) & MASK32
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    return x


def owen_scramble(bits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Hash-based nested uniform (Owen) scramble of a [0,1) value's bits
    (Laine-Karras hash as tuned by Burley 2020)."""
    x = _bit_reverse(bits)
    x = x ^ _mul(x, 0x3D20ADEA)
    x = (x + key) & MASK32
    x = _mul(x, (key >> 16) | 1)
    x = x ^ _mul(x, 0x05526C56)
    x = x ^ _mul(x, 0x53A22864)
    return _bit_reverse(x)


class SampleStream(NamedTuple):
    """Per-lane deterministic sample stream identity, as 32-bit words.

    pixel_id: (N,) flat pixel index (stable across devices)
    sample_id: () or (N,) sample (path) index within the pixel
    seed: () render-wide seed
    """

    pixel_id: torch.Tensor
    sample_id: torch.Tensor
    seed: torch.Tensor

    def _keys(self, dim):
        dev = self.pixel_id.device
        d = as_u32(dim, dev)
        ks = hash_u32(self.seed, self.pixel_id, _mul(d, 4), device=dev)
        return ks, _mix(ks ^ 0xA511E9B3), _mix(ks ^ 0x63D83595)

    def next_1d(self, dim) -> torch.Tensor:
        """Stratified 1D sample in [0, 1); `dim` may be an int or a per-lane
        int tensor (a bounce-depth-derived dimension)."""
        ks, kv, _ = self._keys(dim)
        idx = owen_scramble(as_u32(self.sample_id), ks)  # index shuffle
        return u32_to_uniform(owen_scramble(_mul(idx, _ALPHA_1D), kv))

    def next_2d_parts(self, dim) -> tuple[torch.Tensor, torch.Tensor]:
        ks, kx, ky = self._keys(dim)
        idx = owen_scramble(as_u32(self.sample_id), ks)
        ux = u32_to_uniform(owen_scramble(_mul(idx, _ALPHA_2X), kx))
        uy = u32_to_uniform(owen_scramble(_mul(idx, _ALPHA_2Y), ky))
        return ux, uy

    def next_2d(self, dim) -> torch.Tensor:
        """Stratified 2D sample in [0, 1)^2 (shared index shuffle,
        independent output scrambles)."""
        ux, uy = self.next_2d_parts(dim)
        return torch.stack([ux, uy], dim=-1)

    def white_1d(self, dim) -> torch.Tensor:
        """Pure-hash (white noise) 1D sample."""
        return u32_to_uniform(
            hash_u32(self.seed, self.pixel_id, self.sample_id, dim,
                     device=self.pixel_id.device)
        )

    def white_2d(self, dim) -> torch.Tensor:
        dev = self.pixel_id.device
        bits0 = hash_u32(self.seed, self.pixel_id, self.sample_id, dim, 0, device=dev)
        bits1 = hash_u32(self.seed, self.pixel_id, self.sample_id, dim, 1, device=dev)
        return torch.stack([u32_to_uniform(bits0), u32_to_uniform(bits1)], dim=-1)


# --- sample mappings ---


def uniform_sphere(u: torch.Tensor) -> torch.Tensor:
    """[0,1)^2 -> uniform direction on the unit sphere."""
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def uniform_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """[0,1)^2 -> uniform direction on the +z hemisphere."""
    z = u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = (2.0 * math.pi) * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def concentric_disk(u: torch.Tensor) -> torch.Tensor:
    """[0,1)^2 -> concentric mapping to the unit disk (Shirley-Chiu)."""
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
    theta = torch.where(
        r_big, (math.pi / 4.0) * ratio, (math.pi / 2.0) - (math.pi / 4.0) * ratio
    )
    zero = (ox == 0.0) & (oy == 0.0)
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return torch.stack([x, y], dim=-1)


def cosine_hemisphere(u: torch.Tensor) -> torch.Tensor:
    """[0,1)^2 -> cosine-weighted direction on the +z hemisphere."""
    d = concentric_disk(u)
    z = torch.sqrt(torch.clamp(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2, min=0.0))
    return torch.cat([d, z[..., None]], dim=-1)


def uniform_triangle(u: torch.Tensor) -> torch.Tensor:
    """[0,1)^2 -> uniform barycentric (b0, b1) on a triangle (sqrt warp)."""
    s = torch.sqrt(torch.clamp(u[..., 0], min=0.0))
    return torch.stack([1.0 - s, u[..., 1] * s], dim=-1)
