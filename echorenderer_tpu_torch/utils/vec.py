"""Vector math on trailing-axis-3 float32 tensors (counterpart of
echorenderer_tpu/utils/vec.py).

Sums over the three components are written out left to right, x + y + z,
and products are never fused: a reduction or a cross-product kernel on the
card may sum in another order or contract into fused multiply-adds, and the
CUDA kernels of the port (built with -fmad=false) round exactly as this
code does only when the order is fixed.
"""

from __future__ import annotations

import torch


def component_sum(a: torch.Tensor) -> torch.Tensor:
    """x + y + z over the trailing axis, in that order."""
    return a[..., 0] + a[..., 1] + a[..., 2]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, keepdims dropped."""
    return component_sum(a * b)


def length_squared(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis (broadcasting)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def rotate(v: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """v @ rot.T for a (3, 3) matrix: row k of rot dotted with v."""
    return torch.stack([dot(v, rot[k]) for k in range(3)], dim=-1)


def affine(v: torch.Tensor, m: torch.Tensor, offset: torch.Tensor | None = None) -> torch.Tensor:
    """Per-lane (..., 3, 3) matrices m applied to v (..., 3): row k of m
    dotted with v, summed left to right, then + offset[..., k] when given."""
    rows = [dot(v, m[..., k, :]) for k in range(3)]
    if offset is not None:
        rows = [r + offset[..., k] for k, r in enumerate(rows)]
    return torch.stack(rows, dim=-1)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Normalize over the trailing axis; zero vectors map to zero."""
    sq = length_squared(a)[..., None]
    inv = torch.where(sq > 0.0, torch.rsqrt(torch.clamp(sq, min=1e-38)), 0.0)
    return a * inv


def orthonormal_frame(normal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Right-handed basis (tangent, bitangent) around a unit normal
    (Duff et al. 2017, branchless)."""
    n = normal
    sign = torch.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2:3])
    b = n[..., 0:1] * n[..., 1:2] * a
    tangent = torch.cat(
        [1.0 + sign * n[..., 0:1] ** 2 * a, sign * b, -sign * n[..., 0:1]], dim=-1
    )
    bitangent = torch.cat([b, sign + n[..., 1:2] ** 2 * a, -n[..., 1:2]], dim=-1)
    return tangent, bitangent


def to_local(v, tangent, bitangent, normal) -> torch.Tensor:
    """World -> local shading frame (z = normal)."""
    return torch.stack([dot(v, tangent), dot(v, bitangent), dot(v, normal)], dim=-1)


def to_world(v, tangent, bitangent, normal) -> torch.Tensor:
    """Local shading frame -> world."""
    return v[..., 0:1] * tangent + v[..., 1:2] * bitangent + v[..., 2:3] * normal
