"""Vector math on trailing-axis-3 float32 tensors (counterpart of
echorenderer_tpu/utils/vec.py)."""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis, keepdims dropped."""
    return torch.sum(a * b, dim=-1)


def length_squared(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * a, dim=-1)


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Normalize over the trailing axis; zero vectors map to zero."""
    sq = torch.sum(a * a, dim=-1, keepdim=True)
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
