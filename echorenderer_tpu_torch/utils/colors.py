"""Color math on (..., 3) float32 tensors (counterpart of
echorenderer_tpu/utils/colors.py)."""

from __future__ import annotations

import torch

# radiance weights from reference RGB128
LUMINANCE_WEIGHTS = (0.212671, 0.715160, 0.072169)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(LUMINANCE_WEIGHTS, dtype=torch.float32, device=rgb.device)
    return torch.sum(rgb[..., :3] * w, dim=-1)


def srgb_encode(linear: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB gamma."""
    l = torch.clamp(linear, 0.0, 1.0)
    return torch.where(l <= 0.0031308, 12.92 * l, 1.055 * torch.pow(l, 1.0 / 2.4) - 0.055)


def srgb_decode(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB gamma -> linear."""
    s = torch.clamp(srgb, 0.0, 1.0)
    return torch.where(s <= 0.04045, s / 12.92, torch.pow((s + 0.055) / 1.055, 2.4))
