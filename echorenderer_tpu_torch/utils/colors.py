"""Color math on (..., 3) float32 tensors (counterpart of
echorenderer_tpu/utils/colors.py), and the color-literal parser of the
.echo loader in numpy."""

from __future__ import annotations

import re

import numpy as np
import torch

from . import vec

# radiance weights from reference RGB128
LUMINANCE_WEIGHTS = (0.212671, 0.715160, 0.072169)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(LUMINANCE_WEIGHTS, dtype=torch.float32, device=rgb.device)
    return vec.dot(rgb[..., :3], w)


def srgb_encode(linear: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB gamma."""
    l = torch.clamp(linear, 0.0, 1.0)
    return torch.where(l <= 0.0031308, 12.92 * l, 1.055 * torch.pow(l, 1.0 / 2.4) - 0.055)


def srgb_decode(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB gamma -> linear."""
    s = torch.clamp(srgb, 0.0, 1.0)
    return torch.where(s <= 0.04045, s / 12.92, torch.pow((s + 0.055) / 1.055, 2.4))


# prefixes per the reference parser: 0x, # (doubled # tolerated), or bare
_HEX_RE = re.compile(r"^(?:0[xX]|##?)?([0-9a-fA-F]{1,8})$")


def parse_color(text: str) -> np.ndarray:
    """Parse a color literal into linear RGBA float32.

    Supports the reference RGBA128 parser forms (Textures/Colors/RGBA128.Parser.cs):
    hex (`#FF00FF`, `#F0F`, with optional alpha), `rgb(r, g, b[, a])` with
    0-255 components, and `hdr(r, g, b[, a])` with raw float components.
    """
    text = text.strip()
    m = _HEX_RE.match(text)
    if m:
        h = m.group(1)
        # reference hex forms (RGBA128.Parser.cs ParseHex): 1 = gray nibble,
        # 3/4 = rgb(a) nibbles, 6/8 = rgb(a) bytes
        if len(h) == 1:
            h = h * 6
        elif len(h) in (3, 4):
            h = "".join(c * 2 for c in h)
        if len(h) == 6:
            h += "FF"
        if len(h) != 8:
            raise ValueError(f"bad hex color {text!r}")
        vals = np.array([int(h[i : i + 2], 16) / 255.0 for i in range(0, 8, 2)])
        rgb = _srgb_decode_np(vals[:3])
        return np.append(rgb, vals[3]).astype(np.float32)

    for prefix, scale, gamma in (("rgb", 255.0, True), ("hdr", 1.0, False)):
        if text.lower().startswith(prefix):
            inner = text[len(prefix) :].strip()
            if inner.startswith("(") and inner.endswith(")"):
                inner = inner[1:-1]
            parts = [float(p) for p in inner.replace(",", " ").split()]
            if len(parts) == 1:
                parts = parts * 3
            if len(parts) == 3:
                parts.append(scale if gamma else 1.0)
            vals = np.array(parts, dtype=np.float64) / scale
            if gamma:
                vals[:3] = _srgb_decode_np(vals[:3])
            return vals.astype(np.float32)

    raise ValueError(f"unrecognized color literal {text!r}")


def _srgb_decode_np(s: np.ndarray) -> np.ndarray:
    s = np.clip(s, 0.0, 1.0)
    return np.where(s <= 0.04045, s / 12.92, ((s + 0.055) / 1.055) ** 2.4)
