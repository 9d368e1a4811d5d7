"""The composition stack of the README's standard profile, in plain
PyTorch: a frozen copy of the operators of
echorenderer_tpu_torch/processes/composition.py and processes/denoise.py
that `standard_path_traced_profile` stacks (LearnedDenoise, AutoExposure,
Bloom, ToneMapper with the ACES curve, Vignette, Watermark), at their
defaults, op for op. The denoiser's weights are read from the port's
committed file, an input both sides read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS = Path(__file__).resolve().parents[2] / "echorenderer_tpu_torch" / "data" / "denoiser.npz"
_LUM = (0.212671, 0.715160, 0.072169)
_DILATIONS = (1, 1, 2, 4, 1)
_KERNEL = 5
_EPS = 1e-3


def _luminance(rgb):
    w = torch.tensor(_LUM, dtype=torch.float32).to(rgb.device, rgb.dtype)
    x = rgb[..., :3] * w
    return x[..., 0] + x[..., 1] + x[..., 2]


def _gaussian_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(image, sigma: float):
    """Separable, edge-clamped Gaussian blur, taps summed in order."""
    k = _gaussian_kernel(sigma)
    r = (k.shape[0] - 1) // 2

    def axis(img, ax):
        n = img.shape[ax]
        edge = torch.clamp(torch.arange(-r, n + r, device=img.device), 0, n - 1)
        padded = torch.index_select(img, ax, edge)
        out = torch.zeros_like(img)
        for i in range(k.shape[0]):
            out = out + float(k[i]) * padded.narrow(ax, i, n)
        return out

    return axis(axis(image, 0), 1)


def _inclusive_sum(x):
    shift = 1
    while shift < x.shape[0]:
        x = torch.cat([x[:shift], x[shift:] + x[:-shift]])
        shift *= 2
    return x


def denoise(color, albedo, normal):
    """The kernel-predicting CNN: (H, W, 3) each; float32 convolutions."""
    with np.load(WEIGHTS) as data:
        p = {k: torch.as_tensor(data[k], device=color.device).to(color.dtype)
             for k in data.files}
    demod = color / (albedo + _EPS)
    x = torch.cat([torch.log1p(demod), albedo, normal], dim=-1)[None].permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for i, d in enumerate(_DILATIONS):
            x = F.conv2d(x, p[f"w{i}"].permute(3, 2, 0, 1), padding=d, dilation=d)
            x = x + p[f"b{i}"][:, None, None]
            if i < len(_DILATIONS) - 1:
                x = torch.relu(x)
    weights = torch.softmax(x, dim=1).permute(0, 2, 3, 1)[0]
    r = _KERNEL // 2
    pad = F.pad(demod[None].permute(0, 3, 1, 2), (r, r, r, r), mode="replicate")
    pad = pad.permute(0, 2, 3, 1)[0]
    h, w = color.shape[0], color.shape[1]
    out = torch.zeros_like(demod)
    for dy in range(_KERNEL):
        for dx in range(_KERNEL):
            k = weights[..., dy * _KERNEL + dx: dy * _KERNEL + dx + 1]
            out = out + k * pad[dy: dy + h, dx: dx + w, :]
    return out * (albedo + _EPS)


def auto_exposure(img):
    h, w = img.shape[0], img.shape[1]
    dt = img.dtype
    log_lum = torch.log2(torch.clamp(_luminance(img), min=1e-6))
    v = (torch.arange(h, dtype=dt, device=img.device) + 0.5) / h - 0.5
    u = (torch.arange(w, dtype=dt, device=img.device) + 0.5) / w - 0.5
    s = torch.clamp(torch.sqrt(u[None, :] ** 2 + v[:, None] ** 2) * 2.0, 0.0, 1.0)
    sig = 3.0 * s * s - 2.0 * s * s * s
    weight = (1.0 - sig * (2.0 - sig)) * 1.0 + 1.0
    ll_s, order = torch.sort(log_lum.reshape(-1), stable=True)
    ww_s = torch.broadcast_to(weight, log_lum.shape).reshape(-1)[order]
    cum = _inclusive_sum(ww_s)
    total = cum[-1]
    kept = torch.clamp(torch.minimum(cum, (1.0 - 0.03) * total)
                       - torch.maximum(cum - ww_s, 0.55 * total), min=0.0)
    avg_log = torch.sum(kept * ll_s) / torch.clamp(torch.sum(kept), min=1e-20)
    scale = torch.clamp(0.45 / torch.clamp(torch.exp2(avg_log), min=1e-8), 0.03125, 32.0)
    return img * scale


def bloom(img):
    lum = _luminance(img)[..., None]
    bright = torch.where(lum > 0.95, torch.clamp(img - 0.95, min=0.0), 0.0)
    return img + _blur(bright, 0.01 * img.shape[1]) * 0.88


def tone_map(img):
    img = img[..., :3] * 1.0
    lum = _luminance(img)
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    mapped = torch.clamp((lum * (a * lum + b)) / (lum * (c * lum + d) + e), 0.0, 1.0)
    return torch.clamp(img * (mapped / torch.clamp(lum, min=1e-8))[..., None], 0.0, 1.0)


def vignette(img):
    h, w = img.shape[0], img.shape[1]
    dt = img.dtype
    y = (torch.arange(h, dtype=dt, device=img.device) + 0.5) / h - 0.5
    x = (torch.arange(w, dtype=dt, device=img.device) + 0.5) / w - 0.5
    dist = torch.sqrt(x[None, :] ** 2 + y[:, None] ** 2) * float(np.sqrt(np.float32(2.0)))
    s = torch.clamp(dist, 0.0, 1.0)
    sig = 3.0 * s * s - 2.0 * s * s * s
    return img * (1.0 - sig * 0.25)[..., None]


_GLYPHS = {
    "e": [0b00000, 0b00000, 0b01110, 0b10001, 0b11111, 0b10000, 0b01110],
    "c": [0b00000, 0b00000, 0b01110, 0b10000, 0b10000, 0b10001, 0b01110],
    "h": [0b10000, 0b10000, 0b10110, 0b11001, 0b10001, 0b10001, 0b10001],
    "o": [0b00000, 0b00000, 0b01110, 0b10001, 0b10001, 0b10001, 0b01110],
    "r": [0b00000, 0b00000, 0b10110, 0b11001, 0b10000, 0b10000, 0b10000],
    "n": [0b00000, 0b00000, 0b10110, 0b11001, 0b10001, 0b10001, 0b10001],
    "d": [0b00001, 0b00001, 0b01101, 0b10011, 0b10001, 0b10011, 0b01101],
    "t": [0b01000, 0b01000, 0b11100, 0b01000, 0b01000, 0b01001, 0b00110],
    "p": [0b00000, 0b10110, 0b11001, 0b11001, 0b10110, 0b10000, 0b10000],
    "u": [0b00000, 0b00000, 0b10001, 0b10001, 0b10001, 0b10011, 0b01101],
    "-": [0b00000, 0b00000, 0b00000, 0b11111, 0b00000, 0b00000, 0b00000],
}


def _text_mask(text: str, scale: int) -> np.ndarray:
    """The 5x7 bitmap font's mask of `text`, rows flipped (row 0 at the
    bottom of a y-up image)."""
    mask = np.zeros((7, len(text) * 6 - 1), np.float32)
    for i, ch in enumerate(text):
        for y, bits in enumerate(_GLYPHS[ch]):
            for x in range(5):
                mask[y, i * 6 + x] = (bits >> (4 - x)) & 1
    return np.kron(mask, np.ones((scale, scale), np.float32))[::-1].copy()


def watermark(img, text="echorenderer-tpu", scale=2, margin=8, opacity=0.7):
    h, w = img.shape[0], img.shape[1]
    mask = torch.as_tensor(_text_mask(text, scale), device=img.device).to(img.dtype)
    th, tw = mask.shape
    if th + 2 * margin > h or tw + 2 * margin > w:
        return img
    y0, x0 = margin, w - tw - margin
    full = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    full[y0:y0 + th, x0:x0 + tw] = mask
    region = torch.zeros_like(full)
    half = margin // 2
    ys, xs = min(max(y0 - half, 0), h - th - 2 * half), min(max(x0 - half, 0), w - tw - 2 * half)
    region[ys:ys + th + 2 * half, xs:xs + tw + 2 * half] = 1.0
    blurred = _blur(img, 2.0)
    img = img * (1 - region[..., None]) + (blurred * 0.7 + 0.08) * region[..., None]
    tint = torch.where(_luminance(blurred) > 0.5, 0.0, 1.0).to(img.dtype)[..., None]
    return img * (1.0 - full[..., None] * opacity) + tint * full[..., None] * opacity


def standard_stack(main, albedo, normal_depth):
    """The standard profile's composed main layer from its three layers."""
    img = denoise(main, albedo[..., :3], normal_depth[..., :3])
    for op in (auto_exposure, bloom, tone_map, vignette, watermark):
        img = op(img)
    return img
