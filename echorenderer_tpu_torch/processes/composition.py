"""Compositing stack (counterpart of echorenderer_tpu/processes/composition.py):
post-process operators over named AOV layers.

Each operator is a dataclass whose `.apply(layers)` maps a dict of (H, W, C)
float32 tensors to the same dict, computing on the layers' own device.
`compose` runs a stack of them op by op; an operator whose `validate` or
`apply` raises is recorded under its class name and skipped, which is
what the JAX package's jitted stack gives after its op-by-op fallback.

Operators (reference file in parens):
  TextureManage  copy/clear layers              (TextureManage.cs)
  AutoExposure   log-average luminance exposure (AutoExposure.cs)
  Bloom          threshold + Gaussian blur add  (Bloom.cs)
  ToneMapper     saturation/exposure + curve:
                 pass_through/basic_shoulder/reinhard/aces/hable
                                                (ToneMapper.cs:10-197)
  Vignette       radial darkening + film grain  (Vignette.cs)
  Watermark      blurred backdrop + bitmap text (Watermark.cs, InOut/Font.cs)
  BilateralDenoise, LearnedDenoise  the denoiser slot (OidnDenoise.cs)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..utils import colors

F32 = torch.float32


# ----------------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------------


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W, C) image (the reference's
    ICompositeContext.GaussianBlurAsync helper). Edge-clamped; the taps
    are summed in kernel order, as the JAX package sums them."""
    if sigma <= 0.0:
        return image
    k = gaussian_kernel1d(sigma)
    r = (k.shape[0] - 1) // 2

    def conv_axis(img, axis):
        n = img.shape[axis]
        edge = torch.clamp(torch.arange(-r, n + r, device=img.device), 0, n - 1)
        padded = torch.index_select(img, axis, edge)
        out = torch.zeros_like(img)
        for i in range(k.shape[0]):
            out = out + float(k[i]) * padded.narrow(axis, i, n)
        return out

    return conv_axis(conv_axis(image, 0), 1)


def _inclusive_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums of a 1-D tensor by doubling steps (Hillis and
    Steele): elementwise adds in a fixed order, so every device gives the
    same bits on every call. torch.cumsum of a CUDA float vector runs a
    scan whose grouping of tiles varies from call to call."""
    shift = 1
    while shift < x.shape[0]:
        x = torch.cat([x[:shift], x[shift:] + x[:-shift]])
        shift *= 2
    return x


def _f32_exp(x: float) -> float:
    """exp of a host scalar in float32, as jnp.exp of a Python float."""
    return float(np.exp(np.float32(x)))


def _update_slice(operand: torch.Tensor, update: torch.Tensor, start) -> torch.Tensor:
    """`lax.dynamic_update_slice`: a negative start counts from the end,
    then the starts are clamped so that the update lies inside the operand."""
    if any(u > o for u, o in zip(update.shape, operand.shape)):
        raise ValueError(f"update {tuple(update.shape)} larger than operand "
                         f"{tuple(operand.shape)}")
    starts = [min(max(s + o if s < 0 else s, 0), o - u)
              for s, u, o in zip(map(int, start), update.shape, operand.shape)]
    out = operand.clone()
    out[tuple(slice(s, s + u) for s, u in zip(starts, update.shape))] = update
    return out


# ----------------------------------------------------------------------------
# operators: each is a dataclass with .apply(layers: dict) -> dict
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class TextureManage:
    """Copy or clear named layers (reference TextureManage.cs)."""

    copy_from: str | None = None
    copy_to: str | None = None
    clear: str | None = None
    clear_color: tuple = (0.0, 0.0, 0.0)

    def apply(self, layers):
        if self.copy_from is not None and self.copy_to is not None:
            layers[self.copy_to] = layers[self.copy_from]
        if self.clear is not None and self.clear in layers:
            target = layers[self.clear]
            c = torch.tensor(self.clear_color, dtype=F32, device=target.device)
            layers[self.clear] = torch.broadcast_to(c, target.shape).contiguous()
        return layers


@dataclasses.dataclass
class AutoExposure:
    """Center-weighted percentile-trimmed log-luminance exposure
    (reference AutoExposure.cs:52-120): each pixel's log luminance is
    weighted by (1 - EaseOutSmooth(2*dist_from_center)) * center_weight + 1,
    the weighted distribution is trimmed to the
    [percent_lower, 1 - percent_upper] mass band (one stable key-value
    sort + prefix sums, the un-quantized form of the reference's 128-bin
    histogram), and exposure maps the trimmed average to
    `average_luminance`."""

    layer: str = "main"
    center_weight: float = 1.0
    percent_lower: float = 0.55
    percent_upper: float = 0.03
    average_luminance: float = 0.45
    clamp: tuple = (0.03125, 32.0)

    def apply(self, layers):
        img = layers[self.layer]
        h, w = img.shape[0], img.shape[1]
        lum = colors.luminance(img)
        log_lum = torch.log2(torch.clamp(lum, min=1e-6))
        # center weight map (reference MainPass: uv distance from center *2)
        v = (torch.arange(h, dtype=F32, device=img.device) + 0.5) / h - 0.5
        u = (torch.arange(w, dtype=F32, device=img.device) + 0.5) / w - 0.5
        dist = torch.sqrt(u[None, :] ** 2 + v[:, None] ** 2) * 2.0
        s = torch.clamp(dist, 0.0, 1.0)
        sig = 3.0 * s * s - 2.0 * s * s * s  # Curves.Sigmoid
        ease_out = sig * (2.0 - sig)  # Curves.EaseOut(Sigmoid)
        weight = (1.0 - ease_out) * self.center_weight + 1.0
        # weighted percentile trim: a stable sort keeps tied log luminances
        # in pixel order, as lax.sort's key-value sort does
        ll = log_lum.reshape(-1)
        ww = torch.broadcast_to(weight, log_lum.shape).reshape(-1)
        ll_s, order = torch.sort(ll, stable=True)
        ww_s = ww[order]
        cum = _inclusive_sum(ww_s)
        total = cum[-1]
        lo = self.percent_lower * total
        hi = (1.0 - self.percent_upper) * total
        # mass of each sample inside [lo, hi] (partial bins clip linearly,
        # matching the histogram's split-to-adjacent-bins behavior)
        kept = torch.minimum(cum, hi) - torch.maximum(cum - ww_s, lo)
        kept = torch.clamp(kept, min=0.0)
        avg_log = torch.sum(kept * ll_s) / torch.clamp(torch.sum(kept), min=1e-20)
        average = torch.exp2(avg_log)
        scale = torch.clamp(self.average_luminance / torch.clamp(average, min=1e-8),
                            *self.clamp)
        layers[self.layer] = img * scale
        return layers


@dataclasses.dataclass
class Bloom:
    """Add a Gaussian-blurred copy of above-threshold highlights
    (reference Bloom.cs:10-40: FilterPass -> blur -> additive merge)."""

    layer: str = "main"
    intensity: float = 0.88
    threshold: float = 0.95
    sigma: float = 0.01  # as a fraction of image width

    def apply(self, layers):
        img = layers[self.layer]
        lum = colors.luminance(img)[..., None]
        excess = torch.clamp(img - self.threshold, min=0.0)
        bright = torch.where(lum > self.threshold, excess, 0.0)
        sigma_px = self.sigma * img.shape[1]
        layers[self.layer] = img + gaussian_blur(bright, sigma_px) * self.intensity
        return layers


def _curve_pass_through(l):
    return l


def _curve_basic_shoulder(l, shoulder=0.5):
    """Linear toe + smooth shoulder rolling off to 1 (reference
    ToneMapper.BasicShoulder)."""
    a = 1.0 - shoulder
    return torch.where(l <= a, l, a + shoulder * torch.tanh((l - a) / max(shoulder, 1e-6)))


def _curve_reinhard(l):
    """Extended Reinhard (reference ToneMapper.Reinhard, :145)."""
    return l / (1.0 + l)


def _curve_aces(l):
    """ACES filmic approximation, Narkowicz 2015 (reference ToneMapper.ACES)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((l * (a * l + b)) / (l * (c * l + d) + e), 0.0, 1.0)


def _curve_hable(l):
    """Uncharted 2 filmic curve, Hable 2010 (reference ToneMapper.Hable)."""
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    W = 11.2

    def f(x):
        return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F

    return f(l) / f(W)


LUMINANCE_CURVES: dict[str, Callable] = {
    "pass_through": _curve_pass_through,
    "basic_shoulder": _curve_basic_shoulder,
    "reinhard": _curve_reinhard,
    "aces": _curve_aces,
    "hable": _curve_hable,
}


@dataclasses.dataclass
class ToneMapper:
    """Exposure/saturation grade + luminance curve applied chroma-
    preservingly (reference ToneMapper.cs: adjusts luminance, rescales RGB)."""

    layer: str = "main"
    curve: str = "aces"
    exposure: float = 1.0
    saturation: float = 1.0

    def apply(self, layers):
        img = layers[self.layer][..., :3] * self.exposure
        lum = colors.luminance(img)
        mapped = LUMINANCE_CURVES[self.curve](lum)
        ratio = (mapped / torch.clamp(lum, min=1e-8))[..., None]
        out = img * ratio
        if self.saturation != 1.0:
            grey = colors.luminance(out)[..., None]
            out = grey + (out - grey) * self.saturation
        layers[self.layer] = torch.clamp(out, 0.0, 1.0)
        return layers


@dataclasses.dataclass
class Vignette:
    """Radial darkening: multiplier = 1 - Sigmoid(dist * sqrt2) * intensity
    where dist is the uv distance from the image center and Sigmoid is the
    reference's clamped smoothstep (Vignette.cs:38, Curves.Sigmoid) — the
    corner distance maps to exactly 1. Optional deterministic film grain
    (off by default, the reference has none)."""

    layer: str = "main"
    intensity: float = 0.25
    grain: float = 0.0

    def apply(self, layers):
        img = layers[self.layer]
        h, w = img.shape[0], img.shape[1]
        dev = img.device
        y = (torch.arange(h, dtype=F32, device=dev) + 0.5) / h - 0.5
        x = (torch.arange(w, dtype=F32, device=dev) + 0.5) / w - 0.5
        dist = torch.sqrt(x[None, :] ** 2 + y[:, None] ** 2) * float(np.sqrt(np.float32(2.0)))
        s = torch.clamp(dist, 0.0, 1.0)
        sig = 3.0 * s * s - 2.0 * s * s * s  # Curves.Sigmoid smoothstep
        falloff = 1.0 - sig * self.intensity
        if self.grain > 0.0:
            from ..utils.rng import hash_u32, u32_to_uniform

            pid = torch.arange(h * w, dtype=torch.int64, device=dev).reshape(h, w)
            noise = u32_to_uniform(hash_u32(pid, 0x5EED)) - 0.5
            falloff = falloff + noise * self.grain * 2.0
        layers[self.layer] = img * falloff[..., None]
        return layers


@dataclasses.dataclass
class Watermark:
    """Stamp text over a blurred, brightness-shifted backdrop in a corner
    (reference Watermark.cs:18 + the bitmap Font glyphs)."""

    layer: str = "main"
    text: str = "echorenderer-tpu"
    scale: int = 2
    margin: int = 8
    opacity: float = 0.7

    def apply(self, layers):
        from ..io.font import render_text_mask

        img = layers[self.layer]
        h, w = img.shape[0], img.shape[1]
        dev = img.device
        mask_np = render_text_mask(self.text, scale=self.scale)
        th, tw = mask_np.shape
        if th + 2 * self.margin > h or tw + 2 * self.margin > w:
            return layers  # frame too small, skip (reference skips quietly)
        y0, x0 = self.margin, w - tw - self.margin  # bottom-right, y-up rows
        zeros = torch.zeros((h, w), dtype=F32, device=dev)
        full = _update_slice(zeros, torch.as_tensor(mask_np, device=dev), (y0, x0))
        backdrop_region = _update_slice(
            zeros,
            torch.ones((th + 2 * self.margin // 2, tw + 2 * self.margin // 2), dtype=F32,
                       device=dev),
            (y0 - self.margin // 2, x0 - self.margin // 2),
        )
        blurred = gaussian_blur(img, 2.0)
        region = backdrop_region[..., None]
        img = img * (1 - region) + (blurred * 0.7 + 0.08) * region
        tint = torch.where(colors.luminance(blurred) > 0.5, 0.0, 1.0)[..., None]
        text_col = tint * full[..., None] * self.opacity
        layers[self.layer] = img * (1.0 - full[..., None] * self.opacity) + text_col
        return layers


@dataclasses.dataclass
class BilateralDenoise:
    """AOV-guided denoiser: cross-bilateral filter over the color layer
    guided by albedo + normal/depth AOVs, in the slot of the reference's
    Intel OIDN binding (OidnDenoise.cs:17). Same layer contract: color +
    albedo + normal_depth in, color out. A neighbour is a roll of the
    image, so the filter wraps around the frame's edges."""

    layer: str = "main"
    albedo_layer: str = "albedo"
    normal_layer: str = "normal_depth"
    radius: int = 4
    sigma_spatial: float = 2.0
    sigma_color: float = 0.35
    sigma_albedo: float = 0.12
    sigma_normal: float = 0.25

    def apply(self, layers):
        img = layers[self.layer]
        albedo = layers.get(self.albedo_layer)
        nd = layers.get(self.normal_layer)
        albedo = albedo[..., :3] if albedo is not None else None
        guide_n = nd[..., :3] if nd is not None else None
        lum = colors.luminance(img)

        acc = torch.zeros_like(img)
        wsum = torch.zeros(img.shape[:2], dtype=F32, device=img.device)
        r = self.radius
        inv2ss = 0.5 / (self.sigma_spatial**2)
        inv2sc = 0.5 / (self.sigma_color**2)
        inv2sa = 0.5 / (self.sigma_albedo**2)
        inv2sn = 0.5 / (self.sigma_normal**2)

        def shift(a, dy, dx):
            return torch.roll(a, (dy, dx), dims=(0, 1))

        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                sample = shift(img, dy, dx)
                # luminance is per pixel: the rolled luminance is the
                # sample's luminance, bit for bit
                dl = shift(lum, dy, dx) - lum
                w = _f32_exp(-(dy * dy + dx * dx) * inv2ss) * torch.exp(-(dl * dl) * inv2sc)
                if albedo is not None:
                    da = torch.sum((shift(albedo, dy, dx) - albedo) ** 2, -1)
                    w = w * torch.exp(-da * inv2sa)
                if guide_n is not None:
                    dn = torch.sum((shift(guide_n, dy, dx) - guide_n) ** 2, -1)
                    w = w * torch.exp(-dn * inv2sn)
                acc = acc + sample * w[..., None]
                wsum = wsum + w
        layers[self.layer] = acc / torch.clamp(wsum, min=1e-8)[..., None]
        return layers


@dataclasses.dataclass
class LearnedDenoise:
    """Kernel-predicting CNN denoiser in the reference's OIDN slot
    (OidnDenoise.cs:17-230; weights committed, see processes/denoise.py).
    Same layer contract as BilateralDenoise: color + albedo + normal_depth
    in, color out. Falls back to the cross-bilateral filter when the AOVs
    or the committed weights are missing."""

    layer: str = "main"
    albedo_layer: str = "albedo"
    normal_layer: str = "normal_depth"

    def apply(self, layers):
        from . import denoise as dn

        img = layers[self.layer]
        albedo = layers.get(self.albedo_layer)
        nd = layers.get(self.normal_layer)
        params = dn.load_params(device=img.device)
        if albedo is None or nd is None or params is None:
            return BilateralDenoise(
                layer=self.layer,
                albedo_layer=self.albedo_layer,
                normal_layer=self.normal_layer,
            ).apply(layers)
        layers[self.layer] = dn.apply(
            params, img[None], albedo[None][..., :3], nd[None][..., :3]
        )[0]
        return layers


# ----------------------------------------------------------------------------
# stack execution
# ----------------------------------------------------------------------------


def compose(layers: dict, operators, device="cuda"):
    """Run the operator stack over the layer dict. Arrays are uploaded to
    `device` (the card unless the caller asks for the CPU); tensors stay on
    their own device, and each operator computes on its layers' device.
    Returns (new_layers, errors) with tensor layers: an operator whose
    `validate` or `apply` raises is recorded under its class name and
    skipped (reference CompositionOperation.cs error capture)."""
    errors = {}
    valid = []
    for op in operators:
        try:  # host-side validation first, as the reference does
            if hasattr(op, "validate"):
                op.validate(layers)
            valid.append(op)
        except Exception as exc:  # noqa: BLE001 — recorded, the stack goes on
            errors[type(op).__name__] = str(exc)
    out = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=device)
           for k, v in layers.items()}
    for op in valid:
        try:
            out = op.apply(dict(out))
        except Exception as exc:  # noqa: BLE001 — recorded, the stack goes on
            errors[type(op).__name__] = str(exc)
    return out, errors


STANDARD_STACK = (
    BilateralDenoise(),
    AutoExposure(),
    Bloom(),
    ToneMapper(curve="aces"),
    Vignette(),
    Watermark(),
)
