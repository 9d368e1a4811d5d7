"""Learned denoiser (counterpart of echorenderer_tpu/processes/denoise.py):
a kernel-predicting CNN in the reference's OIDN slot
(Processes/Composition/OidnDenoise.cs:17-230 wraps Intel Open Image Denoise).

Architecture (KPCN-lite, after Bako et al. 2017 "Kernel-Predicting
Convolutional Networks for Denoising Monte Carlo Renderings"): the network
sees the albedo-demodulated noisy color plus the albedo and shading-normal
AOVs and predicts a per-pixel 5x5 softmax kernel; the kernel filters the
demodulated color, and the albedo remodulates the result.

Convolutions are 3x3 with increasing dilation (1,1,2,4,1), zero padding
("SAME"), ~40k parameters. The weights are the JAX package's, committed
byte for byte at echorenderer_tpu_torch/data/denoiser.npz in HWIO layout;
the convolutions run in NCHW with OIHW weights. On the card they run in
float32 (`float32_convs`): cuDNN would otherwise compute them in TF32
(torch's default for convolutions), about 1e-3 off the float32 reference.
A trainer (echorenderer_tpu_torch/tools/train_denoiser.py) runs its
backward pass under the same block, so its gradients are float32 too.
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import diagnostics

KERNEL = 5  # predicted filter size (5x5 softmax weights per pixel)
WIDTH = 32  # conv channels
DILATIONS = (1, 1, 2, 4, 1)
_EPS = 1e-3

WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data",
    "denoiser.npz",
)

# cudnn.flags sets process-wide flags for its block and restores the values
# it found on exit: two denoises overlapping in threads (the scheduler's and
# the caller's) could otherwise run in TF32 or leave the flags changed. An
# RLock, since a training step holds it around `apply` and its backward pass
_CUDNN_FLAGS_LOCK = threading.RLock()


@contextlib.contextmanager
def float32_convs():
    """Float32, deterministic cuDNN convolutions for the block, forward and
    backward, under the module's lock; safe to nest (the inner block sets
    the same flags and restores them to the outer block's)."""
    with _CUDNN_FLAGS_LOCK, torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        yield


def init_params(generator: torch.Generator, device=None) -> dict:
    """He-initialized parameters (HWIO weights), drawn from `generator`."""
    sizes = []
    c_in = 9  # demodulated color (3) + albedo (3) + normal (3)
    for i, _d in enumerate(DILATIONS):
        c_out = KERNEL * KERNEL if i == len(DILATIONS) - 1 else WIDTH
        sizes.append((c_in, c_out))
        c_in = c_out
    params = {}
    for i, (ci, co) in enumerate(sizes):
        w = torch.randn((3, 3, ci, co), generator=generator, dtype=torch.float32)
        params[f"w{i}"] = (w * float(np.sqrt(2.0 / (9 * ci)))).to(device)
        params[f"b{i}"] = torch.zeros((co,), dtype=torch.float32, device=device)
    return params


def _conv(x, w, b, dilation):
    """3x3 "SAME" convolution of an NCHW tensor by HWIO weights, then the
    bias, as lax.conv_general_dilated + b (no kernel flip)."""
    out = F.conv2d(x, w.permute(3, 2, 0, 1), padding=dilation, dilation=dilation)
    return out + b[:, None, None]


def apply(params: dict, color, albedo, normal):
    """Denoise a batch: color/albedo/normal are (N, H, W, 3) linear float32.
    Returns the filtered color (N, H, W, 3)."""
    demod = color / (albedo + _EPS)
    # log compression tames HDR fireflies without losing ordering
    feat = torch.cat([torch.log1p(demod), albedo, normal], dim=-1)
    x = feat.permute(0, 3, 1, 2)
    # float32 convolutions on the card, for this block only (the flags are
    # restored on exit, under a lock); deterministic algorithms, so a frame
    # composes to the same bits
    with float32_convs():
        for i, d in enumerate(DILATIONS):
            x = _conv(x, params[f"w{i}"], params[f"b{i}"], d)
            if i < len(DILATIONS) - 1:
                x = torch.relu(x)
    weights = torch.softmax(x, dim=1).permute(0, 2, 3, 1)  # (N, H, W, K*K)

    # the 5x5 neighborhood of the demodulated color under the predicted
    # kernel, as a shifted sum in the JAX package's (dy, dx) order
    r = KERNEL // 2
    pad = F.pad(demod.permute(0, 3, 1, 2), (r, r, r, r), mode="replicate").permute(0, 2, 3, 1)
    h, w = color.shape[1], color.shape[2]
    out = torch.zeros_like(demod)
    for dy in range(KERNEL):
        for dx in range(KERNEL):
            k = weights[..., dy * KERNEL + dx : dy * KERNEL + dx + 1]
            out = out + k * pad[:, dy : dy + h, dx : dx + w, :]
    return out * (albedo + _EPS)


def load_params(device=None) -> dict | None:
    """Committed weights on `device`, or None when absent (callers fall
    back to the cross-bilateral filter); one `echo.denoise.load_params`
    span."""
    with diagnostics.span("echo.denoise.load_params"):
        if not os.path.exists(WEIGHTS_PATH):
            return None
        with np.load(WEIGHTS_PATH) as data:
            return {k: torch.as_tensor(data[k], device=device) for k in data.files}


def denoise(color, albedo, normal, params: dict | None = None, device="cuda"):
    """Single-image entry point: (H, W, 3) arrays or tensors in, (H, W, 3)
    tensor out, on the color's device. Arrays are uploaded to `device` (the
    card unless the caller asks for the CPU); tensors stay where they are."""
    color, albedo, normal = (a if isinstance(a, torch.Tensor) else torch.as_tensor(a, device=device)
                             for a in (color, albedo, normal))
    if params is None:
        params = load_params(device=color.device)
    if params is None:
        raise FileNotFoundError(f"no denoiser weights at {WEIGHTS_PATH}")
    out = apply(params, color[None], albedo[None], normal[None])
    return out[0]
