"""Per-pixel Welford accumulator (counterpart of
echorenderer_tpu/utils/accumulator.py): online mean/variance, non-finite
sample rejection, Chan's parallel merge of pre-reduced batches, and the
reference's relative noise metric."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Accumulator(NamedTuple):
    mean: torch.Tensor  # (..., C) running mean
    m2: torch.Tensor  # (..., C) sum of squared deviations
    count: torch.Tensor  # (..., 1) number of accepted samples


def create(shape, channels: int = 3, device=None) -> Accumulator:
    shape = tuple(shape)
    z = lambda c: torch.zeros(shape + (c,), dtype=torch.float32, device=device)
    return Accumulator(mean=z(channels), m2=z(channels), count=z(1))


def add(acc: Accumulator, sample: torch.Tensor) -> Accumulator:
    """Add one sample per pixel; non-finite samples are rejected."""
    finite = torch.isfinite(torch.sum(sample, dim=-1, keepdim=True))
    count = acc.count + torch.where(finite, 1.0, 0.0)
    safe_count = torch.clamp(count, min=1.0)
    delta = sample - acc.mean
    mean = acc.mean + torch.where(finite, delta / safe_count, 0.0)
    m2 = acc.m2 + torch.where(finite, delta * (sample - mean), 0.0)
    return Accumulator(mean=mean, m2=m2, count=count)


def add_many(acc: Accumulator, sample_sum, sample_sq_sum, n) -> Accumulator:
    """Merge a batch of n pre-reduced samples (sum and sum of squares)."""
    n = torch.as_tensor(n, dtype=acc.count.dtype, device=acc.count.device)
    n = torch.broadcast_to(n, acc.count.shape)
    nz = n > 0.0
    safe_n = torch.clamp(n, min=1.0)
    batch_mean = sample_sum / safe_n
    batch_m2 = sample_sq_sum - safe_n * batch_mean * batch_mean
    total = acc.count + n
    safe_total = torch.clamp(total, min=1.0)
    delta = batch_mean - acc.mean
    mean = acc.mean + torch.where(nz, delta * (n / safe_total), 0.0)
    m2 = acc.m2 + torch.where(
        nz,
        torch.clamp(batch_m2, min=0.0) + delta * delta * (acc.count * n / safe_total),
        0.0,
    )
    return Accumulator(mean=mean, m2=m2, count=total)


def variance(acc: Accumulator) -> torch.Tensor:
    """Unbiased sample variance (m2 itself when count < 3)."""
    n = acc.count
    return torch.where(n < 3.0, acc.m2, acc.m2 / torch.clamp(n - 1.0, min=1.0))


def noise(acc: Accumulator) -> torch.Tensor:
    """Relative remaining noise per channel:
    sqrt(m2 / ((count-1)^3 * mean^2)), zero where mean is zero or count < 2."""
    n = acc.count
    one_less = torch.clamp(n - 1.0, min=1.0)
    numerator = acc.mean * acc.mean * (one_less**3)
    ratio = numerator / torch.clamp(acc.m2, min=1e-38)
    result = torch.rsqrt(torch.clamp(ratio, min=1e-38))
    result = torch.where(numerator > 0.0, result, 0.0)
    return torch.where(n < 2.0, 0.0, result)


def max_noise(acc: Accumulator) -> torch.Tensor:
    """Max relative noise across channels (adaptive-termination signal)."""
    return torch.amax(noise(acc), dim=-1)
