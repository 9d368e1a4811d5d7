"""Discrete CDF-inversion distributions (counterpart of
echorenderer_tpu/utils/distributions.py): built on the host with numpy,
sampled with `searchsorted` on the tensors' device. The 2D form
(marginal rows + per-row conditionals) serves equirectangular env maps."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Distribution1D(NamedTuple):
    """cdf[i] = P(X <= i), inclusive; pmf in 'bin mass' units."""

    cdf: torch.Tensor  # (N,)
    pmf: torch.Tensor  # (N,)

    @property
    def size(self) -> int:
        return self.cdf.shape[0]

    def sample(self, u):
        """u in [0,1) -> (index, pmf, remapped u within the bin)."""
        idx = torch.searchsorted(self.cdf, u.contiguous(), right=True)
        idx = torch.clamp(idx, 0, self.size - 1)
        pm = self.pmf[idx]
        lo = torch.where(idx > 0, self.cdf[torch.clamp(idx - 1, min=0)], 0.0)
        remap = torch.clamp(
            (u - lo) / torch.clamp(self.cdf[idx] - lo, min=1e-12), 0.0, 1.0 - 1e-7
        )
        return idx.to(torch.int32), pm, remap

    def pmf_of(self, idx):
        return self.pmf[torch.clamp(idx, 0, self.size - 1)]


def build_1d(weights: np.ndarray, device=None) -> Distribution1D:
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    total = w.sum()
    if total <= 0.0:
        w = np.ones_like(w)
        total = w.sum()
    pmf = w / total
    cdf = np.cumsum(pmf)
    cdf[-1] = 1.0
    return Distribution1D(
        cdf=torch.as_tensor(cdf.astype(np.float32), device=device),
        pmf=torch.as_tensor(pmf.astype(np.float32), device=device),
    )


class Distribution2D(NamedTuple):
    """Row marginal + per-row conditional over an (H, W) weight grid."""

    marginal_cdf: torch.Tensor  # (H,)
    marginal_pmf: torch.Tensor  # (H,)
    conditional_cdf: torch.Tensor  # (H, W)
    conditional_pmf: torch.Tensor  # (H, W)

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.conditional_cdf.shape)

    def sample(self, u2):
        """u2 (..., 2) in [0,1)^2 -> (iy, ix, pmf, (uy, ux) remapped)."""
        h, w = self.shape
        uy, ux = u2[..., 0], u2[..., 1]
        iy = torch.clamp(torch.searchsorted(self.marginal_cdf, uy.contiguous(), right=True), 0, h - 1)
        lo_y = torch.where(iy > 0, self.marginal_cdf[torch.clamp(iy - 1, min=0)], 0.0)
        ry = torch.clamp(
            (uy - lo_y) / torch.clamp(self.marginal_cdf[iy] - lo_y, min=1e-12), 0.0, 1.0 - 1e-7
        )
        rows = self.conditional_cdf[iy]  # (..., W)
        ix = torch.searchsorted(rows.reshape(-1, w), ux.reshape(-1, 1).contiguous(), right=True)
        ix = torch.clamp(ix.reshape(ux.shape), 0, w - 1)
        cond = self.conditional_pmf[iy, ix]
        lo_x = torch.where(
            ix > 0, torch.gather(rows, -1, torch.clamp(ix - 1, min=0)[..., None])[..., 0], 0.0
        )
        hi_x = torch.gather(rows, -1, ix[..., None])[..., 0]
        rx = torch.clamp((ux - lo_x) / torch.clamp(hi_x - lo_x, min=1e-12), 0.0, 1.0 - 1e-7)
        pmf = self.marginal_pmf[iy] * cond
        return iy.to(torch.int32), ix.to(torch.int32), pmf, torch.stack([ry, rx], dim=-1)

    def pmf_of(self, iy, ix):
        h, w = self.shape
        iy = torch.clamp(iy, 0, h - 1).long()
        ix = torch.clamp(ix, 0, w - 1).long()
        return self.marginal_pmf[iy] * self.conditional_pmf[iy, ix]


def build_2d(weights: np.ndarray, device=None) -> Distribution2D:
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    row_sum = w.sum(axis=1)
    total = row_sum.sum()
    if total <= 0.0:
        w = np.ones_like(w)
        row_sum = w.sum(axis=1)
        total = row_sum.sum()
    marg_pmf = row_sum / total
    marg_cdf = np.cumsum(marg_pmf)
    marg_cdf[-1] = 1.0
    safe_rows = np.where(row_sum[:, None] > 0.0, w, 1.0)
    cond_pmf = safe_rows / safe_rows.sum(axis=1, keepdims=True)
    cond_cdf = np.cumsum(cond_pmf, axis=1)
    cond_cdf[:, -1] = 1.0
    put = lambda a: torch.as_tensor(a.astype(np.float32), device=device)
    return Distribution2D(
        marginal_cdf=put(marg_cdf), marginal_pmf=put(marg_pmf),
        conditional_cdf=put(cond_cdf), conditional_pmf=put(cond_pmf),
    )
