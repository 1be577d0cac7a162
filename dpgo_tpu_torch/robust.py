"""Robust cost kernels (M-estimation + GNC) on tensors.

The counterpart of dpgo_tpu/robust.py (reference: src/DPGO_robust.cpp:54-134,
include/DPGO/DPGO_robust.h). `weight` is the scalar host function of the
protocol level; `weights` and gnc_tls_weights are the batched forms the GNC
loops use.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import stats as _scipy_stats

from dpgo_tpu_torch.types import RobustCostParameters, RobustCostType


def chi2inv(quantile: float, dof: int) -> float:
    """Chi-squared quantile (reference: DPGO_utils.cpp:509-512, via boost)."""
    return float(_scipy_stats.chi2.ppf(quantile, dof))


def angular_to_chordal_so3(rad: float) -> float:
    """2*sqrt(2)*sin(rad/2) (reference: DPGO_utils.cpp:514-516)."""
    return 2.0 * math.sqrt(2.0) * math.sin(rad / 2.0)


def error_threshold_at_quantile(quantile: float, dimension: int) -> float:
    """sqrt(chi2inv(q, 6)) for 3D (reference: DPGO_robust.h:116-123)."""
    if dimension != 3:
        raise ValueError("quantile threshold currently only supports 3D problems")
    if quantile <= 0:
        raise ValueError("quantile must be positive")
    if quantile < 1:
        return math.sqrt(chi2inv(quantile, 6))
    return 1e5


def gnc_tls_weights(r_sq: torch.Tensor, barc_sq: float, mu: float) -> torch.Tensor:
    """Batched GNC-TLS weight, eq. (14) of Yang et al. (reference:
    DPGO_robust.cpp:80-93). r_sq is the squared residual.

    The JAX package clamps r_sq at 1e-300 before dividing; that constant is
    0 in float32, so the clamp here is max(1e-300, finfo(dtype).tiny): the
    same value in float64, the smallest normal number in float32. Either
    way a clamped residual lies below `lower` and gets weight 1."""
    upper = (mu + 1.0) / mu * barc_sq
    lower = mu / (mu + 1.0) * barc_sq
    floor = max(1e-300, torch.finfo(r_sq.dtype).tiny)
    mid = torch.sqrt(barc_sq * mu * (mu + 1.0) / torch.clamp(r_sq, min=floor)) - mu
    one, zero = torch.ones_like(r_sq), torch.zeros_like(r_sq)
    return torch.where(r_sq >= upper, zero, torch.where(r_sq <= lower, one, mid))


class RobustCost:
    """Stateful robust cost with GNC schedule (reference:
    DPGO_robust.cpp:49-134)."""

    def __init__(self, params: RobustCostParameters):
        self.params = params
        self.mu = params.GNC_init_mu
        self._gnc_iteration = 0

    def reset(self) -> None:
        if self.params.cost_type == RobustCostType.GNC_TLS:
            self.mu = self.params.GNC_init_mu
            self._gnc_iteration = 0

    def set_init_mu(self, mu: float) -> None:
        self.mu = mu

    def weight(self, r: float) -> float:
        """Scalar weight for an (unsquared) residual r."""
        p = self.params
        ct = p.cost_type
        if ct == RobustCostType.L2:
            return 1.0
        if ct == RobustCostType.L1:
            return 1.0 / r
        if ct == RobustCostType.Huber:
            return 1.0 if r < p.huber_threshold else p.huber_threshold / r
        if ct == RobustCostType.TLS:
            return 1.0 if r < p.TLS_threshold else 0.0
        if ct == RobustCostType.GM:
            a = 1.0 + r * r
            return 1.0 / (a * a)
        if ct == RobustCostType.GNC_TLS:
            r_sq = r * r
            barc_sq = p.GNC_barc * p.GNC_barc
            upper = (self.mu + 1.0) / self.mu * barc_sq
            lower = self.mu / (self.mu + 1.0) * barc_sq
            if r_sq >= upper:
                return 0.0
            if r_sq <= lower:
                return 1.0
            return math.sqrt(barc_sq * self.mu * (self.mu + 1.0) / r_sq) - self.mu
        raise NotImplementedError(f"weight not implemented for {ct}")

    def weights(self, r) -> torch.Tensor:
        """Batched weights for a tensor (or array) of unsquared residuals,
        on r's device."""
        p = self.params
        ct = p.cost_type
        if not torch.is_tensor(r):
            r = torch.as_tensor(np.asarray(r))
        if ct == RobustCostType.L2:
            return torch.ones_like(r)
        if ct == RobustCostType.L1:
            return 1.0 / r
        if ct == RobustCostType.Huber:
            return torch.where(r < p.huber_threshold, torch.ones_like(r),
                               p.huber_threshold / r)
        if ct == RobustCostType.TLS:
            return (r < p.TLS_threshold).to(r.dtype)
        if ct == RobustCostType.GM:
            a = 1.0 + r * r
            return 1.0 / (a * a)
        if ct == RobustCostType.GNC_TLS:
            return gnc_tls_weights(r * r, p.GNC_barc**2, self.mu)
        raise NotImplementedError(f"weights not implemented for {ct}")

    def update(self) -> None:
        """Advance the GNC schedule: mu <- mu_step * mu
        (reference: DPGO_robust.cpp:116-134)."""
        if self.params.cost_type != RobustCostType.GNC_TLS:
            return
        self._gnc_iteration += 1
        if self._gnc_iteration > self.params.GNC_max_iters:
            return
        self.mu = self.params.GNC_mu_step * self.mu
