"""Adaptive Inverse Distance Weighting (AIDW): Eq. (2)-(6) of the paper and
a plain PyTorch oracle.  Counterpart of ``repro.core.aidw``.

Squared distances throughout; weights are ``(d^2)^(-alpha/2) = d^(-alpha)``
computed as ``exp(-alpha/2 * log(max(d^2, tiny)))``.  The alpha chain runs
in the data dtype with its constants rounded as the JAX package rounds them:
``r_exp`` in Python float64 then cast, ``pi / r_max`` a Python float applied
as a dtype constant, the five lerp segments clamped in the dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.knn import running_k_best
from repro_torch.core.layouts import coord_sentinel

# Default five decay levels a1..a5 (the paper does not publish its values).
DEFAULT_ALPHA_LEVELS = (0.5, 1.0, 2.0, 3.0, 4.0)


@dataclasses.dataclass(frozen=True)
class AIDWParams:
    """Static configuration of an AIDW interpolation.

    ``k`` neighbours enter ``r_obs``; ``alpha_levels`` are a1..a5 of Eq. (6);
    ``r_min``/``r_max`` bound the membership function of Eq. (5); ``area`` is
    the study region's area for Eq. (2) (``None``: the data's bbox area);
    ``exact_hit_eps`` is the squared distance at or below which a query
    returns the coincident data point's ``z``.
    """

    k: int = 10
    alpha_levels: Sequence[float] = DEFAULT_ALPHA_LEVELS
    r_min: float = 0.0
    r_max: float = 2.0
    area: float | None = None
    exact_hit_eps: float = 1e-18

    def resolve_area(self, dx, dy) -> float:
        if self.area is not None:
            return float(self.area)
        spanx = float(dx.max() - dx.min())
        spany = float(dy.max() - dy.min())
        return max(spanx * spany, 1e-30)


def expected_nn_distance(m: int, area: float):
    """Eq. (2): r_exp = 1 / (2 sqrt(m / A)), a Python float."""
    return 1.0 / (2.0 * math.sqrt(m / area))


def fuzzy_membership(r_stat, r_min: float, r_max: float):
    """Eq. (5): 0 for R <= r_min, 1 for R >= r_max, else
    0.5 - 0.5 cos(pi / r_max * (R - r_min))."""
    mu = 0.5 - 0.5 * torch.cos(math.pi / r_max * (r_stat - r_min))
    mu = torch.where(r_stat <= r_min, torch.zeros_like(mu), mu)
    return torch.where(r_stat >= r_max, torch.ones_like(mu), mu)


def alpha_from_mu(mu, levels: Sequence[float] = DEFAULT_ALPHA_LEVELS):
    """Eq. (6): linear through (0.1, a1), (0.3, a2), (0.5, a3), (0.7, a4),
    (0.9, a5), constant outside; the same clamped-lerp chain as the kernels."""
    a1, a2, a3, a4, a5 = [torch.tensor(a, dtype=mu.dtype, device=mu.device) for a in levels]
    alpha = a1
    for lo, bb in ((0.1, a2), (0.3, a3), (0.5, a4), (0.7, a5)):
        t = torch.clamp((mu - lo) * 5.0, 0.0, 1.0)  # each segment spans 0.2
        alpha = alpha * (1.0 - t) + bb * t
    return alpha


def adaptive_alpha(r_obs, m: int, area: float, params: AIDWParams):
    """Steps 1-3 of paper section 2.2: r_obs -> R(S0) -> mu_R -> alpha."""
    r_exp = torch.tensor(expected_nn_distance(m, area), dtype=r_obs.dtype, device=r_obs.device)
    mu = fuzzy_membership(r_obs / r_exp, params.r_min, params.r_max)
    return alpha_from_mu(mu, params.alpha_levels)


def sqrt_rn(x):
    """Correctly rounded square root, as XLA and CUDA give it.  PyTorch's CPU
    ``sqrt`` can be an ulp off in float32 and in float64, so on the CPU the
    root is numpy's (the processor's square-root instruction)."""
    if x.device.type == "cpu":
        return torch.as_tensor(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def mean_k(v):
    """Row means of ``v (rows, k)`` as the reference computes them: a
    sequential sum in column order (ascending for a k-best set), times the
    dtype's ``1/k``."""
    s = v[:, 0]
    for j in range(1, v.shape[1]):
        s = s + v[:, j]
    return s * (1.0 / v.shape[1])


def tiny_for(dtype) -> float:
    """The clamp that keeps ``log(d^2)`` finite at exact hits."""
    return 1e-30 if dtype == torch.float32 else 1e-290


def _sq_dists(qx, qy, dx, dy):
    """Pairwise squared distances, (n,) queries x (m,) data -> (n, m)."""
    ddx = qx[:, None] - dx[None, :]
    ddy = qy[:, None] - dy[None, :]
    return ddx * ddx + ddy * ddy


def _weighted_average(d2, dz, alpha_half, exact_hit_eps):
    """Phase 2 (Eq. 1): w = (d^2)^(-alpha/2), with the exact-hit override."""
    w = torch.exp(-alpha_half[:, None] * torch.log(torch.clamp(d2, min=tiny_for(d2.dtype))))
    zhat = (w * dz[None, :]).sum(dim=1) / w.sum(dim=1)
    min_d2, arg = torch.min(d2, dim=1)
    return torch.where(min_d2 <= exact_hit_eps, dz[arg], zhat)


def aidw_reference(dx, dy, dz, qx, qy, params: AIDWParams = AIDWParams(), *, area: float | None = None):
    """Memory-naive oracle over the full ``(n, m)`` distance matrix.
    Returns ``(z_hat, alpha)``, shape ``(n,)`` each."""
    m = dx.shape[0]
    a = area if area is not None else params.resolve_area(dx, dy)
    d2 = _sq_dists(qx, qy, dx, dy)
    r_obs = mean_k(sqrt_rn(torch.topk(d2, params.k, dim=1, largest=False, sorted=True).values))
    alpha = adaptive_alpha(r_obs, m, a, params)
    return _weighted_average(d2, dz, alpha * 0.5, params.exact_hit_eps), alpha


def brute_r_obs(dx, dy, qx, qy, k: int, *, q_chunk: int = 1024, d_chunk: int = 4096):
    """Phase 1, brute force: chunked running-k-best scan over all m data
    points -> mean k-nearest distance per query, shape ``(n,)``."""
    n = qx.shape[0]
    big = coord_sentinel(dx.dtype, dx.device)
    m_pad = (-dx.shape[0]) % d_chunk
    dxt = torch.cat([dx, big.expand(m_pad)]).reshape(-1, d_chunk)
    dyt = torch.cat([dy, big.expand(m_pad)]).reshape(-1, d_chunk)
    out = []
    for s in range(0, n, q_chunk):
        qcx, qcy = qx[s:s + q_chunk], qy[s:s + q_chunk]
        best = torch.full((qcx.shape[0], k), math.inf, dtype=qx.dtype, device=qx.device)
        for tx, ty in zip(dxt, dyt):
            best = running_k_best(best, _sq_dists(qcx, qcy, tx, ty))
        out.append(mean_k(sqrt_rn(best)))
    return torch.cat(out)
