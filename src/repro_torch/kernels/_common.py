"""Plain PyTorch versions of the semantics every AIDW kernel shares.
Counterpart of ``repro.kernels._common`` in the SoA orientation (queries
along dim 0, data points along dim 1); ``csrc/aidw_common.cuh`` holds the
same semantics as device functions.

* :func:`sq_dist_tile` - d^2 = dx^2 + dy^2; pad points at the sentinel
  overflow to +inf.
* :func:`merge_k_best` - keeps the k smallest, duplicates included.
* :func:`alpha_from_best` - r_obs = mean sqrt(best) (summed in ascending
  order), then Eq. (2)-(6).
* :func:`pow_weight` - w = exp(-(alpha/2) log(max(d^2, tiny))).
* :func:`weight_tile` - one tile of the weighting pass; the hit z is taken
  at the first index of the tile's minimum.
* :func:`run_sum` - a tile's sum in the order ``near.cu`` and ``far.cu``
  take it: runs of :data:`SUM_RUN` terms, each left to right, then the run
  sums left to right.
"""

from __future__ import annotations

import torch

from repro_torch.core.aidw import AIDWParams, adaptive_alpha, mean_k, sqrt_rn, tiny_for
from repro_torch.core.knn import running_k_best

SUM_RUN = 32  # terms per run of a tile's sum in near.cu and far.cu (kSumRun)


def sq_dist_tile(qx, qy, dx, dy):
    """Squared-distance tile by broadcasting (queries ``(bn, 1)``, data ``(1, bm)``)."""
    ddx = qx - dx
    ddy = qy - dy
    return ddx * ddx + ddy * ddy


def merge_k_best(best, d2):
    """The k smallest of ``best (bn, k)`` and ``d2 (bn, bm)`` per row, ascending."""
    return running_k_best(best, d2)


def alpha_from_best(best, m_real: int, area: float, params: AIDWParams):
    """r_obs -> R(S0) -> mu -> alpha per row, shape ``(bn, 1)``."""
    r_obs = mean_k(sqrt_rn(best))[:, None]
    return adaptive_alpha(r_obs, m_real, area, params)


def pow_weight(d2, alpha_half):
    """``(d^2)^(-alpha/2)`` with the dtype's tiny clamp; sentinel distances
    (+inf) get weight 0."""
    return torch.exp(-alpha_half * torch.log(torch.clamp(d2, min=tiny_for(d2.dtype))))


def run_sum(t):
    """Sum of ``t (bn, bm)`` along dim 1, ``(bn, 1)``, in a fixed order: each
    run of ``SUM_RUN`` consecutive terms from 0 left to right, then the run
    sums from 0 left to right (``bm % SUM_RUN == 0``).  This is the order of
    the near-field and far-cell kernels, so their sums and these agree to
    the last bit wherever the terms do."""
    bn, bm = t.shape
    runs = t.reshape(bn, bm // SUM_RUN, SUM_RUN)
    part = torch.zeros_like(runs[:, :, 0])
    for i in range(SUM_RUN):
        part = part + runs[:, :, i]
    total = torch.zeros_like(part[:, :1])
    for j in range(part.shape[1]):
        total = total + part[:, j:j + 1]
    return total


def weight_tile(d2, dz, alpha_half, *, in_runs: bool = False):
    """One tile of the weighting pass.  ``d2 (bn, bm)``, ``dz (1, bm)``,
    ``alpha_half (bn, 1)``.  Returns ``(sum_w, sum_wz, tile_min, tile_hit_z)``,
    each ``(bn, 1)``; ``in_runs`` sums the tile with :func:`run_sum`."""
    w = pow_weight(d2, alpha_half)
    tile_min, first = torch.min(d2, dim=1, keepdim=True)
    hit_z = torch.gather(dz.expand_as(d2), 1, first)
    if in_runs:
        return run_sum(w), run_sum(w * dz), tile_min, hit_z
    return w.sum(dim=1, keepdim=True), (w * dz).sum(dim=1, keepdim=True), tile_min, hit_z
