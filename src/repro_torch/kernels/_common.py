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
* :func:`sfu_weight_eps`, :func:`sfu_term_budget`, :func:`sfu_sum_tolerance`,
  :func:`tolerance_ratio` - how far a float32 kernel sum whose weights come
  from the special-function units may lie from the plain sum of the same
  terms in the same order.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.aidw import AIDWParams, adaptive_alpha, mean_k, sqrt_rn, tiny_for
from repro_torch.core.knn import running_k_best

SUM_RUN = 32  # terms per run of a tile's sum in near.cu and far.cu (kSumRun)
EPS32 = 2.0 ** -23   # float32's machine epsilon, the ulp of 1
LG2_ABS = 2.0 ** -22.6  # lg2.approx.f32: absolute error in log2 x (PTX ISA)


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


def sfu_weight_eps(d2, alpha_half):
    """The relative budget, per term and in float64, of one float32 weight
    of ``csrc/aidw_common.cuh: pow_weight``, 2^(-(alpha/2) log2 max(d^2,
    tiny)) with ``lg2.approx`` and ``ex2.approx``, against :func:`pow_weight`
    here (``torch.exp``/``torch.log``) on the same ``d2`` and ``alpha_half``::

        eps = |t| 2^-22 + ln2 (alpha/2) 2^-22.6 + 3 2^-23,  t = (alpha/2) ln max(d^2, tiny)

    ``|t| 2^-22``: the exponent rounds to float32 twice on each side (the
    logarithm's result and its product with alpha/2), each half an ulp of
    |t|, which w = e^-t turns into a relative error; ``ln2 (alpha/2)
    2^-22.6``: ``lg2.approx``'s absolute error in log2 x, scaled into the
    exponent; ``3 2^-23``: ``ex2.approx``'s 2 ulps and the library exp's 1.
    (With the kernel's roundings alone, |t| 2^-23, 137 of 1,048,576 terms
    measured on an H100 lay past the budget, by up to 1.37x;
    ``chip_smoke.py`` phase 7 prints the per-term errors.)  A
    sentinel term (d^2 = +inf, w = 0) gets +inf; :func:`sfu_term_budget`
    counts it as 0."""
    x = torch.clamp(d2, min=tiny_for(d2.dtype)).double()
    ah = alpha_half.double()
    return (ah * torch.log(x)).abs() * 2 * EPS32 + math.log(2.0) * ah * LG2_ABS + 3 * EPS32


def sfu_term_budget(term, eps):
    """``(sum |term| eps, sum |term|)`` along dim 1, in float64: what a sum
    of ``term`` owes to its terms' own errors ``eps``
    (:func:`sfu_weight_eps`), and its magnitude.  A zero term adds nothing
    to either; an infinite one makes both infinite."""
    a = term.double().abs()
    return torch.where(a > 0, a * eps, 0.0).sum(dim=1), a.sum(dim=1)


def sfu_sum_tolerance(eps_sum, abs_sum, tile_d: int, tiles):
    """Per-query tolerance of a float32 kernel sum (``near.cu``, ``far.cu``:
    weights on the special-function units) against the plain sum of the
    same terms in the same order (:func:`run_sum` in tiles of ``tile_d``,
    ``tiles`` of them folded), from :func:`sfu_term_budget`'s two sums::

        tol = sum |term_i| eps_i + 2^-23 (SUM_RUN - 1 + tile_d / SUM_RUN - 1 + tiles - 1) sum |term_i|

    The first part is the terms' own errors.  The second is the summation
    slack of the shared order: each addition may round the two sums apart
    by up to one ulp of its partial sum, 2^-23 of it at most.  A run's 31
    additions have partial sums within that run's sum of |term|, a tile's
    additions of run sums within the tile's, the fold's within the whole
    sum, so over every run, tile and fold the partial sums add up to at
    most the count above times sum |term|."""
    adds = (SUM_RUN - 1) + (tile_d // SUM_RUN - 1) + (torch.as_tensor(tiles, dtype=torch.float64) - 1).clamp(min=0)
    return eps_sum + EPS32 * adds.to(abs_sum.device) * abs_sum


def tolerance_ratio(k, p, tol):
    """The largest ``|k - p| / tol`` over the entries, in float64: at most 1
    when the kernel sums ``k`` meet the per-query tolerance ``tol`` against
    the plain sums ``p``.  Equal infinities count as equal; a finite value
    against an infinity, or any difference where ``tol`` is 0, is +inf."""
    k, p, tol = k.double(), p.double(), tol.double()
    same = k == p
    diff = torch.where(same, 0.0, (k - p).abs())
    ratio = torch.where(same, 0.0, torch.where(tol > 0, diff / tol, math.inf))
    ratio = torch.where(~same & ~(torch.isfinite(k) & torch.isfinite(p)), math.inf, ratio)
    return float(ratio.max()) if ratio.numel() else 0.0
