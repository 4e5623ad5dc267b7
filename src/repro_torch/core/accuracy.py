"""Accuracy tooling: the Kahan-compensated oracle and the far-field error
report.  Counterpart of ``repro.core.accuracy``.

The dominant float32 error of AIDW is the long accumulation of sum(w) and
sum(w z) over m data points (w spans many orders of magnitude near the
query).  Kahan-compensated accumulation of the cross-tile partial sums
recovers near-float64 accuracy at the data dtype; it is the oracle the
far-field plans are measured against, never a kernel's arithmetic.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.aidw import AIDWParams, _sq_dists, adaptive_alpha, mean_k, sqrt_rn, tiny_for
from repro_torch.core.knn import running_k_best
from repro_torch.core.layouts import coord_sentinel, pad_to


def kahan_add(s, c, x):
    """One compensated accumulation step: returns ``(new_sum, new_compensation)``."""
    y = x - c
    t = s + y
    c_new = (t - s) - y
    return t, c_new


def aidw_interpolate_kahan(dx, dy, dz, qx, qy, params: AIDWParams = AIDWParams(), *, area: float,
                           q_chunk: int = 1024, d_chunk: int = 4096):
    """Tiled AIDW with Kahan-compensated cross-tile sum(w) / sum(w z).

    Plain PyTorch on the inputs' device, in chunks of ``q_chunk`` queries and
    ``d_chunk`` data points.  Returns ``(z_hat, alpha)``, shape ``(n,)`` each.
    """
    m, n = dx.shape[0], qx.shape[0]
    dtype, dev = qx.dtype, qx.device
    big = coord_sentinel(dtype, dev)
    tiles = [pad_to(a, d_chunk, v).reshape(-1, d_chunk) for a, v in ((dx, big), (dy, big), (dz, 0.0))]
    tiny = tiny_for(dtype)
    z_out, a_out = [], []
    for s in range(0, n, q_chunk):
        qcx, qcy = qx[s:s + q_chunk], qy[s:s + q_chunk]
        nq = qcx.shape[0]
        best = torch.full((nq, params.k), math.inf, dtype=dtype, device=dev)
        for tx, ty, _ in zip(*tiles):
            best = running_k_best(best, _sq_dists(qcx, qcy, tx, ty))
        alpha = adaptive_alpha(mean_k(sqrt_rn(best)), m, area, params)
        ah = (alpha * 0.5)[:, None]
        zeros = torch.zeros((nq,), dtype=dtype, device=dev)
        sw, cw, swz, cwz, hit_z = zeros, zeros, zeros, zeros, zeros
        min_d2 = torch.full((nq,), math.inf, dtype=dtype, device=dev)
        for tx, ty, tz in zip(*tiles):
            d2 = _sq_dists(qcx, qcy, tx, ty)
            w = torch.exp(-ah * torch.log(torch.clamp(d2, min=tiny)))
            sw, cw = kahan_add(sw, cw, w.sum(dim=1))
            swz, cwz = kahan_add(swz, cwz, (w * tz[None, :]).sum(dim=1))
            tmin, arg = torch.min(d2, dim=1)
            better = tmin < min_d2
            hit_z = torch.where(better, tz[arg], hit_z)
            min_d2 = torch.where(better, tmin, min_d2)
        z_out.append(torch.where(min_d2 <= params.exact_hit_eps, hit_z, swz / sw))
        a_out.append(alpha)
    return torch.cat(z_out), torch.cat(a_out)


# Floating-point slack separating the far-field model bound (exact
# arithmetic) from a measured comparison of two finite-precision pipelines:
# both round, so a mathematically exact case still measures O(eps).  It
# scales with sqrt(m) because the compared path accumulates plain-dtype
# partial sums over m terms.
FP_SLACK_ULPS = 64


def farfield_error_report(plan, qx, qy, *, q_chunk: int = 1024, d_chunk: int = 4096):
    """Measure a grid plan's Phase-2 approximation error against the Kahan
    oracle: runs ``execute(plan, qx, qy)``, recomputes the exact interpolant
    with :func:`aidw_interpolate_kahan`, and reports the relative error on
    the scale the bound is stated on, ``max|z_data|``.

    Returns a dict: ``max_rel_err`` / ``rms_rel_err`` / ``max_abs_err``
    (differences in float64), ``scale``, ``phase2``, ``bound`` (the plan's
    ``farfield_bound``), ``fp_slack`` (``FP_SLACK_ULPS * eps * sqrt(m)``),
    ``within_bound`` (``max_rel_err <= bound + fp_slack``) and ``n_queries``.
    """
    from repro_torch.engine import execute  # lazy: core <-> engine

    if plan.impl != "grid":
        raise ValueError(f"farfield_error_report expects an impl='grid' plan (got impl={plan.impl!r})")
    dxp, dyp, dzp = plan.data
    dx, dy, dz = dxp[:plan.m], dyp[:plan.m], dzp[:plan.m]
    qx = torch.as_tensor(qx, device=plan.device)
    qy = torch.as_tensor(qy, device=plan.device)
    z_approx, _ = execute(plan, qx, qy)
    z_exact, _ = aidw_interpolate_kahan(dx, dy, dz, qx, qy, plan.params, area=plan.area,
                                        q_chunk=q_chunk, d_chunk=d_chunk)
    diff = (z_approx.double() - z_exact.double()).abs()
    scale = max(float(dz.double().abs().max()), 1e-300)
    bound = float(plan.farfield_bound)
    fp_slack = FP_SLACK_ULPS * float(torch.finfo(dx.dtype).eps) * max(1.0, math.sqrt(plan.m))
    empty = diff.numel() == 0
    max_rel = 0.0 if empty else float(diff.max()) / scale
    return {
        "max_rel_err": max_rel,
        "rms_rel_err": 0.0 if empty else float(diff.square().mean().sqrt()) / scale,
        "max_abs_err": 0.0 if empty else float(diff.max()),
        "scale": scale,
        "phase2": plan.phase2,
        "bound": bound,
        "fp_slack": fp_slack,
        "within_bound": max_rel <= bound + fp_slack,
        "n_queries": int(qx.shape[0]),
    }
