"""Standard IDW (Shepard 1968), the paper's comparison baseline: the AIDW
weighting pass at one user-fixed power alpha, with no kNN pass.
Counterpart of ``repro.core.idw``."""

from __future__ import annotations

import torch

from repro_torch.core.aidw import _sq_dists, _weight_sweep, tiny_for


def idw_reference(dx, dy, dz, qx, qy, alpha: float = 2.0, *, exact_hit_eps: float = 1e-18):
    """Memory-naive oracle over the full ``(n, m)`` distance matrix.
    Returns z_hat ``(n,)``."""
    d2 = _sq_dists(qx, qy, dx, dy)
    w = torch.exp(-(alpha * 0.5) * torch.log(torch.clamp(d2, min=tiny_for(d2.dtype))))
    zhat = (w * dz[None, :]).sum(dim=1) / w.sum(dim=1)
    min_d2, arg = torch.min(d2, dim=1)
    return torch.where(min_d2 <= exact_hit_eps, dz[arg], zhat)


def idw_interpolate(dx, dy, dz, qx, qy, alpha: float = 2.0, *, q_chunk: int = 1024, d_chunk: int = 4096):
    """Chunked single-host IDW (one distance sweep) on the inputs' device.
    Returns z_hat ``(n,)``."""
    return _weight_sweep(dx, dy, dz, qx, qy, alpha * 0.5, 1e-18, q_chunk=q_chunk, d_chunk=d_chunk)
