"""Standard IDW, the paper's comparison baseline: ``csrc/weight.cu`` at one
constant power, the port of ``repro/kernels/idw_tiled.py:_idw_kernel``,
with its plain PyTorch version beside it.

One distance sweep, no kNN pass: ``alpha / 2`` is rounded to the dtype once
and every query takes it.  The sum order is ``weight_sweep``'s, so z is the
bits of ``weight_sweep`` on a filled ``alpha_half``.

A wrapper given CPU tensors runs the plain version (the CPU path); given
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.aidw import tiny_for
from repro_torch.kernels import _build
from repro_torch.kernels.aidw_tiled import (
    _check_float,
    _on_card,
    _suffix,
    _weight_threads,
    weight_sweep_plain,
)


def idw_tiled_soa_plain(dx, dy, dz, qx, qy, *, alpha: float, exact_hit_eps: float, block_d: int):
    """Plain version of :func:`idw_tiled_soa`: the weight sweep's plain
    version at ``alpha * 0.5`` rounded to the dtype."""
    alpha_half = torch.full_like(qx, alpha * 0.5)
    return weight_sweep_plain(qx, qy, alpha_half, dx, dy, dz, tile_d=block_d, eps=exact_hit_eps)


def idw_tiled_soa(dx, dy, dz, qx, qy, *, alpha: float = 2.0, exact_hit_eps: float = 1e-18, block_q: int = 256,
                  block_d: int = 512):
    """IDW at the constant power ``alpha``.  Inputs pre-padded: ``qx, qy
    (n,)`` with ``n % block_q == 0``; ``dx, dy, dz (m,)`` sentinel-padded
    with ``m % block_d == 0``.  Returns z_hat ``(n,)``."""
    n, m = qx.shape[0], dx.shape[0]
    if n % block_q or m % block_d or not (dy.shape == dz.shape == dx.shape) or qy.shape != qx.shape:
        raise ValueError(f"idw_tiled_soa: bad shapes n={n} block_q={block_q} m={m} block_d={block_d}")
    if not _on_card("idw_tiled_soa", dx, dy, dz, qx, qy):
        return idw_tiled_soa_plain(dx, dy, dz, qx, qy, alpha=alpha, exact_hit_eps=exact_hit_eps, block_d=block_d)
    _check_float("idw_tiled_soa", qx, qy, dx, dy, dz)
    out = torch.empty_like(qx)
    fn = _build.entry(f"aidw_idw_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(), n, m, block_d,
             _weight_threads(qx), float(alpha), float(exact_hit_eps), tiny_for(qx.dtype), out.data_ptr(),
             torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "idw_tiled_soa launch")
    _build.LAUNCHES["idw"] += 1
    return out
