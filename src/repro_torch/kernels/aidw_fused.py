"""Fused AIDW: both phases in one hand-written CUDA kernel
(``csrc/fused.cu``), the port of ``repro/kernels/aidw_fused.py:_fused_kernel``,
with its plain PyTorch version beside it.

Each thread takes one query: the k-best over the data staged tile by tile
through shared memory, alpha in a register, then the weight sweep at
alpha / 2 with ``csrc/weight.cu``'s sum order.  Alpha and z are then the
bits of the ``tiled`` impl's two kernels (``knn.cu`` and ``weight.cu``).

A wrapper given CPU tensors runs the plain version (the CPU path); given
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.aidw import AIDWParams, tiny_for
from repro_torch.kernels import _build
from repro_torch.kernels.aidw_tiled import (
    _alpha_consts,
    _check_float,
    _on_card,
    _suffix,
    check_k,
    knn_alpha_plain,
    weight_sweep_plain,
)

_FUSED_THREADS = 256


def aidw_fused_soa_plain(dx, dy, dz, qx, qy, *, params: AIDWParams, area: float, m_real: int, block_q: int,
                         block_d: int):
    """Plain version of :func:`aidw_fused_soa`: the tiled impl's two plain
    versions on the same tiles."""
    alpha = knn_alpha_plain(qx, qy, dx[None], dy[None], block_q=block_q, tile_d=block_d, params=params,
                            area=area, m_real=m_real)
    z = weight_sweep_plain(qx, qy, alpha * 0.5, dx, dy, dz, tile_d=block_d, eps=params.exact_hit_eps)
    return z, alpha


def aidw_fused_soa(dx, dy, dz, qx, qy, *, params: AIDWParams, area: float, m_real: int, block_q: int = 256,
                   block_d: int = 512):
    """Both AIDW phases in one launch.  Inputs pre-padded: ``qx, qy (n,)``
    with ``n % block_q == 0``; ``dx, dy, dz (m,)`` sentinel-padded with
    ``m % block_d == 0``.  Returns ``(z_hat, alpha)``, shape ``(n,)`` each."""
    n, m = qx.shape[0], dx.shape[0]
    if n % block_q or m % block_d or not (dy.shape == dz.shape == dx.shape) or qy.shape != qx.shape:
        raise ValueError(f"aidw_fused_soa: bad shapes n={n} block_q={block_q} m={m} block_d={block_d}")
    if not _on_card("aidw_fused_soa", dx, dy, dz, qx, qy):
        return aidw_fused_soa_plain(dx, dy, dz, qx, qy, params=params, area=area, m_real=m_real, block_q=block_q,
                                    block_d=block_d)
    _check_float("aidw_fused_soa", qx, qy, dx, dy, dz)
    check_k("aidw_fused_soa", params.k)
    z, alpha = torch.empty_like(qx), torch.empty_like(qx)
    fn = _build.entry(f"aidw_fused_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(), n, m, block_d, params.k,
             math.gcd(block_q, _FUSED_THREADS), *_alpha_consts(params, area, m_real), float(params.exact_hit_eps),
             tiny_for(qx.dtype), z.data_ptr(), alpha.data_ptr(), torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "aidw_fused_soa launch")
    _build.LAUNCHES["fused"] += 1
    return z, alpha
