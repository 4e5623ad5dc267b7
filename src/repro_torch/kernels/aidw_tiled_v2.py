"""The threshold-skip kNN pass: ``csrc/knn.cu`` with its merge count, the
port of ``repro/kernels/aidw_tiled_v2.py:_knn_kernel_v2``, with its plain
PyTorch version beside it.

The Pallas kernel merges a ``(block_q, block_d)`` tile of d^2 into the
running k-best only if some d^2 in it is below its row's k-th best tau at
the tile's start, and counts the merges of each query block.  On the card
each thread already rejects a pair with one compare against its k-th best,
so the kernel is B1's walk with a vote: each thread keeps its tile's minimum
d^2, and at the tile's end the block votes on ``minimum < tau``.  Alpha is
B1's bits; :func:`aidw_tiled_v2_soa` adds the exact weight sweep (B2).

A wrapper given CPU tensors runs the plain version (the CPU path); given
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.aidw import AIDWParams
from repro_torch.kernels import _build
from repro_torch.kernels._common import alpha_from_best, merge_k_best, sq_dist_tile
from repro_torch.kernels.aidw_tiled import (
    _alpha_consts,
    _check_float,
    _on_card,
    _suffix,
    check_k,
    knn_launch_for,
    weight_sweep,
)


def knn_alpha_v2_plain(qx, qy, dx, dy, *, block_q: int, tile_d: int, params: AIDWParams, area: float,
                       m_real: int):
    """Plain version of :func:`knn_alpha_v2`, tile by tile: a block merges a
    tile when some d^2 of it lies below its row's k-th best."""
    n = qx.shape[0]
    nb = n // block_q
    best = torch.full((n, params.k), math.inf, dtype=qx.dtype, device=qx.device)
    merges = torch.zeros(nb, dtype=torch.int32, device=qx.device)
    for j in range(dx.shape[0] // tile_d):
        s = slice(j * tile_d, (j + 1) * tile_d)
        d2 = sq_dist_tile(qx[:, None], qy[:, None], dx[None, s], dy[None, s])
        hit = (d2 < best[:, -1:]).reshape(nb, block_q * tile_d).any(dim=1)
        best = torch.where(hit.repeat_interleave(block_q)[:, None], merge_k_best(best, d2), best)
        merges += hit.to(torch.int32)
    return alpha_from_best(best, m_real, area, params)[:, 0], merges


def knn_alpha_v2(qx, qy, dx, dy, *, block_q: int, tile_d: int, params: AIDWParams, area: float, m_real: int):
    """Phase 1 over the shared data row with the merge count: ``qx, qy (n,)``
    with ``n % block_q == 0``; ``dx, dy (m,)`` sentinel-padded with
    ``m % tile_d == 0``.  Returns ``(alpha (n,), merges (n // block_q,)
    int32)``, the tiles each query block merged."""
    n, m = qx.shape[0], dx.shape[0]
    if n % block_q or m % tile_d or dy.shape != dx.shape or qy.shape != qx.shape:
        raise ValueError(f"knn_alpha_v2: bad shapes n={n} block_q={block_q} m={m} tile_d={tile_d}")
    if not _on_card("knn_alpha_v2", qx, qy, dx, dy):
        return knn_alpha_v2_plain(qx, qy, dx, dy, block_q=block_q, tile_d=tile_d, params=params, area=area,
                                  m_real=m_real)
    _check_float("knn_alpha_v2", qx, qy, dx, dy)
    check_k("knn_alpha_v2", params.k)
    threads, splits = knn_launch_for(qx, block_q, vote=True)  # splits == 1
    alpha = torch.empty_like(qx)
    votes = torch.empty((n // threads, m // tile_d), dtype=torch.uint8, device=qx.device)
    fn = _build.entry(f"aidw_knn_alpha_v2_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), dx.data_ptr(), dy.data_ptr(), n, block_q, m, tile_d, params.k, threads,
             splits, *_alpha_consts(params, area, m_real), alpha.data_ptr(), votes.data_ptr(),
             torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "knn_alpha_v2 launch")
    _build.LAUNCHES["knn_v2"] += 1
    # the CUDA blocks of one plan block vote together
    merged = votes.view(n // block_q, block_q // threads, m // tile_d).amax(dim=1)
    return alpha, merged.sum(dim=1, dtype=torch.int32)


def aidw_knn_v2(dx, dy, qx, qy, *, params: AIDWParams, area: float, m_real: int, block_q: int = 256,
                block_d: int = 512):
    """The threshold-skip kNN pass under the reference's name and argument
    order (data first): :func:`knn_alpha_v2` at a ``block_d`` tile.  Inputs
    pre-padded as :func:`aidw_tiled_v2_soa`.  Returns ``(alpha (n,),
    merges_per_block (n // block_q,) int32)``."""
    return knn_alpha_v2(qx, qy, dx, dy, block_q=block_q, tile_d=block_d, params=params, area=area, m_real=m_real)


def aidw_tiled_v2_soa(dx, dy, dz, qx, qy, *, params: AIDWParams, area: float, m_real: int, block_q: int = 256,
                      block_d: int = 512):
    """The threshold-skip kNN pass, then the exact weight sweep.  Inputs
    pre-padded as :func:`repro_torch.kernels.aidw_tiled.aidw_tiled_soa`.
    Returns ``(z_hat, alpha, merges)``: ``(n,)``, ``(n,)`` and
    ``(n // block_q,)`` int32."""
    alpha, merges = aidw_knn_v2(dx, dy, qx, qy, params=params, area=area, m_real=m_real, block_q=block_q,
                                block_d=block_d)
    z = weight_sweep(qx, qy, alpha * 0.5, dx, dy, dz, tile_d=block_d, eps=params.exact_hit_eps)
    return z, alpha, merges
