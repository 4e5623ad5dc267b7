"""Fused AIDW: both phases in one hand-written CUDA kernel
(``csrc/fused.cu``), the port of ``repro/kernels/aidw_fused.py:_fused_kernel``,
with its plain PyTorch version beside it.

S threads take one query, one warp-aligned part each (:func:`fused_launch`):
the k-best over the data staged stage by stage through shared memory, each
part sweeping its slice of every stage (:func:`fused_part`), the parts'
k-bests merged, alpha in a register; then the weight sweep at alpha / 2,
each tile of ``block_d`` points summed by one part from 0 and the tile sums
folded in data order (the order of ``csrc/weight.cu``).  Alpha and z are
then the bits of the ``tiled`` impl's two kernels (``knn.cu`` and
``weight.cu``).

A wrapper given CPU tensors runs the plain version (the CPU path); given
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core.aidw import AIDWParams, tiny_for
from repro_torch.kernels import _build
from repro_torch.kernels.aidw_tiled import (
    _alpha_consts,
    _check_float,
    _on_card,
    _sm_count,
    _suffix,
    check_k,
    knn_alpha_plain,
    knn_part,
    weight_sweep_plain,
)

# csrc/aidw_common.cuh: kStageBytes, the {x, y, z, pad} points of a weight
# stage; CPU tests read it back from the source
STAGE_BYTES = 32 * 1024
# fused_launch lets threads share a query while a batch has fewer threads
# than this per SM, at most four a query, in CUDA blocks of _FUSED_THREADS
_FUSED_SPLIT_THREADS_PER_SM = 8192
_FUSED_THREADS = 256


def fused_launch(n: int, sms: int, block_d: int, dtype) -> tuple[int, int]:
    """``(threads, S)`` of a launch of the fused kernel (``csrc/fused.cu``)
    for a batch of ``n`` queries and plan tiles of ``block_d`` points on a
    card with ``sms`` multiprocessors: S threads of a CUDA block share a
    query, one warp-aligned part each, which split its points in the kNN pass
    and its tiles in the weight pass.  S doubles, up to 4, while the batch
    has fewer than ``_FUSED_SPLIT_THREADS_PER_SM`` threads per SM, and falls
    where a round of S tiles does not fit one ``STAGE_BYTES`` stage (a
    tile of 4,096 float32 points is 64 KiB: S = 1).  Always 256 threads a
    block: 128 were slower at 8,192, 65,536 and 2^20 queries, even where 256
    leave SMs without a block (each block stages the whole data set, for
    half as many queries at 128).  The CUDA block is not tied to the plan's
    ``block_q``, which only pads the queries.  ``chip_smoke.py`` phase 36
    times S = 1, 2, 4 at 128 and 256 threads a block at 8,192, 65,536 and
    2^20 queries.  A query's alpha and z do not depend on it."""
    tile_bytes = block_d * 4 * (torch.finfo(dtype).bits // 8)
    splits = 1
    while splits < 4 and n * splits < _FUSED_SPLIT_THREADS_PER_SM * sms:
        splits *= 2
    while splits > 1 and splits * tile_bytes > STAGE_BYTES:
        splits //= 2
    return _FUSED_THREADS, splits


def fused_part(m: int, stage_d: int, splits: int, part: int) -> torch.Tensor:
    """The points of a row of ``m`` that part ``part`` of ``splits`` walks in
    the fused kernel's kNN pass: its slice of each stage of ``stage_d``
    points (``aidw_tiled.py: knn_part``, the cut of ``csrc/knn.cu``)."""
    out = []
    for base in range(0, m, stage_d):
        lo, hi = knn_part(min(stage_d, m - base), splits, part)
        out.append(torch.arange(base + lo, base + hi))
    return torch.cat(out)


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
    threads, splits = fused_launch(n, _sm_count(qx.device.index), block_d, qx.dtype)
    err = fn(qx.data_ptr(), qy.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(), n, m, block_d, params.k,
             threads, splits, *_alpha_consts(params, area, m_real), float(params.exact_hit_eps),
             tiny_for(qx.dtype), z.data_ptr(), alpha.data_ptr(), torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "aidw_fused_soa launch")
    _build.LAUNCHES["fused"] += 1
    return z, alpha
