"""The paper's naive AIDW, SoA and AoaS: both phases in one hand-written CUDA
kernel with no shared memory (``csrc/naive.cu``), with its plain PyTorch
version beside it.

* :func:`aidw_naive_soa` - the port of
  ``repro/kernels/aidw_naive.py:_naive_kernel_soa``;
* :func:`aidw_naive_aoas` - the port of
  ``repro/kernels/aidw_naive.py:_naive_kernel_aoas``, on ``(m, 4)`` structs.

S threads take one query, one warp-aligned part each (:func:`naive_launch`):
they read every data point from global memory for the k-best and alpha,
``KNN_GROUP`` points a step dealt out between the parts (:func:`naive_part`),
then read them all again for the weights, each tile of ``block_d`` points
summed by one part, the tile sums folded in data order (the order of
``csrc/weight.cu``): alpha and z are then the tiled kernels' bits.

A wrapper given CPU tensors runs the plain version (the CPU path); given
CUDA tensors it launches the kernel or raises.  The plain version computes
the whole row's d^2 per pass, as the Pallas kernel does, in chunks of
queries that keep each ``(chunk, m)`` tensor under :data:`CHUNK_BYTES`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.aidw import AIDWParams, tiny_for
from repro_torch.kernels import _build
from repro_torch.kernels._common import alpha_from_best, merge_k_best, pow_weight, sq_dist_tile
from repro_torch.kernels.aidw_tiled import (
    KNN_GROUP,
    _alpha_consts,
    _check_float,
    _on_card,
    _sm_count,
    _suffix,
    aoas_columns,
    check_aoas,
    check_k,
    check_soa_aligned,
)

CHUNK_BYTES = 1 << 30  # one (chunk, m) tensor of the plain version
# naive_launch lets threads share a query while a batch has fewer threads
# than this per SM, at most four a query
_NAIVE_SPLIT_THREADS_PER_SM = 8192


def naive_launch(n: int, sms: int) -> tuple[int, int]:
    """``(threads, S)`` of a launch of the naive kernel (``csrc/naive.cu``)
    for a batch of ``n`` queries on a card with ``sms`` multiprocessors: S
    threads of a CUDA block share a query, one warp-aligned part each, which
    split its points in the kNN pass and its tiles in the weight pass.  S
    doubles, up to 4, while the batch has fewer than
    ``_NAIVE_SPLIT_THREADS_PER_SM`` threads per SM: the parts' warps hide
    the latency of the global loads.  A batch whose threads give every SM a
    256-thread block takes 256 threads a block, a smaller one 128, as
    ``weight_launch`` does.  ``chip_smoke.py`` phase 35 times S = 1, 2, 4 at
    128 and 256 threads a block at 8,192, 65,536 and 2^20 queries.  A
    query's alpha and z do not depend on it."""
    splits = 1
    while splits < 4 and n * splits < _NAIVE_SPLIT_THREADS_PER_SM * sms:
        splits *= 2
    return (256 if n * splits >= 256 * sms else 128), splits


def naive_part(m: int, splits: int, part: int) -> torch.Tensor:
    """The points of a row of ``m`` that part ``part`` of ``splits`` walks in
    the naive kernel's kNN pass (``aidw_common.cuh: knn_rows``): the groups
    ``g = part, part + splits, ...`` of ``KNN_GROUP`` consecutive points,
    the short last group included."""
    j = torch.arange(m)
    return j[(j // KNN_GROUP) % splits == part]


def aidw_naive_soa_plain(dx, dy, dz, qx, qy, *, params: AIDWParams, area: float, m_real: int, block_d: int):
    """Plain version of :func:`aidw_naive_soa`."""
    n, m = qx.shape[0], dx.shape[0]
    chunk = max(1, CHUNK_BYTES // (m * dx.element_size()))
    alpha = torch.empty_like(qx)
    tile_w = torch.empty((n, m // block_d), dtype=qx.dtype, device=qx.device)
    tile_wz = torch.empty_like(tile_w)
    min_d2, hit_z = torch.empty_like(qx), torch.empty_like(qx)
    for s in range(0, n, chunk):
        cx, cy = qx[s:s + chunk, None], qy[s:s + chunk, None]
        rows = cx.shape[0]
        # pass 1: the whole row's distances, k-best, alpha
        best = torch.full((rows, params.k), math.inf, dtype=qx.dtype, device=qx.device)
        a = alpha_from_best(merge_k_best(best, sq_dist_tile(cx, cy, dx[None], dy[None])), m_real, area, params)
        alpha[s:s + rows] = a[:, 0]
        # pass 2: the distances again, weights summed per tile of block_d
        d2 = sq_dist_tile(cx, cy, dx[None], dy[None])
        w = pow_weight(d2, a * 0.5)
        tile_w[s:s + rows] = w.reshape(rows, -1, block_d).sum(dim=2)
        tile_wz[s:s + rows] = (w * dz[None]).reshape(rows, -1, block_d).sum(dim=2)
        md, first = torch.min(d2, dim=1)
        min_d2[s:s + rows], hit_z[s:s + rows] = md, dz[first]
    # the tile sums folded in data order
    sum_w, sum_wz = torch.zeros_like(qx), torch.zeros_like(qx)
    for j in range(tile_w.shape[1]):
        sum_w = sum_w + tile_w[:, j]
        sum_wz = sum_wz + tile_wz[:, j]
    return torch.where(min_d2 <= params.exact_hit_eps, hit_z, sum_wz / sum_w), alpha


def _check_shapes(name: str, n: int, m: int, block_q: int, block_d: int) -> None:
    if n % block_q or m % block_d:
        raise ValueError(f"{name}: bad shapes n={n} block_q={block_q} m={m} block_d={block_d}")


def _launch(entry: str, pointers, n: int, m: int, block_d: int, qx, params: AIDWParams, area: float,
            m_real: int):
    check_k(entry, params.k)
    z, alpha = torch.empty_like(qx), torch.empty_like(qx)
    fn = _build.entry(f"aidw_{entry}_{_suffix(qx.dtype)}")
    threads, splits = naive_launch(n, _sm_count(qx.device.index))
    err = fn(*pointers, n, m, block_d, params.k, threads, splits, *_alpha_consts(params, area, m_real),
             float(params.exact_hit_eps), tiny_for(qx.dtype), z.data_ptr(), alpha.data_ptr(),
             torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, f"{entry} launch")
    _build.LAUNCHES[entry] += 1
    return z, alpha


def aidw_naive_soa(dx, dy, dz, qx, qy, *, params: AIDWParams, area: float, m_real: int, block_q: int = 64,
                   block_d: int = 512):
    """Both naive passes.  Inputs pre-padded: ``qx, qy (n,)`` with
    ``n % block_q == 0``; ``dx, dy, dz (m,)`` with ``m % block_d == 0``.
    ``block_q`` only pads the queries (the CUDA block size is the kernel's);
    ``block_d`` is the tile of the weight sums.  Returns ``(z_hat, alpha)``,
    shape ``(n,)`` each."""
    n, m = qx.shape[0], dx.shape[0]
    _check_shapes("aidw_naive_soa", n, m, block_q, block_d)
    if not (dy.shape == dz.shape == dx.shape) or qy.shape != qx.shape:
        raise ValueError("aidw_naive_soa: dx, dy, dz and qx, qy must have matching shapes")
    if not _on_card("aidw_naive_soa", dx, dy, dz, qx, qy):
        return aidw_naive_soa_plain(dx, dy, dz, qx, qy, params=params, area=area, m_real=m_real, block_d=block_d)
    _check_float("aidw_naive_soa", qx, qy, dx, dy, dz)
    check_soa_aligned("aidw_naive_soa", dx, dy, dz)
    ptrs = (qx.data_ptr(), qy.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr())
    return _launch("naive_soa", ptrs, n, m, block_d, qx, params, area, m_real)


def aidw_naive_aoas_plain(data, qx, qy, *, params: AIDWParams, area: float, m_real: int, block_d: int):
    """Plain version of :func:`aidw_naive_aoas`: the SoA plain version on the
    struct columns."""
    return aidw_naive_soa_plain(*aoas_columns(data), qx, qy, params=params, area=area, m_real=m_real,
                                block_d=block_d)


def aidw_naive_aoas(data, qx, qy, *, params: AIDWParams, area: float, m_real: int, block_q: int = 64,
                    block_d: int = 512):
    """:func:`aidw_naive_soa` on the AoaS layout: ``data (m, 4)`` structs."""
    n, m = qx.shape[0], data.shape[0]
    _check_shapes("aidw_naive_aoas", n, m, block_q, block_d)
    if data.dim() != 2 or qy.shape != qx.shape:
        raise ValueError(f"aidw_naive_aoas: bad shapes data={tuple(data.shape)} q={tuple(qx.shape)}")
    if not _on_card("aidw_naive_aoas", data, qx, qy):
        return aidw_naive_aoas_plain(data, qx, qy, params=params, area=area, m_real=m_real, block_d=block_d)
    _check_float("aidw_naive_aoas", qx, qy, data)
    check_aoas("aidw_naive_aoas", data)
    return _launch("naive_aoas", (qx.data_ptr(), qy.data_ptr(), data.data_ptr()), n, m, block_d, qx, params,
                   area, m_real)
