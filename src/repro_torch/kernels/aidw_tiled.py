"""The paper's tiled AIDW (SoA): Phase 1 and Phase 2 as hand-written CUDA
kernels, each with its plain PyTorch version beside it.

* :func:`knn_alpha` - ``csrc/knn.cu``, the port of
  ``repro/kernels/aidw_tiled.py:_knn_kernel_soa`` and, with a tile table, of
  ``repro/kernels/aidw_grid.py:_knn_kernel_skip``.  Running k-best of d^2
  over streamed tiles of a candidate row, then alpha (Eq. 2-6).
* :func:`weight_sweep` - ``csrc/weight.cu``, the port of
  ``repro/kernels/aidw_tiled.py:_weight_kernel_soa``.  sum(w), sum(w z), the
  running min d^2 and its z, then z.

A wrapper given CPU tensors runs the plain version (the CPU path); given
CUDA tensors it launches the kernel or raises.  The plain versions compute
tile by tile, as the Pallas kernels do: per-tile reductions folded into
running accumulators.  On the card nothing on the main path calls them;
they are the reference the kernels are held against.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.aidw import AIDWParams, expected_nn_distance, tiny_for
from repro_torch.kernels import _build
from repro_torch.kernels._common import alpha_from_best, merge_k_best, sq_dist_tile, weight_tile

# the k values csrc/knn.cu is instantiated for: 10 (aidw-pod-1m and the
# golden fixture) and 5; a new value goes here and into knn.cu's switch
SUPPORTED_K = (5, 10)

_KNN_THREADS = 256
_WEIGHT_THREADS = 256


def _on_card(name: str, *tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on anything else
    or on a mix of devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return True


def _check_float(name: str, *tensors) -> None:
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 only, got {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def knn_alpha_plain(qx, qy, cand_x, cand_y, *, block_q: int, tile_d: int, num_tiles=None,
                    params: AIDWParams, area: float, m_real: int):
    """Plain version of :func:`knn_alpha`: the k-best folded tile by tile,
    rows past their tile count left untouched."""
    n = qx.shape[0]
    rows, c_tot = cand_x.shape
    best = torch.full((n, params.k), math.inf, dtype=qx.dtype, device=qx.device)
    steps = c_tot // tile_d
    if num_tiles is not None:
        steps = min(steps, int(num_tiles.max()) if rows else 0)
    if rows == 1:
        qx2, qy2 = qx[:, None], qy[:, None]
    else:
        qx2, qy2 = qx.reshape(rows, block_q, 1), qy.reshape(rows, block_q, 1)
    for j in range(steps):
        tx = cand_x[:, j * tile_d:(j + 1) * tile_d]
        ty = cand_y[:, j * tile_d:(j + 1) * tile_d]
        if rows == 1:
            d2 = sq_dist_tile(qx2, qy2, tx, ty)
        else:
            d2 = sq_dist_tile(qx2, qy2, tx[:, None, :], ty[:, None, :]).reshape(n, tile_d)
        merged = merge_k_best(best, d2)
        if num_tiles is not None:
            live = (j < num_tiles).repeat_interleave(n // rows)
            best = torch.where(live[:, None], merged, best)
        else:
            best = merged
    return alpha_from_best(best, m_real, area, params)[:, 0]


def knn_alpha(qx, qy, cand_x, cand_y, *, block_q: int, tile_d: int, num_tiles=None,
              params: AIDWParams, area: float, m_real: int):
    """Phase 1: alpha ``(n,)`` of each query from its candidate row.

    ``qx, qy (n,)`` with ``n % block_q == 0``; ``cand_x, cand_y`` are
    ``(1, c)`` (one data row shared by every query, the ``tiled`` impl) or
    ``(n // block_q, c)`` (one candidate row per query block, the grid
    path), with ``c % tile_d == 0``.  ``num_tiles`` (int32, one per row)
    limits row i to its first ``num_tiles[i] * tile_d`` candidates.
    """
    n = qx.shape[0]
    rows, c_tot = cand_x.shape
    if n % block_q or c_tot % tile_d or cand_y.shape != cand_x.shape:
        raise ValueError(f"knn_alpha: bad shapes n={n} block_q={block_q} cand={tuple(cand_x.shape)} "
                         f"tile_d={tile_d}")
    if rows != 1 and rows * block_q != n:
        raise ValueError(f"knn_alpha: {rows} candidate rows for {n // block_q} query blocks")
    tensors = (qx, qy, cand_x, cand_y) + (() if num_tiles is None else (num_tiles,))
    if not _on_card("knn_alpha", *tensors):
        return knn_alpha_plain(qx, qy, cand_x, cand_y, block_q=block_q, tile_d=tile_d,
                               num_tiles=num_tiles, params=params, area=area, m_real=m_real)
    _check_float("knn_alpha", qx, qy, cand_x, cand_y)
    if params.k not in SUPPORTED_K:
        raise ValueError(f"knn_alpha: the CUDA kernel is built for k in {SUPPORTED_K}, got {params.k}")
    if num_tiles is not None and (num_tiles.dtype != torch.int32 or num_tiles.shape != (rows,)
                                  or not num_tiles.is_contiguous()):
        raise ValueError("knn_alpha: num_tiles must be a contiguous int32 tensor, one per row")
    if rows == 1 and num_tiles is not None:
        raise ValueError("knn_alpha: a tile table needs one candidate row per query block")
    alpha = torch.empty_like(qx)
    fn = _build.entry(f"aidw_knn_alpha_{_suffix(qx.dtype)}")
    a1, a2, a3, a4, a5 = (float(a) for a in params.alpha_levels)
    err = fn(qx.data_ptr(), qy.data_ptr(), cand_x.data_ptr(), cand_y.data_ptr(),
             0 if rows == 1 else c_tot, None if num_tiles is None else num_tiles.data_ptr(),
             n, block_q, c_tot, tile_d, params.k, math.gcd(block_q, _KNN_THREADS),
             expected_nn_distance(m_real, area), math.pi / params.r_max,
             float(params.r_min), float(params.r_max), a1, a2, a3, a4, a5,
             alpha.data_ptr(), torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "knn_alpha launch")
    _build.LAUNCHES["knn_soa" if num_tiles is None else "knn_skip"] += 1
    return alpha


def weight_sweep_plain(qx, qy, alpha_half, dx, dy, dz, *, tile_d: int, eps: float):
    """Plain version of :func:`weight_sweep`, tile by tile."""
    n = qx.shape[0]
    zeros = torch.zeros((n, 1), dtype=qx.dtype, device=qx.device)
    sum_w, sum_wz, hit_z = zeros, zeros, zeros
    min_d2 = torch.full((n, 1), math.inf, dtype=qx.dtype, device=qx.device)
    qx2, qy2, ah2 = qx[:, None], qy[:, None], alpha_half[:, None]
    for j in range(dx.shape[0] // tile_d):
        s = slice(j * tile_d, (j + 1) * tile_d)
        d2 = sq_dist_tile(qx2, qy2, dx[None, s], dy[None, s])
        sw, swz, tmin, thz = weight_tile(d2, dz[None, s], ah2)
        sum_w = sum_w + sw
        sum_wz = sum_wz + swz
        better = tmin < min_d2
        hit_z = torch.where(better, thz, hit_z)
        min_d2 = torch.where(better, tmin, min_d2)
    return torch.where(min_d2 <= eps, hit_z, sum_wz / sum_w)[:, 0]


def weight_sweep(qx, qy, alpha_half, dx, dy, dz, *, tile_d: int, eps: float):
    """Exact Phase 2: z ``(n,)`` of each query from all data points.

    ``qx, qy, alpha_half (n,)``; ``dx, dy, dz (m,)`` sentinel-padded, with
    ``m % tile_d == 0``.  Kernel and plain version both sum per tile of
    ``tile_d`` points and fold the tile sums in data order.
    """
    m = dx.shape[0]
    if m % tile_d or not (dy.shape == dz.shape == dx.shape) or not (qy.shape == alpha_half.shape == qx.shape):
        raise ValueError(f"weight_sweep: bad shapes q={tuple(qx.shape)} d={tuple(dx.shape)} tile_d={tile_d}")
    if not _on_card("weight_sweep", qx, qy, alpha_half, dx, dy, dz):
        return weight_sweep_plain(qx, qy, alpha_half, dx, dy, dz, tile_d=tile_d, eps=eps)
    _check_float("weight_sweep", qx, qy, alpha_half, dx, dy, dz)
    out = torch.empty_like(qx)
    fn = _build.entry(f"aidw_weight_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), alpha_half.data_ptr(), dx.data_ptr(), dy.data_ptr(),
             dz.data_ptr(), qx.shape[0], m, tile_d, _WEIGHT_THREADS, float(eps), tiny_for(qx.dtype),
             out.data_ptr(), torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "weight_sweep launch")
    _build.LAUNCHES["weight_soa"] += 1
    return out


def aidw_tiled_soa(dx, dy, dz, qx, qy, *, params: AIDWParams, area: float, m_real: int,
                   block_q: int = 256, block_d: int = 512):
    """Both tiled passes.  Inputs pre-padded: ``qx, qy (n,)`` with
    ``n % block_q == 0``; ``dx, dy, dz (m,)`` with ``m % block_d == 0``.
    Returns ``(z_hat, alpha)``, shape ``(n,)`` each."""
    alpha = knn_alpha(qx, qy, dx[None, :], dy[None, :], block_q=block_q, tile_d=block_d,
                      params=params, area=area, m_real=m_real)
    z = weight_sweep(qx, qy, alpha * 0.5, dx, dy, dz, tile_d=block_d, eps=params.exact_hit_eps)
    return z, alpha
