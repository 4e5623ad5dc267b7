"""The paper's tiled AIDW, SoA and AoaS: Phase 1 and Phase 2 as hand-written
CUDA kernels, each with its plain PyTorch version beside it.

* :func:`knn_alpha` - ``csrc/knn.cu``, the port of
  ``repro/kernels/aidw_tiled.py:_knn_kernel_soa`` and, with a tile table, of
  ``repro/kernels/aidw_grid.py:_knn_kernel_skip``.  Running k-best of d^2
  over streamed tiles of a candidate row, then alpha (Eq. 2-6); with
  ``nbins > 0`` the approximate ``binned`` prefilter, which cuts each tile
  to bin minima before the merge.
* :func:`weight_sweep` - ``csrc/weight.cu``, the port of
  ``repro/kernels/aidw_tiled.py:_weight_kernel_soa``.  sum(w), sum(w z), the
  running min d^2 and its z, then z.
* :func:`knn_alpha_aoas`, :func:`weight_sweep_aoas` - the same two sources
  on the ``(m, 4)`` AoaS structs, the ports of
  ``repro/kernels/aidw_tiled.py:_knn_kernel_aoas`` and ``_weight_kernel_aoas``.
  Their plain versions take the struct columns and run the SoA plain
  versions, so AoaS gives the SoA bits.
* :func:`knn_fold`, :func:`weight_fold` - the same two sources with their
  FOLD flag, the ring's folds of ``repro/core/distributed.py`` (``_fold_knn``
  and ``_fold_weights``, jnp scans with no Pallas kernel): the walk and the
  sweep over a data shard started from the state carried in, ending with
  that state or, on the ring's last step, with alpha or z.

A wrapper given CPU tensors runs the plain version (the CPU path); given
CUDA tensors it launches the kernel or raises.  The plain versions compute
tile by tile, as the Pallas kernels do: per-tile reductions folded into
running accumulators.  On the card nothing on the main path calls them;
they are the reference the kernels are held against.
"""

from __future__ import annotations

import functools
import math
import re

import torch

from repro_torch.core.aidw import AIDWParams, expected_nn_distance, tiny_for
from repro_torch.kernels import _build
from repro_torch.kernels._common import alpha_from_best, merge_k_best, sq_dist_tile, weight_tile

def _k_list() -> tuple[int, ...]:
    """The k values of ``AIDW_K_LIST`` in ``csrc/aidw_common.cuh``: every
    K-templated kernel (``knn.cu``, ``naive.cu``, ``fused.cu``) takes its
    ``switch (k)`` cases from that one list."""
    text = (_build.CSRC / "aidw_common.cuh").read_text()
    line = re.search(r"#define AIDW_K_LIST\(X\)(.*)", text).group(1)
    return tuple(int(k) for k in re.findall(r"X\((\d+)\)", line))


# the k values the CUDA kernels are instantiated for; a k outside them is
# refused on the card (the CPU path takes any k)
SUPPORTED_K = _k_list()

# csrc/aidw_common.cuh: kKnnStageBytes, the x and y arrays of one stage of
# the kNN walk (2,048 float32 or 1,024 float64 points), and kKnnGroup, the
# points a step; CPU tests read both back from the source
KNN_STAGE_BYTES = 16 * 1024
KNN_GROUP = 8
# knn_launch splits a batch's queries while it has fewer threads than this
# per SM (24 warps), at most four ways
_KNN_SPLIT_THREADS_PER_SM = 768


def knn_stage_points(dtype) -> int:
    """Points of one stage of the kNN walk in ``dtype``."""
    return KNN_STAGE_BYTES // (2 * (torch.finfo(dtype).bits // 8))


def knn_part(cnt: int, splits: int, part: int, unit: int = KNN_GROUP) -> tuple[int, int]:
    """The points ``[lo, hi)`` of a stage of ``cnt`` points that part
    ``part`` of ``splits`` sweeps in ``csrc/knn.cu``: ``ceil(cnt / splits)``
    rounded up to a multiple of ``unit`` (the group, or the binned
    prefilter's bin) a part, the last parts shorter or empty."""
    share = -(-cnt // splits)
    per = -(-share // unit) * unit
    lo = min(part * per, cnt)
    return lo, min(lo + per, cnt)


def knn_launch(n: int, sms: int, *, block_q: int = 256, vote: bool = False, bin_points: int = 0) -> tuple[int, int]:
    """``(threads, S)`` of a launch of the kNN kernel (``csrc/knn.cu``) for a
    batch of ``n`` queries in plan blocks of ``block_q`` on a card with
    ``sms`` multiprocessors: S threads share a query and split its points, a
    CUDA block holds ``threads / S`` queries of one plan block.  S doubles,
    up to 4, while the batch has fewer than ``_KNN_SPLIT_THREADS_PER_SM``
    threads per SM: more warps hide more latency, but every part walks its
    own k-best, so a large batch keeps S = 1 (``chip_smoke.py`` phase 31
    times S = 1, 2, 4 at 8,192, 65,536 and 2^20 queries).  S = 1 with the
    threshold-skip vote, whose tau is the k-th best at each tile's start,
    and with bins that do not divide a float64 stage.  A query's alpha does
    not depend on it."""
    splits = 1
    if not vote and not (bin_points and knn_stage_points(torch.float64) % bin_points):
        while splits < 4 and n * splits < _KNN_SPLIT_THREADS_PER_SM * sms:
            splits *= 2
    queries = math.gcd(block_q, 256 // splits)
    return queries * splits, splits


def weight_launch(n: int, sms: int) -> int:
    """Threads a block of the weight kernel (``csrc/weight.cu``, one query a
    thread) for a batch of ``n`` queries on a card with ``sms``
    multiprocessors.  A batch that gives every SM a 256-thread block takes
    256 threads, a smaller one 128, so its warps reach twice as many SMs
    (the masked arm of the far-field plans sweeps 7,424-9,216 queries of a
    65,536 batch of ``aidw-pod-1m``; ``chip_smoke.py`` phase 30 times
    both).  A query's z does not depend on it."""
    return 256 if n >= 256 * sms else 128


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _weight_threads(q: torch.Tensor) -> int:
    """``weight_launch`` for the batch ``q`` on its card."""
    return weight_launch(q.shape[0], _sm_count(q.device.index))


def knn_launch_for(q: torch.Tensor, block_q: int, **kw) -> tuple[int, int]:
    """``knn_launch`` for the batch ``q`` on its card."""
    return knn_launch(q.shape[0], _sm_count(q.device.index), block_q=block_q, **kw)


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


def check_k(name: str, k: int) -> None:
    """Refuse a k that the CUDA kernels are not instantiated for."""
    if k not in SUPPORTED_K:
        raise ValueError(f"{name}: the CUDA kernels are built for k in {min(SUPPORTED_K)}..{max(SUPPORTED_K)} "
                         f"(AIDW_K_LIST in csrc/aidw_common.cuh), got k={k}")


def _suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def check_aoas(name: str, data) -> None:
    """A kernel reads an AoaS point as one 16-byte float4 (two double2): the
    tensor must be a contiguous ``(m, 4)`` whose base is aligned to a point."""
    if data.dim() != 2 or data.shape[1] != 4 or not data.is_contiguous():
        raise ValueError(f"{name}: AoaS data must be a contiguous (m, 4) tensor, got {tuple(data.shape)}")
    if data.data_ptr() % (4 * data.element_size()):
        raise ValueError(f"{name}: AoaS data must be aligned to {4 * data.element_size()} bytes")


def check_soa_aligned(name: str, *tensors) -> None:
    """A kernel that reads SoA data with 16-byte vector loads from global
    memory (``csrc/naive.cu``) needs each array's base aligned to 16 bytes:
    a slice that starts inside a vector is refused."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: SoA data must be aligned to 16 bytes, got an array at offset "
                             f"{t.data_ptr() % 16} (a slice of a larger tensor?)")


def aoas_columns(data):
    """The x, y, z columns of ``(m, 4)`` structs as contiguous ``(m,)`` tensors."""
    return tuple(data[:, c].contiguous() for c in range(3))


def _alpha_consts(params: AIDWParams, area: float, m_real: int):
    """The alpha chain's constants as the kernels take them (doubles)."""
    return (expected_nn_distance(m_real, area), math.pi / params.r_max, float(params.r_min),
            float(params.r_max), *(float(a) for a in params.alpha_levels))


def knn_alpha_plain(qx, qy, cand_x, cand_y, *, block_q: int, tile_d: int, num_tiles=None, nbins: int = 0,
                    params: AIDWParams, area: float, m_real: int):
    """Plain version of :func:`knn_alpha`: the k-best folded tile by tile,
    rows past their tile count left untouched; with ``nbins`` each tile is
    first cut to the minima of its ``nbins`` runs of ``tile_d // nbins``
    points."""
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
        if nbins:
            d2 = d2.reshape(n, nbins, tile_d // nbins).amin(dim=2)
        merged = merge_k_best(best, d2)
        if num_tiles is not None:
            live = (j < num_tiles).repeat_interleave(n // rows)
            best = torch.where(live[:, None], merged, best)
        else:
            best = merged
    return alpha_from_best(best, m_real, area, params)[:, 0]


def knn_alpha(qx, qy, cand_x, cand_y, *, block_q: int, tile_d: int, num_tiles=None, nbins: int = 0,
              params: AIDWParams, area: float, m_real: int):
    """Phase 1: alpha ``(n,)`` of each query from its candidate row.

    ``qx, qy (n,)`` with ``n % block_q == 0``; ``cand_x, cand_y`` are
    ``(1, c)`` (one data row shared by every query, the ``tiled`` impl) or
    ``(n // block_q, c)`` (one candidate row per query block, the grid
    path), with ``c % tile_d == 0``.  ``num_tiles`` (int32, one per row)
    limits row i to its first ``num_tiles[i] * tile_d`` candidates.
    ``nbins > 0`` (a divisor of ``tile_d``) is the approximate ``binned``
    prefilter: only the minimum of each run of ``tile_d // nbins`` points
    enters the k-best.
    """
    n = qx.shape[0]
    rows, c_tot = cand_x.shape
    if n % block_q or c_tot % tile_d or cand_y.shape != cand_x.shape:
        raise ValueError(f"knn_alpha: bad shapes n={n} block_q={block_q} cand={tuple(cand_x.shape)} "
                         f"tile_d={tile_d}")
    if nbins < 0 or (nbins and tile_d % nbins):
        raise ValueError(f"knn_alpha: nbins={nbins} must divide tile_d={tile_d}")
    if rows != 1 and rows * block_q != n:
        raise ValueError(f"knn_alpha: {rows} candidate rows for {n // block_q} query blocks")
    # one row is a shared data row, or the row of a batch of one query block
    if num_tiles is not None and rows * block_q != n:
        raise ValueError("knn_alpha: a tile table needs one candidate row per query block")
    tensors = (qx, qy, cand_x, cand_y) + (() if num_tiles is None else (num_tiles,))
    if not _on_card("knn_alpha", *tensors):
        return knn_alpha_plain(qx, qy, cand_x, cand_y, block_q=block_q, tile_d=tile_d,
                               num_tiles=num_tiles, nbins=nbins, params=params, area=area, m_real=m_real)
    _check_float("knn_alpha", qx, qy, cand_x, cand_y)
    check_k("knn_alpha", params.k)
    if num_tiles is not None and (num_tiles.dtype != torch.int32 or num_tiles.shape != (rows,)
                                  or not num_tiles.is_contiguous()):
        raise ValueError("knn_alpha: num_tiles must be a contiguous int32 tensor, one per row")
    alpha = torch.empty_like(qx)
    threads, splits = knn_launch_for(qx, block_q, bin_points=tile_d // nbins if nbins else 0)
    fn = _build.entry(f"aidw_knn_alpha_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), cand_x.data_ptr(), cand_y.data_ptr(),
             0 if rows == 1 else c_tot, None if num_tiles is None else num_tiles.data_ptr(),
             n, block_q, c_tot, tile_d, nbins, params.k, threads, splits,
             *_alpha_consts(params, area, m_real), alpha.data_ptr(),
             torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "knn_alpha launch")
    _build.LAUNCHES["knn_binned" if nbins else "knn_soa" if num_tiles is None else "knn_skip"] += 1
    return alpha


def weight_sweep_plain(qx, qy, alpha_half, dx, dy, dz, *, tile_d: int, eps: float):
    """Plain version of :func:`weight_sweep`, tile by tile: the fold of all
    the data onto the empty carry."""
    return weight_fold_plain(weight_carry(qx), qx, qy, alpha_half, dx, dy, dz, tile_d=tile_d, eps=eps, finish=True)


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
             dz.data_ptr(), qx.shape[0], m, tile_d, _weight_threads(qx), float(eps), tiny_for(qx.dtype),
             out.data_ptr(), torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "weight_sweep launch")
    _build.LAUNCHES["weight_soa"] += 1
    return out


def aidw_tiled_soa(dx, dy, dz, qx, qy, *, params: AIDWParams, area: float, m_real: int,
                   block_q: int = 256, block_d: int = 512, nbins: int = 0):
    """Both tiled passes.  Inputs pre-padded: ``qx, qy (n,)`` with
    ``n % block_q == 0``; ``dx, dy, dz (m,)`` with ``m % block_d == 0``.
    ``nbins > 0`` takes the approximate binned prefilter in Phase 1.
    Returns ``(z_hat, alpha)``, shape ``(n,)`` each."""
    alpha = knn_alpha(qx, qy, dx[None, :], dy[None, :], block_q=block_q, tile_d=block_d, nbins=nbins,
                      params=params, area=area, m_real=m_real)
    z = weight_sweep(qx, qy, alpha * 0.5, dx, dy, dz, tile_d=block_d, eps=params.exact_hit_eps)
    return z, alpha


# ------------------------------------------------------------ AoaS family
def knn_alpha_aoas_plain(qx, qy, data, *, block_q: int, tile_d: int, params: AIDWParams, area: float,
                         m_real: int):
    """Plain version of :func:`knn_alpha_aoas`: the SoA plain version on the
    struct columns."""
    dx, dy, _ = aoas_columns(data)
    return knn_alpha_plain(qx, qy, dx[None], dy[None], block_q=block_q, tile_d=tile_d, params=params,
                           area=area, m_real=m_real)


def knn_alpha_aoas(qx, qy, data, *, block_q: int, tile_d: int, params: AIDWParams, area: float, m_real: int):
    """Phase 1 on the AoaS layout: alpha ``(n,)`` of each query from the
    shared ``(m, 4)`` data structs, ``n % block_q == 0``, ``m % tile_d == 0``."""
    n, m = qx.shape[0], data.shape[0]
    if n % block_q or data.dim() != 2 or m % tile_d or qy.shape != qx.shape:
        raise ValueError(f"knn_alpha_aoas: bad shapes n={n} block_q={block_q} data={tuple(data.shape)} "
                         f"tile_d={tile_d}")
    if not _on_card("knn_alpha_aoas", qx, qy, data):
        return knn_alpha_aoas_plain(qx, qy, data, block_q=block_q, tile_d=tile_d, params=params, area=area,
                                    m_real=m_real)
    _check_float("knn_alpha_aoas", qx, qy, data)
    check_aoas("knn_alpha_aoas", data)
    check_k("knn_alpha_aoas", params.k)
    alpha = torch.empty_like(qx)
    fn = _build.entry(f"aidw_knn_alpha_aoas_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), data.data_ptr(), n, block_q, m, tile_d, params.k,
             *knn_launch_for(qx, block_q), *_alpha_consts(params, area, m_real), alpha.data_ptr(),
             torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "knn_alpha_aoas launch")
    _build.LAUNCHES["knn_aoas"] += 1
    return alpha


def weight_sweep_aoas_plain(qx, qy, alpha_half, data, *, tile_d: int, eps: float):
    """Plain version of :func:`weight_sweep_aoas`: the SoA plain version on
    the struct columns."""
    return weight_sweep_plain(qx, qy, alpha_half, *aoas_columns(data), tile_d=tile_d, eps=eps)


def weight_sweep_aoas(qx, qy, alpha_half, data, *, tile_d: int, eps: float):
    """Exact Phase 2 on the AoaS layout: z ``(n,)`` of each query from the
    ``(m, 4)`` sentinel-padded data structs, ``m % tile_d == 0``; summed in
    :func:`weight_sweep`'s order."""
    m = data.shape[0]
    if data.dim() != 2 or m % tile_d or not (qy.shape == alpha_half.shape == qx.shape):
        raise ValueError(f"weight_sweep_aoas: bad shapes q={tuple(qx.shape)} data={tuple(data.shape)} "
                         f"tile_d={tile_d}")
    if not _on_card("weight_sweep_aoas", qx, qy, alpha_half, data):
        return weight_sweep_aoas_plain(qx, qy, alpha_half, data, tile_d=tile_d, eps=eps)
    _check_float("weight_sweep_aoas", qx, qy, alpha_half, data)
    check_aoas("weight_sweep_aoas", data)
    out = torch.empty_like(qx)
    fn = _build.entry(f"aidw_weight_aoas_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), alpha_half.data_ptr(), data.data_ptr(), qx.shape[0], m, tile_d,
             _weight_threads(qx), float(eps), tiny_for(qx.dtype), out.data_ptr(),
             torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "weight_sweep_aoas launch")
    _build.LAUNCHES["weight_aoas"] += 1
    return out


def aidw_tiled_aoas(data, qx, qy, *, params: AIDWParams, area: float, m_real: int, block_q: int = 256,
                    block_d: int = 512):
    """Both tiled passes on the AoaS layout.  Inputs pre-padded: ``data
    (m, 4)`` with ``m % block_d == 0``; ``qx, qy (n,)`` with
    ``n % block_q == 0``.  Returns ``(z_hat, alpha)``, shape ``(n,)`` each."""
    alpha = knn_alpha_aoas(qx, qy, data, block_q=block_q, tile_d=block_d, params=params, area=area,
                           m_real=m_real)
    z = weight_sweep_aoas(qx, qy, alpha * 0.5, data, tile_d=block_d, eps=params.exact_hit_eps)
    return z, alpha


# ------------------------------------------------------------ the ring's folds
def weight_carry(qx):
    """The weight partials of the queries ``qx`` before any data: ``(4, n)``
    rows sum_w = 0, sum_wz = 0, min_d2 = +inf, hit_z = 0."""
    carry = torch.zeros((4, qx.shape[0]), dtype=qx.dtype, device=qx.device)
    carry[2] = math.inf
    return carry


def knn_fold_plain(best, qx, qy, dx, dy, *, tile_d: int, params: AIDWParams, area: float, m_total: int,
                   finish: bool = False):
    """Plain version of :func:`knn_fold`: ``best`` merged with each tile of
    ``tile_d`` points in turn (``merge_k_best``), then with ``finish`` alpha."""
    qx2, qy2 = qx[:, None], qy[:, None]
    for j in range(dx.shape[0] // tile_d):
        s = slice(j * tile_d, (j + 1) * tile_d)
        best = merge_k_best(best, sq_dist_tile(qx2, qy2, dx[None, s], dy[None, s]))
    return alpha_from_best(best, m_total, area, params)[:, 0] if finish else best


def knn_fold(best, qx, qy, dx, dy, *, tile_d: int, params: AIDWParams, area: float, m_total: int,
             finish: bool = False):
    """The ring's Phase-1 fold: the k smallest d^2 of each query among its
    carried k-best ``best (n, k)`` and the data shard ``dx, dy (m,)``,
    ``m % tile_d == 0``, ascending ``(n, k)``; with ``finish`` (the ring's
    last step) alpha ``(n,)`` from them with the alpha constants of
    ``m_total`` data points, B1's epilogue.  The kernel's k-best does not
    depend on ``tile_d``; the plain version folds tile by tile."""
    n, m = qx.shape[0], dx.shape[0]
    if best.shape != (n, params.k) or qy.shape != qx.shape or dy.shape != dx.shape or m % tile_d:
        raise ValueError(f"knn_fold: bad shapes best={tuple(best.shape)} q={tuple(qx.shape)} d={tuple(dx.shape)} "
                         f"k={params.k} tile_d={tile_d}")
    kw = dict(params=params, area=area, m_total=m_total, finish=finish)
    if not _on_card("knn_fold", best, qx, qy, dx, dy):
        return knn_fold_plain(best, qx, qy, dx, dy, tile_d=tile_d, **kw)
    _check_float("knn_fold", qx, qy, dx, dy, best)
    check_k("knn_fold", params.k)
    block_q = math.gcd(n, 256)  # a CUDA block's queries divide it, and it divides n
    threads, splits = knn_launch_for(qx, block_q)
    out = torch.empty_like(qx) if finish else torch.empty_like(best)
    fn = _build.entry(f"aidw_knn_fold_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), dx.data_ptr(), dy.data_ptr(), best.data_ptr(), n, block_q, m, params.k,
             threads, splits, *_alpha_consts(params, area, m_total), None if finish else out.data_ptr(),
             out.data_ptr() if finish else None, torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "knn_fold launch")
    _build.LAUNCHES["knn_fold"] += 1
    return out


def weight_fold_plain(carry, qx, qy, alpha_half, dx, dy, dz, *, tile_d: int, eps: float, finish: bool = False):
    """Plain version of :func:`weight_fold`, tile by tile."""
    sum_w, sum_wz, min_d2, hit_z = (c[:, None] for c in carry)
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
    if finish:
        return torch.where(min_d2 <= eps, hit_z, sum_wz / sum_w)[:, 0]
    return torch.cat([sum_w, sum_wz, min_d2, hit_z], dim=1).T.contiguous()


def weight_fold(carry, qx, qy, alpha_half, dx, dy, dz, *, tile_d: int, eps: float, finish: bool = False):
    """The ring's Phase-2 fold: the weight partials ``carry (4, n)`` (rows
    sum_w, sum_wz, min_d2, hit_z; :func:`weight_carry` before any data) after
    the data shard ``dx, dy, dz (m,)``, ``m % tile_d == 0``: each tile's sums
    added to them in data order, the first minimum kept with a strict ``<``
    (a tie keeps the carried one).  Returns the new ``(4, n)`` partials, or
    with ``finish`` (the ring's last step) z ``(n,)`` by the exact-hit rule
    at ``eps``.  Summed in :func:`weight_sweep`'s order, so the fold of all
    the data onto :func:`weight_carry` gives B2's z."""
    n, m = qx.shape[0], dx.shape[0]
    if (carry.shape != (4, n) or m % tile_d or not (dy.shape == dz.shape == dx.shape)
            or not (qy.shape == alpha_half.shape == qx.shape)):
        raise ValueError(f"weight_fold: bad shapes carry={tuple(carry.shape)} q={tuple(qx.shape)} "
                         f"d={tuple(dx.shape)} tile_d={tile_d}")
    if not _on_card("weight_fold", carry, qx, qy, alpha_half, dx, dy, dz):
        return weight_fold_plain(carry, qx, qy, alpha_half, dx, dy, dz, tile_d=tile_d, eps=eps, finish=finish)
    _check_float("weight_fold", qx, qy, alpha_half, dx, dy, dz, carry)
    out = torch.empty_like(qx) if finish else torch.empty_like(carry)
    fn = _build.entry(f"aidw_weight_fold_{_suffix(qx.dtype)}")
    err = fn(qx.data_ptr(), qy.data_ptr(), alpha_half.data_ptr(), dx.data_ptr(), dy.data_ptr(), dz.data_ptr(),
             carry.data_ptr(), n, m, tile_d, _weight_threads(qx), float(eps), tiny_for(qx.dtype),
             None if finish else out.data_ptr(), out.data_ptr() if finish else None,
             torch.cuda.current_stream(qx.device).cuda_stream)
    _build.check(err, "weight_fold launch")
    _build.LAUNCHES["weight_fold"] += 1
    return out
