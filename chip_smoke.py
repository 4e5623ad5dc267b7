#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit.  It builds the hand-written kernels from
``src/repro_torch/kernels/csrc`` into ``build/repro_torch_kernels/`` and runs,
in order (a failed check raises, and the script exits nonzero):

1. build: each kernel's registers and spills, as ``ptxas -v`` prints them,
   and the SASS instructions and special-function-unit (MUFU) ops per pair
   of the float32 weight kernel's inner loop, which must take at most the
   two MUFU ops a pair the function needs, of the float32 near-field (B4)
   and far-cell (B5) loops, which must take one MUFU.LG2 and one MUFU.EX2 a
   pair and no FFMA, of the float32 quadtree loop (B6), which must take one
   MUFU.LG2, one MUFU.EX2 and one MUFU.RCP a pair and no FFMA, and of the
   float32 kNN walk's hot loop, which must hold no FFMA and at most one
   shared load per two pairs, of the float32 naive kernels' (B7, B8)
   kNN and weight loops, SoA and AoaS, which must read global memory and no
   shared memory and, in SoA, read their points with 16-byte vector loads,
   and of the float32 fused kernel's (B11) kNN loop, held as the kNN walk's,
   and weight loop, which must take at most two MUFU ops a pair and one
   LDS.128 a point;
2. each kernel against its plain PyTorch version on the card, float32 and
   float64, at the shapes the main path gives it (m = 2^20): B1 and B3
   alpha bit for bit, with a control that a walk losing one split part
   fails, and B2 also at a 4,096-point plan tile (the dynamic-shared-memory
   path) with its control;
3. the golden fixture (``tests/fixtures/aidw_golden.npz``) for ``grid`` with
   both pipelines and for ``tiled``, float32 and float64;
4. run-to-run determinism and NaN/Inf query hardening; B2 on a 65,536
   batch gives the bits of B2 on slices of it (other block sizes);
5. the serving run of the ``aidw-pod-1m`` configuration: clustered data,
   m = 2^20, k = 10, three batches of 65,536 uniform queries and one of 2^20
   on the main path (``impl="grid"``, ``pipeline="prefetch"``), then one
   batch through ``pipeline="dense"`` and one through ``impl="tiled"``; each
   path with its launch counts, sampled queries held against a float64
   brute-force reference, and on the main path the kernel's error there
   within 2x its plain version's on the same queries;
6. each kernel timed with CUDA events at the serving batch's shapes, and
   B1 also on the ``tiled`` impl's shared data row;
7. the far-field kernels (``phase2="farfield"``) against their plain
   versions on the card, float32 and float64, at the serving batch's shapes:
   B4 (near field) and B5 (far cells), float32 within each query's
   tolerance from its terms (``kernels/_common.py: sfu_sum_tolerance``; the
   weights come from the special-function units), float64 within 8 ulps,
   B4's minimum and its z bit for bit; the per-term ulps of the float32
   weight by |t|; controls that a sweep dropping one tile, one near point or
   one far cell, or masking one more cell a block, fails the check by 10x;
8. the golden far-field pin (``ffpin_*`` of the fixture) on the card;
9. the far-field plan built on the card against the one built on the CPU;
10. the far-field serving run of ``aidw-pod-1m``: the same four batches, the
    radius, bound and warning of the plan, each batch's time, stats and
    launches, its error against the Kahan oracle on sampled queries, and B4
    and B5 at its shapes against their plain versions on sampled blocks;
11. the far-field overflow arm at the reference test's small shape, bitwise
    against an exact plan;
12. B4 and B5 timed with CUDA events at the serving batch's shapes, with
    their operations, special-function-unit and issue bounds;
13. the quadtree kernel B6 (``phase2="quadtree"``) against its plain version
    on the card, every level, at the serving batch's shapes: first the
    float32 per-term errors against their own budgets, then float32 within
    each query's tolerance (``phase2_far_nodes_tolerance``: the weights and
    the gradient's reciprocal come from the special-function units) and
    float64 within 8 ulps; controls, per level, that a table losing its
    first node and a sweep without the dipole term fail the check by 10x at
    the level where each shows most; and B4 on the quadtree plan's near
    field as in phase 7;
14. the golden quadtree pin (``qtree_*`` of the fixture) on the card;
15. the quadtree plan built on the card against the one built on the CPU;
16. the quadtree serving run of ``aidw-pod-1m``: the same four batches, each
    batch's time, the walk's time alone, stats and launches, its error
    against the Kahan oracle on sampled queries, and B6 and B4 at its shapes
    against their plain versions on sampled blocks;
17. the quadtree overflow arm at the reference test's small shape, bitwise
    against an exact plan;
18. the ring-search arm with every query active on 1,024 queries far
    outside the data's box: its rings and time, r_obs against a float64
    brute force;
19. B6 timed with CUDA events per level at the serving batch's shapes,
    float32 and float64, with the pairs it needs and walks and its
    special-function-unit, operations and issue bounds, beside the
    quadtree, far-field and exact batch times of this run;
20. (a) the paper's dense variants' kernels against their plain versions on
    the card, float32 and float64, m = 2^20, 2,048 queries: B7 and B8
    (``naive.cu``, SoA and AoaS), B9 and B10 (``knn.cu`` and ``weight.cu``
    on AoaS) and B1 with ``nbins`` (the ``binned`` prefilter, also at 4- and
    12-point bins), alpha exactly and z within 64 ulps, with controls that a
    weight pass dropping its first tile and a k-best dropping the nearest
    point fail the check;
21. (b) naive SoA, naive AoaS, tiled AoaS and tiled SoA give the same
    alpha and z bits;
22. (c) the golden fixture for naive SoA/AoaS and tiled AoaS, float32 and
    float64;
23. (d) the dense run of ``aidw-pod-1m``: the first serving batch (65,536
    queries) through naive and tiled in SoA and AoaS and through ``binned``,
    float32 and float64, each with its launch counts and wall time, sampled
    queries held against a float64 brute-force reference (``binned``
    against the error envelope of the reference's tests);
24. (e) B7-B10 and B1 binned timed with CUDA events at that shape, float32
    and float64, with their bounds, and the paper's comparison table (naive
    vs tiled, SoA vs AoaS, float32 vs float64);
25. the last three kernels against their plain versions on the card,
    float32 and float64, m = 2^20, 2,048 queries: B11 (``fused.cu``), B12
    (``knn.cu`` with the threshold-skip vote) and B13 (``weight.cu`` at one
    alpha); alpha exactly, z within 64 ulps, merges equal, with controls
    that a fused sweep without its first tile, a fused k-best that loses one
    part of four (by 10x), a threshold-skip pass that never merges after
    tile 0 and an IDW sweep at alpha / 2 + 1 ulp fail;
26. bits on the card: fused equals tiled SoA, also at S = 1, 2 and 4
    threads a query and at a plan tile of 4,096 float32 or 2,048 float64
    points (past the first design's 48 KiB of shared memory), tiled_v2 alpha
    equals B1 and its z B2 on it, idw equals ``weight_sweep`` at a filled
    alpha / 2; and k = 7 through ``knn.cu``, ``naive.cu`` and ``fused.cu``
    against the plain versions;
27. the golden fixture for fused, tiled_v2 and chunked (brute and grid),
    float32 and float64;
28. the first serving batch of ``aidw-pod-1m`` (65,536 queries, seed 1)
    through fused, tiled_v2, idw (alpha = 2) and chunked (brute and grid),
    each with its launches, wall time and stats (``merge_fraction``),
    sampled queries held against a float64 brute-force reference (idw
    against a float64 ``idw_reference``);
29. B11-B13 timed with CUDA events at that shape, float32 and float64, with
    their bounds, and B11 beside the B1 + B2 pair it fuses;
30. B2 (float32) timed with CUDA events at 128 and 256 threads a block at
    8,192, 65,536 and 2^20 queries, beside the wrapper's choice
    (``kernels/aidw_tiled.py: weight_launch``), both giving the same bits;
31. B1 (float32, shared row) timed with CUDA events at S = 1, 2 and 4
    threads a query and 128 or 256 threads a block, at 8,192, 65,536 and
    2^20 queries (in phases 31-33 each setting's time is the median of 5
    rounds that time every setting in turn): all give the same bits, and
    the wrapper's choice
    (``kernels/aidw_tiled.py: knn_launch``) is the fastest or within 3%;
32. B4 and B5 (float32) timed with CUDA events at 64, 128 and 256 threads
    a block at 8,192, 65,536 (two batches) and 2^20 queries, beside the
    wrapper's choice (``kernels/aidw_grid.py: row_launch``), which must be
    the fastest or within 5%, all giving the same bits, with the spread of
    the near rows' lengths;
33. B6 (float32), its level launches together, timed with CUDA events at S
    = 1, 2 and 4 threads a query and 64, 128 and 256 threads a block at
    8,192, 65,536 and 2^20 queries, beside the wrapper's choice
    (``kernels/aidw_grid.py: far_node_launch``), which must be the fastest
    or within 5%, all giving the same bits;
34. the serving layer on ``aidw-pod-1m``: an exact grid plan sized for 64
    queries a cell behind a ``CapacityReestimator``, served uniform 65,536
    batches until the overflow streak triggers a background re-plan and the
    swap ends the overflow; each batch's wall, overflow and state, the
    batches before the swap bitwise the old plan's and the first after it
    a fresh ``replan_with_capacity``'s, z within phase 5's gate, B3 and B2
    launched; the same storm on a far-field plan with ``p2_capacity``,
    ``p2_overflow_queries`` and the masked B2 arm's time before and after
    the swap; three injected build failures degrading with one
    ``PlanDegradedWarning``; and the plan memo of ``kernels.aidw``;
35. B7 and B8 (float32, ``naive.cu``) timed with CUDA events at S = 1, 2
    and 4 threads a query and 128 and 256 threads a block, at 8,192, 65,536
    and 2^20 queries, beside the wrapper's choice
    (``kernels/aidw_naive.py: naive_launch``), which must be the fastest or
    within 3%, every setting giving the wrapper's bits;
36. B11 (float32, ``fused.cu``) timed with CUDA events at S = 1, 2 and 4
    threads a query and 128 and 256 threads a block, at 8,192, 65,536 and
    2^20 queries (the median of 5 rounds), beside the wrapper's choice
    (``kernels/aidw_fused.py: fused_launch``), which must be the fastest or
    within 3%, every setting giving the wrapper's bits;
37. multi-device AIDW (``repro_torch.core.distributed``): 4 ranks started
    with ``torch.multiprocessing`` share the card over gloo (one card holds
    no two NCCL ranks, so each rotation is staged through the host and the
    folds stay on the card) on a (2, 2) ``("data", "model")`` mesh, with the
    ``aidw-pod-1m`` data and its first serving batch: ``ring_aidw`` over
    both dims and over ``"data"``, ``ring_aidw_rotate_queries``,
    ``sharded_queries_aidw``, and ``ring_aidw`` in float64 at 8,192
    queries, each with its wall time per rank, fold launches and bytes
    staged a rotation; ring alpha bit for bit B1's, ring z within 64 ulps of
    B2's, sharded queries bit for bit the single-process ``chunked`` plan;
    the ring replayed in one process (the fold kernels give the ranks' bits,
    their plain versions alpha's bits and z within 64 ulps), with controls
    that skip one rotation or drop the carry at one step, 10x outside; the
    fold kernels (``knn.cu`` and ``weight.cu`` with FOLD) against their
    plain versions on one rank's shapes, their SASS per pair, and their
    CUDA-event times;
38. the LM scaffold's serving path (``repro_torch.launch.serve``), after
    ``torch.cuda.empty_cache()``: minitron-4b and qwen3-moe-30b-a3b at full
    published width and depth, random bf16 weights made leaf by leaf on the
    card, batch 4, prompt 128, 32 generated tokens through the launcher's
    loop (a first call, then a warm one): prefill ms, decode ms a step,
    tok/s and peak memory; the tokens in the vocabulary, the logits finite,
    prefill-then-decode at T against the full forward on T + 1 tokens at
    full depth and on the first two layers (qwen3-moe at a dropless
    capacity, each layer's expert choice pinned to the full forward's),
    with a zeroed cache and a decode one position early as controls, and
    the first two layers card against the port's CPU path on the same
    weights and tokens (batch 2, 16 tokens); then the other five ported archs at ``smoke``
    widths, prefill and three serve steps card against CPU.  The phase adds
    no kernel: the scaffold has no Pallas kernel to port.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA card,
or without the repository beside it, it exits nonzero and prints no result.
"""

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "fixtures" / "aidw_golden.npz"
GOLDEN_RTOL, GOLDEN_ATOL = 5e-4, 5e-5  # tests/test_golden.py
FP_SLACK_ULPS = 64                     # src/repro_torch/core/accuracy.py: fp slack per sqrt(m)
M_FULL = 1 << 20                       # aidw-pod-1m: the paper's 1000K rounded to 2^20
SERVING = [(65536, 1), (65536, 2), (65536, 3), (M_FULL, 4)]  # (queries, seed)
N_SAMPLE = 1024                        # queries per batch held against the f64 reference
N_CHECK = 2048                         # queries of the shared-row kernel checks
# phase 34: the serving plans assume this many queries a cell (the reference
# tests' deliberately undersized capacity), and after the re-plan's join the
# storm serves this many more batches
SERVE_QO = 64.0
POST_BATCHES = 3
# B6, and B4/B5 in float64, against their plain versions: the same terms
# (precise exp/log on both sides) summed in the same order
# (kernels/_common.py: run_sum), so the sums differ only where the card's
# exp/log in the kernel and in PyTorch give a term other last bits.  Float32
# B4/B5 take their weights from the special-function units and are held to
# a per-query tolerance instead (kernels/_common.py: sfu_sum_tolerance).
SUM_ULPS = 8
N_BLOCKS = 64                          # blocks of each far-field serving batch held against plain

# H100 SXM (NVIDIA data sheet), non-tensor-core, at 132 SMs and 1.98 GHz:
# operations at one lane slot each, 128 FP32 or 64 FP64 lanes per SM and
# clock.  The published 67 (34) TFLOP/s count an FMA as two flops; the
# kernels' counted operations (the _rn sub, mul and add of d^2 and the
# weights, compares, mins) never fuse into an FMA, so each takes a slot.
PEAK_OPS = {"float32": 132 * 128 * 1.98e9, "float64": 132 * 64 * 1.98e9}
PEAK_BYTES = 3.35e12
# special-function units: 16 results per SM per clock, 132 SMs, 1.98 GHz boost
PEAK_SFU = 132 * 16 * 1.98e9
# what a float32 weight pair needs of them: one log2 and one exp2 (the
# float64 weights take precise exp/log on the FP64 pipes)
MUFU_PER_PAIR = 2
# instruction issue: 4 warp schedulers x 32 threads per SM per clock
PEAK_ISSUE = 132 * 128 * 1.98e9
# a float32 pair of the quadtree sweep (B6) on the special-function units:
# pow_weight's log2 and exp2, and the reciprocal of the dipole's gradient
FAR_NODE_MUFU = {"MUFU.EX2": 1.0, "MUFU.LG2": 1.0, "MUFU.RCP": 1.0}
# the same pair's operations on the FP32 pipes, counted from far_node.cu's
# loop: d^2 5 (2 sub, 2 mul, add), the clamp, the exponent's mul, grad 2
# muls, the dipole 4 (2 muls, add, mul), the count's mul and add, z_sum's
# mul and 2 adds
FAR_NODE_OPS = 18

# the binned prefilter's error envelope against the reference, from
# tests/kernels/test_aidw_variants.py: mean and max relative z error, and
# the share of queries whose alpha moves by more than ALPHA_SHIFT
BINNED_MEAN, BINNED_MAX, ALPHA_SHIFT, ALPHA_SHIFT_SHARE = 1e-4, 2e-2, 0.05, 0.02

# phase 37: the ranks that share the card, their mesh, the rings' fold tile
# (core/distributed.py's default d_chunk), the queries of each slab that the
# single-process replays take, and the runs: name -> (function, axis_names,
# dtype, queries; None: the whole serving batch)
RING_RANKS, RING_MESH, RING_DIMS = 4, (2, 2), ("data", "model")
RING_TILE, RING_SAMPLE, RING_F64_QUERIES = 2048, 256, 8192
RING_TIMEOUT = 300.0  # seconds for the ranks, their start included
RING_RUNS = {
    "ring (data, model)": ("ring_aidw", None, "float32", None),
    "ring (data)": ("ring_aidw", ("data",), "float32", None),
    "ring_q (data, model)": ("ring_aidw_rotate_queries", None, "float32", None),
    "sharded": ("sharded_queries_aidw", None, "float32", None),
    "ring f64 (data, model)": ("ring_aidw", None, "float64", RING_F64_QUERIES),
}

KERNELS = {
    "knn_skip": dict(source="src/repro_torch/kernels/csrc/knn.cu",
                     replaces="src/repro/kernels/aidw_grid.py:168 _knn_kernel_skip"),
    "knn_soa": dict(source="src/repro_torch/kernels/csrc/knn.cu",
                    replaces="src/repro/kernels/aidw_tiled.py:39 _knn_kernel_soa"),
    "weight_soa": dict(source="src/repro_torch/kernels/csrc/weight.cu",
                       replaces="src/repro/kernels/aidw_tiled.py:69 _weight_kernel_soa"),
    "near_weight": dict(source="src/repro_torch/kernels/csrc/near.cu",
                        replaces="src/repro/kernels/aidw_grid.py:257 _near_weight_kernel"),
    "far_cell": dict(source="src/repro_torch/kernels/csrc/far.cu",
                     replaces="src/repro/kernels/aidw_grid.py:328 _far_cell_kernel"),
    "far_node": dict(source="src/repro_torch/kernels/csrc/far_node.cu",
                     replaces="src/repro/kernels/aidw_grid.py:396 _far_node_kernel"),
    "naive_soa": dict(source="src/repro_torch/kernels/csrc/naive.cu",
                      replaces="src/repro/kernels/aidw_naive.py:37 _naive_kernel_soa"),
    "naive_aoas": dict(source="src/repro_torch/kernels/csrc/naive.cu",
                       replaces="src/repro/kernels/aidw_naive.py:52 _naive_kernel_aoas"),
    "knn_aoas": dict(source="src/repro_torch/kernels/csrc/knn.cu",
                     replaces="src/repro/kernels/aidw_tiled.py:136 _knn_kernel_aoas"),
    "weight_aoas": dict(source="src/repro_torch/kernels/csrc/weight.cu",
                        replaces="src/repro/kernels/aidw_tiled.py:154 _weight_kernel_aoas"),
    "knn_binned": dict(source="src/repro_torch/kernels/csrc/knn.cu",
                       replaces="src/repro/kernels/aidw_tiled.py:39 _knn_kernel_soa (nbins > 0)"),
    "fused": dict(source="src/repro_torch/kernels/csrc/fused.cu",
                  replaces="src/repro/kernels/aidw_fused.py:40 _fused_kernel"),
    "knn_v2": dict(source="src/repro_torch/kernels/csrc/knn.cu",
                   replaces="src/repro/kernels/aidw_tiled_v2.py:38 _knn_kernel_v2"),
    "idw": dict(source="src/repro_torch/kernels/csrc/weight.cu",
                replaces="src/repro/kernels/idw_tiled.py:21 _idw_kernel"),
    "knn_fold": dict(source="src/repro_torch/kernels/csrc/knn.cu",
                     replaces="src/repro/core/distributed.py:62 _fold_knn (jnp, no Pallas)"),
    "weight_fold": dict(source="src/repro_torch/kernels/csrc/weight.cu",
                        replaces="src/repro/core/distributed.py:86 _fold_weights (jnp, no Pallas)"),
}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_in_turns(time_ms, runs, reps, rounds=5):
    """CUDA-event ms of each setting's ``run``: the median of ``rounds``
    rounds that time every setting in turn, so that a drift of the card's
    clock or of its neighbours between settings does not decide which one
    is fastest."""
    import statistics

    times = {key: [] for key in runs}
    for _ in range(rounds):
        for key, run in runs.items():
            times[key].append(time_ms(run, reps))
    return {key: statistics.median(t) for key, t in times.items()}


def report(name, err, tol):
    print(f"  {name}: max err {err:.3e} (tolerance {tol:.3e})", flush=True)
    check(err <= tol, f"{name}: {err} > {tol}")


def ulps(k, p, dtype):
    """Largest |kernel - plain| / |plain| over the nonzero plain sums, in
    ulps of ``dtype``."""
    import torch

    k, p = k.double(), p.double()
    nz = p != 0
    return float(((k - p).abs()[nz] / p[nz].abs()).max()) / torch.finfo(dtype).eps if bool(nz.any()) else 0.0


def off_by(k, p, dtype, tol=None):
    """How far a sum ``k`` lies from the plain sum ``p``, in tolerances: the
    largest ``|k - p| / tol`` over the queries (``tolerance_ratio``) for a
    per-query ``tol``, else its ulps over ``SUM_ULPS``.  At most 1 passes."""
    from repro_torch.kernels._common import tolerance_ratio

    return ulps(k, p, dtype) / SUM_ULPS if tol is None else tolerance_ratio(k, p, tol)


def hold(tag, k, pl, dtype, tol=None):
    """A far-field kernel against its plain version on the same inputs: sum
    w and sum w z within SUM_ULPS of each sum (``tol`` None: B6, and B4/B5
    in float64, bitwise in practice) or within the per-query tolerances
    ``tol = (tol_w, tol_wz)`` (float32 B4 and B5, whose weights come from
    the special-function units: ``phase2_near_tolerance``,
    ``phase2_far_tolerance``), and zero where the plain sum is zero; B4's
    min d^2 and hit z bit for bit.  Returns ``(tolerances used, ulps, all
    outputs bitwise equal, min d^2 and hit z equal)``."""
    import torch

    for s_k, s_p in zip(k[:2], pl[:2]):
        check(torch.equal(s_k == 0, s_p == 0), f"{tag}: the same sums are 0")
    e = max(ulps(k[0], pl[0], dtype), ulps(k[1], pl[1], dtype))
    r = max(off_by(k[i], pl[i], dtype, None if tol is None else tol[i]) for i in (0, 1))
    same = e == 0.0 and all(torch.equal(a, b) for a, b in zip(k, pl))
    same_min = len(k) == 2 or (torch.equal(k[2], pl[2]) and torch.equal(k[3], pl[3]))
    check(r <= 1.0 and same_min, f"{tag} matches its plain version ({r} tolerances, {e} ulps)")
    return r, e, same, same_min


def profile_batch(tag, run):
    """Where one batch's device time goes (CUPTI trace): "busy" is the summed
    time of the device's own events (kernels, copies, memsets), not of the
    host-side ops that launched them, over the batch's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.time() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms > 0:
        print(f"  profile {tag}: wall {wall_ms} ms, device busy {busy_ms} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%")
        for e in events[:10]:
            print(f"    {dev_us(e) / 1e3} ms  x{e.count} {e.key[:70]}")
    else:
        print("  profile: the trace shows no device time; device busy share not measured")


def inner_loop_sass(cuobjdump: str, lib: Path, kernel: str, marker: str = "MUFU.EX2", per_pair: int = 1,
                    cold: bool = False, exclude: str = ""):
    """The per-pair loop of ``kernel``'s SASS: the innermost loop with the
    most ``marker`` ops (the shortest of those), ``per_pair`` of them a pair
    (one MUFU.EX2, the exp, in a weight loop; two FMUL, dx^2 and dy^2, in
    the kNN loop), among the loops with no ``exclude`` op (the naive
    kernel's kNN loop: no MUFU.EX2).  With ``cold`` the instructions that a
    forward branch inside the loop jumps over are left out: the kNN loop's
    k-best insertion, run only when a group's minimum beats the k-th best.
    Returns ``(instructions per pair, {opcode: count per pair})``, or
    ``None`` when no such loop is found.
    Also writes the library's SASS beside it as ``<lib>.sass``."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    lib.with_name(lib.name + ".sass").write_text(text)
    func = next((f for f in text.split("Function : ")[1:] if f.startswith(kernel)), "")
    instr = [(int(a, 16), op) for a, op in
             re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)]
    labels = {lab: int(a, 16) for lab, a in re.findall(r"(\.L_x_\d+):\s*\n\s*/\*([0-9a-f]+)\*/", func)}
    branches = []
    for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/[^\n]*?BRA\s+`?\(?(0x[0-9a-f]+|\.L_x_\d+)", func):
        a, t = int(a, 16), labels.get(t) if t.startswith(".") else int(t, 16)
        if t is not None:
            branches.append((a, t))
    spans = {(t, a) for a, t in branches if t <= a}
    inner = [(t, a) for t, a in spans
             if not any((t2, a2) != (t, a) and t <= t2 and a2 <= a for t2, a2 in spans)]

    def is_op(op, name):
        return op == name or op.startswith(name + ".")

    bodies = []
    for t, a in inner:
        skipped = [(b, e) for b, e in branches if cold and t <= b < e <= a]
        bodies.append([op for addr, op in instr
                       if t <= addr <= a and not any(b < addr < e for b, e in skipped)])
    bodies = [b for b in bodies if any(is_op(op, marker) for op in b)
              and not (exclude and any(is_op(op, exclude) for op in b))]
    if not bodies:
        return None
    # among loops with as many marker ops, the shortest: a loop that the
    # compiler unrolled for a remainder carries its exits as well
    body = max(bodies, key=lambda b: (sum(is_op(op, marker) for op in b), -len(b)))
    pairs = sum(is_op(op, marker) for op in body) / per_pair
    return len(body) / pairs, {op: body.count(op) / pairs for op in sorted(set(body))}


def mufu(ops):
    """The special-function-unit ops of an ``inner_loop_sass`` mix."""
    return {op: c for op, c in ops.items() if op.startswith("MUFU")}


def weight_func(aoas=False, const_ah=False, fold=False):
    """Mangled-name prefix of the float32 ``weight_kernel<float, aoas, const_ah, fold>``."""
    return f"_ZN4aidw13weight_kernelIfLb{int(aoas)}ELb{int(const_ah)}ELb{int(fold)}EE"


def knn_func(k, aoas=False, binned=False, vote=False, fold=False):
    """Mangled-name prefix of the float32 ``knn_alpha_kernel<float, k, aoas, binned, vote, fold>``."""
    return f"_ZN4aidw16knn_alpha_kernelIfLi{k}ELb{int(aoas)}ELb{int(binned)}ELb{int(vote)}ELb{int(fold)}EE"


_SASS = {}


def kernel_sass(lib, func, **kw):
    """``inner_loop_sass`` of ``func`` in the built library ``lib``, read once."""
    from repro_torch.kernels import _build

    key = (lib, func, tuple(sorted(kw.items())))
    if key not in _SASS:
        cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
        _SASS[key] = inner_loop_sass(cuobjdump, _build.library_path(lib), func, **kw)
    return _SASS[key]


def far_sass(name, splits=1):
    """The per-pair loop of the float32 near-field (B4), far-cell (B5) or
    quadtree (B6, at S = ``splits`` threads a query) kernel (one MUFU.EX2 a
    pair; B4's first-minimum update, taken only when a group's minimum beats
    the running one, and B6's tile fold, taken once a tile, left out)."""
    lib, func = {"near_weight": ("near", "_ZN4aidw18near_weight_kernelIfEE"),
                 "far_cell": ("far", "_ZN4aidw15far_cell_kernelIfEE"),
                 "far_node": ("far_node", f"_ZN4aidw15far_node_kernelIfLi{splits}EE")}[name]
    return kernel_sass(lib, func, cold=True)


def knn_sass(k, fold=False):
    """The hot kNN loop of ``knn_alpha_kernel<float, k, false, false, false, fold>``
    (two FMUL a pair; the insertion block left out)."""
    return kernel_sass("knn", knn_func(k, fold=fold), marker="FMUL", per_pair=2, cold=True)


def naive_func(k, aoas=False):
    """Mangled-name prefix of the float32 ``naive_kernel<float, k, aoas>``."""
    return f"_ZN4aidw12naive_kernelIfLi{k}ELb{int(aoas)}EEE"


def naive_sass(k, aoas=False):
    """The float32 naive kernel's two loops: ``(kNN loop, weight loop)``; the
    kNN loop is the one with two FMUL a pair and no MUFU (the insertion
    block left out), the weight loop the one with one MUFU.EX2 a pair."""
    knn = kernel_sass("naive", naive_func(k, aoas), marker="FMUL", per_pair=2, cold=True, exclude="MUFU.EX2")
    return knn, kernel_sass("naive", naive_func(k, aoas))


def fused_func(k):
    """Mangled-name prefix of the float32 ``fused_kernel<float, k>``."""
    return f"_ZN4aidw12fused_kernelIfLi{k}EEE"


def fused_sass(k):
    """The float32 fused kernel's two loops, as ``naive_sass`` reads B7's:
    ``(kNN loop, weight loop)``; the kNN loop is the one with two FMUL a
    pair and no MUFU (the insertion block left out), the weight loop the one
    with one MUFU.EX2 a pair."""
    knn = kernel_sass("fused", fused_func(k), marker="FMUL", per_pair=2, cold=True, exclude="MUFU.EX2")
    return knn, kernel_sass("fused", fused_func(k))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir() or not GOLDEN.exists():
        print("chip_smoke: run it from the root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import AIDW_WORKLOADS
    from repro_torch.core.aidw import AIDWParams, aidw_reference
    from repro_torch.core.layouts import coord_sentinel
    from repro_torch.data import clustered_points
    from repro_torch.engine import build_plan, execute, execute_with_stats
    from repro_torch.engine.execute import _grid_layout
    from repro_torch.kernels import _build
    from repro_torch.kernels.aidw_fused import fused_launch
    from repro_torch.kernels.aidw_tiled import (
        knn_alpha,
        knn_alpha_plain,
        knn_launch,
        knn_part,
        knn_stage_points,
        weight_launch,
        weight_sweep,
        weight_sweep_plain,
    )

    dev = torch.device("cuda")
    t_start = time.time()
    eps = {torch.float32: float(np.finfo(np.float32).eps), torch.float64: float(np.finfo(np.float64).eps)}

    def z_tol(dtype, m, z_abs_max):
        # the repo's fp slack for a sum of m terms taken in another order
        return FP_SLACK_ULPS * eps[dtype] * math.sqrt(m) * z_abs_max

    def b2_rtol(dtype):
        # kernel and plain version fold their tile sums at the same tile
        # boundaries, in data order; only the order inside a tile differs,
        # which moves z by a few ulps: 64 ulps of each z
        return FP_SLACK_ULPS * eps[dtype]

    def sync():
        torch.cuda.synchronize()

    def maxerr(a, b):
        return float((a.double() - b.double()).abs().max())

    # ------------------------------------------------------------- 1. build
    print("== 1. build", flush=True)
    t0 = time.time()
    paths = _build.build_all()
    print(f"  built {sorted(p.name for p in paths.values())} in {time.time() - t0:.1f} s")
    # every K-templated kernel is instantiated for each k of AIDW_K_LIST: print
    # the kernels without a k and the k = 7 and k = 10 instances, and a summary
    entries = _build.ptxas_entries()
    for src, name, regs, st, ld in entries:
        if not re.search(r"Li\d+E", name) or re.search(r"Li(7|10)E", name):
            print(f"  ptxas {src}: {name[:72]}: {regs} registers, spill stores {st} B, loads {ld} B")
    print(f"  ptxas: {len(entries)} kernels, at most {max(e[2] for e in entries)} registers, "
          f"{sum(e[3] + e[4] for e in entries)} spill bytes in all")
    # the float32 weight kernel's per-pair loop: its MUFU ops are held to
    # what the function needs (the bounds below take that, not this count)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sass = kernel_sass("weight", weight_func())
    check(sass is not None, "the SASS of weight_kernel<float> has a per-pair loop")
    print(f"  weight_kernel<float> SASS per-pair loop: {sass[0]} instructions per pair, MUFU per pair "
          f"{mufu(sass[1])}")
    check(sum(mufu(sass[1]).values()) <= MUFU_PER_PAIR,
          f"weight_kernel<float> takes at most {MUFU_PER_PAIR} MUFU ops a pair")
    print(f"  {sms} SMs; the 65,536 batch runs {weight_launch(SERVING[0][0], sms)} threads a block")
    # the kNN walk's hot loop (aidw_common.cuh: knn_span, knn_group) at
    # aidw-pod-1m's k: d^2 stays uncontracted (no FFMA) and one 16-byte
    # shared load serves two pairs or more; the insertion, taken only when a
    # group beats the k-th best, is left out of the count
    knn_loop = knn_sass(10)
    check(knn_loop is not None, "the SASS of knn_alpha_kernel<float, 10> has a per-pair loop")
    ffma = sum(c for op, c in knn_loop[1].items() if op.startswith("FFMA"))
    lds = sum(c for op, c in knn_loop[1].items() if op.startswith("LDS"))
    print(f"  knn_alpha_kernel<float, 10> SASS hot loop: {knn_loop[0]} instructions per pair (aim 8 or fewer), "
          f"FFMA {ffma}, LDS {lds} per pair; per pair {knn_loop[1]}")
    check(ffma == 0, "the kNN loop forms no FFMA")
    check(lds <= 0.5, "the kNN loop issues at most one shared load per two pairs")
    print(f"  knn_launch at 65,536 queries: (threads, S) = {knn_launch(SERVING[0][0], sms)}; at {N_CHECK}: "
          f"{knn_launch(N_CHECK, sms)}")
    # the naive kernels (B7 SoA, B8 AoaS): both loops read global memory and
    # no shared memory; SoA fetches a kNN group and a weight group with
    # 16-byte vector loads (x, y: 4 LDG.128 for 8 pairs; x, y, z: 3 for 4)
    for aoas in (False, True):
        tag = f"naive_kernel<float, 10, {'AoaS' if aoas else 'SoA'}>"
        for what, loop in zip(("kNN", "weight"), naive_sass(10, aoas)):
            check(loop is not None, f"the SASS of {tag} has a {what} loop")
            ldg = {op: c for op, c in loop[1].items() if op.startswith("LDG")}
            shared = {op: c for op, c in loop[1].items() if op.startswith(("LDS", "STS"))}
            print(f"  {tag} SASS {what} loop: {loop[0]} instructions per pair, LDG {ldg}, MUFU {mufu(loop[1])}, "
                  f"FFMA {sum(c for op, c in loop[1].items() if op.startswith('FFMA'))}; per pair {loop[1]}")
            check(ldg and not shared, f"{tag}'s {what} loop reads global memory and no shared memory")
            if not aoas:
                check(all(".128" in op for op in ldg), f"{tag}'s {what} loop loads 16-byte vectors")
    # the fused kernel (B11): its kNN loop is knn.cu's (no FFMA, one 16-byte
    # shared load per two pairs or fewer), its weight loop weight.cu's (at
    # most the two MUFU ops a pair the function needs, one LDS.128 a point)
    b11_knn, b11_weight = fused_sass(10)
    tag = "fused_kernel<float, 10>"
    check(b11_knn is not None and b11_weight is not None, f"the SASS of {tag} has a kNN loop and a weight loop")
    ffma = sum(c for op, c in b11_knn[1].items() if op.startswith("FFMA"))
    lds = sum(c for op, c in b11_knn[1].items() if op.startswith("LDS"))
    print(f"  {tag} SASS kNN loop: {b11_knn[0]} instructions per pair, FFMA {ffma}, LDS {lds} per pair; "
          f"per pair {b11_knn[1]}")
    check(ffma == 0 and lds <= 0.5, f"{tag}'s kNN loop forms no FFMA and issues at most one shared load per two pairs")
    lds = {op: c for op, c in b11_weight[1].items() if op.startswith("LDS")}
    print(f"  {tag} SASS weight loop: {b11_weight[0]} instructions per pair, MUFU per pair {mufu(b11_weight[1])}, "
          f"LDS {lds}; per pair {b11_weight[1]}")
    check(sum(mufu(b11_weight[1]).values()) <= MUFU_PER_PAIR and set(lds) == {"LDS.128"} and lds["LDS.128"] <= 1,
          f"{tag}'s weight loop takes at most {MUFU_PER_PAIR} MUFU ops a pair and one LDS.128 a point")
    print(f"  fused_launch at 65,536 queries: (threads, S) = "
          f"{fused_launch(SERVING[0][0], sms, 512, torch.float32)}; at {N_CHECK}: "
          f"{fused_launch(N_CHECK, sms, 512, torch.float32)}")
    # the near and far-cell sweeps (B4, B5): one MUFU.LG2 and one MUFU.EX2 a
    # pair (pow_weight), and none of precise expf/logf's FFMA polynomials
    for kname in ("near_weight", "far_cell"):
        loop = far_sass(kname)
        check(loop is not None, f"the SASS of the float32 {kname} kernel has a per-pair loop")
        ffma = sum(c for op, c in loop[1].items() if op.startswith("FFMA"))
        print(f"  {kname} kernel<float> SASS per-pair loop: {loop[0]} instructions per pair, MUFU per pair "
              f"{mufu(loop[1])}, FFMA {ffma}, LDS {sum(c for op, c in loop[1].items() if op.startswith('LDS'))}; "
              f"per pair {loop[1]}")
        check(mufu(loop[1]) == {"MUFU.EX2": 1.0, "MUFU.LG2": 1.0} and ffma == 0,
              f"the {kname} loop takes one MUFU.LG2 and one MUFU.EX2 a pair and no FFMA")
    # the quadtree sweep (B6): pow_weight's MUFU.LG2 and MUFU.EX2 and the
    # dipole's MUFU.RCP a pair, no FFMA, one LDS.128 and one LDS.64
    for splits in (1, 4):
        loop = far_sass("far_node", splits)
        check(loop is not None, f"the SASS of far_node_kernel<float, {splits}> has a per-pair loop")
        ffma = sum(c for op, c in loop[1].items() if op.startswith("FFMA"))
        lds = {op: c for op, c in loop[1].items() if op.startswith("LDS")}
        print(f"  far_node_kernel<float, {splits}> SASS per-pair loop: {loop[0]} instructions per pair, MUFU per "
              f"pair {mufu(loop[1])}, FFMA {ffma}, LDS {lds}; per pair {loop[1]}")
        check(mufu(loop[1]) == FAR_NODE_MUFU and ffma == 0,
              f"the far_node loop (S = {splits}) takes one MUFU.LG2, MUFU.EX2 and MUFU.RCP a pair and no FFMA")

    wl = AIDW_WORKLOADS["aidw-pod-1m"]
    check(wl.m == M_FULL and wl.n == M_FULL and wl.k == 10, "aidw-pod-1m is m = n = 2^20, k = 10")
    params = AIDWParams(k=wl.k, area=1.0)
    dx_np, dy_np, dz_np = clustered_points(M_FULL, seed=0)

    def queries(n, seed, dtype=torch.float32):
        rng = np.random.default_rng(seed)
        return tuple(torch.as_tensor(rng.random(n).astype(np.float32)).to(dev, dtype) for _ in range(2))

    def data(dtype):
        return tuple(torch.as_tensor(a).to(dev, dtype) for a in (dx_np, dy_np, dz_np))

    # ---------------------------------------------------- 2. kernels vs plain
    print("== 2. kernels vs their plain versions (m = 2^20)", flush=True)
    errs = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[1]
        dx, dy, dz = data(dtype)
        zmax = float(dz.abs().max())
        qx, qy = queries(SERVING[0][0], SERVING[0][1], dtype)
        qxc, qyc = qx[:N_CHECK].contiguous(), qy[:N_CHECK].contiguous()
        kw = dict(params=params, area=1.0, m_real=M_FULL)
        a_k = knn_alpha(qxc, qyc, dx[None], dy[None], block_q=256, tile_d=512, **kw)
        a_p = knn_alpha_plain(qxc, qyc, dx[None], dy[None], block_q=256, tile_d=512, **kw)
        split = knn_launch(N_CHECK, sms)
        print(f"  B1 shared row {name} ({split[1]} threads a query, {split[0]} a block): bitwise equal to plain "
              f"{torch.equal(a_k, a_p)} (max err {maxerr(a_k, a_p):.3e})")
        check(torch.equal(a_k, a_p), f"B1 shared row {name} equals its plain version exactly")
        # the control: the plain version without the last of four parts of
        # every stage (what a walk that lost a split part would see)
        stage = knn_stage_points(dtype)
        pos = torch.arange(dx.shape[0], device=dev) % stage
        lo, hi = knn_part(stage, 4, 3)
        lost = (pos >= lo) & (pos < hi)
        sent = coord_sentinel(dtype, dev)
        a_lost = knn_alpha_plain(qxc, qyc, torch.where(lost, sent, dx)[None], torch.where(lost, sent, dy)[None],
                                 block_q=256, tile_d=512, **kw)
        moved = int((a_lost != a_p).sum())
        print(f"  B1 {name} control: a walk without part 4 of 4 of every {stage}-point stage moves {moved} of "
              f"{N_CHECK} alphas")
        check(moved > 0, "the bitwise B1 check catches a lost split part")
        z_k = weight_sweep(qxc, qyc, a_k * 0.5, dx, dy, dz, tile_d=512, eps=params.exact_hit_eps)
        z_p = weight_sweep_plain(qxc, qyc, a_k * 0.5, dx, dy, dz, tile_d=512, eps=params.exact_hit_eps)
        e_b2 = maxerr(z_k, z_p)
        print(f"  B2 {name}: max abs err {e_b2:.3e}")
        report(f"B2 {name} relative", float(((z_k - z_p) / z_p).abs().max()), b2_rtol(dtype))
        # the tolerance is tight enough to see a sweep that loses one tile
        gone = torch.zeros_like(dx, dtype=torch.bool)
        gone[:512] = True
        z_gone = weight_sweep_plain(qxc, qyc, a_k * 0.5, torch.where(gone, sent, dx), torch.where(gone, sent, dy),
                                    dz, tile_d=512, eps=params.exact_hit_eps)
        e_gone = float(((z_gone - z_p) / z_p).abs().max())
        print(f"  B2 {name}: a sweep without its first tile is off by {e_gone:.3e} relative")
        check(e_gone > b2_rtol(dtype), "the B2 tolerance catches a lost tile")
        # a plan tile larger than a 32 KiB stage: one tile a stage, in
        # dynamic shared memory past 48 KiB (64 KiB in float32, 128 KiB in
        # float64).  A sequential sum's rounding bound grows with its length,
        # (n - 1) u sum|x|, so the 64 ulps set for 512-point tiles scale by
        # 4096 / 512; a sweep that loses 512 points stays outside it
        big = 4096
        tol_big = b2_rtol(dtype) * big / 512
        z_big = weight_sweep(qxc, qyc, a_k * 0.5, dx, dy, dz, tile_d=big, eps=params.exact_hit_eps)
        z_big_p = weight_sweep_plain(qxc, qyc, a_k * 0.5, dx, dy, dz, tile_d=big, eps=params.exact_hit_eps)
        e_big = float(((z_big - z_big_p) / z_big_p).abs().max())
        report(f"B2 {name} with tile_d {big} relative", e_big, tol_big)
        check(e_gone > tol_big, "the large-tile tolerance catches a sweep that loses 512 points")
        # its own control: the kernel at that tile without its first tile
        lost = torch.zeros_like(dx, dtype=torch.bool)
        lost[:big] = True
        z_lost = weight_sweep(qxc, qyc, a_k * 0.5, torch.where(lost, sent, dx), torch.where(lost, sent, dy), dz,
                              tile_d=big, eps=params.exact_hit_eps)
        e_lost = float(((z_lost - z_big_p) / z_big_p).abs().max())
        print(f"  B2 {name} with tile_d {big}: sound {e_big:.3e}, limit {tol_big:.3e}, "
              f"without its first tile {e_lost:.3e} relative")
        check(e_lost > tol_big, f"the tile_d {big} tolerance catches the kernel losing its first tile")

        plan = build_plan(dx, dy, dz, params=params, area=1.0, impl="grid")
        lay = _grid_layout(plan, qx, qy)
        full = plan.cand_capacity // plan.cand_block_d
        check(bool((lay.num_tiles < full).any()), "some blocks walk fewer tiles than the capacity")
        rows = dict(block_q=plan.block_q, tile_d=plan.cand_block_d, **kw)
        a3 = knn_alpha(lay.qx_v, lay.qy_v, lay.cand_x, lay.cand_y, num_tiles=lay.num_tiles, **rows)
        a3_p = knn_alpha_plain(lay.qx_v, lay.qy_v, lay.cand_x, lay.cand_y, num_tiles=lay.num_tiles, **rows)
        a1 = knn_alpha(lay.qx_v, lay.qy_v, lay.cand_x, lay.cand_y, **rows)
        a1_p = knn_alpha_plain(lay.qx_v, lay.qy_v, lay.cand_x, lay.cand_y, **rows)
        sync()
        cut = int((lay.num_tiles < full).sum())
        for tag, a_k, a_p in ((f"B3 tile table {name} ({cut} of {lay.num_tiles.shape[0]} rows walk < {full} tiles)",
                               a3, a3_p), (f"B1 candidate rows {name}", a1, a1_p)):
            print(f"  {tag}: bitwise equal to plain {torch.equal(a_k, a_p)} (max err {maxerr(a_k, a_p):.3e})")
            check(torch.equal(a_k, a_p), f"{tag} equals its plain version exactly")
        check(torch.equal(a3, a1), f"B3 alpha bitwise equal to B1-dense alpha ({name})")
        print(f"  B3 == B1-dense bitwise ({name}): True")
        if dtype == torch.float32:
            errs = {"knn_skip": maxerr(a3, a3_p), "knn_soa": maxerr(a1, a1_p), "weight_soa": e_b2}
        del plan, lay, a3, a3_p, a1, a1_p

    # ------------------------------------------------------------- 3. golden
    print("== 3. golden fixture", flush=True)
    with np.load(GOLDEN) as blob:
        golden = {k: blob[k] for k in blob.files}
    gp = AIDWParams(k=int(golden["k"]), area=float(golden["area"]))
    for dtype in (torch.float32, torch.float64):
        for batch in ("uniform", "clustered"):
            arr = [torch.as_tensor(golden[f"{batch}_{n}"]).to(dev, dtype) for n in ("dx", "dy", "dz", "qx", "qy")]
            for impl, pipeline in (("grid", "prefetch"), ("grid", "dense"), ("tiled", "prefetch")):
                plan = build_plan(*arr[:3], params=gp, area=gp.area, impl=impl, pipeline=pipeline,
                                  block_q=64, block_d=128)
                z, a = execute(plan, arr[3], arr[4])
                ez = np.abs(z.cpu().double().numpy() - golden[f"{batch}_z"])
                ea = np.abs(a.cpu().double().numpy() - golden[f"{batch}_alpha"])
                tz = GOLDEN_ATOL + GOLDEN_RTOL * np.abs(golden[f"{batch}_z"])
                ta = GOLDEN_ATOL + GOLDEN_RTOL * np.abs(golden[f"{batch}_alpha"])
                tag = f"{impl}/{pipeline} {batch} {str(dtype).split('.')[1]}"
                print(f"  {tag}: max |dz| {ez.max():.3e}, max |dalpha| {ea.max():.3e}")
                check(bool((ez <= tz).all() and (ea <= ta).all()), f"golden {tag}")

    # ------------------------------------------------ 4. determinism, hardening
    print("== 4. determinism and hardening", flush=True)
    dx, dy, dz = data(torch.float32)
    plan = build_plan(dx, dy, dz, params=params, area=1.0, impl="grid")
    qx, qy = queries(*SERVING[0])
    z1, a1 = execute(plan, qx, qy)
    z2, a2 = execute(plan, qx, qy)
    check(torch.equal(z1, z2) and torch.equal(a1, a2), "two runs of one batch give the same bits")
    print("  run-to-run bitwise equal: True")
    hx, hy = qx[:4096].clone(), qy[:4096].clone()
    hx[3], hy[7], hx[11], hy[12], hx[20] = math.nan, math.nan, math.inf, -math.inf, math.nan
    bad = ~(torch.isfinite(hx) & torch.isfinite(hy))
    zh, ah = execute(plan, hx, hy)
    zd, ad = execute(plan, torch.where(bad, 0.0, hx), torch.where(bad, 0.0, hy))
    check(bool(torch.isnan(zh[bad]).all() and torch.isnan(ah[bad]).all()), "non-finite queries give NaN")
    check(torch.equal(zh[~bad], zd[~bad]) and torch.equal(ah[~bad], ad[~bad]),
          "finite queries unchanged bit for bit")
    print(f"  {int(bad.sum())} non-finite queries -> NaN; finite slots bitwise unchanged: True")
    # a query's B2 bits do not depend on the batch: the whole 65,536 batch
    # against slices of it, which take another block size
    dxp, dyp, dzp = plan.data
    sweep = dict(tile_d=plan.block_d, eps=params.exact_hit_eps)
    whole = weight_sweep(qx, qy, a1 * 0.5, dxp, dyp, dzp, **sweep)
    for lo, hi in ((0, 256), (1000, 1256), (0, 8192)):
        part = weight_sweep(qx[lo:hi].contiguous(), qy[lo:hi].contiguous(), (a1[lo:hi] * 0.5).contiguous(), dxp,
                            dyp, dzp, **sweep)
        same = torch.equal(part, whole[lo:hi])
        print(f"  B2 on queries {lo}:{hi} ({weight_launch(hi - lo, sms)} threads) vs the whole batch "
              f"({weight_launch(qx.shape[0], sms)} threads): bitwise equal {same}")
        check(same, f"B2 on queries {lo}:{hi} gives the whole batch's bits")
    check(torch.equal(whole, z1), "B2 on the batch gives the path's z")
    del plan, z1, z2, a1, a2, whole

    # ---------------------------------------------------- 5. serving run
    print("== 5. serving run: aidw-pod-1m, clustered m = 2^20, k = 10, float32", flush=True)

    def f64_check(tag, qx, qy, z, a, seed):
        idx = torch.as_tensor(np.random.default_rng(seed).choice(qx.shape[0], N_SAMPLE, replace=False),
                              device=dev)
        d64 = [t.double() for t in (dx, dy, dz)]
        zr, ar = [], []
        for part in idx.split(128):
            zz, aa = aidw_reference(*d64, qx[part].double(), qy[part].double(), params, area=1.0)
            zr.append(zz)
            ar.append(aa)
        zr = torch.cat(zr)
        ez, ea = maxerr(z[idx], zr), maxerr(a[idx], torch.cat(ar))
        report(f"{tag} z vs f64 reference", ez, z_tol(torch.float32, M_FULL, float(dz.abs().max())))
        report(f"{tag} alpha vs f64 reference", ea, 1e-5)
        return idx, zr, ez

    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.time()
    plan = build_plan(dx, dy, dz, params=params, area=1.0, impl="grid")
    sync()
    plan_s = time.time() - t0
    print(f"  plan build {plan_s} s: grid {plan.grid.gx}x{plan.grid.gy}, cand_capacity "
          f"{plan.cand_capacity}, cand_block_d {plan.cand_block_d}, seam_level {plan.seam_level}, "
          f"rebuilds {plan.grid_rebuilds}")
    batches = [queries(n, seed) for n, seed in SERVING]
    sync()
    _build.reset_launch_counts()
    results = []
    for (n, seed), (qx, qy) in zip(SERVING, batches):
        sync()
        t0 = time.time()
        z, a, stats = execute_with_stats(plan, qx, qy)
        sync()
        wall = time.time() - t0
        results.append((z, a, stats, wall))
        print(f"  batch n={n} seed={seed}: {wall} s, {n / wall} queries/s, overflow_queries "
              f"{int(stats['overflow_queries'])}, skipped_tile_fraction "
              f"{float(stats['skipped_tile_fraction'])}, cand_need_max {int(stats['cand_need_max'])}",
              flush=True)
    main_launches = dict(_build.LAUNCHES)
    print(f"  launches on the main path: {main_launches}")
    check(main_launches["knn_skip"] > 0 and main_launches["weight_soa"] > 0,
          "the main path launched B3 and B2")
    print(f"  max memory allocated {torch.cuda.max_memory_allocated()} bytes")
    dxp, dyp, dzp = plan.data
    for (n, seed), (qx, qy), (z, a, _, _) in zip(SERVING, batches, results):
        check(bool(torch.isfinite(z).all() and torch.isfinite(a).all()) and z.shape == (n,),
              f"finite outputs of shape ({n},)")
        idx, zr, ez = f64_check(f"batch n={n} seed={seed}", qx, qy, z, a, seed)
        # the same sampled queries through B2's plain version on the path's
        # alpha: the kernel's f32 weights (lg2/ex2 on the special-function
        # units) may cost no more than rounding-level noise against it
        z_pl = weight_sweep_plain(qx[idx], qy[idx], a[idx] * 0.5, dxp, dyp, dzp, tile_d=plan.block_d,
                                  eps=params.exact_hit_eps)
        ez_pl = maxerr(z_pl, zr)
        print(f"  batch n={n} seed={seed}: z vs f64 reference, kernel {ez:.3e}, plain version {ez_pl:.3e} "
              f"(ratio {ez / ez_pl if ez_pl else math.inf:.3f}, limit 2)", flush=True)
        check(ez <= 2 * ez_pl, f"batch n={n}: the kernel's z error within 2x its plain version's")

    # where one serving batch's device time goes
    qx, qy = batches[0]
    profile_batch(f"n={qx.shape[0]}", lambda: execute_with_stats(plan, qx, qy))

    path_launches = {"grid/prefetch": main_launches}
    plan_t = build_plan(dx, dy, dz, params=params, area=1.0, impl="tiled")
    for tag, p in (("grid/dense", dataclasses.replace(plan, pipeline="dense")), ("tiled", plan_t)):
        sync()
        _build.reset_launch_counts()
        t0 = time.time()
        z, a = execute(p, qx, qy)
        sync()
        wall = time.time() - t0
        path_launches[tag] = dict(_build.LAUNCHES)
        print(f"  {tag} n={qx.shape[0]}: {wall} s, launches {path_launches[tag]}")
        check(path_launches[tag]["knn_soa"] > 0 and path_launches[tag]["weight_soa"] > 0,
              f"{tag} launched B1 and B2")
        if tag == "grid/dense":
            check(torch.equal(z, results[0][0]) and torch.equal(a, results[0][1]),
                  "dense pipeline gives the prefetch pipeline's bits")
            print("  dense == prefetch bitwise: True")
        else:
            f64_check("tiled", qx, qy, z, a, SERVING[0][1])

    # ------------------------------------------------------------ 6. timings
    print("== 6. kernel timings (CUDA events, serving batch n=65536, m=2^20)", flush=True)

    def time_ms(fn, reps, warmup=1):
        for _ in range(warmup):
            fn()
        sync()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    lay = _grid_layout(plan, qx, qy)
    ah_s = torch.full_like(lay.qx_s, 1.0)  # the sweep's cost does not depend on alpha
    kw = dict(params=params, area=1.0, m_real=M_FULL)
    rows = dict(block_q=plan.block_q, tile_d=plan.cand_block_d, **kw)
    dxp, dyp, dzp = plan.data
    calls = {
        "knn_skip": (lambda: knn_alpha(lay.qx_v, lay.qy_v, lay.cand_x, lay.cand_y, num_tiles=lay.num_tiles, **rows),
                     lambda: knn_alpha_plain(lay.qx_v, lay.qy_v, lay.cand_x, lay.cand_y,
                                             num_tiles=lay.num_tiles, **rows), 20),
        "knn_soa": (lambda: knn_alpha(lay.qx_v, lay.qy_v, lay.cand_x, lay.cand_y, **rows),
                    lambda: knn_alpha_plain(lay.qx_v, lay.qy_v, lay.cand_x, lay.cand_y, **rows), 20),
        "weight_soa": (lambda: weight_sweep(lay.qx_s, lay.qy_s, ah_s, dxp, dyp, dzp, tile_d=plan.block_d,
                                            eps=params.exact_hit_eps),
                       lambda: weight_sweep_plain(lay.qx_s, lay.qy_s, ah_s, dxp, dyp, dzp,
                                                  tile_d=plan.block_d, eps=params.exact_hit_eps), 3),
    }
    n_v = lay.qx_v.shape[0]
    # what these inputs need: each block's nt[i] tiles of its row; the dense
    # walk (B1) merges the same candidates, its tail past nt[i] is sentinel
    cand_pairs = plan.block_q * int(lay.num_tiles.long().sum()) * plan.cand_block_d
    cand_bytes = 2 * 4 * int(lay.num_tiles.long().sum()) * plan.cand_block_d + 3 * 4 * n_v
    pairs = {"knn_skip": cand_pairs, "knn_soa": cand_pairs, "weight_soa": lay.qx_s.shape[0] * dxp.shape[0]}
    row_bytes = {"knn_skip": cand_bytes, "knn_soa": cand_bytes,
                 "weight_soa": 3 * 4 * dxp.shape[0] + 4 * 4 * lay.qx_s.shape[0]}
    # operations per pair, counted from the kernels' code: kNN 2 sub, 2 mul,
    # 1 add, 1 compare; weight the same 5 for d^2, max, mul, 2 adds, mul,
    # compare, and exp and log counted as one operation each
    ops_pair = {"knn_skip": 6, "knn_soa": 6, "weight_soa": 13}

    def bound(n_pairs, n_bytes, ops, dtype="float32", sfu_ops=0):
        # the larger of the bytes over the memory rate and the operations
        # over their rate: n_pairs * ops on the FP32 (FP64) pipes, one lane
        # slot each (PEAK_OPS, not the FMA-counting 67 TFLOP/s), sfu_ops
        # MUFU ops (MUFU_PER_PAIR a float32 weight pair) on the
        # special-function units
        t_ops = max(n_pairs * ops / PEAK_OPS[dtype], sfu_ops / PEAK_SFU)
        t_bytes = n_bytes / PEAK_BYTES
        return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    sfu = {"weight_soa": pairs["weight_soa"] * MUFU_PER_PAIR}
    rows_out = []
    for name, (kern, plain, reps) in calls.items():
        ms = time_ms(kern, reps)
        plain_ms = time_ms(plain, 1, warmup=0)
        bound_ms, bound_by = bound(pairs[name], row_bytes[name], ops_pair[name], sfu_ops=sfu.get(name, 0))
        launches = path_launches["grid/dense" if name == "knn_soa" else "grid/prefetch"][name]
        rows_out.append(dict(name=name, route="cuda", **KERNELS[name], launches=launches,
                             max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None))
        if name.startswith("knn"):
            rows_out[-1].update(zip(("threads", "splits"), knn_launch(n_v, sms, block_q=plan.block_q)))
        print(f"  {name}: {ms} ms (plain {plain_ms} ms, bound {bound_ms} ms, {pairs[name]} pairs)",
              flush=True)
    p2 = pairs["weight_soa"]
    print(f"  weight_soa beside its bound: operations {1e3 * p2 * ops_pair['weight_soa'] / PEAK_OPS['float32']} ms "
          f"({ops_pair['weight_soa']} a pair); MUFU {1e3 * p2 * MUFU_PER_PAIR / PEAK_SFU} ms "
          f"({MUFU_PER_PAIR} per pair at 16/SM/clock); instruction issue {1e3 * p2 * sass[0] / PEAK_ISSUE} "
          f"ms ({sass[0]} SASS instructions per pair at 128/SM/clock)")

    # B1 on the `tiled` impl's shared data row: every query walks all m points
    qx_t, qy_t = qx.contiguous(), qy.contiguous()
    dxt, dyt, _ = plan_t.data
    shared = dict(block_q=plan_t.block_q, tile_d=plan_t.block_d, **kw)
    ms = time_ms(lambda: knn_alpha(qx_t, qy_t, dxt[None], dyt[None], **shared), 3)
    plain_ms = time_ms(lambda: knn_alpha_plain(qx_t, qy_t, dxt[None], dyt[None], **shared), 1, warmup=0)
    sh_pairs = qx_t.shape[0] * M_FULL
    bound_ms, bound_by = bound(sh_pairs, 2 * 4 * M_FULL + 3 * 4 * qx_t.shape[0], ops_pair["knn_soa"])
    print(f"  knn_soa shared row (tiled): {ms} ms (plain {plain_ms} ms, bound {bound_ms} ms by {bound_by}, "
          f"{sh_pairs} pairs, (threads, S) {knn_launch(qx_t.shape[0], sms, block_q=plan_t.block_q)})", flush=True)
    next(r for r in rows_out if r["name"] == "knn_soa").update(shared_row_ms=ms, shared_row_bound_ms=bound_ms)
    ff_rows, ff_walls = farfield_phases(
        dev=dev, params=params, golden=golden, eps=eps, data=data, queries=queries, sync=sync,
        maxerr=maxerr, time_ms=time_ms, bound=bound, batches=batches, results=results,
        exact_b2_ms=next(r["ms"] for r in rows_out if r["name"] == "weight_soa"))
    rows_out += ff_rows
    rows_out += quadtree_phases(
        dev=dev, params=params, golden=golden, data=data, queries=queries, sync=sync, maxerr=maxerr,
        time_ms=time_ms, bound=bound, batches=batches, results=results, ff_walls=ff_walls)
    del plan, plan_t, lay, batches, results
    rows_out += dense_phases(
        dev=dev, params=params, golden=golden, eps=eps, data=data, queries=queries, sync=sync, maxerr=maxerr,
        time_ms=time_ms, bound=bound, z_tol=z_tol, b2_rtol=b2_rtol,
        phase6_ms={r["name"]: r["ms"] for r in rows_out if r["name"] == "weight_soa"} | {"knn_soa_row": ms})
    rows_out += fused_v2_idw_phases(
        dev=dev, params=params, golden=golden, data=data, queries=queries, sync=sync, maxerr=maxerr,
        time_ms=time_ms, bound=bound, z_tol=z_tol, b2_rtol=b2_rtol)
    weight_shape_phase(params=params, data=data, queries=queries, time_ms=time_ms)
    knn_shape_phase(params=params, data=data, queries=queries, time_ms=time_ms)
    row_shape_phase(params=params, data=data, queries=queries, time_ms=time_ms)
    far_node_shape_phase(params=params, data=data, queries=queries, time_ms=time_ms)
    serving_phase(dev=dev, params=params, data=data, queries=queries, sync=sync, maxerr=maxerr, time_ms=time_ms,
                  z_tol=z_tol)
    naive_shape_phase(params=params, data=data, queries=queries, time_ms=time_ms)
    fused_shape_phase(params=params, data=data, queries=queries, time_ms=time_ms)
    rows_out += ring_phase(dev=dev, params=params, data=data, queries=queries, time_ms=time_ms, bound=bound,
                           b2_rtol=b2_rtol, maxerr=maxerr)
    lm_phase(dev=dev)
    print(f"  total {time.time() - t_start:.1f} s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def farfield_phases(*, dev, params, golden, eps, data, queries, sync, maxerr, time_ms, bound, batches,
                    results, exact_b2_ms):
    """Phases 7-12: the far-field Phase 2 (``phase2="farfield"``) on the card,
    with main's data, helpers, and the exact path's serving batches, their
    results and B2's time.  Returns the B4 and B5 rows of the kernels line
    and the far-field serving batches' wall times."""
    import torch

    from repro_torch.core.accuracy import aidw_interpolate_kahan, farfield_error_report
    from repro_torch.core.aidw import AIDWParams
    from repro_torch.core.grid import build_grid
    from repro_torch.core.layouts import coord_sentinel
    from repro_torch.engine import build_plan, execute, execute_with_stats
    from repro_torch.engine.execute import _grid_layout, _near_field
    from repro_torch.errors import UnprovableRtolWarning
    from repro_torch.kernels import _build
    from repro_torch.kernels._common import EPS32, SUM_RUN, pow_weight, sfu_weight_eps, sq_dist_tile
    from repro_torch.kernels.aidw_grid import (
        phase1_alpha_from_candidates,
        phase2_far_aggregates,
        phase2_far_aggregates_plain,
        phase2_far_tolerance,
        phase2_near_tolerance,
        phase2_near_weights,
        phase2_near_weights_plain,
    )

    f32, f64 = torch.float32, torch.float64
    hit_eps = params.exact_hit_eps

    def ff_plan(dx, dy, dz, device=None):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            p = build_plan(dx, dy, dz, params=params, area=1.0, impl="grid", phase2="farfield", device=device)
        return p, [str(w.message) for w in rec if issubclass(w.category, UnprovableRtolWarning)]

    def ff_inputs(p, qx, qy):
        # the kernels' inputs as the engine makes them, alpha from Phase 1
        lay = _grid_layout(p, qx, qy)
        near = _near_field(p, lay.cx_v, lay.cy_v)
        alpha = phase1_alpha_from_candidates(lay.qx_v, lay.qy_v, lay.cand_x, lay.cand_y, params=params,
                                             area=1.0, m_real=M_FULL, block_q=p.block_q,
                                             block_d=p.cand_block_d, num_tiles=lay.num_tiles)
        return lay, near, alpha * 0.5

    def z_of(sw_n, swz_n, md_n, hz_n, sw_f, swz_f):
        return torch.where(md_n <= hit_eps, hz_n, (swz_n + swz_f) / (sw_n + sw_f))

    def near_of(lay, near, ah, block_q, blocks=None):
        # B4's and B5's arguments (B5's less the plan's cell arrays), for all
        # blocks or for the rows of `blocks`
        qx, qy, rects = lay.qx_v, lay.qy_v, near.rects
        cand = (near.cand_x, near.cand_y, near.cand_z, near.num_tiles)
        if blocks is not None:
            rows = (blocks[:, None] * block_q + torch.arange(block_q, device=dev)).reshape(-1)
            qx, qy, ah, rects = qx[rows], qy[rows], ah[rows], rects[blocks]
            cand = tuple(c[blocks] for c in cand)
        return (qx, qy, ah, *cand), (qx, qy, ah, rects)

    def term_ulps(p, lay, near, ah, blocks, n_pts=256):
        # the per-term error of the kernels' float32 weight (pow_weight: lg2
        # and ex2 on the special-function units) against the plain version's
        # torch.exp(-ah * torch.log(d^2)), pair by pair: B4 on rows that hold
        # one candidate each, so its sum w is that pair's w exactly and its
        # min d^2 the pair's d^2.  The pairs: each sampled block's queries
        # with the first n_pts candidates of its row, and every query of the
        # batch with its nearest candidate (the largest |t|), one row a query
        bq, nb = p.block_q, near.cand_x.shape[0]
        nearest = torch.cat([sq_dist_tile(lay.qx_v[i * bq:(i + 8) * bq].reshape(-1, bq, 1),
                                          lay.qy_v[i * bq:(i + 8) * bq].reshape(-1, bq, 1),
                                          near.cand_x[i:i + 8, None], near.cand_y[i:i + 8, None]).argmin(dim=2)
                             for i in range(0, nb, 8)]).reshape(-1)
        own = torch.arange(nb, device=dev).repeat_interleave(bq)
        sets = {"first": (bq, [v.reshape(nb, bq)[blocks][:, None, :].expand(-1, n_pts, -1).reshape(-1)
                               for v in (lay.qx_v, lay.qy_v, ah)],
                          [c[blocks, :n_pts].reshape(-1) for c in (near.cand_x, near.cand_y, near.cand_z)]),
                "nearest": (1, [lay.qx_v, lay.qy_v, ah],
                            [c[own, nearest] for c in (near.cand_x, near.cand_y, near.cand_z)])}
        u, t, e_u = [], [], []
        for per_row, q, pts in sets.values():
            cand = []
            for c, fill in zip(pts, (float(coord_sentinel(f32)), float(coord_sentinel(f32)), 0.0)):
                one = torch.full((c.shape[0], SUM_RUN), fill, dtype=f32, device=dev)
                one[:, 0] = c
                cand.append(one)
            q = [v.contiguous() for v in q]
            nt = torch.ones(cand[0].shape[0], dtype=torch.int32, device=dev)
            w_k, _, d2, _ = phase2_near_weights(*q, *cand, nt, block_q=per_row, tile_d=SUM_RUN)
            w_p = pow_weight(d2, q[2])
            live = torch.isfinite(d2) & (w_p > 0) & torch.isfinite(w_p)
            w_k, w_p, d2, ah_t = w_k[live], w_p[live], d2[live], q[2][live]
            u.append(((w_k.double() - w_p.double()).abs() / w_p.double()) / EPS32)
            t.append((ah_t.double() * torch.log(torch.clamp(d2, min=1e-30).double())).abs())
            e_u.append(sfu_weight_eps(d2, ah_t) / EPS32)
        u, t, e_u = torch.cat(u), torch.cat(t), torch.cat(e_u)
        print(f"  per-term ulps of w, float32 kernel (lg2/ex2) vs torch.exp(-ah log d^2), {u.numel()} pairs (the "
              f"first {n_pts} candidates of {blocks.numel()} blocks' rows, and each query's nearest): mean "
              f"{float(u.mean()):.3f}, max {float(u.max()):.3f}; beyond their budget eps_i: {int((u > e_u).sum())}; "
              "by |t| = (alpha/2) |ln d^2|:")
        edges = [0, 1, 2, 4, 8, 16, 32, 64, math.inf]
        for lo, hi in zip(edges[:-1], edges[1:]):
            sel = (t >= lo) & (t < hi)
            if bool(sel.any()):
                print(f"    |t| in [{lo}, {hi}): {int(sel.sum())} pairs, ulps mean {float(u[sel].mean()):.3f}, "
                      f"max {float(u[sel].max()):.3f}; budget eps_i {float(e_u[sel].min()):.2f}-"
                      f"{float(e_u[sel].max()):.2f} ulps, max ulps / eps_i {float((u[sel] / e_u[sel]).max()):.3f}")

    def far_flipped(p, lay, ah, rects, blocks, fk):
        # B5's plain sweep with one more cell a block in its mask (the cell's
        # count and z-sum zeroed for that block alone): the occupied cell
        # outside the block's rectangle nearest to its first query, which an
        # off-by-one rectangle test would drop.  Returns sum w of the
        # blocks' queries and their rows.
        ix, iy, occupied = p.far[4].long(), p.far[5].long(), p.far[2] > 0
        out, rows = [], []
        for b in blocks.tolist():
            r = rects[b].long()
            inside = (ix >= r[0]) & (ix <= r[1]) & (iy >= r[2]) & (iy <= r[3])
            q0 = b * p.block_q
            d2 = (p.far[0] - lay.qx_v[q0]) ** 2 + (p.far[1] - lay.qy_v[q0]) ** 2
            cell = int(torch.where(occupied & ~inside, d2, math.inf).argmin())
            cnt, zs = p.far[2].clone(), p.far[3].clone()
            cnt[cell], zs[cell] = 0.0, 0.0
            sl = slice(q0, q0 + p.block_q)
            out.append(phase2_far_aggregates_plain(lay.qx_v[sl], lay.qy_v[sl], ah[sl], rects[b:b + 1],
                                                   (*p.far[:2], cnt, zs, *p.far[4:]), **fk)[0])
            rows.append(torch.arange(q0, q0 + p.block_q, device=dev))
        return torch.cat(out), torch.cat(rows)

    # ------------------------------------------------ 7. B4, B5 vs plain
    print("== 7. far-field kernels B4 (near.cu) and B5 (far.cu) vs their plain versions (aidw-pod-1m "
          "far-field plan, serving batch n=65536)", flush=True)
    ff_errs, ff32 = {}, None
    for dtype in (f32, f64):
        name = str(dtype).split(".")[1]
        dd = data(dtype)
        check(bool((dd[2] > 0).all()), "the data's z is positive")
        p, _ = ff_plan(*dd)
        qx, qy = queries(*SERVING[0], dtype)
        lay, near, ah = ff_inputs(p, qx, qy)
        nk = dict(block_q=p.block_q, tile_d=p.p2_block_d)
        fk = dict(block_q=p.block_q, tile_d=p.p2_far_block_d)
        near_args, far_args = near_of(lay, near, ah, p.block_q)
        n_k, n_p = phase2_near_weights(*near_args, **nk), phase2_near_weights_plain(*near_args, **nk)
        f_k = phase2_far_aggregates(*far_args, p.far, **fk)
        f_p = phase2_far_aggregates_plain(*far_args, p.far, **fk)
        sync()
        # float32: each query's tolerance from its terms (the weights come
        # from the special-function units); float64: SUM_ULPS
        n_tol = phase2_near_tolerance(*near_args, **nk) if dtype == f32 else None
        f_tol = phase2_far_tolerance(*far_args, p.far, **fk) if dtype == f32 else None
        r_n, e_n, same_n, same_min = hold(f"B4 {name}", n_k, n_p, dtype, n_tol)
        r_f, e_f, same_f, _ = hold(f"B5 {name}", f_k, f_p, dtype, f_tol)
        nb = near.rects.shape[0]
        sampled = torch.as_tensor(np.sort(np.random.default_rng(7).choice(nb, min(N_BLOCKS, nb), replace=False)),
                                  device=dev)
        if dtype == f32:
            term_ulps(p, lay, near, ah, sampled[:16])
        # controls, each a plain sweep of the same inputs less a little:
        # B4 without its first tile, and without the first point of each row;
        # B5 without its first tile of cells, without one cell (the occupied
        # cell of median count), and with one more cell a block masked
        sent = coord_sentinel(dtype, dev)

        def near_less(drop):
            cx, cy = torch.where(drop, sent, near.cand_x), torch.where(drop, sent, near.cand_y)
            return phase2_near_weights_plain(*near_args[:3], cx, cy, *near_args[5:], **nk)

        def far_less(drop):
            cnt, zs = torch.where(drop, 0.0, p.far[2]), torch.where(drop, 0.0, p.far[3])
            return phase2_far_aggregates_plain(*far_args, (*p.far[:2], cnt, zs, *p.far[4:]), **fk)

        def off(k, pl, tol, rows=None):
            # the control's sum w against the plain one, in tolerances
            pl, tol = pl[0], None if tol is None else tol[0]
            if rows is not None:
                pl, tol = pl[rows], None if tol is None else tol[rows]
            return off_by(k, pl, dtype, tol)

        drop = torch.zeros_like(near.cand_x, dtype=torch.bool)
        drop[:, :p.p2_block_d] = True
        c_ntile = off(near_less(drop)[0], n_p, n_tol)
        drop = torch.zeros_like(near.cand_x, dtype=torch.bool)
        drop[:, 0] = True
        c_npt = off(near_less(drop)[0], n_p, n_tol)
        drop = torch.zeros_like(p.far[2], dtype=torch.bool)
        drop[:p.p2_far_block_d] = True
        c_ftile = off(far_less(drop)[0], f_p, f_tol)
        occupied = torch.nonzero(p.far[2] > 0).reshape(-1)
        median_cell = occupied[torch.argsort(p.far[2][occupied], stable=True)[occupied.numel() // 2]]
        drop = torch.zeros_like(p.far[2], dtype=torch.bool)
        drop[median_cell] = True
        c_fcell = off(far_less(drop)[0], f_p, f_tol)
        flipped, flip_rows = far_flipped(p, lay, ah, near.rects, sampled, fk)
        c_flip = off(flipped, f_p, f_tol, flip_rows)
        z_pp = z_of(*n_p, *f_p)
        ez_n, ez_f = maxerr(z_of(*n_k, *f_p), z_pp), maxerr(z_of(*n_p, *f_k), z_pp)
        full = p.p2_capacity // p.p2_block_d
        short = int((near.num_tiles < full).sum())
        rule = "the per-query tolerance" if dtype == f32 else f"{SUM_ULPS} ulps"
        print(f"  B4 {name}: sum_w, sum_wz within {r_n:.4f} of {rule} ({e_n:.2f} ulps), all four outputs "
              f"bitwise equal: {same_n}; min d^2 and hit z equal: {same_min}; z max abs err {ez_n:.3e}; "
              f"{short} of {near.num_tiles.shape[0]} rows walk fewer than {full} tiles")
        if dtype == f32:
            rel = [(t / s.double().abs()).median() / EPS32 for t, s in zip(n_tol + f_tol, n_p[:2] + f_p)]
            print(f"  float32 tolerances, median over queries in ulps of the sum: B4 sum_w {float(rel[0]):.1f}, "
                  f"sum_wz {float(rel[1]):.1f}; B5 sum_w {float(rel[2]):.1f}, sum_wz {float(rel[3]):.1f}")
        print(f"  B4 {name} controls (in tolerances, limit 1): the plain sweep without its first tile is off by "
              f"{c_ntile:.3e}, without the first point of each row by {c_npt:.3e}")
        print(f"  B5 {name}: sum_w, sum_wz within {r_f:.4f} of {rule} ({e_f:.2f} ulps), bitwise equal: {same_f}; "
              f"z max abs err {ez_f:.3e}")
        print(f"  B5 {name} controls (in tolerances): the plain sweep without its first tile of cells is off by "
              f"{c_ftile:.3e}, without cell {int(median_cell)} (count {float(p.far[2][median_cell])}, the median of "
              f"{occupied.numel()} occupied cells) by {c_fcell:.3e}, with one more cell masked in each of "
              f"{sampled.numel()} blocks by {c_flip:.3e}", flush=True)
        check(min(c_ntile, c_npt, c_ftile, c_fcell, c_flip) >= 10,
              f"the B4/B5 check fails a lost tile, point and cell and a flipped mask cell by 10x or more ({name})")
        check(short > 0, "some near rows walk fewer tiles than the capacity")
        if dtype == f32:
            ff_errs = {"near_weight": ez_n, "far_cell": ez_f}
            ff32 = (p, lay, near, ah)
        del n_k, n_p, f_k, f_p, drop, n_tol, f_tol

    # ---------------------------------------------------- 8. golden pin
    print("== 8. golden far-field pin (ffpin) on the card", flush=True)
    arr = [torch.as_tensor(golden[f"uniform_{n}"]).to(dev) for n in ("dx", "dy", "dz", "qx", "qy")]
    gp = AIDWParams(k=int(golden["k"]), area=float(golden["area"]))
    gxp = int(golden["ffpin_gx"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pin = build_plan(*arr[:3], params=gp, area=gp.area, impl="grid", grid=build_grid(*arr[:3], gx=gxp, gy=gxp),
                         phase2="farfield", farfield_radius=int(golden["ffpin_radius"]), block_q=64)
    z, a = execute(pin, arr[3], arr[4])
    ez = np.abs(z.cpu().double().numpy() - golden["ffpin_z"])
    ea = np.abs(a.cpu().double().numpy() - golden["ffpin_alpha"])
    print(f"  ffpin: max |dz| {ez.max():.3e} (limit 2e-6 + 2e-6 |z|), max |dalpha| {ea.max():.3e} (limit 1e-6)")
    check(bool((ez <= 2e-6 + 2e-6 * np.abs(golden["ffpin_z"])).all() and (ea <= 1e-6).all()), "golden ffpin")

    # ---------------------------------------------- 9. card plan vs CPU plan
    print("== 9. far-field plan: built on the card vs built on the CPU (aidw-pod-1m, float32)", flush=True)
    dx, dy, dz = data(f32)
    sync()
    t0 = time.time()
    plan_ff, warned = ff_plan(dx, dy, dz)
    sync()
    ff_build_s = time.time() - t0
    t0 = time.time()
    plan_cpu, warned_cpu = ff_plan(dx.cpu(), dy.cpu(), dz.cpu(), device="cpu")
    cpu_build_s = time.time() - t0
    diffs = [f for f in ("cand_capacity", "cand_block_d", "seam_level", "grid_rebuilds", "block_d",
                         "farfield_radius", "farfield_bound", "p2_capacity", "p2_block_d", "p2_far_block_d")
             if getattr(plan_ff, f) != getattr(plan_cpu, f)]
    g_c, g_h = plan_ff.grid, plan_cpu.grid
    if (g_c.gx, g_c.gy, g_c.cap) != (g_h.gx, g_h.gy, g_h.cap):
        diffs.append("grid shape")
    for f in ("counts", "cum", "starts"):
        if not torch.equal(getattr(g_c, f).cpu(), getattr(g_h, f)):
            diffs.append(f)
    if not torch.equal(plan_ff.r_need.cpu(), plan_cpu.r_need):
        diffs.append("r_need")
    for i, f in ((2, "count"), (4, "ix"), (5, "iy")):
        if not torch.equal(plan_ff.far[i].cpu(), plan_cpu.far[i]):
            diffs.append(f"far {f}")
    if warned != warned_cpu:
        diffs.append("warnings")
    far_diff = max(maxerr(plan_ff.far[i].cpu(), plan_cpu.far[i]) for i in (0, 1, 3))
    print(f"  built in {ff_build_s} s on the card, {cpu_build_s} s on the CPU; integer state, bound and "
          f"warnings equal: {not diffs} {diffs}; centroids and z-sums max |diff| {far_diff}")
    check(not diffs, "the card's far-field plan equals the CPU's")
    del plan_cpu

    # ------------------------------------------------- 10. far-field serving
    print(f"== 10. far-field serving: aidw-pod-1m, clustered m = 2^20, k = 10, float32, farfield_rtol = "
          f"{plan_ff.farfield_rtol}", flush=True)
    print(f"  plan: radius {plan_ff.farfield_radius}, bound {plan_ff.farfield_bound}, UnprovableRtolWarning "
          f"fired: {bool(warned)}; p2_capacity {plan_ff.p2_capacity}, p2_block_d {plan_ff.p2_block_d}, "
          f"p2_far_block_d {plan_ff.p2_far_block_d}, {plan_ff.grid.n_cells} cells ({plan_ff.far[0].shape[0]} "
          f"padded)")
    sync()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    ff_results, ff_walls = [], []
    for (n, seed), (qx, qy), (_, _, _, exact_wall) in zip(SERVING, batches, results):
        before = dict(_build.LAUNCHES)
        sync()
        t0 = time.time()
        z, a, stats = execute_with_stats(plan_ff, qx, qy)
        sync()
        wall = time.time() - t0
        delta = {k: _build.LAUNCHES[k] - before[k] for k in before}
        ff_results.append((z, a, stats))
        ff_walls.append(wall)
        n_over = int(stats["p2_overflow_queries"])
        print(f"  batch n={n} seed={seed}: {wall} s (exact path {exact_wall} s, {exact_wall / wall:.2f}x), "
              f"near_points_mean {float(stats['near_points_mean'])}, far_cells_mean "
              f"{float(stats['far_cells_mean'])}, p2_overflow_queries {n_over}, overflow_queries "
              f"{int(stats['overflow_queries'])}, launches {delta}", flush=True)
        check(delta["near_weight"] == 1 and delta["far_cell"] == 1 and delta["knn_skip"] == 1,
              "each batch launches B3, B4 and B5 once")
        check(delta["weight_soa"] == (1 if n_over else 0), "B2 runs once if a near field overflows, else never")
    ff_launches = dict(_build.LAUNCHES)
    print(f"  launches on the far-field path: {ff_launches}")
    print(f"  max memory allocated {torch.cuda.max_memory_allocated()} bytes")
    check(ff_launches["near_weight"] > 0 and ff_launches["far_cell"] > 0, "the far-field path launched B4 and B5")
    scale = float(dz.abs().max())
    fp_slack = FP_SLACK_ULPS * eps[f32] * math.sqrt(M_FULL)
    for (n, seed), (qx, qy), (z, a, _), (_, a_exact, _, _) in zip(SERVING, batches, ff_results, results):
        check(bool(torch.isfinite(z).all()) and z.shape == (n,), f"finite z of shape ({n},)")
        check(torch.equal(a, a_exact), "alpha equals the exact path's bit for bit")
        idx = torch.as_tensor(np.random.default_rng(seed).choice(n, N_SAMPLE, replace=False), device=dev)
        z_ref, _ = aidw_interpolate_kahan(dx, dy, dz, qx[idx], qy[idx], params, area=1.0)
        batch_rel = maxerr(z[idx], z_ref) / scale
        rep = farfield_error_report(plan_ff, qx[idx], qy[idx])
        print(f"  batch n={n} seed={seed}: {N_SAMPLE} sampled queries of the batch off the Kahan oracle by "
              f"{batch_rel:.3e} relative; farfield_error_report on them as a batch: max_rel_err "
              f"{rep['max_rel_err']:.3e}, rms {rep['rms_rel_err']:.3e}, bound {rep['bound']} + fp slack "
              f"{rep['fp_slack']:.3e}, within_bound {rep['within_bound']}", flush=True)
        check(batch_rel <= plan_ff.farfield_bound + fp_slack and rep["within_bound"],
              f"far-field batch n={n} within its proved bound")
        # B4 and B5 at this batch's shapes, against their plain versions on
        # N_BLOCKS sampled query blocks
        lay, near, ah = ff_inputs(plan_ff, qx, qy)
        near_args, far_args = near_of(lay, near, ah, plan_ff.block_q)
        n_k = phase2_near_weights(*near_args, block_q=plan_ff.block_q, tile_d=plan_ff.p2_block_d)
        f_k = phase2_far_aggregates(*far_args, plan_ff.far, block_q=plan_ff.block_q,
                                    tile_d=plan_ff.p2_far_block_d)
        nb = near.rects.shape[0]
        blocks = torch.as_tensor(np.sort(np.random.default_rng(seed).choice(nb, min(N_BLOCKS, nb), replace=False)),
                                 device=dev)
        rows = (blocks[:, None] * plan_ff.block_q + torch.arange(plan_ff.block_q, device=dev)).reshape(-1)
        near_s, far_s = near_of(lay, near, ah, plan_ff.block_q, blocks)
        nk = dict(block_q=plan_ff.block_q, tile_d=plan_ff.p2_block_d)
        fk = dict(block_q=plan_ff.block_q, tile_d=plan_ff.p2_far_block_d)
        n_p, n_tol = phase2_near_weights_plain(*near_s, **nk), phase2_near_tolerance(*near_s, **nk)
        f_p, f_tol = (phase2_far_aggregates_plain(*far_s, plan_ff.far, **fk),
                      phase2_far_tolerance(*far_s, plan_ff.far, **fk))
        r_n, e_n, same_n, _ = hold(f"B4 batch n={n}", tuple(o[rows] for o in n_k), n_p, f32, n_tol)
        r_f, e_f, same_f, _ = hold(f"B5 batch n={n}", tuple(o[rows] for o in f_k), f_p, f32, f_tol)
        print(f"  batch n={n} seed={seed}: B4 and B5 on {blocks.numel()} of its {nb} query blocks against their "
              f"plain versions: within {r_n:.4f} and {r_f:.4f} of the per-query tolerance ({e_n:.2f} and "
              f"{e_f:.2f} ulps), bitwise equal: {same_n} and {same_f}", flush=True)
        del lay, near, ah, near_args, far_args, n_k, f_k
    qx, qy = batches[0]
    z2, a2, _ = execute_with_stats(plan_ff, qx, qy)
    check(torch.equal(z2, ff_results[0][0]) and torch.equal(a2, ff_results[0][1]), "far-field run-to-run bits")
    print("  far-field run-to-run bitwise equal: True")

    profile_batch(f"far-field n={qx.shape[0]}", lambda: execute_with_stats(plan_ff, qx, qy))

    # ------------------------------------------------- 11. overflow arm
    print("== 11. far-field overflow arm: 4,096 points, 96 queries over [-3, 3]^2, radius 1", flush=True)
    rng = np.random.default_rng(14)
    odx, ody = rng.random(4096).astype(np.float32), rng.random(4096).astype(np.float32)
    odz = (np.sin(6 * odx) * np.cos(6 * ody) + 2.0).astype(np.float32)
    oqx = torch.as_tensor((rng.random(96) * 6 - 3).astype(np.float32), device=dev)
    oqy = torch.as_tensor((rng.random(96) * 6 - 3).astype(np.float32), device=dev)
    op = AIDWParams(k=10, area=1.0, r_max=64.0)
    od = [torch.as_tensor(v, device=dev) for v in (odx, ody, odz)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pf = build_plan(*od, params=op, area=1.0, impl="grid", phase2="farfield", farfield_radius=1,
                        query_occupancy=64.0)
        pe = build_plan(*od, params=op, area=1.0, impl="grid", query_occupancy=64.0)
    _build.reset_launch_counts()
    sync()
    t0 = time.time()
    z_ff, a_ff, st = execute_with_stats(pf, oqx, oqy)
    sync()
    o_wall = time.time() - t0
    o_launches = dict(_build.LAUNCHES)
    z_ex, a_ex = execute(pe, oqx, oqy)
    same = torch.equal(z_ff, z_ex) and torch.equal(a_ff, a_ex)
    print(f"  {o_wall} s, p2_capacity {pf.p2_capacity} of m = {pf.m}; p2_overflow_queries "
          f"{int(st['p2_overflow_queries'])} of 96; launches {o_launches}; z and alpha equal the exact plan's "
          f"bit for bit: {same}")
    check(int(st["p2_overflow_queries"]) == 96 and o_launches["weight_soa"] == 1, "the batch overflows into B2")
    check(same, "the overflow arm is the exact plan's, bit for bit")

    # ------------------------------------------------- 12. B4, B5 timings
    print("== 12. far-field kernel timings (CUDA events, serving batch n=65536, m=2^20, float32)", flush=True)
    p, lay, near, ah = ff32
    nk = dict(block_q=p.block_q, tile_d=p.p2_block_d)
    fk = dict(block_q=p.block_q, tile_d=p.p2_far_block_d)
    near_args, far_args = near_of(lay, near, ah, p.block_q)
    far_args = (*far_args, p.far)
    n_v, nb, ncp = lay.qx_v.shape[0], near.rects.shape[0], p.far[0].shape[0]
    tiles = int(near.num_tiles.long().sum())
    # What these inputs need.  B4: each block's nt[i] tiles of its near row,
    # 13 operations per pair as B2 (d^2 5, max, mul, 2 adds, mul, compare,
    # exp and log one each).  B5: a term for each occupied cell outside the
    # block's rectangle (pad cells, empty cells and the rectangle's own add
    # 0), 13 operations per pair (w 9, 2 muls, 2 adds), plus one rectangle
    # test (4 compares and a select) per block and cell.  Bytes: each input
    # read once, each output written once.
    ix, iy, occupied = p.far[4].long(), p.far[5].long(), p.far[2] > 0
    far_pairs = 0
    for r in near.rects.long().split(64):
        inside = (ix >= r[:, 0:1]) & (ix <= r[:, 1:2]) & (iy >= r[:, 2:3]) & (iy <= r[:, 3:4])
        far_pairs += int((occupied & ~inside).sum())
    far_pairs *= p.block_q
    near_pairs = p.block_q * tiles * p.p2_block_d
    print(f"  {int(occupied.sum())} of {ncp} padded cells occupied; B5 needs {far_pairs} query-cell pairs "
          f"({far_pairs / n_v} per query) of the {n_v * ncp} its launch walks")
    specs = {
        "near_weight": (lambda: phase2_near_weights(*near_args, **nk),
                        lambda: phase2_near_weights_plain(*near_args, **nk),
                        near_pairs, 13 * near_pairs,
                        3 * 4 * tiles * p.p2_block_d + 4 * nb + 3 * 4 * n_v + 4 * 4 * n_v),
        "far_cell": (lambda: phase2_far_aggregates(*far_args, **fk),
                     lambda: phase2_far_aggregates_plain(*far_args, **fk),
                     far_pairs, 13 * far_pairs + 5 * nb * ncp, 6 * 4 * ncp + 16 * nb + 3 * 4 * n_v + 2 * 4 * n_v),
    }
    rows = []
    total_ms = 0.0
    for name, (kern, plain, n_pairs, ops, n_bytes) in specs.items():
        ms = time_ms(kern, 10)
        plain_ms = time_ms(plain, 1, warmup=0)
        # a float32 pair's weight also takes one lg2 and one exp2 on the
        # special-function units (MUFU_PER_PAIR)
        bound_ms, bound_by = bound(ops, n_bytes, 1, sfu_ops=MUFU_PER_PAIR * n_pairs)
        total_ms += ms
        rows.append(dict(name=name, route="cuda", **KERNELS[name], launches=ff_launches[name],
                         max_abs_err=ff_errs[name], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None))
        sass = far_sass(name)
        walked = n_v * ncp if name == "far_cell" else n_pairs
        print(f"  {name}: {ms} ms (plain {plain_ms} ms, bound {bound_ms} ms by {bound_by}, {n_pairs} pairs, "
              f"{ops} operations); operations {1e3 * ops / PEAK_OPS['float32']} ms, MUFU "
              f"{1e3 * MUFU_PER_PAIR * n_pairs / PEAK_SFU} ms, instruction issue of the {walked} pairs the "
              f"launch walks {1e3 * walked * sass[0] / PEAK_ISSUE} ms ({sass[0]} SASS instructions a pair)",
              flush=True)
    print(f"  B4 + B5 {total_ms} ms per 65,536-query batch against exact B2's {exact_b2_ms} ms "
          f"(phase 6), {exact_b2_ms / total_ms:.2f}x")
    return rows, ff_walls


def quadtree_phases(*, dev, params, golden, data, queries, sync, maxerr, time_ms, bound, batches, results,
                    ff_walls):
    """Phases 13-19: the quadtree far field (``phase2="quadtree"``) and the
    ring-search arm on the card, with main's data, helpers and serving
    batches, the exact path's results and the far-field batch times.
    Returns the B6 row of the kernels line."""
    import torch

    from repro_torch.core.accuracy import aidw_interpolate_kahan, farfield_error_report
    from repro_torch.core.aidw import AIDWParams, brute_r_obs, mean_k, sqrt_rn
    from repro_torch.core.grid import _ring_search, build_grid
    from repro_torch.engine import build_plan, execute, execute_with_stats
    from repro_torch.engine.execute import _grid_layout, _near_field, _quadtree_walk
    from repro_torch.engine.plan import QT_ARRAYS
    from repro_torch.errors import UnprovableRtolWarning
    from repro_torch.kernels import _build
    from repro_torch.core.aidw import tiny_for
    from repro_torch.kernels._common import EPS32, SUM_RUN, sfu_weight_eps
    from repro_torch.kernels.aidw_grid import (
        block_rectangles,
        far_node_launch,
        far_node_terms,
        phase1_alpha_from_candidates,
        phase2_far_nodes,
        phase2_far_nodes_plain,
        phase2_far_nodes_tolerance,
        phase2_near_tolerance,
        phase2_near_weights,
        phase2_near_weights_plain,
    )

    f32, f64 = torch.float32, torch.float64
    hit_eps = params.exact_hit_eps
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def qt_plan(dx, dy, dz, device=None):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            p = build_plan(dx, dy, dz, params=params, area=1.0, impl="grid", phase2="quadtree", device=device)
        return p, [str(w.message) for w in rec if issubclass(w.category, UnprovableRtolWarning)]

    def qt_inputs(p, qx, qy):
        # B6's inputs as the engine makes them: the blocked view, alpha from
        # Phase 1, the near field, and per level the walk's table, its tile
        # counts and the level's node arrays
        lay = _grid_layout(p, qx, qy)
        alpha = phase1_alpha_from_candidates(lay.qx_v, lay.qy_v, lay.cand_x, lay.cand_y, params=params, area=1.0,
                                             m_real=M_FULL, block_q=p.block_q, block_d=p.cand_block_d,
                                             num_tiles=lay.num_tiles)
        home = block_rectangles(p.grid, lay.cx_v, lay.cy_v, torch.zeros_like(lay.cx_v), p.block_q)
        levels = []
        for lv, (tbl, n_closed, _, _) in enumerate(_quadtree_walk(p, *home)):
            k_pad, tile = p.qt_levels[lv][3:]
            nt = ((n_closed.clamp(max=k_pad) + tile - 1) // tile).to(torch.int32)
            levels.append((tbl, nt, n_closed, p.far[lv][:6], tile))
        return lay, alpha * 0.5, home, levels

    def level_args(lay, ah, levels, rows=None):
        # per level B6's arguments, for all query blocks or the blocks of
        # `rows` = (query rows, blocks)
        qx, qy = lay.qx_v, lay.qy_v
        if rows is not None:
            qx, qy, ah = qx[rows[0]], qy[rows[0]], ah[rows[0]]
        for tbl, nt, n_closed, nodes, tile in levels:
            if rows is not None:
                tbl, nt, n_closed = tbl[rows[1]], nt[rows[1]], n_closed[rows[1]]
            yield (qx, qy, ah, tbl.contiguous(), nt.contiguous(), nodes), n_closed.contiguous(), tile

    def b6(lay, ah, levels, block_q, rows=None, plain=False, drop_first=False, no_dipole=False):
        # B6 on every level (the kernel, cut at the closed nodes as the
        # engine calls it, or the plain version); the controls drop each
        # row's first closed node or the dipole moments
        out = []
        for (qx, qy, a, tbl, nt, nodes), n_closed, tile in level_args(lay, ah, levels, rows):
            if drop_first:
                tbl = tbl.clone()
                tbl[:, 0] = nodes[0].shape[0] - 1
            if no_dipole:
                nodes = (*nodes[:4], torch.zeros_like(nodes[4]), torch.zeros_like(nodes[5]))
            kw = dict(block_q=block_q, tile_d=tile)
            out.append(phase2_far_nodes_plain(qx, qy, a, tbl, nt, nodes, **kw) if plain
                       else phase2_far_nodes(qx, qy, a, tbl, nt, nodes, n_closed=n_closed, **kw))
        return out

    def b6_tol(lay, ah, levels, block_q, rows=None):
        # the float32 kernel's per-query tolerances (tol_w, tol_wz), every level
        return [phase2_far_nodes_tolerance(*args, block_q=block_q, tile_d=tile)
                for args, _, tile in level_args(lay, ah, levels, rows)]

    def b6_term_ulps(p, lay, ah, levels, blocks, per_row=32):
        # the float32 kernel's per-term errors against the plain version's
        # terms, pair by pair: each pair (a query of a sampled block, one of
        # the first `per_row` closed nodes of its row) alone in a table row
        # of one run (the other 31 slots the sentinel, which adds +0), so the
        # kernel's sum w is that pair's w count and its sum w z its w z_sum
        # + dip; each held to its own-term budget in phase2_far_nodes_tolerance
        bq = p.block_q
        out = []
        for lv, (tbl, _, n_closed, nodes, _) in enumerate(levels):
            ids = tbl[blocks, :per_row]
            keep = torch.arange(ids.shape[1], device=dev)[None, :] < n_closed[blocks, None]
            node_ids, blk = ids[keep], blocks[:, None].expand_as(ids)[keep]
            if node_ids.numel() == 0:
                continue
            one = torch.full((node_ids.numel(), SUM_RUN), nodes[0].shape[0] - 1, dtype=torch.int32, device=dev)
            one[:, 0] = node_ids
            qsel = (blk[:, None] * bq + torch.arange(bq, device=dev)).reshape(-1)
            q = (lay.qx_v[qsel].contiguous(), lay.qy_v[qsel].contiguous(), ah[qsel].contiguous())
            ones = torch.ones(node_ids.numel(), dtype=torch.int32, device=dev)
            kw = dict(block_q=bq, tile_d=SUM_RUN)
            got = phase2_far_nodes(*q, one, ones, nodes, n_closed=ones, **kw)
            want = phase2_far_nodes_plain(*q, one, ones, nodes, **kw)
            d2, _, _, wz, dip = (t.reshape(-1) for t in far_node_terms(
                q[0].reshape(-1, bq, 1), q[1].reshape(-1, bq, 1), q[2].reshape(-1, bq, 1), one[:, None, :1].long(),
                nodes))
            e_w, wz, dip = sfu_weight_eps(d2, q[2]), wz.double().abs(), dip.double().abs()
            live = (want[0] > 0) & torch.isfinite(want[0]) & (want[1] != 0)
            budget = (e_w + EPS32, (wz * (e_w + 2 * EPS32) + dip * (e_w + 5 * EPS32)) / want[1].double().abs())
            t = (q[2].double() * torch.log(torch.clamp(d2, min=tiny_for(f32)).double())).abs()[live]
            row = [lv, int(live.sum()), float((dip / want[1].double().abs())[live].max())]
            for k, pl, bud in zip(got, want, budget):
                u = ((k.double() - pl.double()).abs() / pl.double().abs())[live] / EPS32
                r = u / (bud[live] / EPS32)
                row += [float(u.mean()), float(u.max()), int((r > 1).sum()), float(r.max())]
            out.append(row + [float(t.max())])
        for lv, n, dip_rel, *rest, t_max in out:
            print(f"  B6 float32 per-term error, level {lv}, {n} pairs (|t| up to {t_max:.1f}, largest dipole "
                  f"{dip_rel:.3e} of its term): w count {rest[0]:.3f} ulps mean, {rest[1]:.3f} max, {rest[2]} past "
                  f"its budget (max {rest[3]:.3f} of it); w z_sum + dip {rest[4]:.3f} mean, {rest[5]:.3f} max, "
                  f"{rest[6]} past its budget (max {rest[7]:.3f} of it)")
        return max(max(row[6], row[10]) for row in out)

    # ------------------------------------------------ 13. (a) B6 vs plain
    print("== 13. (a) quadtree kernel B6 (far_node.cu) vs its plain version, every level (aidw-pod-1m quadtree "
          "plan, serving batch n=65536)", flush=True)
    qt32, qt64, b6_err = None, None, 0.0
    for dtype in (f32, f64):
        name = str(dtype).split(".")[1]
        p, _ = qt_plan(*data(dtype))
        qx, qy = queries(*SERVING[0], dtype)
        lay, ah, home, levels = qt_inputs(p, qx, qy)
        if dtype == f32:
            nb = levels[0][0].shape[0]
            sampled = torch.as_tensor(np.sort(np.random.default_rng(13).choice(nb, 16, replace=False)), device=dev)
            worst = b6_term_ulps(p, lay, ah, levels, sampled)
            check(worst <= 1.0, f"every B6 float32 term within its own budget ({worst})")
        k_out, p_out = b6(lay, ah, levels, p.block_q), b6(lay, ah, levels, p.block_q, plain=True)
        # float32: each query's tolerance from its terms (the weights and the
        # gradient's reciprocal come from the special-function units);
        # float64: SUM_ULPS, bitwise in practice
        tols = b6_tol(lay, ah, levels, p.block_q) if dtype == f32 else [None] * len(levels)
        sync()
        per_level = []
        for lv, (k, pl, tol) in enumerate(zip(k_out, p_out, tols)):
            r, e, same, _ = hold(f"B6 {name} level {lv}", k, pl, dtype, tol)
            per_level.append((r, e, same, float(levels[lv][2].float().mean()), int(levels[lv][2].max()),
                              p.qt_levels[lv][3]))
        # controls, each a plain sweep of the same inputs less a little, in
        # tolerances (SUM_ULPS in float64) per level
        c_drop = [max(off_by(k[i], pl[i], dtype, None if tol is None else tol[i]) for i in (0, 1)) for k, pl, tol in
                  zip(b6(lay, ah, levels, p.block_q, plain=True, drop_first=True), p_out, tols)]
        c_dip = [off_by(k[1], pl[1], dtype, None if tol is None else tol[1]) for k, pl, tol in
                 zip(b6(lay, ah, levels, p.block_q, plain=True, no_dipole=True), p_out, tols)]
        rule = "the per-query tolerance" if dtype == f32 else f"{SUM_ULPS} ulps"
        for lv, (r, e, same, mean_c, max_c, k_pad) in enumerate(per_level):
            print(f"  B6 {name} level {lv}: sum_w, sum_wz within {r:.4f} of {rule} ({e:.2f} ulps), bitwise equal: "
                  f"{same}; closed nodes per block mean {mean_c}, max {max_c} of k_pad {k_pad}; controls (limit 1): "
                  f"first closed node dropped {c_drop[lv]:.3e}, dipole dropped {c_dip[lv]:.3e}")
        if dtype == f32:
            rel = [float(max((t / s.double().abs()).nan_to_num(nan=0.0, posinf=0.0).median() for t, s in
                             zip(tol, pl))) / EPS32 for tol, pl in zip(tols, p_out)]
            print(f"  float32 tolerances, median over queries in ulps of the sum, per level: {rel}")
        print(f"  B6 {name} controls, largest over the levels: first closed node dropped {max(c_drop):.3e}, "
              f"dipole dropped {max(c_dip):.3e} (at level {int(np.argmax(c_dip))}); both must reach 10", flush=True)
        check(max(c_drop) >= 10 and max(c_dip) >= 10,
              f"the B6 check fails a lost node and a lost dipole by 10x or more ({name})")
        if dtype == f64:
            qt64 = (p, lay, ah, levels)
        # B4 on the quadtree plan's near field: float32 within the per-query
        # tolerance of its terms, float64 within SUM_ULPS
        near = _near_field(p, lay.cx_v, lay.cy_v)
        near_args = (lay.qx_v, lay.qy_v, ah, near.cand_x, near.cand_y, near.cand_z, near.num_tiles)
        nk = dict(block_q=p.block_q, tile_d=p.p2_block_d)
        nsum = phase2_near_weights_plain(*near_args, **nk)
        n_tol = phase2_near_tolerance(*near_args, **nk) if dtype == f32 else None
        r_n, e_n, same_n, same_min = hold(f"B4 quadtree {name}", phase2_near_weights(*near_args, **nk), nsum, dtype,
                                          n_tol)
        print(f"  B4 {name} on the quadtree near field: within {r_n:.4f} of its tolerance ({e_n:.2f} ulps), all four "
              f"outputs bitwise equal: {same_n}; min d^2 and hit z equal: {same_min}", flush=True)
        if dtype == f32:

            def z_all(far):
                sw, swz = nsum[0], nsum[1]
                for s_w, s_wz in far:
                    sw, swz = sw + s_w, swz + s_wz
                return torch.where(nsum[2] <= hit_eps, nsum[3], swz / sw)

            b6_err = maxerr(z_all(k_out), z_all(p_out))
            qt32 = (p, lay, ah, levels)
        del k_out, p_out, tols

    # ------------------------------------------------ 14. (b) golden pin
    print("== 14. (b) golden quadtree pin (qtree) on the card", flush=True)
    arr = [torch.as_tensor(golden[f"qtree_{n}"]).to(dev) for n in ("dx", "dy", "dz", "qx", "qy")]
    gp = AIDWParams(k=int(golden["k"]), area=float(golden["area"]))
    gxq = int(golden["qtree_gx"])
    pin = build_plan(*arr[:3], params=gp, area=gp.area, impl="grid", grid=build_grid(*arr[:3], gx=gxq, gy=gxq),
                     phase2="quadtree", block_q=64)
    z, a = execute(pin, arr[3], arr[4])
    g_bound = float(golden["qtree_bound"])
    fp_slack = FP_SLACK_ULPS * float(np.finfo(np.float32).eps) * math.sqrt(arr[0].shape[0])
    rel = float(np.abs(z.cpu().double().numpy() - golden["qtree_z"].astype(np.float64)).max()) / float(
        np.abs(golden["qtree_dz"]).max())
    ea = np.abs(a.cpu().double().numpy() - golden["qtree_alpha"])
    print(f"  qtree: plan bound {pin.farfield_bound} (committed {g_bound}); z off the committed Kahan reference by "
          f"{rel:.3e} relative (limit bound + fp slack {g_bound + fp_slack:.3e}); max |dalpha| {ea.max():.3e}")
    check(abs(pin.farfield_bound - g_bound) <= 1e-9 * abs(g_bound) and g_bound <= 1e-3, "qtree bound")
    check(rel <= g_bound + fp_slack, "qtree z within the bound")
    check(bool((ea <= GOLDEN_ATOL + GOLDEN_RTOL * np.abs(golden["qtree_alpha"])).all()), "qtree alpha")

    # ---------------------------------------------- 15. (c) card vs CPU plan
    print("== 15. (c) quadtree plan: built on the card vs built on the CPU (aidw-pod-1m, float32)", flush=True)
    dx, dy, dz = data(f32)
    sync()
    t0 = time.time()
    plan_qt, warned = qt_plan(dx, dy, dz)
    sync()
    qt_build_s = time.time() - t0
    t0 = time.time()
    plan_cpu, warned_cpu = qt_plan(dx.cpu(), dy.cpu(), dz.cpu(), device="cpu")
    cpu_build_s = time.time() - t0
    diffs = [f for f in ("cand_capacity", "cand_block_d", "seam_level", "grid_rebuilds", "block_d",
                         "farfield_radius", "p2_capacity", "p2_block_d", "qt_levels")
             if getattr(plan_qt, f) != getattr(plan_cpu, f)]
    for f in ("farfield_bound", "qt_tau"):
        if abs(getattr(plan_qt, f) - getattr(plan_cpu, f)) > 2 * np.finfo(np.float64).eps * abs(getattr(plan_cpu, f)):
            diffs.append(f)
    if warned != warned_cpu:
        diffs.append("warnings")
    worst = 0.0
    for lv, (lc, lh) in enumerate(zip(plan_qt.far, plan_cpu.far)):
        for name, a_c, a_h in zip(QT_ARRAYS, lc, lh):
            a_c = a_c.cpu()
            if name in ("count", "z_sum"):
                if not torch.equal(a_c, a_h):
                    diffs.append(f"level {lv} {name}")
            else:
                w = ulps(a_c, a_h, f32)
                worst = max(worst, w)
                if w > 2:
                    diffs.append(f"level {lv} {name}")
    print(f"  built in {qt_build_s} s on the card, {cpu_build_s} s on the CPU; radius, capacities, qt_levels, counts "
          f"and z-sums equal, bound, tau and node floats within 2 ulps, warning equal: {not diffs} {diffs}; node "
          f"floats within {worst} ulps")
    check(not diffs, "the card's quadtree plan equals the CPU's")
    del plan_cpu

    # ------------------------------------------------ 16. (d) serving run
    print(f"== 16. (d) quadtree serving: aidw-pod-1m, clustered m = 2^20, k = 10, float32, farfield_rtol = "
          f"{plan_qt.farfield_rtol}", flush=True)
    n_lv = len(plan_qt.qt_levels)
    print(f"  plan: radius {plan_qt.farfield_radius}, bound {plan_qt.farfield_bound}, qt_tau {plan_qt.qt_tau}, "
          f"UnprovableRtolWarning fired: {bool(warned)}; p2_capacity {plan_qt.p2_capacity}, p2_block_d "
          f"{plan_qt.p2_block_d}; qt_levels (nx, ny, step, k_pad, tile) {plan_qt.qt_levels}")
    sync()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    qt_results, qt_walls = [], []
    scale = float(dz.abs().max())
    fp_slack = FP_SLACK_ULPS * float(np.finfo(np.float32).eps) * math.sqrt(M_FULL)
    for (n, seed), (qx, qy), (_, a_exact, _, exact_wall), ff_wall in zip(SERVING, batches, results, ff_walls):
        before = dict(_build.LAUNCHES)
        sync()
        t0 = time.time()
        z, a, stats = execute_with_stats(plan_qt, qx, qy)
        sync()
        wall = time.time() - t0
        delta = {k: _build.LAUNCHES[k] - before[k] for k in before}
        qt_results.append((z, a, stats))
        qt_walls.append(wall)
        n_over = int(stats["p2_overflow_queries"])
        print(f"  batch n={n} seed={seed}: {wall} s (far-field {ff_wall} s, exact {exact_wall} s), near_points_mean "
              f"{float(stats['near_points_mean'])}, far_cells_mean {float(stats['far_cells_mean'])}, cells_per_level "
              f"{stats['cells_per_level'].tolist()}, opened_fraction {float(stats['opened_fraction'])}, "
              f"p2_overflow_queries {n_over}, overflow_queries {int(stats['overflow_queries'])}, launches {delta}",
              flush=True)
        check(delta["far_node"] == n_lv and delta["near_weight"] == 1 and delta["knn_skip"] == 1
              and delta["far_cell"] == 0, f"each batch launches B3 and B4 once and B6 once per level ({n_lv})")
        check(delta["weight_soa"] == (1 if n_over else 0), "B2 runs once if a near field or table overflows")
        check(bool(torch.isfinite(z).all()) and z.shape == (n,), f"finite z of shape ({n},)")
        check(torch.equal(a, a_exact), "alpha equals the exact path's bit for bit")
        check(abs(float(stats["cells_per_level"].sum()) - float(stats["far_cells_mean"]))
              <= 1e-6 * float(stats["far_cells_mean"]) and 0.0 <= float(stats["opened_fraction"]) <= 1.0,
              "cells_per_level sums to far_cells_mean; opened_fraction in [0, 1]")
    qt_launches = dict(_build.LAUNCHES)
    print(f"  launches on the quadtree path: {qt_launches}")
    print(f"  max memory allocated {torch.cuda.max_memory_allocated()} bytes")
    check(qt_launches["far_node"] > 0 and qt_launches["near_weight"] > 0, "the quadtree path launched B6 and B4")
    for (n, seed), (qx, qy), (z, _, _) in zip(SERVING, batches, qt_results):
        # the walk alone, at this batch's blocks
        lay = _grid_layout(plan_qt, qx, qy)
        home = block_rectangles(plan_qt.grid, lay.cx_v, lay.cy_v, torch.zeros_like(lay.cx_v), plan_qt.block_q)
        sync()
        t0 = time.time()
        _quadtree_walk(plan_qt, *home)
        sync()
        walk_s = time.time() - t0
        idx = torch.as_tensor(np.random.default_rng(seed).choice(n, N_SAMPLE, replace=False), device=dev)
        z_ref, _ = aidw_interpolate_kahan(dx, dy, dz, qx[idx], qy[idx], params, area=1.0)
        batch_rel = maxerr(z[idx], z_ref) / scale
        rep = farfield_error_report(plan_qt, qx[idx], qy[idx])
        print(f"  batch n={n} seed={seed}: walk alone {walk_s} s; {N_SAMPLE} sampled queries off the Kahan oracle by "
              f"{batch_rel:.3e} relative; farfield_error_report on them: max_rel_err {rep['max_rel_err']:.3e}, rms "
              f"{rep['rms_rel_err']:.3e}, bound {rep['bound']} + fp slack {rep['fp_slack']:.3e}, within_bound "
              f"{rep['within_bound']}", flush=True)
        check(batch_rel <= plan_qt.farfield_bound + fp_slack and rep["within_bound"],
              f"quadtree batch n={n} within its proved bound")
        # B6 at this batch's shapes against its plain version on N_BLOCKS
        # sampled query blocks
        lay, ah, _, levels = qt_inputs(plan_qt, qx, qy)
        nb = levels[0][0].shape[0]
        blocks = torch.as_tensor(np.sort(np.random.default_rng(seed).choice(nb, min(N_BLOCKS, nb), replace=False)),
                                 device=dev)
        rows = (blocks[:, None] * plan_qt.block_q + torch.arange(plan_qt.block_q, device=dev)).reshape(-1)
        k_out = b6(lay, ah, levels, plan_qt.block_q)
        p_out = b6(lay, ah, levels, plan_qt.block_q, rows=(rows, blocks), plain=True)
        t_out = b6_tol(lay, ah, levels, plan_qt.block_q, rows=(rows, blocks))
        r_b, e_b, same_b = 0.0, 0.0, True
        for lv, (k, pl, tol) in enumerate(zip(k_out, p_out, t_out)):
            r, e, same, _ = hold(f"B6 batch n={n} level {lv}", tuple(o[rows] for o in k), pl, f32, tol)
            r_b, e_b, same_b = max(r_b, r), max(e_b, e), same_b and same
        # B4 at this batch's shapes on the same sampled blocks
        near = _near_field(plan_qt, lay.cx_v, lay.cy_v)
        cand = (near.cand_x, near.cand_y, near.cand_z, near.num_tiles)
        nk = dict(block_q=plan_qt.block_q, tile_d=plan_qt.p2_block_d)
        n_k = phase2_near_weights(lay.qx_v, lay.qy_v, ah, *cand, **nk)
        near_s = (lay.qx_v[rows], lay.qy_v[rows], ah[rows], *(c[blocks] for c in cand))
        r_n, e_n, same_n, _ = hold(f"B4 quadtree batch n={n}", tuple(o[rows] for o in n_k),
                                   phase2_near_weights_plain(*near_s, **nk), f32, phase2_near_tolerance(*near_s, **nk))
        print(f"  batch n={n} seed={seed}: B6 on {blocks.numel()} of its {nb} query blocks, every level, against its "
              f"plain version: within {r_b:.4f} of its per-query tolerance ({e_b:.2f} ulps), bitwise equal: "
              f"{same_b}; B4 on them within {r_n:.4f} of its tolerance ({e_n:.2f} ulps), bitwise equal: {same_n}",
              flush=True)
        del lay, ah, levels, k_out, p_out, t_out
    qx, qy = batches[0]
    z2, a2, _ = execute_with_stats(plan_qt, qx, qy)
    check(torch.equal(z2, qt_results[0][0]) and torch.equal(a2, qt_results[0][1]), "quadtree run-to-run bits")
    print("  quadtree run-to-run bitwise equal: True")
    profile_batch(f"quadtree n={qx.shape[0]}", lambda: execute_with_stats(plan_qt, qx, qy))

    # ------------------------------------------------ 17. (e) overflow arm
    print("== 17. (e) quadtree overflow arm: 4,096 points, 96 queries over [-3, 3]^2, radius 1", flush=True)
    rng = np.random.default_rng(14)
    odx, ody = rng.random(4096).astype(np.float32), rng.random(4096).astype(np.float32)
    odz = (np.sin(6 * odx) * np.cos(6 * ody) + 2.0).astype(np.float32)
    oqx = torch.as_tensor((rng.random(96) * 6 - 3).astype(np.float32), device=dev)
    oqy = torch.as_tensor((rng.random(96) * 6 - 3).astype(np.float32), device=dev)
    op = AIDWParams(k=10, area=1.0, r_max=64.0)
    od = [torch.as_tensor(v, device=dev) for v in (odx, ody, odz)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pq = build_plan(*od, params=op, area=1.0, impl="grid", phase2="quadtree", farfield_radius=1,
                        query_occupancy=64.0)
        pe = build_plan(*od, params=op, area=1.0, impl="grid", query_occupancy=64.0)
    _build.reset_launch_counts()
    z_q, a_q, st = execute_with_stats(pq, oqx, oqy)
    o_launches = dict(_build.LAUNCHES)
    z_ex, a_ex = execute(pe, oqx, oqy)
    same = torch.equal(z_q, z_ex) and torch.equal(a_q, a_ex)
    print(f"  p2_capacity {pq.p2_capacity} of m = {pq.m}; p2_overflow_queries {int(st['p2_overflow_queries'])} of 96; "
          f"launches {o_launches}; z and alpha equal the exact plan's bit for bit: {same}")
    check(int(st["p2_overflow_queries"]) == 96 and o_launches["weight_soa"] == 1, "the batch overflows into B2")
    check(same, "the quadtree overflow arm is the exact plan's, bit for bit")

    # ------------------------------------------------ 18. (f) the ring arm
    print("== 18. (f) ring search, every query active: 1,024 queries over [-3, 3]^2 against the aidw-pod-1m grid",
          flush=True)
    grid = plan_qt.grid
    rng = np.random.default_rng(18)
    rqx, rqy = (torch.as_tensor((rng.random(1024) * 6 - 3).astype(np.float32), device=dev) for _ in range(2))
    sync()
    t0 = time.time()
    best, rings = _ring_search(grid, rqx, rqy, params.k, active=torch.ones(1024, dtype=torch.bool, device=dev))
    r_obs = mean_k(sqrt_rn(best))
    sync()
    ring_s = time.time() - t0
    ref = brute_r_obs(dx.double(), dy.double(), rqx.double(), rqy.double(), params.k)
    e_ring = float(((r_obs.double() - ref).abs() / ref).max())
    print(f"  {rings} rings (cover radius of a corner query {max(grid.gx, grid.gy) - 1}), {ring_s} s host clock "
          f"({grid.gx}x{grid.gy} cells, cap {grid.cap}); r_obs vs float64 brute force: max rel err {e_ring:.3e} "
          f"(tolerance 1e-5)", flush=True)
    check(e_ring <= 1e-5, "ring-search r_obs matches the float64 brute force")
    # the arm as the serving path runs it: the queries of the first 65,536
    # batch whose block overflowed the candidate capacity
    lay = _grid_layout(plan_qt, *batches[0])
    sync()
    t0 = time.time()
    _, rings = _ring_search(grid, lay.qx_s, lay.qy_s, params.k, active=lay.over_q)
    sync()
    print(f"  serving batch n={batches[0][0].shape[0]} seed={SERVING[0][1]}: the arm for its {int(lay.over_q.sum())} "
          f"overflowed queries walks {rings} rings in {time.time() - t0} s host clock", flush=True)

    # ------------------------------------------------ 19. (g) B6 timings
    print("== 19. (g) B6 timings (CUDA events, serving batch n=65536, m=2^20, float32 and float64)", flush=True)
    p, lay, ah, levels = qt32
    n_v = lay.qx_v.shape[0]
    threads, splits = far_node_launch(n_v, sms, block_q=p.block_q)
    sass = far_sass("far_node", splits)
    # What these inputs need: a term for each closed node of each block,
    # FAR_NODE_OPS operations on the FP32 pipes and the three FAR_NODE_MUFU
    # ops on the special-function units a pair.  Bytes: queries and alpha
    # read once, the closed ids and the level's node arrays read once, the
    # two sums written once.  The launch walks each row up to its closed
    # nodes rounded up to a run; the first design walked whole tiles.
    total = dict(ms=0.0, plain=0.0, f64=0.0, bound=0.0, pairs=0, walked=0, tiles=0)
    bound_kinds = set()
    lv64 = list(level_args(*qt64[1:]))
    for lv, ((qx, qy, a, tbl, nt, nodes), n_closed, tile) in enumerate(level_args(lay, ah, levels)):
        kw = dict(block_q=p.block_q, tile_d=tile)
        ms = time_ms(lambda: phase2_far_nodes(qx, qy, a, tbl, nt, nodes, n_closed=n_closed, **kw), 10)
        plain_ms = time_ms(lambda: phase2_far_nodes_plain(qx, qy, a, tbl, nt, nodes, **kw), 1, warmup=0)
        args64, nc64, tile64 = lv64[lv]
        ms64 = time_ms(lambda: phase2_far_nodes(*args64, n_closed=nc64, block_q=qt64[0].block_q, tile_d=tile64), 3)
        closed = torch.clamp(n_closed.long(), 0, tbl.shape[1])
        n_closed_tot = int(closed.sum())
        pairs = p.block_q * n_closed_tot
        walked = p.block_q * int(torch.minimum(nt.long() * tile, (closed + SUM_RUN - 1) // SUM_RUN * SUM_RUN).sum())
        tiles = p.block_q * int(nt.long().sum()) * tile
        n_bytes = 3 * 4 * n_v + 4 * n_closed_tot + 6 * 4 * nodes[0].shape[0] + 2 * 4 * n_v
        bound_ms, bound_by = bound(pairs, n_bytes, FAR_NODE_OPS, sfu_ops=len(FAR_NODE_MUFU) * pairs)
        for key, v in (("ms", ms), ("plain", plain_ms), ("f64", ms64), ("bound", bound_ms), ("pairs", pairs),
                       ("walked", walked), ("tiles", tiles)):
            total[key] += v
        bound_kinds.add(bound_by)
        print(f"  far_node level {lv}: {ms} ms (f64 {ms64} ms; plain {plain_ms} ms), bound {bound_ms} ms by "
              f"{bound_by}; {pairs} pairs needed, {walked} walked ({tiles} in whole tiles); k_pad "
              f"{p.qt_levels[lv][3]}, tile {tile}", flush=True)
    pairs, walked = total["pairs"], total["walked"]
    f64_ops = 1e3 * pairs * 20 / PEAK_OPS["float64"]
    print(f"  far_node, {len(levels)} launches per batch ({threads} threads a block, S = {splits}): {total['ms']} ms "
          f"float32, {total['f64']} ms float64 (plain {total['plain']} ms), bound {total['bound']} ms; "
          f"{pairs} pairs needed (block_q x sum of closed nodes), {walked} walked, {total['tiles']} in whole tiles")
    print(f"  far_node beside its bounds (float32): MUFU {1e3 * pairs * len(FAR_NODE_MUFU) / PEAK_SFU} ms "
          f"({len(FAR_NODE_MUFU)} a pair at 16/SM/clock); operations {1e3 * pairs * FAR_NODE_OPS / PEAK_OPS['float32']} "
          f"ms ({FAR_NODE_OPS} a pair); instruction issue of the walked pairs {1e3 * walked * sass[0] / PEAK_ISSUE} "
          f"ms ({sass[0]} SASS instructions a pair, S = {splits}); float64 operations {f64_ops} ms (20 a pair, exp, "
          "log and the division one each)")
    print(f"  batch wall times (host clock, this call): quadtree {qt_walls}, far-field {ff_walls}, exact "
          f"{[r[3] for r in results]} s")
    return [dict(name="far_node", route="cuda", **KERNELS["far_node"], launches=qt_launches["far_node"],
                 max_abs_err=b6_err, ms=total["ms"], plain_ms=total["plain"], bound_ms=total["bound"],
                 bound_by="operations" if bound_kinds == {"operations"} else "bytes", library_ms=None,
                 f64_ms=total["f64"], threads=threads, splits=splits)]


def dense_phases(*, dev, params, golden, eps, data, queries, sync, maxerr, time_ms, bound, z_tol, b2_rtol,
                 phase6_ms):
    """Phases 20-24: the paper's dense variants on the card, naive and tiled
    in SoA and AoaS, and the binned prefilter, with main's data and helpers.
    Returns the B7-B10 and binned B1 rows of the kernels line."""
    import torch

    from repro_torch.core.aidw import aidw_reference
    from repro_torch.core.layouts import coord_sentinel, soa_to_aoas
    from repro_torch.engine import build_plan, execute
    from repro_torch.engine.execute import binned_nbins
    from repro_torch.kernels import _build
    from repro_torch.kernels._common import alpha_from_best, sq_dist_tile
    from repro_torch.kernels.aidw_naive import (
        aidw_naive_aoas,
        aidw_naive_aoas_plain,
        aidw_naive_soa,
        aidw_naive_soa_plain,
        naive_launch,
    )
    from repro_torch.kernels.aidw_tiled import (
        knn_alpha,
        knn_alpha_aoas,
        knn_alpha_aoas_plain,
        knn_alpha_plain,
        knn_launch,
        weight_sweep,
        weight_sweep_aoas,
        weight_sweep_aoas_plain,
        weight_sweep_plain,
    )

    f32, f64 = torch.float32, torch.float64
    hit_eps = params.exact_hit_eps
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    block_d = 512  # the plans' default data tile
    nbins = binned_nbins(params.k, block_d)
    kw = dict(params=params, area=1.0, m_real=M_FULL)
    variants = {  # (impl, layout) -> the kernels its path launches
        ("naive", "soa"): {"naive_soa"}, ("naive", "aoas"): {"naive_aoas"},
        ("tiled", "soa"): {"knn_soa", "weight_soa"}, ("tiled", "aoas"): {"knn_aoas", "weight_aoas"},
        ("binned", "soa"): {"knn_binned", "weight_soa"},
    }

    def dtname(dtype):
        return str(dtype).split(".")[1]

    def padded(dtype):
        dx, dy, dz = data(dtype)
        pad = build_plan(dx, dy, dz, params=params, area=1.0, impl="tiled", block_d=block_d).data
        return pad, soa_to_aoas(*pad)

    def rel(k, p):
        return float(((k - p) / p).abs().max())

    def nearest_dropped_alpha(qx, qy, dx, dy):
        # the control: a k-best that loses each query's nearest point
        out = []
        for s in range(0, qx.shape[0], 256):
            d2 = sq_dist_tile(qx[s:s + 256, None], qy[s:s + 256, None], dx[None], dy[None])
            best = torch.topk(d2, params.k + 1, dim=1, largest=False, sorted=True).values[:, 1:]
            out.append(alpha_from_best(best, M_FULL, 1.0, params)[:, 0])
        return torch.cat(out)

    # ---------------------------------------- 20. (a) B7-B10, B1 binned vs plain
    print("== 20. (a) dense kernels vs their plain versions: B7/B8 naive.cu, B9 knn.cu AoaS, B10 weight.cu "
          f"AoaS, B1 binned (nbins {nbins}); m = 2^20, {N_CHECK} queries", flush=True)
    t_phase = time.time()
    errs, check_out = {}, {}
    for dtype in (f32, f64):
        name = dtname(dtype)
        (dxp, dyp, dzp), aoas = padded(dtype)
        qx, qy = (q[:N_CHECK].contiguous() for q in queries(*SERVING[0], dtype))
        nk = dict(block_q=64, block_d=block_d, **kw)
        z7, a7 = aidw_naive_soa(dxp, dyp, dzp, qx, qy, **nk)
        z7p, a7p = aidw_naive_soa_plain(dxp, dyp, dzp, qx, qy, params=params, area=1.0, m_real=M_FULL,
                                        block_d=block_d)
        z8, a8 = aidw_naive_aoas(aoas, qx, qy, **nk)
        z8p, a8p = aidw_naive_aoas_plain(aoas, qx, qy, params=params, area=1.0, m_real=M_FULL, block_d=block_d)
        tk = dict(block_q=256, tile_d=block_d, **kw)
        a9, a9p = knn_alpha_aoas(qx, qy, aoas, **tk), knn_alpha_aoas_plain(qx, qy, aoas, **tk)
        z10 = weight_sweep_aoas(qx, qy, a9 * 0.5, aoas, tile_d=block_d, eps=hit_eps)
        z10p = weight_sweep_aoas_plain(qx, qy, a9 * 0.5, aoas, tile_d=block_d, eps=hit_eps)
        ab = knn_alpha(qx, qy, dxp[None], dyp[None], nbins=nbins, **tk)
        abp = knn_alpha_plain(qx, qy, dxp[None], dyp[None], nbins=nbins, **tk)
        sync()
        for tag, a_k, a_p in (("B7 naive_soa alpha", a7, a7p), ("B8 naive_aoas alpha", a8, a8p),
                              ("B9 knn_aoas alpha", a9, a9p), ("B1 knn_binned alpha", ab, abp)):
            print(f"  {tag} {name}: bitwise equal to plain {torch.equal(a_k, a_p)} "
                  f"(max err {maxerr(a_k, a_p):.3e})")
            check(torch.equal(a_k, a_p), f"{tag} {name} equals its plain version exactly")
        # the binned walk's other bins: 4 points (not whole groups of the walk,
        # split between threads) and 12 points (one thread a query, bins
        # across stages), on the row cut to whole tiles
        for tile_o, nbins_o in ((512, 128), (384, 32)):
            m_o = dxp.shape[0] // tile_o * tile_o
            ko = dict(block_q=256, tile_d=tile_o, nbins=nbins_o, **kw)
            a_o = knn_alpha(qx, qy, dxp[None, :m_o], dyp[None, :m_o], **ko)
            a_op = knn_alpha_plain(qx, qy, dxp[None, :m_o], dyp[None, :m_o], **ko)
            tag = f"B1 knn_binned alpha, {tile_o // nbins_o}-point bins, {name}"
            print(f"  {tag} (threads, S) {knn_launch(N_CHECK, sms, bin_points=tile_o // nbins_o)}: bitwise equal to "
                  f"plain {torch.equal(a_o, a_op)}")
            check(torch.equal(a_o, a_op), f"{tag} equals its plain version exactly")
        for tag, z_k, z_p in (("B7 naive_soa z", z7, z7p), ("B8 naive_aoas z", z8, z8p),
                              ("B10 weight_aoas z", z10, z10p)):
            report(f"{tag} {name} relative (bitwise {torch.equal(z_k, z_p)})", rel(z_k, z_p), b2_rtol(dtype))
        # controls: a weight pass without its first tile, a k-best without the nearest point
        sent = coord_sentinel(dtype, dev)
        cut = aoas.clone()
        cut[:block_d, :2] = sent
        e_tile = rel(weight_sweep_aoas_plain(qx, qy, a9 * 0.5, cut, tile_d=block_d, eps=hit_eps), z10p)
        e_tile_naive = rel(weight_sweep_plain(qx, qy, a7p * 0.5, cut[:, 0].contiguous(), cut[:, 1].contiguous(),
                                              dzp, tile_d=block_d, eps=hit_eps), z7p)
        a_ctrl = nearest_dropped_alpha(qx, qy, dxp, dyp)
        moved = int((a_ctrl != a7p).sum())
        print(f"  controls {name}: a weight pass without its first tile is off by {e_tile:.3e} (B10) and "
              f"{e_tile_naive:.3e} (B7) relative; a k-best without the nearest point moves {moved} of "
              f"{N_CHECK} alphas", flush=True)
        check(min(e_tile, e_tile_naive) >= 10 * b2_rtol(dtype), "the z tolerance catches a lost tile by 10x")
        check(moved > 0, "the exact alpha check catches a lost nearest point")
        if dtype == f32:
            errs = {"naive_soa": max(maxerr(z7, z7p), maxerr(a7, a7p)),
                    "naive_aoas": max(maxerr(z8, z8p), maxerr(a8, a8p)),
                    "knn_aoas": maxerr(a9, a9p), "weight_aoas": maxerr(z10, z10p), "knn_binned": maxerr(ab, abp)}
        check_out[dtype] = (qx, qy, (dxp, dyp, dzp), aoas, {"naive_soa": (z7, a7), "naive_aoas": (z8, a8),
                                                            "tiled_aoas": (z10, a9)})
        del z7p, a7p, z8p, a8p, a9p, z10p, abp, cut
    print(f"  phase 20: {time.time() - t_phase:.1f} s", flush=True)

    # ---------------------------------------------- 21. (b) across variants
    print("== 21. (b) the variants against each other on the card (same inputs as phase 20)", flush=True)
    t_phase = time.time()
    for dtype in (f32, f64):
        qx, qy, (dxp, dyp, dzp), aoas, outs = check_out[dtype]
        a1 = knn_alpha(qx, qy, dxp[None], dyp[None], block_q=256, tile_d=block_d, **kw)
        z_ref, a_ref = weight_sweep(qx, qy, a1 * 0.5, dxp, dyp, dzp, tile_d=block_d, eps=hit_eps), a1
        for tag, (z, a) in outs.items():
            same_z = torch.equal(z, z_ref)
            print(f"  {tag} {dtname(dtype)} vs tiled_soa: alpha bitwise {torch.equal(a, a_ref)}, z bitwise {same_z} "
                  f"(relative {rel(z, z_ref):.3e})")
            check(torch.equal(a, a_ref) and same_z, f"{tag} gives tiled_soa's bits ({dtname(dtype)})")
    del check_out
    print(f"  phase 21: {time.time() - t_phase:.1f} s", flush=True)

    # ------------------------------------------------------- 22. (c) golden
    print("== 22. (c) golden fixture, dense variants", flush=True)
    t_phase = time.time()
    gp = type(params)(k=int(golden["k"]), area=float(golden["area"]))
    for dtype in (f32, f64):
        for batch in ("uniform", "clustered"):
            arr = [torch.as_tensor(golden[f"{batch}_{n}"]).to(dev, dtype) for n in ("dx", "dy", "dz", "qx", "qy")]
            for impl, layout in (("naive", "soa"), ("naive", "aoas"), ("tiled", "aoas")):
                plan = build_plan(*arr[:3], params=gp, area=gp.area, impl=impl, layout=layout, block_q=64,
                                  block_d=128)
                z, a = execute(plan, arr[3], arr[4])
                ez = np.abs(z.cpu().double().numpy() - golden[f"{batch}_z"])
                ea = np.abs(a.cpu().double().numpy() - golden[f"{batch}_alpha"])
                tz = GOLDEN_ATOL + GOLDEN_RTOL * np.abs(golden[f"{batch}_z"])
                ta = GOLDEN_ATOL + GOLDEN_RTOL * np.abs(golden[f"{batch}_alpha"])
                tag = f"{impl}/{layout} {batch} {dtname(dtype)}"
                print(f"  {tag}: max |dz| {ez.max():.3e}, max |dalpha| {ea.max():.3e}")
                check(bool((ez <= tz).all() and (ea <= ta).all()), f"golden {tag}")
    print(f"  phase 22: {time.time() - t_phase:.1f} s", flush=True)

    # -------------------------------------------- 23. (d) aidw-pod-1m dense
    n_q, seed = SERVING[0]
    print(f"== 23. (d) dense run of aidw-pod-1m: clustered m = 2^20, k = 10, serving batch n={n_q} "
          f"seed={seed}", flush=True)
    t_phase = time.time()
    qx64, qy64 = queries(n_q, seed, f64)
    idx = torch.as_tensor(np.random.default_rng(seed).choice(n_q, N_SAMPLE, replace=False), device=dev)
    d64 = data(f64)
    zr, ar = [], []
    for part in idx.split(128):
        zz, aa = aidw_reference(*d64, qx64[part], qy64[part], params, area=1.0)
        zr.append(zz)
        ar.append(aa)
    zr, ar = torch.cat(zr), torch.cat(ar)
    zmax = float(d64[2].abs().max())
    dense_launches, walls = {}, {}
    for dtype in (f32, f64):
        dd = data(dtype)
        qx, qy = queries(n_q, seed, dtype)
        for (impl, layout), own in variants.items():
            tag = f"{impl}/{layout} {dtname(dtype)}"
            sync()
            t0 = time.time()
            plan = build_plan(*dd, params=params, area=1.0, impl=impl, layout=layout)
            sync()
            plan_s = time.time() - t0
            _build.reset_launch_counts()
            sync()
            t0 = time.time()
            z, a = execute(plan, qx, qy)
            sync()
            wall = time.time() - t0
            launched = dict(_build.LAUNCHES)
            walls[impl, layout, dtype] = wall
            for kname, count in launched.items():
                dense_launches[kname] = dense_launches.get(kname, 0) + count
            print(f"  {tag}: plan {plan_s} s, batch {wall} s ({n_q / wall} queries/s), block_q {plan.block_q}, "
                  f"launches {{{', '.join(f'{k}: {v}' for k, v in launched.items() if v)}}}", flush=True)
            check({k for k, v in launched.items() if v} == own, f"{tag} launches its own kernels and no others")
            check(bool(torch.isfinite(z).all() and torch.isfinite(a).all()) and z.shape == (n_q,),
                  f"{tag} finite outputs of shape ({n_q},)")
            zs, as_ = z[idx].double(), a[idx].double()
            if impl == "binned":
                r = (zs - zr).abs() / (zr.abs() + 1e-9)
                shift = float(((as_ - ar).abs() > ALPHA_SHIFT).double().mean())
                print(f"  {tag} vs f64 reference: mean rel {float(r.mean()):.3e} (< {BINNED_MEAN}), max rel "
                      f"{float(r.max()):.3e} (< {BINNED_MAX}), alpha shifted > {ALPHA_SHIFT}: {shift} "
                      f"(< {ALPHA_SHIFT_SHARE}), max |dalpha| {maxerr(as_, ar):.3e}")
                check(float(r.mean()) < BINNED_MEAN and float(r.max()) < BINNED_MAX and shift < ALPHA_SHIFT_SHARE,
                      f"{tag} within the binned error envelope")
            else:
                report(f"{tag} z vs f64 reference", maxerr(zs, zr), z_tol(dtype, M_FULL, zmax))
                report(f"{tag} alpha vs f64 reference", maxerr(as_, ar), 1e-5)
            del plan, z, a
    print(f"  phase 23: {time.time() - t_phase:.1f} s", flush=True)

    # ---------------------------------------------------- 24. (e) timings
    print(f"== 24. (e) dense kernel timings (CUDA events, n={n_q}, m=2^20)", flush=True)
    t_phase = time.time()
    n_pairs = n_q * M_FULL
    sub = block_d // nbins
    # operations, counted from the kernels' code: kNN 6 per pair (d^2 5, the
    # k-th-best compare); weight 13 (d^2 5, max, mul, 2 adds, mul, compare,
    # exp and log one each); naive both, 19 per pair over its two passes;
    # binned 6 per pair (d^2 5, the bin-min compare) and one k-th-best
    # compare per bin.  Bytes: each input read once (a point is 3 values in
    # SoA, 4 in AoaS), each output written once.
    ops = {"naive_soa": 19 * n_pairs, "naive_aoas": 19 * n_pairs, "knn_aoas": 6 * n_pairs,
           "weight_aoas": 13 * n_pairs, "knn_binned": 6 * n_pairs + n_q * (M_FULL // sub),
           "knn_soa": 6 * n_pairs, "weight_soa": 13 * n_pairs}
    vals = {"naive_soa": (3 * M_FULL, 4 * n_q), "naive_aoas": (4 * M_FULL, 4 * n_q),
            "knn_aoas": (4 * M_FULL, 3 * n_q), "weight_aoas": (4 * M_FULL, 4 * n_q),
            "knn_binned": (2 * M_FULL, 3 * n_q), "knn_soa": (2 * M_FULL, 3 * n_q), "weight_soa": (3 * M_FULL, 4 * n_q)}
    # the kernels with a float32 weight pass: MUFU_PER_PAIR a pair on the
    # special-function units, a term of the bound
    sfu_kernels = {"naive_soa", "naive_aoas", "weight_aoas", "weight_soa"}
    times, rows = {}, []
    for dtype in (f32, f64):
        name = dtname(dtype)
        (dxp, dyp, dzp), aoas = padded(dtype)
        qx, qy = queries(n_q, seed, dtype)
        ah = torch.full_like(qx, 1.0)  # the sweep's cost does not depend on alpha
        nk = dict(block_q=64, block_d=block_d, **kw)
        tk = dict(block_q=256, tile_d=block_d, **kw)
        calls = {
            "naive_soa": (lambda: aidw_naive_soa(dxp, dyp, dzp, qx, qy, **nk),
                          lambda: aidw_naive_soa_plain(dxp, dyp, dzp, qx, qy, params=params, area=1.0,
                                                       m_real=M_FULL, block_d=block_d)),
            "naive_aoas": (lambda: aidw_naive_aoas(aoas, qx, qy, **nk),
                           lambda: aidw_naive_aoas_plain(aoas, qx, qy, params=params, area=1.0, m_real=M_FULL,
                                                         block_d=block_d)),
            "knn_aoas": (lambda: knn_alpha_aoas(qx, qy, aoas, **tk), lambda: knn_alpha_aoas_plain(qx, qy, aoas, **tk)),
            "weight_aoas": (lambda: weight_sweep_aoas(qx, qy, ah, aoas, tile_d=block_d, eps=hit_eps),
                            lambda: weight_sweep_aoas_plain(qx, qy, ah, aoas, tile_d=block_d, eps=hit_eps)),
            "knn_binned": (lambda: knn_alpha(qx, qy, dxp[None], dyp[None], nbins=nbins, **tk),
                           lambda: knn_alpha_plain(qx, qy, dxp[None], dyp[None], nbins=nbins, **tk)),
            "knn_soa": (lambda: knn_alpha(qx, qy, dxp[None], dyp[None], **tk), None),
            "weight_soa": (lambda: weight_sweep(qx, qy, ah, dxp, dyp, dzp, tile_d=block_d, eps=hit_eps), None),
        }
        for kname, (kern, plain) in calls.items():
            # float64 launches take of the order of a second, and every kernel here ran in phase 23:
            # one timed launch, no warm-up
            ms = time_ms(kern, 3) if dtype == f32 else time_ms(kern, 1, warmup=0)
            n_vals, q_vals = vals[kname]
            sfu_ops = n_pairs * MUFU_PER_PAIR if dtype == f32 and kname in sfu_kernels else 0
            bound_ms, bound_by = bound(ops[kname], (n_vals + q_vals) * dtype.itemsize, 1, name, sfu_ops=sfu_ops)
            times[kname, dtype] = ms
            line = f"  {kname} {name}: {ms} ms (bound {bound_ms} ms by {bound_by}"
            if dtype == f32 and plain is not None:
                plain_ms = time_ms(plain, 1, warmup=0)
                line += f", plain {plain_ms} ms"
                rows.append(dict(name=kname, route="cuda", **KERNELS[kname], launches=dense_launches[kname],
                                 max_abs_err=errs[kname], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by, library_ms=None))
                if kname.startswith("knn"):
                    rows[-1].update(zip(("threads", "splits"), knn_launch(
                        n_q, sms, block_q=256, bin_points=sub if kname == "knn_binned" else 0)))
                elif kname.startswith("naive"):
                    rows[-1].update(zip(("threads", "splits"), naive_launch(n_q, sms)))
            print(line + ")", flush=True)
    print(f"  tiled SoA beside phase 6 (float32, this call): knn_soa {times['knn_soa', f32]} ms here, "
          f"{phase6_ms['knn_soa_row']} ms in phase 6; weight_soa {times['weight_soa', f32]} ms here, "
          f"{phase6_ms['weight_soa']} ms in phase 6")
    table = {"naive SoA": ("naive_soa",), "naive AoaS": ("naive_aoas",), "tiled SoA": ("knn_soa", "weight_soa"),
             "tiled AoaS": ("knn_aoas", "weight_aoas"), "binned SoA": ("knn_binned", "weight_soa")}
    print("  the paper's comparison (kernel ms, CUDA events; batch s, host clock, phase 23):")
    print("  | variant | f32 kernels ms | f64 kernels ms | f64 / f32 | f32 batch s | f64 batch s |")
    tot = {}
    for label, names in table.items():
        for dtype in (f32, f64):
            tot[label, dtype] = sum(times[k, dtype] for k in names)
        impl, layout = label.split()
        print(f"  | {label} | {tot[label, f32]} | {tot[label, f64]} | {tot[label, f64] / tot[label, f32]:.2f} | "
              f"{walls[impl, layout.lower(), f32]} | {walls[impl, layout.lower(), f64]} |")
    for dtype in (f32, f64):
        print(f"  {dtname(dtype)}: naive / tiled SoA {tot['naive SoA', dtype] / tot['tiled SoA', dtype]:.3f}, "
              f"AoaS {tot['naive AoaS', dtype] / tot['tiled AoaS', dtype]:.3f}; AoaS / SoA naive "
              f"{tot['naive AoaS', dtype] / tot['naive SoA', dtype]:.3f}, tiled "
              f"{tot['tiled AoaS', dtype] / tot['tiled SoA', dtype]:.3f}")
    print(f"  phase 24: {time.time() - t_phase:.1f} s", flush=True)
    return rows



def fused_v2_idw_phases(*, dev, params, golden, data, queries, sync, maxerr, time_ms, bound, z_tol, b2_rtol):
    """Phases 25-29: the ``fused``, ``tiled_v2``, ``idw`` and ``chunked``
    impls on the card, with main's data and helpers.  Returns the B11-B13
    rows of the kernels line."""
    import torch

    from repro_torch.core.aidw import aidw_reference
    from repro_torch.core.idw import idw_reference
    from repro_torch.core.layouts import coord_sentinel
    from repro_torch.engine import build_plan, execute, execute_with_stats
    from repro_torch.kernels import _build
    from repro_torch.kernels._common import alpha_from_best, merge_k_best, sq_dist_tile
    from repro_torch.core.aidw import tiny_for
    from repro_torch.kernels.aidw_fused import aidw_fused_soa, aidw_fused_soa_plain, fused_launch, fused_part
    from repro_torch.kernels.aidw_naive import aidw_naive_soa, aidw_naive_soa_plain
    from repro_torch.kernels.aidw_tiled import (
        _alpha_consts,
        aidw_tiled_soa,
        knn_alpha,
        knn_alpha_plain,
        knn_launch,
        knn_stage_points,
        weight_sweep,
        weight_sweep_plain,
    )
    from repro_torch.kernels.aidw_tiled_v2 import knn_alpha_v2, knn_alpha_v2_plain
    from repro_torch.kernels.idw_tiled import idw_tiled_soa, idw_tiled_soa_plain

    f32, f64 = torch.float32, torch.float64
    hit_eps = params.exact_hit_eps
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    block_q, block_d = 256, 512  # the plans' defaults
    idw_alpha = 2.0
    kw = dict(params=params, area=1.0, m_real=M_FULL)

    def dtname(dtype):
        return str(dtype).split(".")[1]

    def padded(dtype):
        dx, dy, dz = data(dtype)
        return build_plan(dx, dy, dz, params=params, area=1.0, impl="tiled", block_d=block_d).data

    def rel(k, p):
        return float(((k - p) / p).abs().max())

    def tile0_alpha(qx, qy, dx, dy, p):
        # the control: a threshold-skip pass that never merges after tile 0
        best = torch.full((qx.shape[0], p.k), math.inf, dtype=qx.dtype, device=qx.device)
        best = merge_k_best(best, sq_dist_tile(qx[:, None], qy[:, None], dx[None, :block_d], dy[None, :block_d]))
        return alpha_from_best(best, M_FULL, 1.0, p)[:, 0]

    # ---------------------------------------------- 25. B11-B13 vs plain
    print(f"== 25. B11 fused.cu, B12 knn.cu threshold-skip, B13 weight.cu IDW vs their plain versions; m = 2^20, "
          f"{N_CHECK} queries", flush=True)
    t_phase = time.time()
    errs, check_out = {}, {}
    for dtype in (f32, f64):
        name = dtname(dtype)
        dxp, dyp, dzp = padded(dtype)
        qx, qy = (q[:N_CHECK].contiguous() for q in queries(*SERVING[0], dtype))
        fk = dict(block_q=block_q, block_d=block_d, **kw)
        z11, a11 = aidw_fused_soa(dxp, dyp, dzp, qx, qy, **fk)
        z11p, a11p = aidw_fused_soa_plain(dxp, dyp, dzp, qx, qy, **fk)
        vk = dict(block_q=block_q, tile_d=block_d, **kw)
        a12, m12 = knn_alpha_v2(qx, qy, dxp, dyp, **vk)
        a12p, m12p = knn_alpha_v2_plain(qx, qy, dxp, dyp, **vk)
        z13 = idw_tiled_soa(dxp, dyp, dzp, qx, qy, alpha=idw_alpha, exact_hit_eps=hit_eps, block_q=block_q,
                            block_d=block_d)
        z13p = idw_tiled_soa_plain(dxp, dyp, dzp, qx, qy, alpha=idw_alpha, exact_hit_eps=hit_eps, block_d=block_d)
        half = torch.full_like(qx, idw_alpha * 0.5)
        z13_b2 = weight_sweep(qx, qy, half, dxp, dyp, dzp, tile_d=block_d, eps=hit_eps)
        z13_up = weight_sweep(qx, qy, torch.nextafter(half, torch.full_like(half, math.inf)), dxp, dyp, dzp,
                              tile_d=block_d, eps=hit_eps)
        sync()
        for tag, a_k, a_p in (("B11 fused alpha", a11, a11p), ("B12 knn_v2 alpha", a12, a12p)):
            print(f"  {tag} {name}: bitwise equal to plain {torch.equal(a_k, a_p)} (max err {maxerr(a_k, a_p):.3e})")
            check(torch.equal(a_k, a_p), f"{tag} {name} equals its plain version exactly")
        n_tiles = dxp.shape[0] // block_d
        print(f"  B12 merges {name}: {m12.tolist()} of {n_tiles} tiles per block; equal to plain "
              f"{torch.equal(m12, m12p)}")
        check(torch.equal(m12, m12p), f"B12 {name} merges equal the plain version's")
        for tag, z_k, z_p in (("B11 fused z", z11, z11p), ("B13 idw z", z13, z13p)):
            report(f"{tag} {name} relative (bitwise {torch.equal(z_k, z_p)})", rel(z_k, z_p), b2_rtol(dtype))
        check(torch.equal(z13, z13_b2), f"B13 {name} gives B2's bits at the filled alpha / 2")
        # controls
        sent = coord_sentinel(dtype, dev)
        cut = torch.zeros_like(dxp, dtype=torch.bool)
        cut[:block_d] = True
        z_cut, _ = aidw_fused_soa_plain(torch.where(cut, sent, dxp), torch.where(cut, sent, dyp), dzp, qx, qy, **fk)
        e_cut = rel(z_cut, z11p)
        a_t0 = tile0_alpha(qx, qy, dxp, dyp, params)
        moved = int((a_t0 != a12).sum())
        idw_up_same = torch.equal(z13_up, z13)
        # B11's split: a k-best that loses the points of the last of four
        # parts of every kNN stage (fused_part), and z at its alpha
        gone = torch.zeros_like(dxp, dtype=torch.bool)
        gone[fused_part(dxp.shape[0], knn_stage_points(dtype), 4, 3).to(dev)] = True
        a_part = knn_alpha_plain(qx, qy, torch.where(gone, sent, dxp)[None], torch.where(gone, sent, dyp)[None],
                                 block_q=block_q, tile_d=block_d, **kw)
        z_part = weight_sweep_plain(qx, qy, a_part * 0.5, dxp, dyp, dzp, tile_d=block_d, eps=hit_eps)
        moved_part, e_part = int((a_part != a11p).sum()), rel(z_part, z11p)
        print(f"  B11 control {name}: a k-best without part 4 of 4 of every stage moves {moved_part} of {N_CHECK} "
              f"alphas and z by {e_part:.3e} relative, {e_part / b2_rtol(dtype):.1f}x the tolerance", flush=True)
        check(moved_part > 0 and e_part > 10 * b2_rtol(dtype), "B11's checks catch a k-best that loses a part by 10x")
        print(f"  controls {name}: a fused sweep without its first tile is off by {e_cut:.3e} relative; a pass "
              f"that never merges after tile 0 moves {moved} of {N_CHECK} alphas and counts "
              f"{qx.shape[0] // block_q} merges against {int(m12.sum())}; a sweep at alpha / 2 + 1 ulp gives "
              f"B13's bits: {idw_up_same} (relative {rel(z13_up, z13):.3e})", flush=True)
        check(e_cut > b2_rtol(dtype), "the z tolerance catches a fused sweep that loses a tile")
        check(moved > 0 and int(m12.sum()) > qx.shape[0] // block_q, "the exact checks catch a pass that stops merging")
        check(not idw_up_same, "the bitwise check catches alpha / 2 one ulp off")
        if dtype == f32:
            errs = {"fused": max(maxerr(z11, z11p), maxerr(a11, a11p)), "knn_v2": maxerr(a12, a12p),
                    "idw": maxerr(z13, z13p)}
        check_out[dtype] = (qx, qy, (dxp, dyp, dzp), z11, a11, a12, m12, z13)
        del z11p, a11p, a12p, z13p, z_cut, z_part
    print(f"  phase 25: {time.time() - t_phase:.1f} s", flush=True)

    # --------------------------------------------------- 26. bits on the card
    print("== 26. bits on the card: fused == tiled SoA, tiled_v2 alpha == B1, idw == filled B2; k = 7", flush=True)
    t_phase = time.time()
    for dtype in (f32, f64):
        qx, qy, (dxp, dyp, dzp), z11, a11, a12, m12, z13 = check_out[dtype]
        a1 = knn_alpha(qx, qy, dxp[None], dyp[None], block_q=block_q, tile_d=block_d, **kw)
        z2 = weight_sweep(qx, qy, a1 * 0.5, dxp, dyp, dzp, tile_d=block_d, eps=hit_eps)
        same = {"fused alpha": torch.equal(a11, a1), "fused z": torch.equal(z11, z2),
                "tiled_v2 alpha": torch.equal(a12, a1)}
        print(f"  {dtname(dtype)}: {same}")
        check(all(same.values()), f"fused and tiled_v2 give tiled SoA's bits ({dtname(dtype)})")
        # B11 at S = 1, 2 and 4 threads a query (256 threads a block), and at
        # a plan tile past the first design's 48 KiB cap (4,096 float32 or
        # 2,048 float64 points: 64 KiB of {x, y, z, pad}) through the wrapper
        # (fused_launch) and at S = 2 (two such tiles a round)
        fn = _build.entry("aidw_fused_f32" if dtype == f32 else "aidw_fused_f64")
        consts = _alpha_consts(params, 1.0, M_FULL)
        stream = torch.cuda.current_stream().cuda_stream

        def fused_at(tile, splits):
            z, a = torch.empty_like(qx), torch.empty_like(qx)
            _build.check(fn(qx.data_ptr(), qy.data_ptr(), dxp.data_ptr(), dyp.data_ptr(), dzp.data_ptr(), qx.shape[0],
                            dxp.shape[0], tile, params.k, 256, splits, *consts, float(hit_eps), tiny_for(dtype),
                            z.data_ptr(), a.data_ptr(), stream), "fused launch")
            return z, a

        big = 4096 if dtype == f32 else 2048
        z_big = weight_sweep(qx, qy, a1 * 0.5, dxp, dyp, dzp, tile_d=big, eps=hit_eps)
        runs = {f"S={sp}": (fused_at(block_d, sp), z2) for sp in (1, 2, 4)}
        runs[f"block_d {big} {fused_launch(qx.shape[0], sms, big, dtype)}"] = (
            aidw_fused_soa(dxp, dyp, dzp, qx, qy, block_q=block_q, block_d=big, **kw), z_big)
        runs[f"block_d {big} S=2"] = (fused_at(big, 2), z_big)
        s_same = {tag: torch.equal(a, a1) and torch.equal(z, z_ref) for tag, ((z, a), z_ref) in runs.items()}
        print(f"  fused == tiled SoA {dtname(dtype)} by launch shape: {s_same}", flush=True)
        check(all(s_same.values()), f"B11 gives tiled SoA's bits at every S and at block_d {big} ({dtname(dtype)})")
        p7 = type(params)(k=7, area=1.0)
        k7 = dict(params=p7, area=1.0, m_real=M_FULL)
        a_k = knn_alpha(qx, qy, dxp[None], dyp[None], block_q=block_q, tile_d=block_d, **k7)
        a_p = knn_alpha_plain(qx, qy, dxp[None], dyp[None], block_q=block_q, tile_d=block_d, **k7)
        zn, an = aidw_naive_soa(dxp, dyp, dzp, qx, qy, block_q=64, block_d=block_d, **k7)
        znp, anp = aidw_naive_soa_plain(dxp, dyp, dzp, qx, qy, block_d=block_d, **k7)
        zf, af = aidw_fused_soa(dxp, dyp, dzp, qx, qy, block_q=block_q, block_d=block_d, **k7)
        zfp, afp = aidw_fused_soa_plain(dxp, dyp, dzp, qx, qy, block_q=block_q, block_d=block_d, **k7)
        sync()
        k7_same = {"knn": torch.equal(a_k, a_p), "naive": torch.equal(an, anp), "fused": torch.equal(af, afp)}
        print(f"  k = 7 {dtname(dtype)}: alpha bitwise equal to plain {k7_same}; z relative naive "
              f"{rel(zn, znp):.3e}, fused {rel(zf, zfp):.3e}; k = 7 alpha differs from k = 10 at "
              f"{int((a_k != a1).sum())} of {N_CHECK} queries")
        check(all(k7_same.values()), f"k = 7 alpha equals the plain versions' ({dtname(dtype)})")
        check(rel(zn, znp) <= b2_rtol(dtype) and rel(zf, zfp) <= b2_rtol(dtype), "k = 7 z within 64 ulps")
        check(torch.equal(an, af) and torch.equal(zn, zf), "k = 7 naive and fused give the same bits")
    del check_out
    print(f"  phase 26: {time.time() - t_phase:.1f} s", flush=True)

    # ------------------------------------------------------- 27. golden
    print("== 27. golden fixture: fused, tiled_v2, chunked", flush=True)
    t_phase = time.time()
    gp = type(params)(k=int(golden["k"]), area=float(golden["area"]))
    for dtype in (f32, f64):
        for batch in ("uniform", "clustered"):
            arr = [torch.as_tensor(golden[f"{batch}_{n}"]).to(dev, dtype) for n in ("dx", "dy", "dz", "qx", "qy")]
            for impl, extra in (("fused", {}), ("tiled_v2", {}), ("chunked", dict(knn="brute")),
                                ("chunked", dict(knn="grid"))):
                plan = build_plan(*arr[:3], params=gp, area=gp.area, impl=impl, block_q=64, block_d=128, **extra)
                z, a = execute(plan, arr[3], arr[4])
                ez = np.abs(z.cpu().double().numpy() - golden[f"{batch}_z"])
                ea = np.abs(a.cpu().double().numpy() - golden[f"{batch}_alpha"])
                tz = GOLDEN_ATOL + GOLDEN_RTOL * np.abs(golden[f"{batch}_z"])
                ta = GOLDEN_ATOL + GOLDEN_RTOL * np.abs(golden[f"{batch}_alpha"])
                tag = f"{impl}{'/' + extra['knn'] if extra else ''} {batch} {dtname(dtype)}"
                print(f"  {tag}: max |dz| {ez.max():.3e}, max |dalpha| {ea.max():.3e}")
                check(bool((ez <= tz).all() and (ea <= ta).all()), f"golden {tag}")
    print(f"  phase 27: {time.time() - t_phase:.1f} s", flush=True)

    # ------------------------------------------ 28. aidw-pod-1m, the four impls
    n_q, seed = SERVING[0]
    print(f"== 28. aidw-pod-1m through fused, tiled_v2, idw (alpha = {idw_alpha}) and chunked: clustered m = 2^20, "
          f"k = 10, serving batch n={n_q} seed={seed}, float32", flush=True)
    t_phase = time.time()
    qx64, qy64 = queries(n_q, seed, f64)
    idx = torch.as_tensor(np.random.default_rng(seed).choice(n_q, N_SAMPLE, replace=False), device=dev)
    d64 = data(f64)
    zr, ar, zi = [], [], []
    for part in idx.split(128):
        zz, aa = aidw_reference(*d64, qx64[part], qy64[part], params, area=1.0)
        zr.append(zz)
        ar.append(aa)
        zi.append(idw_reference(*d64, qx64[part], qy64[part], idw_alpha))
    zr, ar, zi = torch.cat(zr), torch.cat(ar), torch.cat(zi)
    zmax = float(d64[2].abs().max())
    dd = data(f32)
    qx, qy = queries(n_q, seed, f32)
    paths = {"fused": ({}, {"fused"}), "tiled_v2": ({}, {"knn_v2", "weight_soa"}),
             "idw": (dict(idw_alpha=idw_alpha), {"idw"}), "chunked/brute": (dict(knn="brute"), set()),
             "chunked/grid": (dict(knn="grid"), set())}
    launches = {}
    for tag, (extra, own) in paths.items():
        impl = tag.split("/")[0]
        sync()
        t0 = time.time()
        plan = build_plan(*dd, params=params, area=1.0, impl=impl, **extra)
        sync()
        plan_s = time.time() - t0
        _build.reset_launch_counts()
        sync()
        t0 = time.time()
        z, a, stats = execute_with_stats(plan, qx, qy)
        sync()
        wall = time.time() - t0
        launched = {k: v for k, v in _build.LAUNCHES.items() if v}
        launches[tag] = launched
        shown = {k: float(v) for k, v in stats.items()}
        print(f"  {tag}: plan {plan_s} s, batch {wall} s ({n_q / wall} queries/s), launches {launched}, "
              f"stats {shown}", flush=True)
        check(set(launched) == own, f"{tag} launches its own kernels and no others")
        check(bool(torch.isfinite(z).all() and torch.isfinite(a).all()) and z.shape == (n_q,),
              f"{tag} finite outputs of shape ({n_q},)")
        zs, as_ = z[idx].double(), a[idx].double()
        if impl == "idw":
            report(f"{tag} z vs f64 idw_reference", maxerr(zs, zi), z_tol(f32, M_FULL, zmax))
            check(bool((a == idw_alpha).all()), "idw alpha is the constant")
        else:
            report(f"{tag} z vs f64 reference", maxerr(zs, zr), z_tol(f32, M_FULL, zmax))
            report(f"{tag} alpha vs f64 reference", maxerr(as_, ar), 1e-5)
        if impl == "tiled_v2":
            check(0.0 < float(stats["merge_fraction"]) <= 1.0, "merge_fraction in (0, 1]")
        del plan, z, a
    print(f"  phase 28: {time.time() - t_phase:.1f} s", flush=True)

    # ------------------------------------------------------- 29. timings
    print(f"== 29. B11-B13 timings (CUDA events, n={n_q}, m=2^20)", flush=True)
    t_phase = time.time()
    n_pairs = n_q * M_FULL
    # operations per pair, counted from the kernels' code: fused 6 (kNN: d^2
    # 5, the k-th-best compare) + 13 (weight: d^2 5, max, mul, 2 adds, mul,
    # compare, exp and log one each); the vote rides on the kNN compare; IDW
    # 13.  Bytes: each input read once, each output written once (values;
    # B12's merge votes are one byte per CUDA block and tile)
    ops = {"fused": 19 * n_pairs, "knn_v2": 6 * n_pairs, "idw": 13 * n_pairs}
    # the kernels with a float32 weight pass: MUFU_PER_PAIR a pair on the
    # special-function units, a term of the bound
    sfu_kernels = {"fused", "idw"}
    rows = []
    for dtype in (f32, f64):
        name = dtname(dtype)
        dxp, dyp, dzp = padded(dtype)
        qx, qy = queries(n_q, seed, dtype)
        n_tiles = dxp.shape[0] // block_d
        nbytes = {"fused": (3 * M_FULL + 4 * n_q) * dtype.itemsize,
                  "knn_v2": (2 * M_FULL + 3 * n_q) * dtype.itemsize + (n_q // block_q) * n_tiles,
                  "idw": (3 * M_FULL + 3 * n_q) * dtype.itemsize}
        fk = dict(block_q=block_q, block_d=block_d, **kw)
        vk = dict(block_q=block_q, tile_d=block_d, **kw)
        ik = dict(alpha=idw_alpha, exact_hit_eps=hit_eps, block_d=block_d)
        calls = {
            "fused": (lambda: aidw_fused_soa(dxp, dyp, dzp, qx, qy, **fk),
                      lambda: aidw_fused_soa_plain(dxp, dyp, dzp, qx, qy, **fk)),
            "knn_v2": (lambda: knn_alpha_v2(qx, qy, dxp, dyp, **vk), lambda: knn_alpha_v2_plain(qx, qy, dxp, dyp, **vk)),
            "idw": (lambda: idw_tiled_soa(dxp, dyp, dzp, qx, qy, block_q=block_q, **ik),
                    lambda: idw_tiled_soa_plain(dxp, dyp, dzp, qx, qy, **ik)),
        }
        for kname, (kern, plain) in calls.items():
            # float64 launches take of the order of a second: one timed launch after phase 28's
            ms = time_ms(kern, 3) if dtype == f32 else time_ms(kern, 1)
            sfu_ops = n_pairs * MUFU_PER_PAIR if dtype == f32 and kname in sfu_kernels else 0
            bound_ms, bound_by = bound(ops[kname], nbytes[kname], 1, name, sfu_ops=sfu_ops)
            line = f"  {kname} {name}: {ms} ms (bound {bound_ms} ms by {bound_by}"
            if dtype == f32:
                plain_ms = time_ms(plain, 1, warmup=0)
                line += f", plain {plain_ms} ms"
                rows.append(dict(name=kname, route="cuda", **KERNELS[kname],
                                 launches=sum(v.get(kname, 0) for v in launches.values()), max_abs_err=errs[kname],
                                 ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
                if kname == "knn_v2":
                    rows[-1].update(zip(("threads", "splits"), knn_launch(n_q, sms, block_q=block_q, vote=True)))
                elif kname == "fused":
                    rows[-1].update(zip(("threads", "splits"), fused_launch(n_q, sms, block_d, dtype)))
            print(line + ")", flush=True)
            if kname == "fused":
                # the two launches it replaces, B1 (shared row) then B2, on the same inputs
                pair_ms = time_ms(lambda: aidw_tiled_soa(dxp, dyp, dzp, qx, qy, **fk), 3 if dtype == f32 else 1)
                print(f"  fused {name} beside B1 + B2 (aidw_tiled_soa, this call): {ms} ms against {pair_ms} ms, "
                      f"{ms / pair_ms:.4f}x; {fused_launch(n_q, sms, block_d, dtype)} (threads, S)", flush=True)
    # the per-pair weight loop of each float32 sweep, from the SASS
    for kname, lib, func in (("weight_soa", "weight", weight_func()),
                             ("weight_aoas", "weight", weight_func(aoas=True)),
                             ("idw", "weight", weight_func(const_ah=True)),
                             ("naive_soa", "naive", naive_func(params.k)),
                             ("fused", "fused", fused_func(params.k))):
        sass = kernel_sass(lib, func)
        print(f"  {kname} float32 SASS weight loop: " + ("not found" if sass is None else
              f"{sass[0]} instructions per pair, MUFU per pair {mufu(sass[1])}"))
    print(f"  phase 29: {time.time() - t_phase:.1f} s", flush=True)
    return rows


def weight_shape_phase(*, params, data, queries, time_ms):
    """Phase 30: B2 (float32, SoA, m = 2^20) timed with CUDA events at 128 and
    256 threads a block at the masked arm's size, the serving batch's and
    2^20 queries, beside the wrapper's choice; both give the bits of the
    wrapper's launch."""
    import torch

    from repro_torch.engine import build_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.aidw_tiled import weight_launch, weight_sweep

    print("== 30. B2 block sizes (CUDA events, float32, m = 2^20)", flush=True)
    t_phase = time.time()
    block_d = 512
    dxp, dyp, dzp = build_plan(*data(torch.float32), params=params, area=1.0, impl="tiled", block_d=block_d).data
    fn = _build.entry("aidw_weight_f32")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in (8192, SERVING[0][0], M_FULL):
        qx, qy = queries(n, 30)
        ah = torch.full_like(qx, 1.0)
        ref = weight_sweep(qx, qy, ah, dxp, dyp, dzp, tile_d=block_d, eps=params.exact_hit_eps)
        stream = torch.cuda.current_stream().cuda_stream
        got = {}
        for threads in (128, 256):
            out = torch.empty_like(qx)

            def run():
                _build.check(fn(qx.data_ptr(), qy.data_ptr(), ah.data_ptr(), dxp.data_ptr(), dyp.data_ptr(),
                                dzp.data_ptr(), n, dxp.shape[0], block_d, threads, float(params.exact_hit_eps),
                                1e-30, out.data_ptr(), stream), "weight launch")

            got[threads] = time_ms(run, 1 if n == M_FULL else 3)
            check(torch.equal(out, ref), f"B2 with {threads} threads gives the wrapper's bits (n={n})")
        best = min(got, key=got.get)
        rule = weight_launch(n, sms)
        print(f"  n={n}: 128 threads {got[128]} ms, 256 threads {got[256]} ms; fastest {best}; "
              f"weight_launch picks {rule} ({sms} SMs); both bitwise equal", flush=True)
    print(f"  phase 30: {time.time() - t_phase:.1f} s", flush=True)


def knn_shape_phase(*, params, data, queries, time_ms):
    """Phase 31: B1 (float32, SoA shared row, m = 2^20) timed with CUDA events
    at S = 1, 2 and 4 threads a query and 128 or 256 threads a block, at
    8,192, 65,536 and 2^20 queries, beside the wrapper's choice
    (``kernels/aidw_tiled.py: knn_launch``), which must be the fastest or
    within 3% of it; every setting gives the wrapper's bits."""
    import torch

    from repro_torch.engine import build_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.aidw_tiled import KNN_GROUP, _alpha_consts, knn_alpha, knn_launch

    print(f"== 31. B1 splits (CUDA events, float32, m = 2^20, {KNN_GROUP} points a group)", flush=True)
    t_phase = time.time()
    block_q, block_d = 256, 512
    dxp, dyp, _ = build_plan(*data(torch.float32), params=params, area=1.0, impl="tiled", block_d=block_d).data
    fn = _build.entry("aidw_knn_alpha_f32")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    consts = _alpha_consts(params, 1.0, M_FULL)
    stream = torch.cuda.current_stream().cuda_stream
    for n in (8192, SERVING[0][0], M_FULL):
        qx, qy = queries(n, 31)
        ref = knn_alpha(qx, qy, dxp[None], dyp[None], block_q=block_q, tile_d=block_d, params=params, area=1.0,
                        m_real=M_FULL)
        runs = {}
        for threads in (128, 256):
            for splits in (1, 2, 4):
                out = torch.empty_like(qx)

                def run(threads=threads, splits=splits, out=out):
                    _build.check(fn(qx.data_ptr(), qy.data_ptr(), dxp.data_ptr(), dyp.data_ptr(), 0, None, n,
                                    block_q, dxp.shape[0], block_d, 0, params.k, threads, splits, *consts,
                                    out.data_ptr(), stream), "knn launch")

                run()
                check(torch.equal(out, ref), f"B1 with {threads} threads and S = {splits} gives the wrapper's bits "
                                             f"(n={n})")
                runs[threads, splits] = run
        got = time_in_turns(time_ms, runs, 1 if n == M_FULL else 3)
        best = min(got, key=got.get)
        rule = knn_launch(n, sms, block_q=block_q)
        print(f"  n={n}: " + ", ".join(f"{t} threads S={sp} {ms} ms" for (t, sp), ms in got.items())
              + f"; fastest {best}; knn_launch picks {rule} ({sms} SMs), {got[rule] / got[best]:.4f}x the fastest; "
              "all bitwise equal", flush=True)
        check(got[rule] <= 1.03 * got[best], f"knn_launch's pick at n={n} is within 3% of the fastest setting")
    print(f"  phase 31: {time.time() - t_phase:.1f} s", flush=True)


def row_shape_phase(*, params, data, queries, time_ms):
    """Phase 32: B4 and B5 (float32, the ``aidw-pod-1m`` far-field plan) timed
    with CUDA events at 64, 128 and 256 threads a block, at 8,192, 65,536
    (the first serving batch and another) and 2^20 queries, beside the
    wrapper's choice (``kernels/aidw_grid.py:
    row_launch``), which must be the fastest or within 5% of it; every
    setting gives the wrapper's bits.  B4 takes its rows longest first
    (``near_order``); it is also timed at the pick in row order, which gives
    the same bits, for comparison.  Also prints how far the near rows'
    lengths spread."""
    import torch

    from repro_torch.core.aidw import tiny_for
    from repro_torch.engine import build_plan
    from repro_torch.engine.execute import _grid_layout, _near_field
    from repro_torch.kernels import _build
    from repro_torch.kernels.aidw_grid import near_order, phase2_far_aggregates, phase2_near_weights, row_launch

    print("== 32. B4 and B5 block sizes (CUDA events, float32, aidw-pod-1m far-field plan, m = 2^20)", flush=True)
    t_phase = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p = build_plan(*data(torch.float32), params=params, area=1.0, impl="grid", phase2="farfield")
    fns = {"B4": _build.entry("aidw_near_weight_f32"), "B5": _build.entry("aidw_far_cell_f32")}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    tiny = tiny_for(torch.float32)
    ncp = p.far[0].shape[0]
    # a short batch, the first serving batch and another of its size (the
    # near rows' spread differs from batch to batch), and the 2^20 batch
    for n, seed in ((8192, 32), SERVING[0], (SERVING[0][0], 32), SERVING[3]):
        qx, qy = queries(n, seed)
        lay = _grid_layout(p, qx, qy)
        near = _near_field(p, lay.cx_v, lay.cy_v)
        n_v, (nb, c_tot) = lay.qx_v.shape[0], near.cand_x.shape
        ah = torch.full_like(lay.qx_v, 1.0)  # the sweeps' cost does not depend on alpha
        q3 = (lay.qx_v.data_ptr(), lay.qy_v.data_ptr(), ah.data_ptr())
        cand = (near.cand_x, near.cand_y, near.cand_z, near.num_tiles)
        order = near_order(near.num_tiles)
        refs = {"B4": phase2_near_weights(lay.qx_v, lay.qy_v, ah, *cand, block_q=p.block_q, tile_d=p.p2_block_d),
                "B5": phase2_far_aggregates(lay.qx_v, lay.qy_v, ah, near.rects, p.far, block_q=p.block_q,
                                            tile_d=p.p2_far_block_d)}
        args = {"B4": lambda t, order=order: (*q3, *(c.data_ptr() for c in cand),
                                              None if order is None else order.data_ptr(), n_v, p.block_q, c_tot,
                                              p.p2_block_d, t, tiny),
                "B5": lambda t: (*q3, near.rects.data_ptr(), *(a.data_ptr() for a in p.far), n_v, p.block_q, ncp,
                                 p.p2_far_block_d, t, tiny)}
        nt = near.num_tiles.double()
        print(f"  n={n} seed={seed} ({n_v} queries after the seam split, {nb} rows): near rows walk {int(nt.min())}-{int(nt.max())} "
              f"tiles of {p.p2_block_d} (mean {float(nt.mean()):.2f}, std {float(nt.std()):.2f})", flush=True)
        for name, fn in fns.items():
            rule = row_launch(n_v, sms, block_q=p.block_q, far=name == "B5")
            runs = {}
            settings = [(t, ()) for t in (64, 128, 256)] + ([("row order", (rule, None))] if name == "B4" else [])
            for key, extra in settings:
                outs = [torch.empty_like(lay.qx_v) for _ in refs[name]]
                call = args[name](*extra) if extra else args[name](key)

                def run(call=call, outs=outs):
                    _build.check(fn(*call, *(o.data_ptr() for o in outs), stream), f"{name} launch")

                run()
                check(all(torch.equal(o, r) for o, r in zip(outs, refs[name])),
                      f"{name} at {key} threads gives the wrapper's bits (n={n})")
                runs[key] = run
            got = time_in_turns(time_ms, runs, 1 if n == M_FULL else 3)
            in_row_order = got.pop("row order", None)
            best = min(got, key=got.get)
            print(f"    {name}: " + ", ".join(f"{t} threads {ms} ms" for t, ms in got.items())
                  + f"; fastest {best}; row_launch picks {rule} ({sms} SMs), {got[rule] / got[best]:.4f}x the "
                  "fastest; all bitwise equal"
                  + (f"; the pick in row order {in_row_order} ms ({in_row_order / got[rule]:.4f}x longest first)"
                     if in_row_order is not None else ""), flush=True)
            check(got[rule] <= 1.05 * got[best],
                  f"row_launch's pick for {name} at n={n} seed={seed} is within 5% of the fastest")
        del lay, near, cand, refs
    print(f"  phase 32: {time.time() - t_phase:.1f} s", flush=True)


def far_node_shape_phase(*, params, data, queries, time_ms):
    """Phase 33: B6 (float32, the ``aidw-pod-1m`` quadtree plan), its level
    launches together, timed with CUDA events at S = 1, 2 and 4 threads a
    query and 64, 128 and 256 threads a block, at 8,192, 65,536 and 2^20
    queries, beside the wrapper's choice (``kernels/aidw_grid.py:
    far_node_launch``), which must be the fastest or within 5% of it; every
    setting gives the wrapper's bits."""
    import torch

    from repro_torch.core.aidw import tiny_for
    from repro_torch.engine import build_plan
    from repro_torch.engine.execute import _grid_layout, _quadtree_walk
    from repro_torch.kernels import _build
    from repro_torch.kernels.aidw_grid import block_rectangles, far_node_launch, phase2_far_nodes

    print("== 33. B6 splits and block sizes (CUDA events, float32, aidw-pod-1m quadtree plan, m = 2^20)", flush=True)
    t_phase = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p = build_plan(*data(torch.float32), params=params, area=1.0, impl="grid", phase2="quadtree")
    fn = _build.entry("aidw_far_node_f32")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    tiny = tiny_for(torch.float32)
    for n, seed in ((8192, 33), SERVING[0], SERVING[3]):
        qx, qy = queries(n, seed)
        lay = _grid_layout(p, qx, qy)
        home = block_rectangles(p.grid, lay.cx_v, lay.cy_v, torch.zeros_like(lay.cx_v), p.block_q)
        levels = []
        for lv, (tbl, n_closed, _, _) in enumerate(_quadtree_walk(p, *home)):
            k_pad, tile = p.qt_levels[lv][3:]
            nt = ((n_closed.clamp(max=k_pad) + tile - 1) // tile).to(torch.int32)
            levels.append((tbl, nt, n_closed, p.far[lv][:6], k_pad, tile))
        n_v = lay.qx_v.shape[0]
        ah = torch.full_like(lay.qx_v, 1.0)  # the sweep's cost does not depend on alpha
        refs = [phase2_far_nodes(lay.qx_v, lay.qy_v, ah, tbl, nt, nodes, block_q=p.block_q, tile_d=tile, n_closed=nc)
                for tbl, nt, nc, nodes, _, tile in levels]
        outs = [(torch.empty_like(ah), torch.empty_like(ah)) for _ in levels]
        rule = far_node_launch(n_v, sms, block_q=p.block_q)
        runs = {}
        for threads in (64, 128, 256):
            for splits in (1, 2, 4):
                if splits > 1 and threads // splits > 128:
                    continue

                def run(threads=threads, splits=splits):
                    for (tbl, nt, nc, nodes, k_pad, tile), (sw, swz) in zip(levels, outs):
                        _build.check(fn(lay.qx_v.data_ptr(), lay.qy_v.data_ptr(), ah.data_ptr(), tbl.data_ptr(),
                                        nt.data_ptr(), nc.data_ptr(), *(a.data_ptr() for a in nodes), n_v, p.block_q,
                                        k_pad, tile, nodes[0].shape[0] - 1, threads, splits, tiny, sw.data_ptr(),
                                        swz.data_ptr(), stream), "far_node launch")

                run()
                check(all(torch.equal(o[0], r[0]) and torch.equal(o[1], r[1]) for o, r in zip(outs, refs)),
                      f"B6 with {threads} threads and S = {splits} gives the wrapper's bits (n={n})")
                runs[threads, splits] = run
        got = time_in_turns(time_ms, runs, 3)
        best = min(got, key=got.get)
        print(f"  n={n} seed={seed} ({n_v} queries after the seam split, {len(levels)} levels): "
              + ", ".join(f"{t} threads S={sp} {ms} ms" for (t, sp), ms in got.items())
              + f"; fastest {best}; far_node_launch picks {rule} ({sms} SMs), {got[rule] / got[best]:.4f}x the "
              "fastest; all bitwise equal", flush=True)
        check(got[rule] <= 1.05 * got[best], f"far_node_launch's pick at n={n} is within 5% of the fastest setting")
        del lay, levels, refs, outs
    print(f"  phase 33: {time.time() - t_phase:.1f} s", flush=True)


def naive_shape_phase(*, params, data, queries, time_ms):
    """Phase 35: B7 and B8 (float32, ``naive.cu``, m = 2^20) timed with CUDA
    events at S = 1, 2 and 4 threads a query and 128 and 256 threads a block,
    at 8,192, 65,536 and 2^20 queries, beside the wrapper's choice
    (``kernels/aidw_naive.py: naive_launch``), which must be the fastest or
    within 3% of it; every setting gives the wrapper's bits."""
    import torch

    from repro_torch.core.aidw import tiny_for
    from repro_torch.core.layouts import soa_to_aoas
    from repro_torch.engine import build_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.aidw_naive import aidw_naive_aoas, aidw_naive_soa, naive_launch
    from repro_torch.kernels.aidw_tiled import _alpha_consts

    print("== 35. B7/B8 splits and block sizes (CUDA events, float32, m = 2^20)", flush=True)
    t_phase = time.time()
    block_d = 512
    dxp, dyp, dzp = build_plan(*data(torch.float32), params=params, area=1.0, impl="naive", block_d=block_d).data
    aoas = soa_to_aoas(dxp, dyp, dzp)
    m = dxp.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    consts = _alpha_consts(params, 1.0, M_FULL)
    stream = torch.cuda.current_stream().cuda_stream
    kw = dict(params=params, area=1.0, m_real=M_FULL, block_q=64, block_d=block_d)
    kernels = {"naive_soa": ((dxp.data_ptr(), dyp.data_ptr(), dzp.data_ptr()),
                             lambda qx, qy: aidw_naive_soa(dxp, dyp, dzp, qx, qy, **kw)),
               "naive_aoas": ((aoas.data_ptr(),), lambda qx, qy: aidw_naive_aoas(aoas, qx, qy, **kw))}
    for n in (8192, SERVING[0][0], M_FULL):
        qx, qy = queries(n, 35)
        rule = naive_launch(n, sms)
        for kname, (ptrs, wrapper) in kernels.items():
            fn = _build.entry(f"aidw_{kname}_f32")
            z_ref, a_ref = wrapper(qx, qy)
            runs = {}
            for threads in (128, 256):
                for splits in (1, 2, 4):
                    z, a = torch.empty_like(qx), torch.empty_like(qx)

                    def run(threads=threads, splits=splits, z=z, a=a):
                        _build.check(fn(qx.data_ptr(), qy.data_ptr(), *ptrs, n, m, block_d, params.k, threads,
                                        splits, *consts, float(params.exact_hit_eps), tiny_for(torch.float32),
                                        z.data_ptr(), a.data_ptr(), stream), f"{kname} launch")

                    run()
                    check(torch.equal(z, z_ref) and torch.equal(a, a_ref),
                          f"{kname} with {threads} threads and S = {splits} gives the wrapper's bits (n={n})")
                    runs[threads, splits] = run
            # 2^20 queries take about a second a launch: 3 rounds, no warm-up
            if n == M_FULL:
                got = time_in_turns(lambda fn_, reps: time_ms(fn_, reps, warmup=0), runs, 1, rounds=3)
            else:
                got = time_in_turns(time_ms, runs, 3)
            best = min(got, key=got.get)
            print(f"  {kname} n={n}: " + ", ".join(f"{t} threads S={sp} {ms} ms" for (t, sp), ms in got.items())
                  + f"; fastest {best}; naive_launch picks {rule} ({sms} SMs), {got[rule] / got[best]:.4f}x the "
                  "fastest; all bitwise equal", flush=True)
            check(got[rule] <= 1.03 * got[best], f"naive_launch's pick for {kname} at n={n} is within 3% of the fastest")
    print(f"  phase 35: {time.time() - t_phase:.1f} s", flush=True)


def fused_shape_phase(*, params, data, queries, time_ms):
    """Phase 36: B11 (float32, ``fused.cu``, m = 2^20) timed with CUDA events
    at S = 1, 2 and 4 threads a query and 128 and 256 threads a block, at
    8,192, 65,536 and 2^20 queries (each setting the median of 5 rounds),
    beside the wrapper's choice (``kernels/aidw_fused.py: fused_launch``),
    which must be the fastest or within 3% of it; every setting gives the
    wrapper's bits."""
    import torch

    from repro_torch.core.aidw import tiny_for
    from repro_torch.engine import build_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.aidw_fused import aidw_fused_soa, fused_launch
    from repro_torch.kernels.aidw_tiled import _alpha_consts

    print("== 36. B11 splits and block sizes (CUDA events, float32, m = 2^20)", flush=True)
    t_phase = time.time()
    block_d = 512
    dxp, dyp, dzp = build_plan(*data(torch.float32), params=params, area=1.0, impl="fused", block_d=block_d).data
    m = dxp.shape[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    consts = _alpha_consts(params, 1.0, M_FULL)
    stream = torch.cuda.current_stream().cuda_stream
    fn = _build.entry("aidw_fused_f32")
    for n in (8192, SERVING[0][0], M_FULL):
        qx, qy = queries(n, 36)
        rule = fused_launch(n, sms, block_d, torch.float32)
        z_ref, a_ref = aidw_fused_soa(dxp, dyp, dzp, qx, qy, params=params, area=1.0, m_real=M_FULL, block_q=256,
                                      block_d=block_d)
        runs = {}
        for threads in (128, 256):
            for splits in (1, 2, 4):
                z, a = torch.empty_like(qx), torch.empty_like(qx)

                def run(threads=threads, splits=splits, z=z, a=a):
                    _build.check(fn(qx.data_ptr(), qy.data_ptr(), dxp.data_ptr(), dyp.data_ptr(), dzp.data_ptr(), n, m,
                                    block_d, params.k, threads, splits, *consts, float(params.exact_hit_eps),
                                    tiny_for(torch.float32), z.data_ptr(), a.data_ptr(), stream), "fused launch")

                run()
                check(torch.equal(z, z_ref) and torch.equal(a, a_ref),
                      f"fused with {threads} threads and S = {splits} gives the wrapper's bits (n={n})")
                runs[threads, splits] = run
        # 2^20 queries take about a second a launch: one launch a round, no warm-up
        if n == M_FULL:
            got = time_in_turns(lambda fn_, reps: time_ms(fn_, reps, warmup=0), runs, 1)
        else:
            got = time_in_turns(time_ms, runs, 3)
        best = min(got, key=got.get)
        print(f"  fused n={n}: " + ", ".join(f"{t} threads S={sp} {ms} ms" for (t, sp), ms in got.items())
              + f"; fastest {best}; fused_launch picks {rule} ({sms} SMs), {got[rule] / got[best]:.4f}x the "
              "fastest; all bitwise equal", flush=True)
        check(got[rule] <= 1.03 * got[best], f"fused_launch's pick at n={n} is within 3% of the fastest")
    print(f"  phase 36: {time.time() - t_phase:.1f} s", flush=True)


def ring_rank(rank, world, m, n_q, seed, params, device):
    """Phase 37 on one of the ranks that share the card: each run of
    ``RING_RUNS`` (after a warm-up that loads the kernel libraries) on this
    rank's shards of the ``aidw-pod-1m`` data (``m`` points, seed 0) and of
    the serving batch (``n_q`` queries from ``seed``), both made here as
    ``main`` makes them, started after a barrier with the launch and
    transfer counts set to 0 and read just after it ends; its host wall time
    (synchronized) and this rank's z and alpha."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import distributed as D
    from repro_torch.data import clustered_points
    from repro_torch.kernels import _build

    rng = np.random.default_rng(seed)
    arrays = (*clustered_points(m, seed=0), *(rng.random(n_q).astype(np.float32) for _ in range(2)))
    mesh = init_device_mesh("cpu", RING_MESH, mesh_dim_names=RING_DIMS)
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}
    for name, (fn, axes, dtype, n_q) in {"warm-up": ("ring_aidw", None, "float32", 4096), **RING_RUNS}.items():
        dt = getattr(torch, dtype)
        data = [torch.as_tensor(a).to(dev, dt) for a in arrays[:3]]
        q = [torch.as_tensor(a[:n_q]).to(dev, dt) for a in arrays[3:]]
        if fn == "sharded_queries_aidw":
            args, kw = (*data, *(D.local_shard(mesh, a) for a in q)), {}
        else:
            args, kw = tuple(D.local_shard(mesh, a, axes) for a in (*data, *q)), {"axis_names": axes}
        sync()
        dist.barrier()
        _build.reset_launch_counts()
        D.reset_transfer_counts()
        t0 = time.time()
        z, alpha = getattr(D, fn)(mesh, *args, params=params, area=1.0, **kw)
        sync()
        wall = time.time() - t0
        out[name] = dict(z=z, alpha=alpha, wall=wall, launches={k: v for k, v in _build.LAUNCHES.items() if v},
                         transfer=dict(D.TRANSFER))
    return out


def ring_phase(*, dev, params, data, queries, time_ms, bound, b2_rtol, maxerr):
    """Phase 37: multi-device AIDW (``repro_torch.core.distributed``) with
    ``RING_RANKS`` ranks that share the one card over gloo (one card holds
    no two NCCL ranks; each rotation is staged through the host, the folds
    stay on the card), on the ``aidw-pod-1m`` data and its first serving
    batch.  Returns the ``kernels`` rows of the two fold kernels."""
    import collections

    import torch

    from repro_torch.core import distributed as D
    from repro_torch.engine import build_plan, execute
    from repro_torch.kernels import _build
    from repro_torch.kernels._common import sfu_weight_eps
    from repro_torch.kernels.aidw_tiled import (
        knn_alpha,
        knn_fold,
        knn_fold_plain,
        weight_carry,
        weight_fold,
        weight_fold_plain,
        weight_sweep,
    )

    n_q, seed = SERVING[0]
    print(f"== 37. multi-device AIDW: {RING_RANKS} ranks on one card over gloo, mesh {RING_MESH} {RING_DIMS}, "
          f"aidw-pod-1m (m = 2^20), serving batch n={n_q} seed={seed}, f64 at {RING_F64_QUERIES} queries", flush=True)
    t_phase = time.time()
    _build.build_all()  # here, once: the ranks load the libraries
    if dev.type == "cuda":
        # the fold instances run B1's and B2's loops: their SASS a pair, held
        # as phase 1 holds those of B1 and B2
        loop, b1 = knn_sass(10, fold=True), knn_sass(10)
        check(loop is not None, "the SASS of knn_alpha_kernel<float, 10, ..., fold> has a per-pair loop")
        ffma = sum(c for op, c in loop[1].items() if op.startswith("FFMA"))
        lds = sum(c for op, c in loop[1].items() if op.startswith("LDS"))
        w = kernel_sass("weight", weight_func(fold=True))
        check(w is not None, "the SASS of weight_kernel<float, false, false, true> has a per-pair loop")
        print(f"  knn_fold SASS hot loop: {loop[0]} instructions per pair (B1 {b1[0]}), FFMA {ffma}, LDS {lds}; "
              f"weight_fold per-pair loop: {w[0]} instructions per pair, MUFU {mufu(w[1])}")
        check(ffma == 0 and lds <= 0.5, "the knn_fold loop holds no FFMA and at most one LDS per two pairs")
        check(sum(mufu(w[1]).values()) <= MUFU_PER_PAIR, f"weight_fold takes at most {MUFU_PER_PAIR} MUFU ops a pair")
    qx, qy = queries(n_q, seed)
    dx, dy, dz = data(torch.float32)
    t0 = time.time()
    ranks = D.spawn_ranks(ring_rank, RING_RANKS, (M_FULL, n_q, seed, params, str(dev)), timeout=RING_TIMEOUT)
    print(f"  {RING_RANKS} ranks started, ran every method and joined in {time.time() - t0:.1f} s; warm-up walls "
          f"{[r['warm-up']['wall'] for r in ranks]} s", flush=True)

    def gathered(name, key):
        # the global array from the ranks' shards: over both dims shard r is
        # rank r's (row-major); over "data" alone mesh row i (ranks 2i, 2i + 1)
        if RING_RUNS[name][1] == ("data",):
            for r in (0, 2):
                check(torch.equal(ranks[r][name][key], ranks[r + 1][name][key]), f"{name}: the replicas agree")
            order = (0, 2)
        else:
            order = range(RING_RANKS)
        return torch.cat([ranks[r][name][key] for r in order]).to(dev)

    # single-process references on the same inputs: B1 (shared row) alpha,
    # B2 z at the ring's tile, and the chunked plan of sharded_queries_aidw
    m_l = M_FULL // RING_RANKS
    refs = {}
    for dtype, n in ((torch.float32, n_q), (torch.float64, RING_F64_QUERIES)):
        x, y, z = data(dtype)
        a, b = qx[:n].to(dtype), qy[:n].to(dtype)
        alpha = knn_alpha(a, b, x[None], y[None], block_q=256, tile_d=512, params=params, area=1.0, m_real=M_FULL)
        refs[dtype] = alpha, weight_sweep(a, b, alpha * 0.5, x, y, z, tile_d=RING_TILE, eps=params.exact_hit_eps)
    plan = build_plan(dx, dy, dz, params=params, area=1.0, impl="chunked", knn="brute", q_chunk=1024, d_chunk=8192,
                      device=dev)
    refs["chunked"] = execute(plan, qx, qy)

    launches = {}
    for name, (fn, axes, dtype, n) in RING_RUNS.items():
        dt = getattr(torch, dtype)
        z, alpha = gathered(name, "z"), gathered(name, "alpha")
        count = collections.Counter()
        for r in ranks:
            count.update(r[name]["launches"])
        launches[name] = dict(count)
        tr = ranks[0][name]["transfer"]
        per = tr["staged_bytes"] / tr["rotations"] if tr["rotations"] else 0
        print(f"  {name}: wall per rank {[r[name]['wall'] for r in ranks]} s, launches (all ranks) {dict(count)}, "
              f"rank 0 {tr['rotations']} rotations, {tr['sent_bytes']} bytes sent, {tr['staged_bytes']} bytes staged "
              f"through the host ({per} a rotation)", flush=True)
        if fn == "sharded_queries_aidw":
            same = torch.equal(z, refs["chunked"][0]) and torch.equal(alpha, refs["chunked"][1])
            print(f"  {name}: bitwise equal to the single-process chunked plan {same}")
            check(same, f"{name} gives the single-process chunked plan's bits")
            check(not count, f"{name} launches no kernel (the chunked plan is plain PyTorch)")
            continue
        a_ref, z_ref = refs[dt]
        rel = float(((z - z_ref) / z_ref).abs().max())
        print(f"  {name}: alpha bitwise equal to B1 {torch.equal(alpha, a_ref)}; z {rel:.3e} relative from B2 "
              f"(tolerance {b2_rtol(dt):.3e}, 64 ulps)")
        check(torch.equal(alpha, a_ref), f"{name}: alpha has B1's bits")
        check(rel <= b2_rtol(dt), f"{name}: z within 64 ulps of B2's")
        steps = 2 if axes == ("data",) else RING_RANKS
        check(count == {"knn_fold": RING_RANKS * steps, "weight_fold": RING_RANKS * steps},
              f"{name}: {steps} launches of each fold kernel a rank")
        check(dev.type == "cpu" or tr["staged_bytes"] == 2 * tr["sent_bytes"] > 0,
              f"{name}: every rotation staged through the host")

    # the ring replayed in this process on RING_SAMPLE queries of each slab:
    # the fold kernels in the ring's visiting order give the ranks' bits; the
    # plain versions alpha's bits and z within 64 ulps; a ring that skips
    # one rotation (a shard folded twice, one never) or drops the carry at
    # one step fails the check against B2 by 10x or more
    shards = [tuple(t[i * m_l:(i + 1) * m_l] for t in (dx, dy, dz)) for i in range(RING_RANKS)]
    last = RING_RANKS - 1

    def replay(lo, order, knn=knn_fold, weight=weight_fold, drop_at=None):
        a, b = qx[lo:lo + RING_SAMPLE], qy[lo:lo + RING_SAMPLE]
        best = torch.full((RING_SAMPLE, params.k), math.inf, device=dev)
        for s, sh in enumerate(order):
            best = knn(torch.full_like(best, math.inf) if s == drop_at else best, a, b, *shards[sh][:2],
                       tile_d=RING_TILE, params=params, area=1.0, m_total=M_FULL, finish=s == last)
        acc = weight_carry(a)
        for s, sh in enumerate(order):
            acc = weight(weight_carry(a) if s == drop_at else acc, a, b, best * 0.5, *shards[sh], tile_d=RING_TILE,
                         eps=params.exact_hit_eps, finish=s == last)
        return acc, best

    tol = b2_rtol(torch.float32)
    controls = {"skip": [], "drop": []}
    for name, step in (("ring (data, model)", -1), ("ring_q (data, model)", 1)):
        z_ring, a_ring = gathered(name, "z"), gathered(name, "alpha")
        for r in range(RING_RANKS):
            lo = r * (n_q // RING_RANKS)
            sl = slice(lo, lo + RING_SAMPLE)
            order = [(r + step * s) % RING_RANKS for s in range(RING_RANKS)]
            zk, ak = replay(lo, order)
            zp, ap = replay(lo, order, knn_fold_plain, weight_fold_plain)
            check(torch.equal(zk, z_ring[sl]) and torch.equal(ak, a_ring[sl]),
                  f"{name}: the replay of slab {r} with the fold kernels gives the ranks' bits")
            check(torch.equal(ap, ak), f"{name}: the plain replay of slab {r} gives alpha's bits")
            report(f"{name} slab {r}: replayed z with the kernels against the plain folds, relative",
                   float(((zk - zp) / zp).abs().max()), tol)
            z_b2 = refs[torch.float32][1][sl]
            skipped = [order[0]] + order[:-1]  # the rotation after step 0 skipped: shard order[-1] never folded
            controls["skip"].append(float(((replay(lo, skipped)[0] - z_b2) / z_b2).abs().max()) / tol)
            controls["drop"].append(float(((replay(lo, order, drop_at=2)[0] - z_b2) / z_b2).abs().max()) / tol)
    print(f"  replays: kernels == ranks bitwise, plain alpha bitwise and z within 64 ulps on {RING_SAMPLE} queries "
          f"of every slab; controls, in tolerances of the B2 check: one rotation skipped "
          f"{min(controls['skip']):.1f}-{max(controls['skip']):.1f}x, the carry dropped at step 2 "
          f"{min(controls['drop']):.1f}-{max(controls['drop']):.1f}x", flush=True)
    check(min(controls["skip"]) >= 10 and min(controls["drop"]) >= 10, "both controls fail the check by 10x or more")

    # each fold kernel against its plain version on one rank's shapes (its
    # slab of the serving batch against one data shard), from a carry of
    # another shard; then timed with CUDA events (float32)
    rows, timed = [], {}
    n_l = n_q // RING_RANKS
    for dtype in (torch.float32, torch.float64):
        x, y, z = data(dtype)
        a, b = qx[:n_l].to(dtype), qy[:n_l].to(dtype)
        s0, s1 = ((x[i * m_l:(i + 1) * m_l], y[i * m_l:(i + 1) * m_l], z[i * m_l:(i + 1) * m_l]) for i in (0, 1))
        kw = dict(tile_d=RING_TILE, params=params, area=1.0, m_total=M_FULL)
        best = knn_fold(torch.full((n_l, params.k), math.inf, dtype=dtype, device=dev), a, b, *s1[:2], **kw)
        kb, pb = knn_fold(best, a, b, *s0[:2], **kw), knn_fold_plain(best, a, b, *s0[:2], **kw)
        ka, pa = (f(best, a, b, *s0[:2], finish=True, **kw) for f in (knn_fold, knn_fold_plain))
        check(torch.equal(kb, pb) and torch.equal(ka, pa), f"knn_fold {dtype}: k-best and alpha equal the plain version")
        ah = ka * 0.5
        wk = dict(tile_d=RING_TILE, eps=params.exact_hit_eps)
        carry = weight_fold(weight_carry(a), a, b, ah, *s1, **wk)
        kc, pc = weight_fold(carry, a, b, ah, *s0, **wk), weight_fold_plain(carry, a, b, ah, *s0, **wk)
        kz, pz = (f(carry, a, b, ah, *s0, finish=True, **wk) for f in (weight_fold, weight_fold_plain))
        e_sum = max(float(((kc[i] - pc[i]) / pc[i]).abs().max()) for i in (0, 1))
        e_z = float(((kz - pz) / pz).abs().max())
        # the tolerances: for the order inside a tile, 64 ulps of z and of
        # each sum scaled by RING_TILE / 512, as phase 2 scales B2's for its
        # larger tile (a sequential sum's rounding bound grows with its
        # length); for the sums in float32 also the special-function units'
        # error of the shard's terms (kernels/_common.py: sfu_weight_eps,
        # largest where |ln d^2| is: at the shard's nearest point or at d^2 =
        # 2, the unit square's diagonal) times the shard's share of the sum
        # (in z those errors cancel to within the 64 ulps)
        rtol = b2_rtol(dtype) * RING_TILE / 512
        tol = rtol * pc[:2].abs().double()
        if dtype == torch.float32:
            near = weight_fold_plain(weight_carry(a), a, b, ah, *s0, **wk)[2]
            sfu = torch.maximum(sfu_weight_eps(near, ah), sfu_weight_eps(torch.full_like(near, 2.0), ah))
            tol = tol + sfu * (pc[:2] - carry[:2]).abs().double()
        r_sum = float(((kc[:2] - pc[:2]).abs().double() / tol).max())
        print(f"  knn_fold {dtype} ({n_l} queries x {m_l} points, carry of shard 1): k-best and alpha bitwise equal "
              f"to plain True; weight_fold sums {e_sum:.3e} relative from plain ({r_sum:.3f} of their tolerance), z "
              f"{e_z:.3e} (tolerance {rtol:.3e}), min d^2 and hit z bitwise {torch.equal(kc[2:], pc[2:])}")
        check(r_sum <= 1 and e_z <= rtol and torch.equal(kc[2:], pc[2:]),
              f"weight_fold {dtype}: sums and z within their tolerances of plain, min d^2 and hit z bitwise")
        # CUDA-event times of both kernels at these shapes, the plain versions' in float32
        calls = {"knn_fold": (lambda: knn_fold(best, a, b, *s0[:2], **kw),
                              lambda: knn_fold_plain(best, a, b, *s0[:2], **kw), maxerr(kb, pb)),
                 "weight_fold": (lambda: weight_fold(carry, a, b, ah, *s0, **wk),
                                 lambda: weight_fold_plain(carry, a, b, ah, *s0, **wk), maxerr(kz, pz))}
        for name, (kern, plain, err) in calls.items():
            t = timed.setdefault(name, {})
            t[dtype] = time_ms(kern, 10)
            if dtype == torch.float32:
                t["plain"], t["err"] = time_ms(plain, 1, warmup=0), err
    pairs = n_l * m_l
    need = {"knn_fold": (pairs, 4 * (2 * n_l + 2 * m_l + 2 * n_l * params.k), 6, 0),
            "weight_fold": (pairs, 4 * (3 * n_l + 3 * m_l + 8 * n_l), 13, pairs * MUFU_PER_PAIR)}
    for name, t in timed.items():
        bound_ms, bound_by = bound(*need[name][:3], sfu_ops=need[name][3])
        n_launch = launches["ring (data, model)"].get(name, 0)
        print(f"  {name}: {t[torch.float32]} ms a launch in float32, {t[torch.float64]} ms in float64 (CUDA events; "
              f"plain {t['plain']} ms in float32, bound {bound_ms} ms by {bound_by}, {pairs} pairs); {n_launch} "
              "launches in the ring (data, model) run", flush=True)
        rows.append(dict(name=name, route="cuda", **KERNELS[name], launches=n_launch, max_abs_err=t["err"],
                         ms=t[torch.float32], plain_ms=t["plain"], bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None))
    print(f"  phase 37: {time.time() - t_phase:.1f} s", flush=True)
    return rows


def serving_phase(*, dev, params, data, queries, sync, maxerr, time_ms, z_tol):
    """Phase 34: the serving layer (``repro_torch.serving``) on ``aidw-pod-1m``.

    (a) An exact grid plan sized for ``SERVE_QO`` queries a cell, far denser
    than the uniform 65,536-query batches served against it, behind a
    ``CapacityReestimator`` with a one-batch warmup: batches (seeds 5 and up)
    until ``overflow_queries`` is 0 after a swap, ``join()``, then more
    batches.  Each batch's wall, overflow, need and state; the trigger, the
    batches to recovery (at most 2 x ``PERSISTENT_OVERFLOW_BATCHES``), the
    capacities, the re-plan's host seconds, the largest wall during the
    re-plan against the median after it, B3 and B2 launches.  Checks: the
    batches before the swap are the old plan's bits, the first after it a
    fresh ``replan_with_capacity``'s, z within phase 5's gate.  (b) The same
    storm on a far-field plan: ``p2_capacity``, ``p2_overflow_queries`` and
    the masked B2 arm's CUDA-event time before and after the swap, and the
    default exact and far-field plans at their seam level and the storm
    plan's, on the first serving batch.  (c) Three
    injected build failures: one ``PlanDegradedWarning``, state degraded, the
    installed plan's bits.  (d) ``kernels.aidw(impl="grid")`` twice: one
    plan build, one miss and one hit in the default registry."""
    import statistics

    import torch

    from repro_torch.core.aidw import aidw_reference
    from repro_torch.engine import PERSISTENT_OVERFLOW_BATCHES, build_plan, execute, replan_with_capacity
    from repro_torch.engine.execute import _grid_layout, _near_field, _phase2_exact_masked
    from repro_torch.errors import PlanDegradedWarning
    from repro_torch.kernels import _build, aidw, ops
    from repro_torch.serving import CapacityReestimator, PlanRegistry, default_registry, faults
    from repro_torch.serving.reestimator import DEGRADED, HEALTHY

    f32 = torch.float32
    n_q = SERVING[0][0]
    dx, dy, dz = data(f32)
    t_phase = time.time()
    print(f"== 34. serving: aidw-pod-1m, clustered m = 2^20, k = 10, float32, plans sized for query_occupancy "
          f"{SERVE_QO}, {n_q}-query uniform batches", flush=True)

    def f64_gate(tag, qx, qy, z, a, seed):
        # phase 5's gate on N_SAMPLE sampled queries against a float64 brute force
        idx = torch.as_tensor(np.random.default_rng(seed).choice(qx.shape[0], N_SAMPLE, replace=False), device=dev)
        d64 = [t.double() for t in (dx, dy, dz)]
        ref = [aidw_reference(*d64, qx[part].double(), qy[part].double(), params, area=1.0) for part in idx.split(128)]
        ez = maxerr(z[idx], torch.cat([r[0] for r in ref]))
        ea = maxerr(a[idx], torch.cat([r[1] for r in ref]))
        report(f"{tag} z vs f64 reference", ez, z_tol(f32, M_FULL, float(dz.abs().max())))
        report(f"{tag} alpha vs f64 reference", ea, 1e-5)

    def stamp(log, what):
        # a fault that records when the worker passes a point, value unchanged
        def at(value):
            log.setdefault(what, time.time())
            return value
        return at

    def storm(re_, seed0, tag, extra=()):
        """Serve until a batch after a swap has no overflow; join; serve
        POST_BATCHES more.  Returns the served batches and the worker's
        time stamps."""
        old = re_.plan
        served, stamps = [], {}
        limit = None
        with faults.inject("reestimator.build", transform=stamp(stamps, "build")), \
                faults.inject("registry.swap", transform=stamp(stamps, "swap")):
            seed = seed0
            while True:
                qx, qy = queries(n_q, seed)
                installed = re_.plan
                sync()
                t0 = time.time()
                z, a, st = re_.execute(qx, qy)
                sync()
                t1 = time.time()
                b = dict(seed=seed, qx=qx, qy=qy, z=z, a=a, st=st, t0=t0, t1=t1, plan=installed, state=re_.state)
                served.append(b)
                more = "".join(f", {k} {int(st[k])}" for k in extra)
                print(f"  {tag} batch {len(served)} seed={seed}: {t1 - t0} s, overflow_queries "
                      f"{st['overflow_queries']}, cand_need_max {st['cand_need_max']}{more}, persistent "
                      f"{st['persistent_overflow']}, state after {b['state']}, "
                      f"{'old' if installed is old else 'new'} plan", flush=True)
                if st["persistent_overflow"] and limit is None:
                    limit = len(served) + 2 * PERSISTENT_OVERFLOW_BATCHES
                if installed is not old and st["overflow_queries"] == 0:
                    break
                check(limit is None or len(served) < limit,
                      f"{tag}: overflow_queries 0 within 2 x {PERSISTENT_OVERFLOW_BATCHES} batches of the trigger")
                check(len(served) < 4 * PERSISTENT_OVERFLOW_BATCHES, f"{tag}: the storm triggered a re-plan")
                seed += 1
            check(re_.join(timeout=600.0) == HEALTHY, f"{tag}: the re-plan ended healthy")
            for _ in range(POST_BATCHES):
                seed += 1
                qx, qy = queries(n_q, seed)
                sync()
                t0 = time.time()
                z, a, st = re_.execute(qx, qy)
                sync()
                t1 = time.time()
                served.append(dict(seed=seed, qx=qx, qy=qy, z=z, a=a, st=st, t0=t0, t1=t1, plan=re_.plan,
                                   state=re_.state))
                print(f"  {tag} batch {len(served)} seed={seed} (after join): {t1 - t0} s, overflow_queries "
                      f"{st['overflow_queries']}, state {re_.state}", flush=True)
            # a new streak on the new plan may have started another re-plan
            check(re_.join(timeout=600.0) in (HEALTHY, DEGRADED), f"{tag}: no re-plan left running")
        return served, stamps

    def summary(tag, re_, old, served, stamps):
        trigger = next(i for i, b in enumerate(served) if b["st"]["persistent_overflow"]) + 1
        first_new = next(i for i, b in enumerate(served) if b["plan"] is not old)
        recovered = next(i for i, b in enumerate(served) if b["plan"] is not old and b["st"]["overflow_queries"] == 0)
        new = re_.plan
        need = max(b["st"]["cand_need_max"] for b in served[:trigger])
        target = min(max(int(old.cand_capacity * 2.0), need), old.m)
        during = [b["t1"] - b["t0"] for b in served
                  if b["t1"] >= stamps.get("build", math.inf) and b["t0"] <= stamps.get("swap", -math.inf)]
        after = [b["t1"] - b["t0"] for b in served[recovered:]]
        print(f"  {tag}: trigger at batch {trigger}, first batch on the new plan {first_new + 1}, overflow 0 at batch "
              f"{recovered + 1} ({recovered + 1 - trigger} after the trigger, limit "
              f"{2 * PERSISTENT_OVERFLOW_BATCHES}); cand_capacity {old.cand_capacity} -> {new.cand_capacity} "
              f"(target {target}: 2 x capacity or the need {need}), p2_capacity {old.p2_capacity} -> "
              f"{new.p2_capacity}; re-plan on the worker, build start to swap (warmup included) "
              f"{stamps['swap'] - stamps['build']} s; largest wall during it "
              f"{max(during) if during else 'none (no batch overlapped it)'} s, median after the swap "
              f"{statistics.median(after)} s; stats {re_.stats()}", flush=True)
        check(0 < recovered + 1 - trigger <= 2 * PERSISTENT_OVERFLOW_BATCHES, f"{tag}: recovery within the limit")
        return trigger, first_new, target

    # ------------------------------------------- (a) exact plan, the storm
    sync()
    t0 = time.time()
    plan = build_plan(dx, dy, dz, params=params, area=1.0, impl="grid", query_occupancy=SERVE_QO)
    sync()
    print(f"  (a) exact plan build {time.time() - t0} s: cand_capacity {plan.cand_capacity}, cand_block_d "
          f"{plan.cand_block_d}, seam_level {plan.seam_level}", flush=True)
    warm = queries(n_q, 4)
    reg = PlanRegistry()
    re_ = CapacityReestimator(reg, "aidw-pod-1m", plan, warmup=warm)
    sync()
    _build.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the streak's CapacityOverflowWarning
        served, stamps = storm(re_, 5, "(a)")
    launches = dict(_build.LAUNCHES)
    print(f"  (a) launches over the storm, its re-plan and warmup: {launches}", flush=True)
    check(launches["knn_skip"] > 0 and launches["weight_soa"] > 0, "the served path launched B3 and B2")
    trigger, first_new, target = summary("(a)", re_, plan, served, stamps)
    for b in served[:first_new]:
        z, a = execute(plan, b["qx"], b["qy"])
        check(torch.equal(z, b["z"]) and torch.equal(a, b["a"]),
              f"(a) batch seed={b['seed']} before the swap equals the old plan's bits")
    sync()
    t0 = time.time()
    fresh = replan_with_capacity(plan, min_cand_capacity=target, min_p2_capacity=target)
    sync()
    replan_s = time.time() - t0
    b = served[first_new]
    z, a = execute(fresh, b["qx"], b["qy"])
    same = torch.equal(z, b["z"]) and torch.equal(a, b["a"])
    print(f"  (a) a fresh replan_with_capacity on the serving thread: {replan_s} s, cand_capacity "
          f"{fresh.cand_capacity}; the first batch after the swap equals it bit for bit: {same}; the {first_new} "
          "batches before the swap equal the old plan's bits: True", flush=True)
    check(fresh.cand_capacity == re_.plan.cand_capacity and same,
          "(a) the first batch after the swap equals a fresh re-plan's bits")
    f64_gate(f"(a) storm batch seed={served[0]['seed']} (old plan)", served[0]["qx"], served[0]["qy"],
             served[0]["z"], served[0]["a"], served[0]["seed"])
    f64_gate(f"(a) batch seed={b['seed']} (new plan)", b["qx"], b["qy"], b["z"], b["a"], b["seed"])
    check(all(bool(torch.isfinite(x["z"]).all()) and x["z"].shape == (n_q,) for x in served),
          "(a) finite z of the batch's shape")
    del served, fresh

    # ---------------------------------- (b) far-field plan, the same storm
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pf = build_plan(dx, dy, dz, params=params, area=1.0, impl="grid", phase2="farfield", farfield_rtol=1e-3,
                        query_occupancy=SERVE_QO)
    print(f"  (b) far-field plan: radius {pf.farfield_radius}, bound {pf.farfield_bound}, cand_capacity "
          f"{pf.cand_capacity}, p2_capacity {pf.p2_capacity}, p2_block_d {pf.p2_block_d}", flush=True)

    def masked_arm(p, qx, qy):
        # the masked B2 arm of one batch as the engine runs it: the blocks
        # whose near field overflows p2_capacity, swept over all data
        lay = _grid_layout(p, qx, qy)
        near = _near_field(p, lay.cx_v, lay.cy_v)
        over_v = (near.need > p.p2_capacity).repeat_interleave(p.block_q)
        over_s = over_v if lay.dest is None else over_v[lay.dest]
        ah = torch.full_like(lay.qx_s, 2.0)
        n_sw = int(over_s.reshape(-1, p.block_q).any(dim=1).sum()) * p.block_q
        ms = time_ms(lambda: _phase2_exact_masked(p, lay.qx_s, lay.qy_s, ah, over_s), 3) if n_sw else 0.0
        return ms, n_sw

    reg_f = PlanRegistry()
    re_f = CapacityReestimator(reg_f, "aidw-pod-1m-farfield", pf, warmup=warm)
    sync()
    _build.reset_launch_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        served_f, stamps_f = storm(re_f, 5, "(b)", extra=("p2_overflow_queries",))
    launches = dict(_build.LAUNCHES)
    print(f"  (b) launches over the storm, its re-plan and warmup: {launches}", flush=True)
    check(all(launches[k] > 0 for k in ("knn_skip", "near_weight", "far_cell", "weight_soa")),
          "the far-field storm launched B3, B4, B5 and the masked B2 arm")
    _, first_new_f, _ = summary("(b)", re_f, pf, served_f, stamps_f)
    b0, b1 = served_f[0], served_f[first_new_f]
    for tag, p_, bb in (("old plan, first storm batch", pf, b0), ("new plan, first batch on it", re_f.plan, b1),
                        ("new plan, the first storm batch again", re_f.plan, b0)):
        ms, n_sw = masked_arm(p_, bb["qx"], bb["qy"])
        _, _, st = execute_with_stats_quiet(p_, bb["qx"], bb["qy"])
        print(f"  (b) {tag} (seed={bb['seed']}): p2_capacity {p_.p2_capacity}, p2_overflow_queries "
              f"{int(st['p2_overflow_queries'])}, overflow_queries {int(st['overflow_queries'])}; masked B2 arm "
              f"{ms} ms over {n_sw} swept query slots (CUDA events)", flush=True)
    check(all(bool(torch.isfinite(x["z"]).all()) for x in served_f), "(b) finite z")
    del served_f
    # the re-plan keeps the old plan's seam level but sizes its capacities at
    # the default query occupancy: the default plans at their own seam level
    # and at the storm plan's, on the first serving batch
    qx, qy = queries(*SERVING[0])
    for phase2 in ("exact", "farfield"):
        for seam in (None, plan.seam_level):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                p_ = build_plan(dx, dy, dz, params=params, area=1.0, impl="grid", phase2=phase2, seam_level=seam)
            walls = []
            for _ in range(3):
                sync()
                t0 = time.time()
                _, _, st = execute_with_stats_quiet(p_, qx, qy)
                sync()
                walls.append(time.time() - t0)
            p2 = f", p2_capacity {p_.p2_capacity}, p2_overflow_queries {int(st['p2_overflow_queries'])}" \
                if phase2 == "farfield" else ""
            print(f"  (b) default {phase2} plan, seam_level {p_.seam_level} ({'auto' if seam is None else 'given'}), "
                  f"batch n={qx.shape[0]} seed={SERVING[0][1]}: cand_capacity {p_.cand_capacity}, overflow_queries "
                  f"{int(st['overflow_queries'])}{p2}; walls {walls} s", flush=True)
            del p_

    # -------------------------------------------- (c) the degrade path
    pc = dataclasses.replace(plan)  # the old plan's tensors, a fresh overflow streak
    reg_c = PlanRegistry()
    re_c = CapacityReestimator(reg_c, "aidw-pod-1m-degrade", pc, max_retries=3)
    with faults.inject("reestimator.build", error=RuntimeError("injected build failure"), times=3) as fault, \
            warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = []
        for seed in range(5, 5 + PERSISTENT_OVERFLOW_BATCHES):
            qx, qy = queries(n_q, seed)
            out.append((qx, qy, *re_c.execute(qx, qy)[:2]))
        state = re_c.join(timeout=600.0)
        qx, qy = queries(n_q, 5 + PERSISTENT_OVERFLOW_BATCHES)
        out.append((qx, qy, *re_c.execute(qx, qy)[:2]))
    degr = [w for w in rec if issubclass(w.category, PlanDegradedWarning)]
    bits = all(torch.equal(z, zz) and torch.equal(a, aa) for qx, qy, z, a in out for zz, aa in [execute(pc, qx, qy)])
    print(f"  (c) 3 injected build failures (fired {fault.fired}): state {state}, PlanDegradedWarning x{len(degr)} "
          f"({str(degr[0].message)[:90] if degr else ''}...), stats {re_c.stats()}; the {len(out)} batches equal "
          f"the installed plan's bits: {bits}", flush=True)
    check(state == DEGRADED and len(degr) == 1 and fault.fired == 3 and re_c.plan is pc and bits,
          "(c) one PlanDegradedWarning, state degraded, the installed plan's bits")
    del out

    # ------------------------------------------------------- (d) the memo
    ops.plan_cache_clear()
    qx, qy = queries(*SERVING[0])
    walls = []
    for _ in range(2):
        sync()
        t0 = time.time()
        z, a = aidw(dx, dy, dz, qx, qy, params=params, area=1.0, impl="grid")
        sync()
        walls.append(time.time() - t0)
    memo = default_registry().stats()
    print(f"  (d) kernels.aidw(impl='grid') twice on the same tensors: {walls[0]} s (plan built), {walls[1]} s "
          f"(memo hit); default registry {memo}", flush=True)
    check(memo["misses"] == 1 and memo["hits"] == 1 and memo["size"] == 1, "(d) one plan build, one miss, one hit")
    ops.plan_cache_clear()
    print(f"  phase 34: {time.time() - t_phase:.1f} s", flush=True)


# phase 38: the LM serving runs, (batch, prompt, generated tokens); the
# card-against-CPU check of the first two layers at full width (batch,
# tokens), held to the CPU tests' bound on the logits, as a fraction of the
# CPU's max |logit| (tests/torch_lm_common.py: BOUND); the bound of the
# smoke archs' card-against-CPU logits; the tolerance of prefill-then-decode
# against the full forward at full width, at full depth and on the first
# two layers, dense and MoE alike; and the headroom a full-depth model must
# leave on the card.  The card's cuBLAS GEMMs sum in another order than the
# CPU's, and in other orders at other shapes, so now and then a bf16 output
# rounds the other way, and the difference grows through the layers: at
# smoke widths up to 1.95e-2 of max |logit| (gemma3-27b, whose tied
# embeddings keep its logits small); prefill-then-decode 1.68e-2
# (minitron-4b) at full depth, 8.0e-3 on two layers.  In an MoE layer such
# a difference can also move a token's top-k across a bf16 near-tie (router
# logits are bf16 products), which moved qwen3-moe-30b-a3b's logits by
# 4.2e-2 to 5.5e-2: the check pins each MoE layer's expert choice to the
# full forward's (``PinnedRouting``), and then reads 1.22e-2 at full depth
# and 6.6e-3 on two layers.  Its controls, a decode on a zeroed cache and
# one at position T - 1 (the slot and RoPE one early), must miss by 10x the
# tolerance; at full depth the latter only by the tolerance, as under random
# weights qwen3-moe's attention spreads over all 128 positions and that
# fault moves its logits by 4.6e-2 (minitron-4b's by 2.3e-1).
LM_RUN, LM_CPU_CHECK, LM_HEADROOM = (4, 128, 32), (2, 16), 8 << 30
LM_BOUND, LM_SMOKE_BOUND = 2e-2, 5e-2
LM_DECODE_TOL = {"full depth": 3e-2, "two layers": 1.5e-2}
LM_FULL = ["minitron-4b", "qwen3-moe-30b-a3b"]
LM_SMOKE = ["stablelm-12b", "gemma3-27b", "qwen1.5-32b", "mixtral-8x7b", "qwen2-vl-72b"]


def lm_rel(got, want):
    """max |got - want| / max |want| on the CPU, in float64."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max())


class PinnedRouting:
    """While in use, pins the MoE layers' expert choice
    (``repro_torch.models.moe.top_k_stable``).  The first forward records
    each MoE call's top-k expert ids, in call order; after ``replay(rows,
    cols)`` every forward reuses the recorded ids of those batch rows and
    tokens and takes the gates from its own router probabilities, and
    ``flips`` counts the (call, token) choices its own top-k would have
    made otherwise, out of ``choices``, since the recording.  A model without MoE layers makes
    no call."""

    def __init__(self):
        self.ids, self.at, self.calls, self.flips, self.choices = [], None, 0, 0, 0

    def replay(self, rows, cols):
        self.at, self.calls = (rows, cols), 0

    def __enter__(self):
        from repro_torch.models import moe

        self.module, self.own = moe, moe.top_k_stable
        moe.top_k_stable = self
        return self

    def __exit__(self, *exc):
        self.module.top_k_stable = self.own

    def __call__(self, probs, k):
        import torch

        gates, ids = self.own(probs, k)
        if self.at is None:
            self.ids.append(ids)
            return gates, ids
        pinned = self.ids[self.calls][self.at]
        self.calls += 1
        self.flips += int((ids.sort(-1).values != pinned.sort(-1).values).any(-1).sum())
        self.choices += ids[..., 0].numel()
        return torch.gather(probs, -1, pinned), pinned


def lm_phase(*, dev):
    """38. The LM scaffold's serving path on the card (see the module's
    docstring)."""
    import torch

    from repro_torch.configs import ARCHS, smoke
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    from repro_torch.models import params as pm
    from repro_torch.train import make_prefill_step, make_serve_step, pad_caches

    print("38. LM serving (repro_torch.launch.serve)")
    t_phase = time.time()
    torch.cuda.empty_cache()

    def prefill_then_decode(model, p, tokens):
        """Last logits of the full forward on ``tokens`` and of a prefill of
        all but the last token followed by one decode step, with the MoE
        layers' expert choice pinned to the full forward's; the same step
        unpinned, on a zeroed cache and at position T - 1 (the controls);
        and how far the full forward at half the batch moves the logits."""
        t, half = tokens.shape[1] - 1, tokens.shape[0] // 2
        serve = make_serve_step(model, model.cfg)
        pin, out = PinnedRouting(), {}
        with torch.inference_mode():
            with pin:
                h, _, _ = model.apply(p, tokens, mode="train")
                out["full"] = model.logits(p, h[:, -1])
                pin.replay(slice(None), slice(None, t))
                _, caches = make_prefill_step(model, model.cfg)(p, {"tokens": tokens[:, :t]})
                caches = pad_caches(caches, t + 1)
                kept = pm.tree_map(torch.clone, caches)
                n_calls = pin.calls
                for key, c, pos in (("decode", caches, t), ("zeroed cache", pm.tree_map(torch.zeros_like, kept), t),
                                    ("position T - 1", pm.tree_map(torch.clone, kept), t - 1)):
                    pin.replay(slice(None), slice(t, None))
                    _, out[key], _ = serve(p, c, tokens[:, t:], pos)
                    n_calls += pin.calls
                    if key == "decode":
                        flips = (pin.flips, pin.choices)  # of the prefill and the decode
                pin.replay(slice(None, half), slice(None))
                h2, _, _ = model.apply(p, tokens[:half], mode="train")
                n_calls += pin.calls
                check(n_calls == 5 * len(pin.ids), f"{model.cfg.name}: every MoE call replayed the full forward's ids")
                floor = lm_rel(model.logits(p, h2[:, -1]), out["full"][:half])
            _, out["unpinned"], _ = serve(p, kept, tokens[:, t:], t)
        return out, floor, len(pin.ids), flips

    def decode_check(name, cfg, p, tokens, depth, label):
        """Prefill-then-decode against the full forward on ``depth`` layers
        (MoE at a dropless capacity: the published 1.25 drops other tokens
        in a group of T + 1 than in one of 1), with its controls."""
        t, tol = tokens.shape[1] - 1, LM_DECODE_TOL[label]
        cfg = dataclasses.replace(cfg, groups=(dataclasses.replace(cfg.groups[0], repeats=depth),),
                                  moe_capacity_factor=float(cfg.n_experts or cfg.moe_capacity_factor))
        runs, floor, n_moe, (flips, choices) = prefill_then_decode(build_model(cfg), p, tokens)
        full = runs.pop("full")
        check(all(bool(torch.isfinite(v).all()) for v in (full, *runs.values())), f"{name}: logits finite")
        errs = {key: lm_rel(v, full) for key, v in runs.items()}
        need = {"zeroed cache": 10 * tol, "position T - 1": (1 if label == "full depth" else 10) * tol}
        print(f"    {depth} layers, prefill {t} then decode against the full forward on {t + 1} tokens: "
              f"{errs['decode']:.3e} of max |logit| (tolerance {tol}); the full forward at half the batch moves "
              f"it {floor:.3e}")
        if n_moe:
            print(f"      expert choice pinned to the full forward's in {n_moe} MoE layers: the prefill's and the "
                  f"decode's own top-k differ in {flips} of {choices} (layer, token) choices; unpinned, the "
                  f"decode misses by {errs['unpinned']:.3e}")
        print(f"      controls: a decode on a zeroed cache misses by {errs['zeroed cache']:.3e} (must reach "
              f"{need['zeroed cache']:.3g}), a decode at position {t - 1} by {errs['position T - 1']:.3e} "
              f"(must reach {need['position T - 1']:.3g})")
        check(errs["decode"] <= tol, f"{name}, {depth} layers: prefill-then-decode matches the full forward")
        for key, limit in need.items():
            check(errs[key] >= limit, f"{name}, {depth} layers: the control ({key}) misses")

    for name in LM_FULL:
        t_arch = time.time()
        cfg = ARCHS[name]
        model = build_model(cfg)
        n_params = pm.count_params(model.spec())
        free, _ = torch.cuda.mem_get_info()
        layers = cfg.n_layers
        if 2 * n_params + LM_HEADROOM > free:
            layers = cfg.n_layers // 2
            cfg = dataclasses.replace(cfg, groups=(dataclasses.replace(cfg.groups[0], repeats=layers),))
            model = build_model(cfg)
            print(f"  {name}: {2 * n_params / 1e9:.1f} GB of bf16 weights and {LM_HEADROOM >> 30} GiB of headroom "
                  f"do not fit the {free / 1e9:.1f} GB free: full width, {layers} of {ARCHS[name].n_layers} layers")
            n_params = pm.count_params(model.spec())
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        p = pm.materialize(model.spec(), gen, dev, torch.bfloat16)
        torch.cuda.synchronize()
        t_mat = time.perf_counter() - t0
        b, t, n_gen = LM_RUN
        tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=gen, device=dev)
        out, tp0, td0 = generate(model, p, tokens, n_gen)
        out, tp, td = generate(model, p, tokens, n_gen)
        peak = torch.cuda.max_memory_allocated()
        print(f"  {name}: {n_params / 1e9:.3f}e9 parameters, {layers} layers, bf16 on the card, made in {t_mat:.2f} s; "
              f"batch {b}, prompt {t}, {n_gen} tokens")
        print(f"    first call: prefill {tp0 * 1e3:.1f} ms, decode {td0 * 1e3 / (n_gen - 1):.2f} ms a step")
        print(f"    warm: prefill {tp * 1e3:.1f} ms, decode {td * 1e3 / (n_gen - 1):.2f} ms a step, "
              f"{(n_gen - 1) * b / td:.1f} tok/s; peak memory {peak / 1e9:.2f} GB "
              f"(max_memory_allocated)")
        check(out.shape == (b, n_gen) and int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
              f"{name}: generated tokens in the vocabulary")
        p2 = dict(p, stacks={"g0": pm.tree_map(lambda x: x[:2], p["stacks"]["g0"])})
        ext = torch.cat([tokens, out[:, :1]], dim=1)
        decode_check(name, cfg, p, ext, layers, "full depth")
        decode_check(name, cfg, p2, ext, 2, "two layers")
        # the first two layers at full width, card against the port's CPU path
        m2 = build_model(dataclasses.replace(cfg, groups=(dataclasses.replace(cfg.groups[0], repeats=2),)))
        bc, tc = LM_CPU_CHECK
        toks2 = tokens[:bc, :tc]
        with torch.inference_mode():
            h_card, _, _ = m2.apply(p2, toks2, mode="train")
            l_card = m2.logits(p2, h_card[:, -1])
            p2_cpu = pm.tree_map(lambda x: x.cpu(), p2)
            h_cpu, _, _ = m2.apply(p2_cpu, toks2.cpu(), mode="train")
            l_cpu = m2.logits(p2_cpu, h_cpu[:, -1])
        eh, el = lm_rel(h_card, h_cpu), lm_rel(l_card, l_cpu)
        print(f"    two layers, batch {bc}, {tc} tokens, card against CPU: last logits {el:.3e} of max |logit| "
              f"(tolerance {LM_BOUND}); hidden states {eh:.3e} of max |h|")
        check(el <= LM_BOUND, f"{name}: two layers on the card match the CPU path")
        print(f"    {name}: {time.time() - t_arch:.1f} s")
        del p, p2, p2_cpu, out
        torch.cuda.empty_cache()

    for name in LM_SMOKE:
        cfg = dataclasses.replace(smoke(ARCHS[name]), moe_capacity_factor=8.0)
        model = build_model(cfg)
        p_cpu = pm.materialize(model.spec(), torch.Generator().manual_seed(1), "cpu")
        p_card = pm.tree_map(lambda x: x.to(dev), p_cpu)
        rng = np.random.default_rng(2)
        toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 24)))
        extra = {}
        if cfg.family == "vlm":
            extra["visual_embeds"] = torch.tensor(rng.standard_normal((2, cfg.n_vis_tokens, cfg.d_model)) * 0.1)
        errs = []
        with torch.inference_mode():
            runs = []
            for p_, d_ in ((p_cpu, torch.device("cpu")), (p_card, dev)):
                batch = {"tokens": toks.to(d_), **{k: v.float().to(d_) for k, v in extra.items()}}
                logits, caches = make_prefill_step(model, cfg)(p_, batch)
                runs.append([p_, d_, logits, pad_caches(caches, 24 + 3)])
            errs.append(lm_rel(runs[1][2], runs[0][2]))
            tok = torch.argmax(runs[0][2], -1).to(torch.int32)[:, None]  # both take the CPU's tokens
            serve = make_serve_step(model, cfg)
            for i in range(3):
                outs = [serve(p_, c_, tok.to(d_), 24 + i) for p_, d_, _, c_ in runs]
                errs.append(lm_rel(outs[1][1], outs[0][1]))
                tok = outs[0][0]
        print(f"  {name} (smoke): prefill and 3 serve steps, card against CPU: "
              f"{', '.join(f'{e:.3e}' for e in errs)} of max |logit| (tolerance {LM_SMOKE_BOUND})")
        check(max(errs) <= LM_SMOKE_BOUND, f"{name}: smoke serving on the card matches the CPU path")
    print(f"  phase 38: {time.time() - t_phase:.1f} s")


def execute_with_stats_quiet(plan, qx, qy):
    """``execute_with_stats`` with its overflow warning silenced (a diagnostic
    call outside a serving loop)."""
    from repro_torch.engine import execute_with_stats

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return execute_with_stats(plan, qx, qy)


if __name__ == "__main__":
    sys.exit(main())
