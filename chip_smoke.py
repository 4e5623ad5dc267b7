#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with one CUDA card and the
CUDA toolkit.  It builds the hand-written kernels from
``src/repro_torch/kernels/csrc`` into ``build/repro_torch_kernels/`` and runs,
in order (a failed check raises, and the script exits nonzero):

1. build: each kernel's registers and spills, as ``ptxas -v`` prints them,
   and the special-function-unit (MUFU) ops of the weight kernel's inner
   loop, from its SASS;
2. each kernel against its plain PyTorch version on the card, float32 and
   float64, at the shapes the main path gives it (m = 2^20);
3. the golden fixture (``tests/fixtures/aidw_golden.npz``) for ``grid`` with
   both pipelines and for ``tiled``, float32 and float64;
4. run-to-run determinism and NaN/Inf query hardening;
5. the serving run of the ``aidw-pod-1m`` configuration: clustered data,
   m = 2^20, k = 10, three batches of 65,536 uniform queries and one of 2^20
   on the main path (``impl="grid"``, ``pipeline="prefetch"``), then one
   batch through ``pipeline="dense"`` and one through ``impl="tiled"``; each
   path with its launch counts, sampled queries held against a float64
   brute-force reference;
6. each kernel timed with CUDA events at the serving batch's shapes, and
   B1 also on the ``tiled`` impl's shared data row;
7. the far-field kernels (``phase2="farfield"``) against their plain
   versions on the card, float32 and float64, at the serving batch's shapes:
   B4 (near field) and B5 (far cells), with controls that a sweep dropping
   one tile, one near point or one far cell fails the check;
8. the golden far-field pin (``ffpin_*`` of the fixture) on the card;
9. the far-field plan built on the card against the one built on the CPU;
10. the far-field serving run of ``aidw-pod-1m``: the same four batches, the
    radius, bound and warning of the plan, each batch's time, stats and
    launches, its error against the Kahan oracle on sampled queries, and B4
    and B5 at its shapes against their plain versions on sampled blocks;
11. the far-field overflow arm at the reference test's small shape, bitwise
    against an exact plan;
12. B4 and B5 timed with CUDA events at the serving batch's shapes;
13. the quadtree kernel B6 (``phase2="quadtree"``) against its plain version
    on the card, every level, float32 and float64, at the serving batch's
    shapes, with controls that a table losing its first node and a sweep
    without the dipole term fail the check;
14. the golden quadtree pin (``qtree_*`` of the fixture) on the card;
15. the quadtree plan built on the card against the one built on the CPU;
16. the quadtree serving run of ``aidw-pod-1m``: the same four batches, each
    batch's time, the walk's time alone, stats and launches, its error
    against the Kahan oracle on sampled queries, and B6 at its shapes against
    the plain version on sampled blocks;
17. the quadtree overflow arm at the reference test's small shape, bitwise
    against an exact plan;
18. the ring-search arm with every query active on 1,024 queries far
    outside the data's box: its rings and time, r_obs against a float64
    brute force;
19. B6 timed with CUDA events per level at the serving batch's shapes,
    beside the quadtree, far-field and exact batch times of this run.

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
# B4/B5 against their plain versions: the same terms summed in the same
# order (kernels/_common.py: run_sum), so the sums differ only where the
# card's exp/log in the kernel and in PyTorch give a term other last bits
SUM_ULPS = 8
N_BLOCKS = 64                          # blocks of each far-field serving batch held against plain

# H100 SXM published peaks (NVIDIA data sheet), non-tensor-core
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12
# special-function units: 16 results per SM per clock, 132 SMs, 1.98 GHz boost
PEAK_SFU = 132 * 16 * 1.98e9
# instruction issue: 4 warp schedulers x 32 threads per SM per clock
PEAK_ISSUE = 132 * 128 * 1.98e9

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
}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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


def hold(tag, k, pl, dtype):
    """A far-field kernel against its plain version on the same inputs: sum w
    and sum w z within SUM_ULPS of each sum and zero where the plain sum is
    zero; B4's min d^2 and hit z bit for bit.  Returns ``(ulps, all outputs
    bitwise equal, min d^2 and hit z equal)``."""
    import torch

    for s_k, s_p in zip(k[:2], pl[:2]):
        check(torch.equal(s_k == 0, s_p == 0), f"{tag}: the same sums are 0")
    e = max(ulps(k[0], pl[0], dtype), ulps(k[1], pl[1], dtype))
    same = e == 0.0 and all(torch.equal(a, b) for a, b in zip(k, pl))
    same_min = len(k) == 2 or (torch.equal(k[2], pl[2]) and torch.equal(k[3], pl[3]))
    check(e <= SUM_ULPS and same_min, f"{tag} matches its plain version ({e} ulps)")
    return e, same, same_min


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


def inner_loop_sass(cuobjdump: str, lib: Path, kernel: str):
    """The per-pair loop of ``kernel``'s SASS: the innermost loop with the
    most MUFU.EX2 (one per exp).  Returns ``(instructions per pair, {MUFU
    opcode: count per pair})``, or ``None`` when no such loop is found.
    Also writes the library's SASS beside it as ``<lib>.sass``."""
    text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    lib.with_name(lib.name + ".sass").write_text(text)
    func = next((f for f in text.split("Function : ")[1:] if f.startswith(kernel)), "")
    instr = [(int(a, 16), op) for a, op in
             re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)]
    labels = {lab: int(a, 16) for lab, a in re.findall(r"(\.L_x_\d+):\s*\n\s*/\*([0-9a-f]+)\*/", func)}
    spans = set()
    for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/[^\n]*?BRA\s+`?\(?(0x[0-9a-f]+|\.L_x_\d+)", func):
        a, t = int(a, 16), labels.get(t) if t.startswith(".") else int(t, 16)
        if t is not None and t <= a:
            spans.add((t, a))
    inner = [(t, a) for t, a in spans
             if not any((t2, a2) != (t, a) and t <= t2 and a2 <= a for t2, a2 in spans)]
    bodies = [[op for addr, op in instr if t <= addr <= a] for t, a in inner]
    bodies = [b for b in bodies if "MUFU.EX2" in b]
    if not bodies:
        return None
    body = max(bodies, key=lambda b: b.count("MUFU.EX2"))
    per = body.count("MUFU.EX2")
    return len(body) / per, {op: body.count(op) / per for op in sorted(set(body)) if op.startswith("MUFU")}


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
    from repro_torch.kernels.aidw_tiled import (
        knn_alpha,
        knn_alpha_plain,
        weight_sweep,
        weight_sweep_plain,
    )

    dev = torch.device("cuda")
    t_start = time.time()
    alpha_tol = {torch.float32: 1e-6, torch.float64: 1e-12}
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
    for line in _build.ptxas_report():
        print("  ptxas", line)
    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    sass = inner_loop_sass(cuobjdump, paths["weight"], "_ZN4aidw13weight_kernelIfE")
    if sass is None:
        print("  weight_kernel<float> SASS: no per-pair loop found; MUFU count not measured")
    else:
        print(f"  weight_kernel<float> SASS per-pair loop: {sass[0]} instructions per pair, "
              f"MUFU per pair {sass[1]}")

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
        report(f"B1 shared row {name}", maxerr(a_k, a_p), alpha_tol[dtype])
        z_k = weight_sweep(qxc, qyc, a_k * 0.5, dx, dy, dz, tile_d=512, eps=params.exact_hit_eps)
        z_p = weight_sweep_plain(qxc, qyc, a_k * 0.5, dx, dy, dz, tile_d=512, eps=params.exact_hit_eps)
        e_b2 = maxerr(z_k, z_p)
        print(f"  B2 {name}: max abs err {e_b2:.3e}")
        report(f"B2 {name} relative", float(((z_k - z_p) / z_p).abs().max()), b2_rtol(dtype))
        # the tolerance is tight enough to see a sweep that loses one tile
        gone = torch.zeros_like(dx, dtype=torch.bool)
        gone[:512] = True
        sent = coord_sentinel(dtype, dev)
        z_gone = weight_sweep_plain(qxc, qyc, a_k * 0.5, torch.where(gone, sent, dx), torch.where(gone, sent, dy),
                                    dz, tile_d=512, eps=params.exact_hit_eps)
        e_gone = float(((z_gone - z_p) / z_p).abs().max())
        print(f"  B2 {name}: a sweep without its first tile is off by {e_gone:.3e} relative")
        check(e_gone > b2_rtol(dtype), "the B2 tolerance catches a lost tile")

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
        report(f"B3 tile table {name} ({cut} of {lay.num_tiles.shape[0]} rows walk < {full} tiles)",
               maxerr(a3, a3_p), alpha_tol[dtype])
        report(f"B1 candidate rows {name}", maxerr(a1, a1_p), alpha_tol[dtype])
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
    del plan, z1, z2, a1, a2

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
        ez, ea = maxerr(z[idx], torch.cat(zr)), maxerr(a[idx], torch.cat(ar))
        report(f"{tag} z vs f64 reference", ez, z_tol(torch.float32, M_FULL, float(dz.abs().max())))
        report(f"{tag} alpha vs f64 reference", ea, 1e-5)

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
    for (n, seed), (qx, qy), (z, a, _, _) in zip(SERVING, batches, results):
        check(bool(torch.isfinite(z).all() and torch.isfinite(a).all()) and z.shape == (n,),
              f"finite outputs of shape ({n},)")
        f64_check(f"batch n={n} seed={seed}", qx, qy, z, a, seed)

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
    flops = {"knn_skip": 6, "knn_soa": 6, "weight_soa": 13}

    def bound(n_pairs, n_bytes, ops):
        t_ops, t_bytes = n_pairs * ops / PEAK_FLOPS["float32"], n_bytes / PEAK_BYTES
        return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"

    rows_out = []
    for name, (kern, plain, reps) in calls.items():
        ms = time_ms(kern, reps)
        plain_ms = time_ms(plain, 1, warmup=0)
        bound_ms, bound_by = bound(pairs[name], row_bytes[name], flops[name])
        launches = path_launches["grid/dense" if name == "knn_soa" else "grid/prefetch"][name]
        rows_out.append(dict(name=name, route="cuda", **KERNELS[name], launches=launches,
                             max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=None))
        print(f"  {name}: {ms} ms (plain {plain_ms} ms, bound {bound_ms} ms, {pairs[name]} pairs)",
              flush=True)
    if sass is not None:
        p2 = pairs["weight_soa"]
        print(f"  weight_soa beside its bound: MUFU {1e3 * p2 * sum(sass[1].values()) / PEAK_SFU} ms "
              f"({sass[1]} per pair at 16/SM/clock); instruction issue {1e3 * p2 * sass[0] / PEAK_ISSUE} "
              f"ms ({sass[0]} SASS instructions per pair at 128/SM/clock)")

    # B1 on the `tiled` impl's shared data row: every query walks all m points
    qx_t, qy_t = qx.contiguous(), qy.contiguous()
    dxt, dyt, _ = plan_t.data
    shared = dict(block_q=plan_t.block_q, tile_d=plan_t.block_d, **kw)
    ms = time_ms(lambda: knn_alpha(qx_t, qy_t, dxt[None], dyt[None], **shared), 3)
    plain_ms = time_ms(lambda: knn_alpha_plain(qx_t, qy_t, dxt[None], dyt[None], **shared), 1, warmup=0)
    sh_pairs = qx_t.shape[0] * M_FULL
    bound_ms, bound_by = bound(sh_pairs, 2 * 4 * M_FULL + 3 * 4 * qx_t.shape[0], flops["knn_soa"])
    print(f"  knn_soa shared row (tiled): {ms} ms (plain {plain_ms} ms, bound {bound_ms} ms by {bound_by}, "
          f"{sh_pairs} pairs)", flush=True)
    ff_rows, ff_walls = farfield_phases(
        dev=dev, params=params, golden=golden, eps=eps, data=data, queries=queries, sync=sync,
        maxerr=maxerr, time_ms=time_ms, bound=bound, batches=batches, results=results,
        exact_b2_ms=next(r["ms"] for r in rows_out if r["name"] == "weight_soa"))
    rows_out += ff_rows
    rows_out += quadtree_phases(
        dev=dev, params=params, golden=golden, data=data, queries=queries, sync=sync, maxerr=maxerr,
        time_ms=time_ms, bound=bound, batches=batches, results=results, ff_walls=ff_walls)
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
    from repro_torch.kernels.aidw_grid import (
        phase1_alpha_from_candidates,
        phase2_far_aggregates,
        phase2_far_aggregates_plain,
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
        e_n, same_n, same_min = hold(f"B4 {name}", n_k, n_p, dtype)
        e_f, same_f, _ = hold(f"B5 {name}", f_k, f_p, dtype)
        # controls, each a plain sweep of the same inputs less a little:
        # B4 without its first tile, and without the first point of each row;
        # B5 without its first tile of cells, and without one cell (the
        # occupied cell of median count)
        sent = coord_sentinel(dtype, dev)

        def near_less(drop):
            cx, cy = torch.where(drop, sent, near.cand_x), torch.where(drop, sent, near.cand_y)
            return phase2_near_weights_plain(*near_args[:3], cx, cy, *near_args[5:], **nk)

        def far_less(drop):
            cnt, zs = torch.where(drop, 0.0, p.far[2]), torch.where(drop, 0.0, p.far[3])
            return phase2_far_aggregates_plain(*far_args, (*p.far[:2], cnt, zs, *p.far[4:]), **fk)

        drop = torch.zeros_like(near.cand_x, dtype=torch.bool)
        drop[:, :p.p2_block_d] = True
        e_ntile = ulps(near_less(drop)[0], n_p[0], dtype)
        drop = torch.zeros_like(near.cand_x, dtype=torch.bool)
        drop[:, 0] = True
        e_npt = ulps(near_less(drop)[0], n_p[0], dtype)
        drop = torch.zeros_like(p.far[2], dtype=torch.bool)
        drop[:p.p2_far_block_d] = True
        e_ftile = ulps(far_less(drop)[0], f_p[0], dtype)
        occupied = torch.nonzero(p.far[2] > 0).reshape(-1)
        median_cell = occupied[torch.argsort(p.far[2][occupied], stable=True)[occupied.numel() // 2]]
        drop = torch.zeros_like(p.far[2], dtype=torch.bool)
        drop[median_cell] = True
        e_fcell = ulps(far_less(drop)[0], f_p[0], dtype)
        z_pp = z_of(*n_p, *f_p)
        ez_n, ez_f = maxerr(z_of(*n_k, *f_p), z_pp), maxerr(z_of(*n_p, *f_k), z_pp)
        full = p.p2_capacity // p.p2_block_d
        short = int((near.num_tiles < full).sum())
        print(f"  B4 {name}: sum_w, sum_wz within {e_n:.2f} ulps (tolerance {SUM_ULPS}), all four outputs "
              f"bitwise equal: {same_n}; min d^2 and hit z equal: {same_min}; z max abs err {ez_n:.3e}; "
              f"{short} of {near.num_tiles.shape[0]} rows walk fewer than {full} tiles")
        print(f"  B4 {name} controls: the plain sweep without its first tile is off by {e_ntile:.3e} ulps, "
              f"without the first point of each row by {e_npt:.3e} ulps")
        print(f"  B5 {name}: sum_w, sum_wz within {e_f:.2f} ulps (tolerance {SUM_ULPS}), bitwise equal: {same_f}; "
              f"z max abs err {ez_f:.3e}")
        print(f"  B5 {name} controls: the plain sweep without its first tile of cells is off by {e_ftile:.3e} "
              f"ulps, without cell {int(median_cell)} (count {float(p.far[2][median_cell])}, the median of "
              f"{occupied.numel()} occupied cells) by {e_fcell:.3e} ulps", flush=True)
        check(min(e_ntile, e_npt, e_ftile, e_fcell) > SUM_ULPS,
              f"the B4/B5 tolerance catches a lost tile, point and cell ({name})")
        check(short > 0, "some near rows walk fewer tiles than the capacity")
        if dtype == f32:
            ff_errs = {"near_weight": ez_n, "far_cell": ez_f}
            ff32 = (p, lay, near, ah)
        del n_k, n_p, f_k, f_p, drop

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
        n_p = phase2_near_weights_plain(*near_s, block_q=plan_ff.block_q, tile_d=plan_ff.p2_block_d)
        f_p = phase2_far_aggregates_plain(*far_s, plan_ff.far, block_q=plan_ff.block_q,
                                          tile_d=plan_ff.p2_far_block_d)
        e_n, same_n, _ = hold(f"B4 batch n={n}", tuple(o[rows] for o in n_k), n_p, f32)
        e_f, same_f, _ = hold(f"B5 batch n={n}", tuple(o[rows] for o in f_k), f_p, f32)
        print(f"  batch n={n} seed={seed}: B4 and B5 on {blocks.numel()} of its {nb} query blocks against their "
              f"plain versions: within {e_n:.2f} and {e_f:.2f} ulps (tolerance {SUM_ULPS}), bitwise equal: "
              f"{same_n} and {same_f}", flush=True)
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
        bound_ms, bound_by = bound(ops, n_bytes, 1)
        total_ms += ms
        rows.append(dict(name=name, route="cuda", **KERNELS[name], launches=ff_launches[name],
                         max_abs_err=ff_errs[name], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None))
        print(f"  {name}: {ms} ms (plain {plain_ms} ms, bound {bound_ms} ms by {bound_by}, {n_pairs} pairs, "
              f"{ops} operations)", flush=True)
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
    from repro_torch.kernels.aidw_grid import (
        block_rectangles,
        phase1_alpha_from_candidates,
        phase2_far_nodes,
        phase2_far_nodes_plain,
        phase2_near_weights_plain,
    )

    f32, f64 = torch.float32, torch.float64
    hit_eps = params.exact_hit_eps

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

    def b6(lay, ah, levels, block_q, rows=None, plain=False, drop_first=False, no_dipole=False):
        # B6 on every level (kernel or plain), all query blocks or the blocks
        # of `rows`; the controls drop each row's first closed node or the
        # dipole moments
        fn = phase2_far_nodes_plain if plain else phase2_far_nodes
        qx, qy = lay.qx_v, lay.qy_v
        if rows is not None:
            qx, qy, ah = qx[rows[0]], qy[rows[0]], ah[rows[0]]
        out = []
        for tbl, nt, _, nodes, tile in levels:
            if rows is not None:
                tbl, nt = tbl[rows[1]], nt[rows[1]]
            if drop_first:
                tbl = tbl.clone()
                tbl[:, 0] = nodes[0].shape[0] - 1
            if no_dipole:
                nodes = (*nodes[:4], torch.zeros_like(nodes[4]), torch.zeros_like(nodes[5]))
            out.append(fn(qx, qy, ah, tbl.contiguous(), nt.contiguous(), nodes, block_q=block_q, tile_d=tile))
        return out

    def level_ulps(a, b, dtype):
        return max(max(ulps(x[0], y[0], dtype), ulps(x[1], y[1], dtype)) for x, y in zip(a, b))

    # ------------------------------------------------ 13. (a) B6 vs plain
    print("== 13. (a) quadtree kernel B6 (far_node.cu) vs its plain version, every level (aidw-pod-1m quadtree "
          "plan, serving batch n=65536)", flush=True)
    qt32, b6_err = None, 0.0
    for dtype in (f32, f64):
        name = str(dtype).split(".")[1]
        p, _ = qt_plan(*data(dtype))
        qx, qy = queries(*SERVING[0], dtype)
        lay, ah, home, levels = qt_inputs(p, qx, qy)
        k_out, p_out = b6(lay, ah, levels, p.block_q), b6(lay, ah, levels, p.block_q, plain=True)
        sync()
        per_level = []
        for lv, (k, pl) in enumerate(zip(k_out, p_out)):
            e, same, _ = hold(f"B6 {name} level {lv}", k, pl, dtype)
            per_level.append((e, same, float(levels[lv][2].float().mean()), int(levels[lv][2].max()),
                              p.qt_levels[lv][3]))
        e_drop = level_ulps(b6(lay, ah, levels, p.block_q, plain=True, drop_first=True), p_out, dtype)
        e_dip = level_ulps(b6(lay, ah, levels, p.block_q, plain=True, no_dipole=True), p_out, dtype)
        for lv, (e, same, mean_c, max_c, k_pad) in enumerate(per_level):
            print(f"  B6 {name} level {lv}: sum_w, sum_wz within {e:.2f} ulps (tolerance {SUM_ULPS}), bitwise equal: "
                  f"{same}; closed nodes per block mean {mean_c}, max {max_c} of k_pad {k_pad}")
        print(f"  B6 {name} controls: the plain sweep with each row's first closed node dropped is off by "
              f"{e_drop:.3e} ulps, without the dipole term by {e_dip:.3e} ulps", flush=True)
        check(min(e_drop, e_dip) > SUM_ULPS, f"the B6 tolerance catches a lost node and a lost dipole ({name})")
        if dtype == f32:
            near = _near_field(p, lay.cx_v, lay.cy_v)
            nsum = phase2_near_weights_plain(lay.qx_v, lay.qy_v, ah, near.cand_x, near.cand_y, near.cand_z,
                                             near.num_tiles, block_q=p.block_q, tile_d=p.p2_block_d)

            def z_all(far):
                sw, swz = nsum[0], nsum[1]
                for s_w, s_wz in far:
                    sw, swz = sw + s_w, swz + s_wz
                return torch.where(nsum[2] <= hit_eps, nsum[3], swz / sw)

            b6_err = maxerr(z_all(k_out), z_all(p_out))
            qt32 = (p, lay, ah, levels)
        del k_out, p_out

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
        e_b, same_b = 0.0, True
        for lv, (k, pl) in enumerate(zip(k_out, p_out)):
            e, same, _ = hold(f"B6 batch n={n} level {lv}", tuple(o[rows] for o in k), pl, f32)
            e_b, same_b = max(e_b, e), same_b and same
        print(f"  batch n={n} seed={seed}: B6 on {blocks.numel()} of its {nb} query blocks, every level, against its "
              f"plain version: within {e_b:.2f} ulps (tolerance {SUM_ULPS}), bitwise equal: {same_b}", flush=True)
        del lay, ah, levels, k_out, p_out
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
    print("== 19. (g) B6 timings (CUDA events, serving batch n=65536, m=2^20, float32)", flush=True)
    p, lay, ah, levels = qt32
    n_v = lay.qx_v.shape[0]
    # What these inputs need: a term for each closed node of each block, 20
    # operations per pair counted from far_node.cu's loop (d^2 5, max, log,
    # mul, exp, 2*ah*w, the division, the dipole's 2 muls, add and mul, the
    # count's mul and add, z_sum's mul, the dipole's add and the sum's add;
    # exp, log and the division one operation each).  Bytes: queries and
    # alpha read once, the closed ids and the level's node arrays read once,
    # the two sums written once.
    total_ms = total_plain = total_bound = 0.0
    total_pairs, bound_kinds = 0, set()
    for lv, (tbl, nt, n_closed, nodes, tile) in enumerate(levels):
        args = (lay.qx_v, lay.qy_v, ah, tbl, nt, nodes)
        ms = time_ms(lambda: phase2_far_nodes(*args, block_q=p.block_q, tile_d=tile), 10)
        plain_ms = time_ms(lambda: phase2_far_nodes_plain(*args, block_q=p.block_q, tile_d=tile), 1, warmup=0)
        n_closed_tot = int(n_closed.long().sum())
        pairs = p.block_q * n_closed_tot
        n_bytes = 3 * 4 * n_v + 4 * n_closed_tot + 6 * 4 * nodes[0].shape[0] + 2 * 4 * n_v
        bound_ms, bound_by = bound(20 * pairs, n_bytes, 1)
        total_ms, total_plain, total_bound, total_pairs = (total_ms + ms, total_plain + plain_ms,
                                                           total_bound + bound_ms, total_pairs + pairs)
        bound_kinds.add(bound_by)
        print(f"  far_node level {lv}: {ms} ms (plain {plain_ms} ms, bound {bound_ms} ms by {bound_by}, {pairs} pairs, "
              f"k_pad {p.qt_levels[lv][3]}, tile {tile})", flush=True)
    print(f"  far_node, {len(levels)} launches per batch: {total_ms} ms (plain {total_plain} ms, bound {total_bound} ms, "
          f"{total_pairs} pairs = block_q x sum of closed nodes)")
    print(f"  batch wall times (host clock, this call): quadtree {qt_walls}, far-field {ff_walls}, exact "
          f"{[r[3] for r in results]} s")
    return [dict(name="far_node", route="cuda", **KERNELS["far_node"], launches=qt_launches["far_node"],
                 max_abs_err=b6_err, ms=total_ms, plain_ms=total_plain, bound_ms=total_bound,
                 bound_by="operations" if bound_kinds == {"operations"} else "bytes",
                 library_ms=None)]


if __name__ == "__main__":
    sys.exit(main())
