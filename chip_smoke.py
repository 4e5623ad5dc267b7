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
   B1 also on the ``tiled`` impl's shared data row.

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
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "fixtures" / "aidw_golden.npz"
GOLDEN_RTOL, GOLDEN_ATOL = 5e-4, 5e-5  # tests/test_golden.py
FP_SLACK_ULPS = 64                     # src/repro/core/accuracy.py: fp slack per sqrt(m)
M_FULL = 1 << 20                       # aidw-pod-1m: the paper's 1000K rounded to 2^20
SERVING = [(65536, 1), (65536, 2), (65536, 3), (M_FULL, 4)]  # (queries, seed)
N_SAMPLE = 1024                        # queries per batch held against the f64 reference
N_CHECK = 2048                         # queries of the shared-row kernel checks

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
}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def report(name, err, tol):
    print(f"  {name}: max err {err:.3e} (tolerance {tol:.3e})", flush=True)
    check(err <= tol, f"{name}: {err} > {tol}")


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

    # where one serving batch's device time goes (CUPTI trace); "busy" is the
    # summed time of the device's own events (kernels, copies, memsets), not
    # of the host-side ops that launched them, over the batch's wall time
    qx, qy = batches[0]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        execute_with_stats(plan, qx, qy)
        sync()
        wall_ms = 1e3 * (time.time() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    if busy_ms > 0:
        print(f"  profile n={qx.shape[0]}: wall {wall_ms} ms, device busy {busy_ms} ms "
              f"({100 * busy_ms / wall_ms:.1f}%), idle {100 * (1 - busy_ms / wall_ms):.1f}%")
        for e in events[:10]:
            print(f"    {dev_us(e) / 1e3} ms  x{e.count} {e.key[:70]}")
    else:
        print("  profile: the trace shows no device time; device busy share not measured")

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
    print(f"  total {time.time() - t_start:.1f} s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
