"""The float32 weight of the exact sweep on the special-function units.

``csrc/aidw_common.cuh: pow_weight`` computes w = 2^(-(alpha/2) log2 d^2)
with ``lg2.approx.ftz.f32`` and ``ex2.approx.ftz.f32`` in float32 (precise
exp/log in float64), and every exact weight loop (``weight.cu``,
``naive.cu``, ``fused.cu``) takes its weights from there.  The CUDA kernels
run only on the card (``chip_smoke.py`` holds them against their plain
versions); here:

* a numpy emulation of the float32 kernel's loop, with the units' errors
  drawn at the PTX ISA's bounds (2^-22.6 absolute in log2, 2 ulps relative
  in 2^x), is held within 64 ulps of each z of ``weight_sweep_plain`` (the
  card's check of B2 against its plain version) and, against a float64
  sweep of the same inputs, within 2x the error of the precise exp/log form
  summed in the same order;
* the sources route every exact weight through ``pow_weight``, every exact
  tile loop through ``weight_tile``, the near-field and far-cell sweeps
  (``near.cu``, ``far.cu``) through ``run_stage`` to ``pow_weight`` as well,
  and the quadtree kernel (``far_node.cu``) through ``node_run`` to
  ``pow_weight``, with no precise ``exp_p``/``log_p`` of its own (float64
  reaches them inside ``pow_weight`` alone; its float32 sums are held within
  a per-query tolerance, ``tests/test_torch_far_node_sfu.py``);
* the wrapper's launch rule, ``kernels/aidw_tiled.py: weight_launch``.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.data import clustered_points
from repro_torch.kernels import _build
from repro_torch.kernels.aidw_tiled import weight_launch, weight_sweep_plain

F32 = np.float32
EPS32 = float(np.finfo(F32).eps)
LG2_ABS = 2.0 ** -22.6   # lg2.approx.f32: absolute error in log2 x
EX2_REL = 2 * EPS32      # ex2.approx.f32: about 2 ulps
TINY = F32(1e-30)        # core/aidw.py: tiny_for(float32)
HIT_EPS = 1e-18
TILE = 512


def _sweep(qx, qy, ah, dx, dy, dz, rng=None):
    """weight.cu's float32 loop in numpy: each tile summed left to right
    (``np.cumsum`` accumulates in float32, in order), the tile sums folded
    in data order, the first minimum kept with a strict ``<``.  With ``rng``
    the weight is the special-function form, each unit's error drawn at its
    bound with a random sign and subnormal results flushed to 0; without it
    the precise exp/log form."""
    with np.errstate(over="ignore", invalid="ignore"):  # sentinel points and the exact hit overflow
        return _sweep_tiles(qx, qy, ah, dx, dy, dz, rng)


def _sweep_tiles(qx, qy, ah, dx, dy, dz, rng):
    n = qx.shape[0]
    neg_ah = (-ah).astype(F32)[:, None]
    sum_w, sum_wz, hit_z = (np.zeros(n, F32) for _ in range(3))
    min_d2 = np.full(n, np.inf, F32)
    for t0 in range(0, dx.shape[0], TILE):
        s = slice(t0, t0 + TILE)
        ddx, ddy = qx[:, None] - dx[None, s], qy[:, None] - dy[None, s]
        d2 = ddx * ddx + ddy * ddy
        c = np.where(d2 > TINY, d2, TINY)
        if rng is None:
            w = np.exp(neg_ah * np.log(c))
        else:
            lg2 = (np.log2(c.astype(np.float64)) + rng.choice([-1.0, 1.0], c.shape) * LG2_ABS).astype(F32)
            t = neg_ah * lg2  # float32 product, as mul_rn
            w = (np.exp2(t.astype(np.float64)) * (1 + rng.choice([-1.0, 1.0], c.shape) * EX2_REL)).astype(F32)
            w = np.where(w < F32(2.0 ** -126), F32(0), w)  # .ftz
        sum_w = sum_w + np.cumsum(w, axis=1, dtype=F32)[:, -1]
        sum_wz = sum_wz + np.cumsum(w * dz[None, s], axis=1, dtype=F32)[:, -1]
        tile_min, first = d2.min(axis=1), d2.argmin(axis=1)
        better = tile_min < min_d2
        hit_z = np.where(better, dz[s][first], hit_z)
        min_d2 = np.where(better, tile_min, min_d2)
    return np.where(min_d2 <= HIT_EPS, hit_z, sum_wz / sum_w)


def _inputs(m, n, seed):
    """Clustered data padded with sentinel points to a tile multiple, uniform
    queries (one of them on a data point), alpha / 2 drawn from [0.5, 2.5]."""
    dx, dy, dz = clustered_points(m, seed=seed)
    pad = (-m) % TILE
    big = F32(np.finfo(F32).max / 4)
    dx, dy = (np.concatenate([v, np.full(pad, big, F32)]) for v in (dx, dy))
    dz = np.concatenate([dz, np.zeros(pad, F32)])
    rng = np.random.default_rng(seed + 1)
    qx, qy = rng.random(n).astype(F32), rng.random(n).astype(F32)
    qx[3], qy[3] = dx[100], dy[100]
    ah = rng.uniform(0.5, 2.5, n).astype(F32)
    return qx, qy, ah, dx, dy, dz


def _rel(z, ref):
    """Largest |z - ref| / |ref|, in float32 ulps."""
    return float(np.max(np.abs(z.astype(np.float64) - ref) / np.abs(ref))) / EPS32


@pytest.mark.parametrize("m", [16000, 131000])
def test_sfu_weights_cost_rounding_noise(m):
    qx, qy, ah, dx, dy, dz = _inputs(m, 256, seed=m)
    z_sfu = _sweep(qx, qy, ah, dx, dy, dz, rng=np.random.default_rng(7))
    z_exp = _sweep(qx, qy, ah, dx, dy, dz)
    t = [torch.as_tensor(a) for a in (qx, qy, ah, dx, dy, dz)]
    z_plain = weight_sweep_plain(*t, tile_d=TILE, eps=HIT_EPS).numpy().astype(np.float64)
    z64 = weight_sweep_plain(*(a.double() for a in t), tile_d=TILE, eps=HIT_EPS).numpy()
    assert np.isfinite(z_sfu).all() and z_sfu[3] == dz[100]  # the exact hit takes the point's z
    # the card's check of B2 against its plain version: 64 ulps of each z
    assert _rel(z_sfu, z_plain) <= 64
    # against float64 truth the special-function units cost no more than
    # rounding-level noise over the precise form in the kernel's order
    err_sfu, err_exp = _rel(z_sfu, z64), _rel(z_exp, z64)
    assert err_sfu <= 2 * err_exp, (err_sfu, err_exp)


def _code(name):
    """A CUDA source without its comments."""
    text = (_build.CSRC / name).read_text()
    return re.sub(r"//[^\n]*", "", text)


def test_exact_weights_go_through_pow_weight():
    header = _code("aidw_common.cuh")
    f32 = re.search(r"float pow_weight\(float neg_ah, float d2, float tiny\) \{(.*?)\n\}", header, re.S).group(1)
    f64 = re.search(r"double pow_weight\(double neg_ah, double d2, double tiny\) \{(.*?)\n\}", header, re.S).group(1)
    assert "ex2_sfu(mul_rn(neg_ah, lg2_sfu(fmaxf(d2, tiny))))" in f32
    assert "exp_p(mul_rn(neg_ah, log_p(d2 > tiny ? d2 : tiny)))" in f64
    assert "lg2.approx.ftz.f32" in header and "ex2.approx.ftz.f32" in header
    # the special-function forms are reached from pow_weight alone, the
    # group function calls it, and the one tile loop calls the group function
    assert header.count("lg2_sfu(") == 2 and header.count("ex2_sfu(") == 2  # definition and pow_weight
    group = re.search(r"void weight_group\(.*?\n\}", header, re.S).group(0)
    assert "pow_weight(neg_ah, d2[u], tiny)" in group
    tile = re.search(r"void weight_tile\(.*?\n\}", header, re.S).group(0)
    assert tile.count("weight_group(") == 2  # the groups of kWeightGroup and the rest
    for name in ("weight.cu", "naive.cu", "fused.cu"):
        src = _code(name)
        assert not re.search(r"\b(exp_p|log_p|expf|logf|exp2f|log2f|__expf|__logf|exp|log|pow_weight)\s*\(", src), name
        assert not re.search(r"\bweight_group\(", src), name
        assert re.search(r"\bweight_tile\(", src), name
    # the near-field and far-cell sweeps take their weights from pow_weight
    # too, through run_stage -> run_span -> run_group (held against their
    # plain versions within a per-query tolerance, tests/test_torch_far_sfu.py)
    group = re.search(r"void run_group\(.*?\n\}", header, re.S).group(0)
    assert "pow_weight(neg_ah, d2[u], tiny)" in group
    assert "run_group<T, kWeightGroup, NEAR>(" in re.search(r"void run_span\(.*?\n\}", header, re.S).group(0)
    assert "run_span<T, NEAR>(" in re.search(r"void run_stage\(.*?\n\}", header, re.S).group(0)
    for name, near in (("near.cu", "true"), ("far.cu", "false")):
        src = _code(name)
        assert not re.search(r"\b(exp_p|log_p|expf|logf|exp2f|log2f|__expf|__logf|exp|log|pow_weight)\s*\(", src), name
        assert src.count(f"run_stage<T, {near}>(") == 1, name
    # the quadtree kernel takes its float32 weights from pow_weight too, in
    # its one run loop, and calls no precise exp/log of its own: float64
    # reaches exp_p/log_p inside pow_weight alone (tests/test_torch_far_node_sfu.py
    # holds its float32 sums within a per-query tolerance)
    src = _code("far_node.cu")
    run = re.search(r"void node_run\(.*?\n\}", src, re.S).group(0)
    assert "pow_weight(neg_ah, d2, tiny)" in run
    assert not re.search(r"\b(exp_p|log_p|expf|logf|exp2f|log2f|__expf|__logf|exp|log|lg2_sfu|ex2_sfu)\s*\(", src)
    assert src.count("pow_weight(") == 1 and src.count("node_run(") == 2  # its definition and the kernel's call
    assert not re.search(r"\b(weight_group|weight_tile|run_stage|run_span|run_group)\(", src)
    assert "exp_p(mul_rn(neg_ah, log_p(d2 > tiny ? d2 : tiny)))" in f64


@pytest.mark.parametrize("n, expected", [(1, 128), (255, 128), (256, 128), (8000, 128), (65536, 256),
                                         (1 << 20, 256)])
def test_weight_launch_rule(n, expected):
    # 132 SMs: an H100 SXM
    assert weight_launch(n, 132) == expected
    # a batch that gives every SM a 256-thread block takes 256, on any card
    for sms in (1, 114, 132):
        assert weight_launch(n, sms) == (256 if n >= 256 * sms else 128)


def test_weight_entry_points_match_their_signatures():
    src = (_build.CSRC / "weight.cu").read_text()
    for macro, names in (("AIDW_WEIGHT_ENTRY", ("aidw_weight_f32", "aidw_weight_f64")),
                         ("AIDW_WEIGHT_AOAS_ENTRY", ("aidw_weight_aoas_f32", "aidw_weight_aoas_f64")),
                         ("AIDW_IDW_ENTRY", ("aidw_idw_f32", "aidw_idw_f64"))):
        sig = re.search(rf"#define {macro}\(NAME, T\).*?NAME\((.*?)\)\s*\{{", src, re.S).group(1)
        params = [p.strip() for p in sig.replace("\\", " ").split(",")]
        kinds = ["p" if "*" in p else "d" if p.startswith("double") else "i" for p in params]
        for name in names:
            argtypes = _build.ENTRY_POINTS[name][1]
            got = ["p" if a is _build._P else "d" if a is _build._D else "i" for a in argtypes]
            assert got == kinds, name
