"""Multi-device AIDW of the port (``repro_torch.core.distributed``) on the
CPU, held against the JAX package's ``repro.core.distributed``.

The port runs on 8 gloo ranks (spawned processes on a ``(4, 2)`` mesh with
dims ``("data", "model")``, ``tests/torch_ring_ranks.py``); the JAX side runs
in a subprocess with 8 host devices (``--xla_force_host_platform_device_count=8``),
as ``tests/distributed/test_ring_aidw.py`` runs it.  Both take the same numpy
inputs (m = 1,024, n = 512, seed 7): both dims, ``axis_names=("data",)``, the
query ring and sharded queries, float32 and float64, and a point copied into
two shards with two z values under an exact hit.

Tolerances: alpha within 1e-6 absolute plus 4 ulps relative and z within
1e-5 relative in float32, 1e-12 in float64 (the libraries' cos, exp and log
and XLA's contracted d^2 differ by a few ulps, ``ROADMAP.md`` C); against
``aidw_ref`` the reference test's own 5e-4 (z) and 1e-5 (alpha).  The
chosen hit z and the layout errors are exact.  The folds' plain versions
are held against JAX's ``_fold_knn`` and ``_fold_weights`` in this process.
"""

import math
import os
import re
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ring_ranks as R
from repro.core import distributed as J
from repro.core.aidw import AIDWParams as JParams
from repro.core.aidw import adaptive_alpha
from repro.kernels.ref import aidw_ref
from repro_torch.core import distributed as D
from repro_torch.core.aidw import AIDWParams
from repro_torch.core.layouts import coord_sentinel
from repro_torch.kernels import _build, aidw_tiled
from repro_torch.kernels.aidw_tiled import (
    knn_alpha_plain,
    knn_fold,
    knn_fold_plain,
    knn_launch,
    weight_carry,
    weight_fold,
    weight_fold_plain,
    weight_sweep_plain,
)
from test_torch_core import enable_x64

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORLD = 8
TIMEOUT = 300  # seconds, the port's ranks and the JAX subprocess each (about 10 and 55 s alone)
TOL = {"float32": (1e-6, 1e-5), "float64": (1e-12, 1e-12)}  # alpha absolute, z relative
RING = [n for n, s in R.SCENARIOS.items() if s[0] != "sharded_queries_aidw"]
CLUSTERED = [n for n, s in R.SCENARIOS.items() if s[4] == "clustered"]

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import distributed as D
from repro.core.aidw import AIDWParams
import torch_ring_ranks as R

assert len(jax.devices()) == 8
x64 = getattr(jax, "enable_x64", None)
if x64 is None:
    from jax.experimental import enable_x64 as x64
mesh = Mesh(np.array(jax.devices()).reshape(R.MESH[0]), R.MESH[1])
params = AIDWParams(k=R.K, area=R.AREA)
inputs = R.make_inputs()
res = {}
for name, (fn, dtype, axes, d_chunk, data) in R.SCENARIOS.items():
    kw = {} if d_chunk is None else {"d_chunk": d_chunk}
    if fn != "sharded_queries_aidw":
        kw["axis_names"] = axes
    if name in R.Q_CHUNK:
        kw["q_chunk"] = R.Q_CHUNK[name]
    with x64(dtype == "float64"):
        z, a = getattr(D, fn)(mesh, *(x.astype(dtype) for x in inputs[data]), params=params, area=R.AREA, **kw)
        res[name + "/z"], res[name + "/alpha"] = np.asarray(z), np.asarray(a)
for case, (fn, q_chunk) in R.Q_CHUNK_REJECTED.items():
    try:
        getattr(D, fn)(mesh, *(x.astype("float32") for x in inputs["clustered"]), params=params, area=R.AREA,
                       q_chunk=q_chunk)
        res["rejected/" + case] = np.array(False)
    except Exception:  # the reference fails in its reshape, with whatever error jax gives
        res["rejected/" + case] = np.array(True)
np.savez(sys.argv[1], **res)
print("OK jax ring 8dev")
"""


def _layout(name):
    """The ranks whose shards, in order, make the global query array, and
    the replicas of each (the other ranks of its shard)."""
    axes = R.SCENARIOS[name][2]
    if axes == ("data",):  # shard i on ranks 2i and 2i + 1 (mesh row i)
        return [2 * i for i in range(4)], {2 * i: 2 * i + 1 for i in range(4)}
    return list(range(WORLD)), {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario through both packages: the port's per-rank results and
    the JAX package's global arrays."""
    out = tmp_path_factory.mktemp("jax_ring") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(["src", "tests"]))
    env.pop("XLA_FLAGS", None)
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(out)], cwd=ROOT, env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = D.spawn_ranks(R.run, WORLD, (R.make_inputs(),), timeout=TIMEOUT)
        log, _ = jax_run.communicate(timeout=TIMEOUT)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0 and "OK jax ring 8dev" in log, log
    with np.load(out) as blob:
        jax_out = {k: blob[k] for k in blob.files}
    return ranks, jax_out


def _port(runs, name):
    """The port's global ``(z, alpha)`` of a scenario, from its ranks' shards."""
    ranks, _ = runs
    order, _ = _layout(name)
    return tuple(torch.cat([ranks[r]["out"][name][i] for r in order]).numpy() for i in (0, 1))


def _jax(runs, name):
    return runs[1][name + "/z"], runs[1][name + "/alpha"]


def _inputs(name):
    fn, dtype, axes, d_chunk, data = R.SCENARIOS[name]
    return [torch.as_tensor(a.astype(dtype)) for a in R.make_inputs()[data]]


@pytest.mark.parametrize("name", CLUSTERED)
def test_port_matches_jax(runs, name):
    dtype = R.SCENARIOS[name][1]
    (z, a), (jz, ja) = _port(runs, name), _jax(runs, name)
    atol, rtol = TOL[dtype]
    assert z.dtype == a.dtype == np.dtype(dtype) and z.shape == a.shape == (R.N,)
    ulp = np.finfo(dtype).eps * np.abs(ja)
    assert np.all(np.abs(a - ja) <= atol + 4 * ulp), np.abs(a - ja).max()
    np.testing.assert_allclose(z, jz, rtol=rtol, atol=0)


@pytest.mark.parametrize("name", [n for n in CLUSTERED if n.endswith("f32")])
def test_port_matches_aidw_ref(runs, name):
    # the reference test's own tolerances against the dense oracle
    dx, dy, dz, qx, qy = (x.numpy() for x in _inputs(name))
    z_ref, a_ref = (np.asarray(v) for v in aidw_ref(dx, dy, dz, qx, qy, JParams(k=R.K, area=R.AREA), R.AREA))
    z, a = _port(runs, name)
    assert np.abs(z - z_ref).max() < 5e-4 and np.abs(a - a_ref).max() < 1e-5


@pytest.mark.parametrize("name", ["ring-data-f32"])
def test_replicas_agree(runs, name):
    # a ring over "data" alone: the two ranks of each mesh row hold one
    # shard and give the same bits
    ranks, _ = runs
    for r, twin in _layout(name)[1].items():
        for i in (0, 1):
            assert torch.equal(ranks[r]["out"][name][i], ranks[twin]["out"][name][i])


@pytest.mark.parametrize("name", RING)
def test_ring_alpha_is_the_single_process_alpha(runs, name):
    # the k-best is a multiset: folded shard by shard in any order it gives
    # the bits of one walk over all the data (B1's plain version); z is the
    # same sweep with the shards' tiles in another order, within 64 ulps
    # (the tie's hit z follows the order: the next test)
    dx, dy, dz, qx, qy = _inputs(name)
    params = AIDWParams(k=R.K, area=R.AREA)
    a1 = knn_alpha_plain(qx, qy, dx[None], dy[None], block_q=R.N, tile_d=128, params=params, area=R.AREA,
                         m_real=R.M)
    z, a = _port(runs, name)
    assert np.array_equal(a, a1.numpy())
    if name in CLUSTERED:
        z2 = weight_sweep_plain(qx, qy, a1 * 0.5, dx, dy, dz, tile_d=64, eps=params.exact_hit_eps)
        np.testing.assert_allclose(z, z2.numpy(), rtol=64 * np.finfo(z.dtype).eps, atol=0)


def _first_hit(slab, order):
    """The z of the tied point that a slab meets first in ``order(slab, s)``."""
    shards = [i // (R.M // WORLD) for i in R.TIE_POINTS]
    step = {sh: next(s for s in range(WORLD) if order(slab, s) == sh) for sh in shards}
    return R.TIE_Z[min(range(2), key=lambda i: step[shards[i]])]


@pytest.mark.parametrize("name,order", [("tie-ring-f32", lambda r, s: (r - s) % WORLD),
                                        ("tie-ringq-f32", lambda r, s: (r + s) % WORLD)])
def test_exact_hit_tie_follows_the_visiting_order(runs, name, order):
    # a point copied into shards 1 and 6 with z 10 and 20: each slab's query
    # on it takes the z of the copy its ring visits first (strict `<` across
    # shards), in the reference's order, and both picks occur
    (z, a), (jz, ja) = _port(runs, name), _jax(runs, name)
    tie = np.arange(R.TIE_QUERY, R.N, R.N // WORLD)
    expected = np.array([_first_hit(slab, order) for slab in range(WORLD)], dtype=np.float32)
    assert set(expected) == set(R.TIE_Z)
    assert np.array_equal(jz[tie], expected) and np.array_equal(z[tie], expected)
    rest = np.setdiff1d(np.arange(R.N), tie)
    np.testing.assert_allclose(z[rest], jz[rest], rtol=TOL["float32"][1], atol=0)
    assert np.all(np.abs(a - ja) <= 1e-6 + 4 * np.finfo(np.float32).eps * np.abs(ja))


@pytest.mark.parametrize("case,message", [
    ("unequal", r"shards of unequal size .*must divide into 8 shards"),
    ("d_chunk", r"a data shard of 128 points does not divide into d_chunk=48 tiles"),
    ("local_shard", r"a global size of 1001 does not divide into 8 shards"),
    ("axis_names", r"must name distinct dims of the mesh"),
    ("q_chunk", r"a query shard of 64 queries does not divide into q_chunk=48 rows"),
    ("q_chunk_zero", r"a query shard of 64 queries does not divide into q_chunk=0 rows"),
])
def test_rejected_layouts_raise_on_every_rank(runs, case, message):
    # every rank raises the same ValueError, so none is left waiting in the ring
    ranks, _ = runs
    got = [r["errors"][case] for r in ranks]
    assert all(g is not None and re.search(message, g) for g in got), got
    assert len(set(got)) == 1


@pytest.mark.parametrize("case", list(R.Q_CHUNK_REJECTED))
def test_reference_rejects_the_same_q_chunk_layouts(runs, case):
    # the layouts the port refuses with ValueError are those the JAX rings
    # cannot reshape into q_chunk rows
    assert bool(runs[1]["rejected/" + case])


@pytest.mark.parametrize("name", list(R.Q_CHUNK))
def test_q_chunk_changes_no_bits(runs, name):
    # the fold kernels hold no query tile: q_chunk gives the bits of the
    # same ring at its default
    twin = next(n for n, s in R.SCENARIOS.items() if n not in R.Q_CHUNK and s == R.SCENARIOS[name])
    for got, want in zip(_port(runs, name), _port(runs, twin)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["ring-f32", "ring-data-f32", "ringq-f64", "sharded-f32"])
def test_rotations_and_bytes(runs, name):
    # what each rank sends: the data ring n - 1 rotations a phase (x, y;
    # then x, y, z), the query ring n - 1 of the queries a phase and n of
    # the state (k-best then alpha; partials then z), sharded queries none;
    # on the CPU nothing is staged
    ranks, _ = runs
    fn, dtype, axes, d_chunk, data = R.SCENARIOS[name]
    n = 4 if axes == ("data",) else WORLD
    m_l, q_l, b = R.M // n, R.N // n, np.dtype(dtype).itemsize
    if fn == "ring_aidw":
        want = (2 * (n - 1), (n - 1) * 5 * m_l * b)
    elif fn == "ring_aidw_rotate_queries":
        state = (n - 1) * (R.K + 4) * q_l + 2 * q_l
        want = (2 * (n - 1) + 2 * n, ((n - 1) * 5 * q_l + state) * b)
    else:
        want = (0, 0)
    for r in ranks:
        assert (r["transfer"][name]["rotations"], r["transfer"][name]["sent_bytes"]) == want
        assert r["transfer"][name]["staged_bytes"] == 0


def test_ring_perm_is_the_reference():
    for n in range(1, 6):
        assert D._ring_perm(n) == J._ring_perm(n)


def _fold_inputs(dtype, seed=11, nq=64, m=256):
    """Queries, a data shard with sentinel pads at its end and an exact hit
    (query 0 on point 5), and a carried k-best from another shard."""
    rng = np.random.default_rng(seed)
    qx, qy = rng.random(nq).astype(dtype), rng.random(nq).astype(dtype)
    dx, dy, dz = rng.random(m).astype(dtype), rng.random(m).astype(dtype), (rng.random(m) + 1).astype(dtype)
    big = float(coord_sentinel(torch.float32 if dtype == np.float32 else torch.float64, "cpu"))
    dx[-40:], dy[-40:], dz[-40:] = big, big, 0
    dx[5], dy[5] = qx[0], qy[0]
    ox, oy = rng.random(8).astype(dtype), rng.random(8).astype(dtype)
    best = np.sort(((qx[:, None] - ox) ** 2 + (qy[:, None] - oy) ** 2).astype(dtype), axis=1)
    best = np.concatenate([best, np.full((nq, R.K - 8), np.inf, dtype)], axis=1)  # 8 carried, 2 empty slots
    return qx, qy, dx, dy, dz, best


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_knn_fold_plain_matches_jax(dtype):
    qx, qy, dx, dy, dz, best = _fold_inputs(dtype)
    params, m_total = AIDWParams(k=R.K, area=R.AREA), 4 * dx.shape[0]
    with enable_x64(dtype == np.float64):
        jb = J._fold_knn(jnp.asarray(best), jnp.asarray(qx), jnp.asarray(qy), jnp.asarray(dx), jnp.asarray(dy), 16, 64)
        ja = adaptive_alpha(jnp.mean(jnp.sqrt(jb), axis=1), m_total, R.AREA, JParams(k=R.K, area=R.AREA))
        jb, ja = np.asarray(jb), np.asarray(ja)
    t = [torch.as_tensor(a) for a in (best, qx, qy, dx, dy)]
    kw = dict(tile_d=64, params=params, area=R.AREA, m_total=m_total)
    b = knn_fold_plain(*t, **kw).numpy()
    a = knn_fold_plain(*t, finish=True, **kw).numpy()
    eps = np.finfo(dtype).eps
    assert b[0, 0] == 0 and np.all(np.diff(b, axis=1) >= 0)  # the exact hit; ascending
    np.testing.assert_allclose(b, jb, rtol=4 * eps, atol=0)  # XLA may contract d^2 into an FMA
    atol = TOL["float32" if dtype == np.float32 else "float64"][0]
    assert np.all(np.abs(a - ja) <= atol + 4 * eps * np.abs(ja))
    # the wrapper on CPU tensors is the plain version, and the carry counts
    assert np.array_equal(knn_fold(*t, **kw).numpy(), b)
    assert not np.array_equal(knn_fold_plain(torch.full_like(t[0], math.inf), *t[1:], **kw).numpy(), b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_weight_fold_plain_matches_jax(dtype):
    qx, qy, dx, dy, dz, _ = _fold_inputs(dtype)
    rng = np.random.default_rng(12)
    ah = (rng.random(qx.shape[0]) + 0.5).astype(dtype)
    carry = np.stack([rng.random(qx.shape[0]) + 1, rng.random(qx.shape[0]) + 2, rng.random(qx.shape[0]) * 1e-3,
                      rng.random(qx.shape[0])]).astype(dtype)
    carry[2, 0], carry[3, 0] = 0, 7  # query 0 carries an exact hit at z = 7; its tie in this shard (z = dz[5]) loses
    eps = 1e-18
    with enable_x64(dtype == np.float64):
        jc = J._fold_weights(tuple(jnp.asarray(c) for c in carry), jnp.asarray(ah), jnp.asarray(qx), jnp.asarray(qy),
                             jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(dz), 16, 64)
        jc = np.stack([np.asarray(c) for c in jc])
    t = [torch.as_tensor(a) for a in (carry, qx, qy, ah, dx, dy, dz)]
    c = weight_fold_plain(*t, tile_d=64, eps=eps).numpy()
    z = weight_fold_plain(*t, tile_d=64, eps=eps, finish=True).numpy()
    rtol = TOL["float32" if dtype == np.float32 else "float64"][1]
    np.testing.assert_allclose(c[:2], jc[:2], rtol=rtol, atol=0)
    np.testing.assert_allclose(c[2], jc[2], rtol=4 * np.finfo(dtype).eps, atol=0)
    assert np.array_equal(c[3], jc[3]) and c[3, 0] == 7 and z[0] == 7 and dz[5] != 7
    np.testing.assert_allclose(z[1:], (jc[1] / jc[0])[1:], rtol=rtol, atol=0)
    assert np.array_equal(weight_fold(*t, tile_d=64, eps=eps).numpy(), c)
    # the fold of all the data onto the empty carry is B2's plain sweep
    empty = weight_carry(t[1])
    assert torch.equal(weight_fold_plain(empty, *t[1:], tile_d=64, eps=eps, finish=True),
                       weight_sweep_plain(*t[1:], tile_d=64, eps=eps))


def _pretend_card(monkeypatch):
    """The wrappers' card path on CPU tensors: every tensor counts as on the
    card, the SM count is an H100's, and the entries record their arguments."""
    calls = []
    monkeypatch.setattr(aidw_tiled, "_on_card", lambda name, *t: True)
    monkeypatch.setattr(aidw_tiled, "_sm_count", lambda index: 132)
    monkeypatch.setattr(_build, "entry", lambda name: lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 0))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("n", [16384, 64, 96])
def test_knn_fold_launch(monkeypatch, n):
    calls = _pretend_card(monkeypatch)
    params = AIDWParams(k=R.K, area=R.AREA)
    q, d = torch.zeros(n), torch.zeros(512)
    best = torch.zeros((n, R.K))
    kw = dict(tile_d=128, params=params, area=R.AREA, m_total=2048)
    out = knn_fold(best, q, q, d, d, **kw)
    alpha = knn_fold(best, q, q, d, d, finish=True, **kw)
    assert out.shape == best.shape and alpha.shape == (n,) and _build.LAUNCHES["knn_fold"] == 2
    (name, args), (_, fin) = calls
    block_q = math.gcd(n, 256)
    threads, splits = knn_launch(n, 132, block_q=block_q)
    assert name == "aidw_knn_fold_f32" and args[5:11] == (n, block_q, 512, R.K, threads, splits)
    assert n % block_q == 0 and block_q % (threads // splits) == 0
    assert args[11] == pytest.approx(1 / (2 * math.sqrt(2048)))  # the alpha constants of m_total
    assert args[20] == out.data_ptr() and args[21] is None  # the k-best out, no alpha
    assert fin[20] is None and fin[21] == alpha.data_ptr()
    with pytest.raises(ValueError, match="k in 1..16"):
        knn_fold(torch.zeros((n, 17)), q, q, d, d, tile_d=128, params=AIDWParams(k=17, area=1.0), area=1.0,
                 m_total=2048)
    assert _build.LAUNCHES["knn_fold"] == 2


def test_weight_fold_launch(monkeypatch):
    calls = _pretend_card(monkeypatch)
    q, d = torch.zeros(300), torch.zeros(512)
    carry = weight_carry(q)
    out = weight_fold(carry, q, q, q, d, d, d, tile_d=128, eps=1e-18)
    z = weight_fold(carry, q, q, q, d, d, d, tile_d=128, eps=1e-18, finish=True)
    assert out.shape == (4, 300) and z.shape == (300,) and _build.LAUNCHES["weight_fold"] == 2
    (name, args), (_, fin) = calls
    assert name == "aidw_weight_fold_f32" and args[6] == carry.data_ptr() and args[7:11] == (300, 512, 128, 128)
    assert args[13] == out.data_ptr() and args[14] is None and fin[13] is None and fin[14] == z.data_ptr()


def test_fold_shapes_are_checked():
    params = AIDWParams(k=R.K, area=R.AREA)
    q, d = torch.zeros(64), torch.zeros(512)
    kw = dict(tile_d=128, params=params, area=R.AREA, m_total=512)
    with pytest.raises(ValueError, match="knn_fold: bad shapes"):
        knn_fold(torch.zeros((64, R.K - 1)), q, q, d, d, **kw)
    with pytest.raises(ValueError, match="knn_fold: bad shapes"):
        knn_fold(torch.zeros((64, R.K)), q, q, d[:500], d[:500], **kw)
    with pytest.raises(ValueError, match="weight_fold: bad shapes"):
        weight_fold(torch.zeros((3, 64)), q, q, q, d, d, d, tile_d=128, eps=1e-18)
    with pytest.raises(ValueError, match="weight_fold: bad shapes"):
        weight_fold(weight_carry(q), q, q, q[:63], d, d, d, tile_d=128, eps=1e-18)


def test_fold_entry_points_match_their_signatures():
    for src, macro, names in (("knn.cu", "AIDW_KNN_FOLD_ENTRY", ("aidw_knn_fold_f32", "aidw_knn_fold_f64")),
                              ("weight.cu", "AIDW_WEIGHT_FOLD_ENTRY", ("aidw_weight_fold_f32", "aidw_weight_fold_f64"))):
        text = (_build.CSRC / src).read_text()
        sig = re.search(rf"#define {macro}\(NAME, T\).*?NAME\((.*?)\)\s*\{{", text, re.S).group(1)
        params = [p.strip() for p in sig.replace("\\", " ").split(",")]
        kinds = ["p" if "*" in p else "d" if p.startswith("double") else "i" for p in params]
        for name in names:
            got = ["p" if a is _build._P else "d" if a is _build._D else "i" for a in _build.ENTRY_POINTS[name][1]]
            assert got == kinds, name
            assert f"{macro}({name}," in text


def test_folds_are_flags_of_the_existing_kernels():
    # one __global__ kernel a source: the folds are template flags of B1's
    # walk and B2's sweep, their carry entering through the insertion and
    # the tile loop
    knn = (_build.CSRC / "knn.cu").read_text()
    weight = (_build.CSRC / "weight.cu").read_text()
    assert knn.count("__global__") == 1 and weight.count("__global__") == 1
    assert "bool VOTE, bool FOLD>" in knn and "kbest_insert(best, best_in[q * K + j])" in knn
    assert "knn_alpha_kernel<T, K, false, false, false, true>" in knn
    assert "bool CONST_AH, bool FOLD>" in weight and "weight_kernel<T, AOAS, CONST_AH, FOLD>" in weight
    assert "sum_w = carry_in[q];" in weight
