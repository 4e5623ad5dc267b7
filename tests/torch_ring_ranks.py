"""The port's side of ``tests/test_torch_distributed.py``: the inputs, the
scenarios, and the function each of the 8 gloo ranks runs.  It imports no
JAX (the ranks are spawned processes that import it by name), and only
numpy at the top, so the JAX subprocess of the test reads the same
scenarios and inputs from it."""

import numpy as np

M, N = 1024, 512             # divisible by 8, as tests/distributed/test_ring_aidw.py
MESH = ((4, 2), ("data", "model"))
K, AREA = 10, 1.0
# the tie: one point copied into shard 1 and shard 6 (of 8) with another z,
# and every query slab's query 3 on it
TIE_POINTS, TIE_Z, TIE_QUERY = (128 + 5, 6 * 128 + 77), (10.0, 20.0), 3

# name -> (function, dtype, axis_names, d_chunk, data set); d_chunk None is
# the function's default (one tile a shard here), 64 two tiles a shard
SCENARIOS = {
    "ring-f32": ("ring_aidw", "float32", None, None, "clustered"),
    "ring-data-f32": ("ring_aidw", "float32", ("data",), 64, "clustered"),
    "ringq-f32": ("ring_aidw_rotate_queries", "float32", None, 64, "clustered"),
    "sharded-f32": ("sharded_queries_aidw", "float32", None, None, "clustered"),
    "ring-f64": ("ring_aidw", "float64", None, 64, "clustered"),
    "ringq-f64": ("ring_aidw_rotate_queries", "float64", None, None, "clustered"),
    "sharded-f64": ("sharded_queries_aidw", "float64", None, None, "clustered"),
    "tie-ring-f32": ("ring_aidw", "float32", None, 64, "tie"),
    "tie-ringq-f32": ("ring_aidw_rotate_queries", "float32", None, 64, "tie"),
    "ring-qc-f32": ("ring_aidw", "float32", None, None, "clustered"),
    "ringq-qc-f32": ("ring_aidw_rotate_queries", "float32", None, 64, "clustered"),
}
# name -> q_chunk, passed as the reference's launcher passes it: 32 divides
# a 64-query shard; 1,000 does not divide the global 512 (min(1000, 64) rows)
Q_CHUNK = {"ring-qc-f32": 32, "ringq-qc-f32": 1000}
# rejected q_chunk layouts: case -> (function, q_chunk); a 64-query shard
# does not divide into 48 rows, nor into min(0, 64) = 0
Q_CHUNK_REJECTED = {"q_chunk": ("ring_aidw", 48), "q_chunk_zero": ("ring_aidw_rotate_queries", 0)}


def make_inputs():
    """Clustered data and uniform queries made as the reference test makes
    them (seed 7), and the same with the tie: data set -> (dx, dy, dz, qx,
    qy), float64, each rounded to the scenario's dtype by both sides."""
    rng = np.random.default_rng(7)
    centers = rng.random((12, 2))
    pts = np.clip(centers[rng.integers(0, 12, M)] + rng.normal(0, .02, (M, 2)), 0, 1).astype(np.float32)
    dx, dy = pts[:, 0].astype(np.float64), pts[:, 1].astype(np.float64)
    dz = np.sin(6 * dx) * np.cos(6 * dy) + 2
    qx, qy = rng.random(N).astype(np.float32).astype(np.float64), rng.random(N).astype(np.float32).astype(np.float64)
    tx, ty, tz, tqx, tqy = dx.copy(), dy.copy(), dz.copy(), qx.copy(), qy.copy()
    for i, z in zip(TIE_POINTS, TIE_Z):
        tx[i], ty[i], tz[i] = 0.5, 0.5, z
    tqx[TIE_QUERY::N // 8], tqy[TIE_QUERY::N // 8] = 0.5, 0.5
    return {"clustered": (dx, dy, dz, qx, qy), "tie": (tx, ty, tz, tqx, tqy)}


def run(rank, world, inputs):
    """Every scenario on this rank: ``{name: (z, alpha)}`` of its queries,
    its transfer counts per scenario, and the ``ValueError`` messages of the
    rejected layouts."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import distributed as D
    from repro_torch.core.aidw import AIDWParams

    mesh = init_device_mesh("cpu", MESH[0], mesh_dim_names=MESH[1])
    params = AIDWParams(k=K, area=AREA)
    out, transfer = {}, {}
    for name, (fn, dtype, axes, d_chunk, data) in SCENARIOS.items():
        dx, dy, dz, qx, qy = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in inputs[data])
        kw = {} if d_chunk is None else {"d_chunk": d_chunk}
        if name in Q_CHUNK:
            kw["q_chunk"] = Q_CHUNK[name]
        D.reset_transfer_counts()
        if fn == "sharded_queries_aidw":
            q = [D.local_shard(mesh, a) for a in (qx, qy)]
            out[name] = D.sharded_queries_aidw(mesh, dx, dy, dz, *q, params=params, area=AREA, **kw)
        else:
            shards = [D.local_shard(mesh, a, axes) for a in (dx, dy, dz, qx, qy)]
            out[name] = getattr(D, fn)(mesh, *shards, params=params, area=AREA, axis_names=axes, **kw)
        transfer[name] = dict(D.TRANSFER)

    errors = {}
    dx, dy, dz, qx, qy = (torch.as_tensor(a).float() for a in inputs["clustered"])
    shards = [D.local_shard(mesh, a) for a in (dx, dy, dz, qx, qy)]
    cut = shards[0].shape[0] - (rank == 5)  # rank 5 one data point short: 1,023 do not divide by 8
    cases = {
        "unequal": lambda: D.ring_aidw(mesh, *(a[:cut] for a in shards[:3]), *shards[3:], params=params, area=AREA),
        "d_chunk": lambda: D.ring_aidw_rotate_queries(mesh, *shards, params=params, area=AREA, d_chunk=48),
        "local_shard": lambda: D.local_shard(mesh, dx[:1001]),
        "axis_names": lambda: D.ring_aidw(mesh, *shards, params=params, area=AREA, axis_names=("data", "pipe")),
    }
    for case, (fn, q_chunk) in Q_CHUNK_REJECTED.items():
        cases[case] = lambda fn=fn, q_chunk=q_chunk: getattr(D, fn)(mesh, *shards, params=params, area=AREA,
                                                                    q_chunk=q_chunk)
    for case, call in cases.items():
        try:
            call()
            errors[case] = None
        except ValueError as e:
            errors[case] = str(e)
    return {"out": out, "transfer": transfer, "errors": errors}
