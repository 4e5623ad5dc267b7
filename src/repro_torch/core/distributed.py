"""Multi-device AIDW over ``torch.distributed``: the port of
``repro/core/distributed.py``.

Sharding scheme, the reference's:

* :func:`ring_aidw` - queries AND data sharded over the flattened mesh
  dims ``axis_names``.  The data shards rotate around the ring (rank ``r``
  folds shard ``(r - s) mod n`` at step ``s``) while each query shard folds
  the visiting shard into its running state: the k-best (Phase 1), then the
  weight partials (Phase 2).  Each rotation is posted before the local fold
  and waited for after it, so the two overlap.
* :func:`ring_aidw_rotate_queries` - the queries and their running state
  rotate instead (slab ``r`` meets shard ``(r + s) mod n`` at step ``s``, and
  after ``n`` rotations it is home); the data never moves.
* :func:`sharded_queries_aidw` - data replicated, queries sharded, a local
  ``chunked`` plan on each rank, no communication.

The folds (:func:`_fold_knn`, :func:`_fold_weights`) are ``csrc/knn.cu`` and
``csrc/weight.cu`` with their FOLD flag (``kernels/aidw_tiled.py:
knn_fold``, ``weight_fold``), B1's walk and B2's sweep started from the
carried state.  The last fold of Phase 1 ends in B1's epilogue with the
alpha constants of the whole data count, so ring alpha has B1's bits (the
k-best is a multiset, whatever the order of the shards); the last fold of
Phase 2 gives z.  z sums each shard's ``d_chunk`` tiles in data order onto
the carry, the shards in the ring's visiting order, which also decides an
exact hit tied across shards (the first minimum in that order).

Each rank passes and gets back its own shard, laid out as the reference's
``P(axes)`` lays it out: the shard of the rank's ring index, its
coordinates over ``axis_names`` flattened in row-major order, replicated over
the other dims (:func:`local_shard` cuts it out of a global array).

Transport: with NCCL, CUDA tensors are sent as they are.  gloo moves host
tensors only, so there a CUDA tensor is staged through the host (device to
host, send and receive, host to device; counted in :data:`TRANSFER`) and
the folds stay on the card.  One card cannot hold two NCCL ranks, so
several ranks that share one card run over gloo.  :func:`spawn_ranks` starts
such ranks on one host.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from datetime import timedelta
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.aidw import AIDWParams
from repro_torch.kernels.aidw_tiled import knn_fold, weight_carry, weight_fold

# this process's rotations since the last reset: how many, the bytes sent,
# and the bytes staged between the card and the host (both directions)
TRANSFER = {"rotations": 0, "sent_bytes": 0, "staged_bytes": 0}


def reset_transfer_counts() -> None:
    for name in TRANSFER:
        TRANSFER[name] = 0


def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


class _Ring:
    """This rank's place in the rings over the mesh dims ``axes`` of
    ``mesh``: ``n`` ranks a ring, this rank's ring index (its coordinates
    over ``axes``, row-major), and the global ranks it sends to and receives
    from (``_ring_perm``: index i sends to i + 1)."""

    def __init__(self, mesh, axis_names):
        names = tuple(mesh.mesh_dim_names or ())
        if mesh.mesh.numel() != dist.get_world_size():
            raise ValueError(f"the mesh's {mesh.mesh.numel()} ranks must be every rank of the process group "
                             f"({dist.get_world_size()})")
        if axis_names is None:
            axes = names
        else:
            axes = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        if not axes or len(set(axes)) != len(axes) or not set(axes) <= set(names):
            raise ValueError(f"axis_names {axis_names!r} must name distinct dims of the mesh {names}")
        dims = [names.index(a) for a in axes]
        ranks = np.moveaxis(mesh.mesh.cpu().numpy(), dims, range(len(dims)))
        self.n = math.prod(ranks.shape[:len(dims)])
        rings = ranks.reshape(self.n, -1)  # column j: one ring, in ring order
        (index, col), = np.argwhere(rings == dist.get_rank())
        self.index = int(index)
        nxt = dict(_ring_perm(self.n))
        prev = {b: a for a, b in nxt.items()}
        self.send_to = int(rings[nxt[self.index], col])
        self.recv_from = int(rings[prev[self.index], col])
        self.backend = str(dist.get_backend())

    def post(self, *tensors):
        """Post the rotation: ``tensors`` (one dtype) to the next rank of the
        ring, the previous rank's into new buffers.  Returns a function that
        waits for both and gives the received tensors, on the device and in
        the shapes of the sent ones.  A ring of one rank moves nothing."""
        if self.n == 1:
            return lambda: tensors
        dev = tensors[0].device
        flat = torch.cat([t.reshape(-1) for t in tensors])
        stage = dev.type != "cpu" and "nccl" not in self.backend  # gloo: host tensors only
        send = flat.cpu() if stage else flat
        recv = torch.empty_like(send)
        works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, self.send_to),
                                        dist.P2POp(dist.irecv, recv, self.recv_from)])
        nbytes = send.numel() * send.element_size()
        TRANSFER["rotations"] += 1
        TRANSFER["sent_bytes"] += nbytes
        TRANSFER["staged_bytes"] += 2 * nbytes if stage else 0

        def wait():
            for w in works:
                w.wait()
            got = recv.to(dev) if stage else recv
            return tuple(p.view(t.shape) for p, t in zip(got.split([t.numel() for t in tensors]), tensors))

        return wait


def local_shard(mesh, x, axis_names: Sequence[str] | str | None = None):
    """This rank's shard of the global array ``x`` (cut along dim 0) under
    the layout ``P(axis_names)`` (default: all mesh dims): the shard of the
    rank's ring index, the same on every rank of the other dims.  Raises
    ``ValueError`` when ``len(x)`` does not divide by the shard count."""
    ring = _Ring(mesh, axis_names)
    if x.shape[0] % ring.n:
        raise ValueError(f"a global size of {x.shape[0]} does not divide into {ring.n} shards (the launcher pads)")
    size = x.shape[0] // ring.n
    return x[ring.index * size:(ring.index + 1) * size]


def _local(arrays):
    """The arrays as contiguous tensors on the device of the first one that
    is a tensor, or on the card when none is."""
    dev = next((a.device for a in arrays if torch.is_tensor(a)), torch.device("cuda"))
    return [torch.as_tensor(a, device=dev).contiguous() for a in arrays]


def _check_shards(ring: _Ring, m_l: int, n_l: int, q_chunk: int, d_chunk: int, device) -> tuple[int, int]:
    """``(m_total, tile)``: the global data count and the fold's tile,
    ``min(d_chunk, m_l)``.  A query shard must divide into
    ``min(q_chunk, n_l)`` rows, as the reference's ``reshape(-1, q_chunk)``
    requires.  Every rank checks the same gathered shard sizes, so a layout
    the reference would reject raises ``ValueError`` on every rank alike,
    before the ring moves any data (no rank is left waiting)."""
    mine = torch.tensor([m_l, n_l], dtype=torch.int64, device=device if "nccl" in ring.backend else "cpu")
    sizes = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(sizes, mine)
    if len({tuple(s.tolist()) for s in sizes}) != 1:
        raise ValueError(f"shards of unequal size (data, queries) {sorted({tuple(s.tolist()) for s in sizes})}: "
                         f"the global sizes must divide into {ring.n} shards (the launcher pads)")
    rows = min(q_chunk, n_l)
    if rows <= 0 or n_l % rows:
        raise ValueError(f"a query shard of {n_l} queries does not divide into q_chunk={q_chunk} rows")
    tile = min(d_chunk, m_l)
    if tile <= 0 or m_l % tile:
        raise ValueError(f"a data shard of {m_l} points does not divide into d_chunk={d_chunk} tiles")
    return m_l * ring.n, tile


def _fold_knn(best, qx_l, qy_l, cx, cy, d_chunk, *, params: AIDWParams, area: float, m_total: int,
              finish: bool = False):
    """Merge the visiting data shard into the running per-query k-best; with
    ``finish`` (the ring's last step) return alpha instead."""
    return knn_fold(best, qx_l, qy_l, cx, cy, tile_d=d_chunk, params=params, area=area, m_total=m_total,
                    finish=finish)


def _fold_weights(carry, ah, qx_l, qy_l, cx, cy, cz, d_chunk, *, eps: float, finish: bool = False):
    """Accumulate this shard's weight partials ``carry (4, n)`` (sum_w,
    sum_wz, min_d2, hit_z); with ``finish`` return z instead."""
    return weight_fold(carry, qx_l, qy_l, ah, cx, cy, cz, tile_d=d_chunk, eps=eps, finish=finish)


def ring_aidw(mesh, dx, dy, dz, qx, qy, *, params: AIDWParams, area: float,
              axis_names: Sequence[str] | str | None = None, q_chunk: int = 1024, d_chunk: int = 2048):
    """Fully sharded AIDW over ``mesh`` (a ``DeviceMesh`` with named dims),
    called on every rank with its shards.

    Queries AND data are sharded over the flattened ``axis_names`` (default:
    all mesh dims), as :func:`local_shard` cuts them.  Every rank's shards
    have one size (the launcher pads), a query shard divides into
    ``min(q_chunk, n_l)`` rows and a data shard into ``d_chunk`` tiles, else
    ``ValueError`` on every rank.  ``q_chunk`` is the reference's query
    tile; the fold kernels hold no query tile, so it checks the layout and
    changes no bits.  The data shards
    rotate ``n - 1`` times a phase (the reference's n-th brings them home
    unused).  Returns ``(z_hat, alpha)`` for this rank's queries.
    """
    ring = _Ring(mesh, axis_names)
    dx, dy, dz, qx, qy = _local([dx, dy, dz, qx, qy])
    m_total, dc = _check_shards(ring, dx.shape[0], qx.shape[0], q_chunk, d_chunk, qx.device)
    kw = dict(params=params, area=area, m_total=m_total)

    # ---- phase 1: ring kNN ----
    best = torch.full((qx.shape[0], params.k), math.inf, dtype=qx.dtype, device=qx.device)
    cx, cy = dx, dy
    for s in range(ring.n):
        last = s == ring.n - 1
        incoming = None if last else ring.post(cx, cy)  # posted first: it overlaps the fold
        best = _fold_knn(best, qx, qy, cx, cy, dc, finish=last, **kw)
        if not last:
            cx, cy = incoming()
    alpha = best  # the last fold gave alpha
    ah = alpha * 0.5

    # ---- phase 2: ring weighting ----
    acc = weight_carry(qx)
    cx, cy, cz = dx, dy, dz
    for s in range(ring.n):
        last = s == ring.n - 1
        incoming = None if last else ring.post(cx, cy, cz)
        acc = _fold_weights(acc, ah, qx, qy, cx, cy, cz, dc, eps=params.exact_hit_eps, finish=last)
        if not last:
            cx, cy, cz = incoming()
    return acc, alpha  # the last fold gave z


def ring_aidw_rotate_queries(mesh, dx, dy, dz, qx, qy, *, params: AIDWParams, area: float,
                             axis_names: Sequence[str] | str | None = None, q_chunk: int = 1024,
                             d_chunk: int = 2048):
    """:func:`ring_aidw` with the QUERIES and their running state rotating
    around the ring instead of the data shards, which never move.

    Phase 1 moves each slab's (qx, qy) and its k-best, Phase 2 its (qx, qy,
    alpha / 2) and its four weight partials; after ``n`` rotations every
    slab is home.  The last fold of each phase (on the rank before home)
    sends alpha, then z, home in place of the state.  The same folds in
    another hand: the results are those of the data ring with each slab's
    shards visited in the order ``r, r + 1, ...``.  ``q_chunk`` and
    ``d_chunk`` are checked as :func:`ring_aidw` checks them.  Returns
    ``(z_hat, alpha)`` for this rank's queries.
    """
    ring = _Ring(mesh, axis_names)
    dx, dy, dz, qx, qy = _local([dx, dy, dz, qx, qy])
    m_total, dc = _check_shards(ring, dx.shape[0], qx.shape[0], q_chunk, d_chunk, qx.device)
    kw = dict(params=params, area=area, m_total=m_total)

    # ---- phase 1: queries + k-best circulate ----
    cqx, cqy = qx, qy
    best = torch.full((qx.shape[0], params.k), math.inf, dtype=qx.dtype, device=qx.device)
    for s in range(ring.n):
        last = s == ring.n - 1
        incoming = None if last else ring.post(cqx, cqy)  # home already holds the slab's own queries
        (best,) = ring.post(_fold_knn(best, cqx, cqy, dx, dy, dc, finish=last, **kw))()
        if not last:
            cqx, cqy = incoming()
    alpha = best  # every slab is home again

    # ---- phase 2: queries + weight partials circulate ----
    cqx, cqy, cah = qx, qy, alpha * 0.5
    acc = weight_carry(qx)
    for s in range(ring.n):
        last = s == ring.n - 1
        incoming = None if last else ring.post(cqx, cqy, cah)
        (acc,) = ring.post(_fold_weights(acc, cah, cqx, cqy, dx, dy, dz, dc, eps=params.exact_hit_eps,
                                         finish=last))()
        if not last:
            cqx, cqy, cah = incoming()
    return acc, alpha  # z and alpha, home


def sharded_queries_aidw(mesh, dx, dy, dz, qx, qy, *, params: AIDWParams, area: float, q_chunk: int = 1024,
                         d_chunk: int = 8192):
    """Data replicated, queries sharded over all mesh dims: every rank
    passes the whole data set and its query shard, and solves it alone
    through the engine's ``chunked`` plan (brute-force Phase 1) on the
    queries' device, with no communication.  Returns ``(z_hat, alpha)`` for
    this rank's queries."""
    from repro_torch.engine import build_plan, execute  # lazy: core <-> engine

    dx, dy, dz, qx, qy = _local([dx, dy, dz, qx, qy])
    plan = build_plan(dx, dy, dz, params=params, area=area, impl="chunked", knn="brute",
                      q_chunk=min(q_chunk, qx.shape[0]), d_chunk=min(d_chunk, dx.shape[0]), device=qx.device)
    return execute(plan, qx, qy)


# ------------------------------------------------------------ local ranks
def _to_cpu(x):
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _rank_main(rank, fn, world_size, args, tmp, timeout):
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=timeout))
    try:
        torch.save(_to_cpu(fn(rank, world_size, *args)), os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world_size: int, args=(), *, timeout: float = 120.0):
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` ranks of this
    host: processes started with ``torch.multiprocessing``'s spawn, one
    intra-op thread each, joined in a gloo process group through a
    ``file://`` rendezvous in a new temporary directory (no port to collide
    on).  ``fn`` must be importable by name.  Returns each rank's result,
    its tensors moved to the CPU.  A rank that fails ends the others and
    raises here; so does a run longer than ``timeout`` seconds, which also
    bounds every collective of the ranks."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        ctx = mp.spawn(_rank_main, args=(fn, world_size, args, tmp, timeout), nprocs=world_size, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"spawn_ranks: {world_size} ranks did not finish within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world_size)]
