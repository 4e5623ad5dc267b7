"""Parameter specs: models declare their parameters as nested dicts of
:class:`ParamSpec` (shape, logical axes, init recipe) rather than tensors.
Counterpart of ``repro.models.params``.

* :func:`materialize` makes real tensors from a ``torch.Generator``, one
  leaf at a time in the dtype asked for, on the device asked for (the card
  unless the caller says otherwise), so a 30B model never exists in float32;
* :func:`count_params` counts without allocating;
* :func:`from_reference` carries the JAX package's materialized parameters
  (nested dicts of numpy arrays) across, checked leaf by leaf against the
  specs, so both packages can run on the same weights.

Leaves are visited in sorted key order, the order ``jax.tree`` flattens a
dict in.  The logical axes are kept for the sharding slice; nothing here
reads them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple  # logical axes, same length as shape
    init: str = "normal"  # "normal" | "zeros" | "ones"
    scale: float | None = None  # stddev for "normal"


def tree_map(fn, tree, *rest, with_path: bool = False, _path: tuple = ()):
    """The tree of ``fn(leaf, *rest_leaves)`` over nested dicts (every value
    that is not a dict is a leaf; ``rest`` are trees of ``tree``'s
    structure), keys visited in sorted order.  With ``with_path=True``,
    ``fn`` takes the leaf's key path first."""
    if isinstance(tree, dict):
        return {
            key: tree_map(fn, tree[key], *(r[key] for r in rest), with_path=with_path, _path=_path + (key,))
            for key in sorted(tree)
        }
    return fn(_path, tree, *rest) if with_path else fn(tree, *rest)


def leaves(tree, prefix: tuple = ()):
    """``[(path, leaf)]`` of a tree of nested dicts, in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out += leaves(tree[key], prefix + (key,))
    return out


def materialize(specs, generator: torch.Generator | None = None, device="cuda", dtype=torch.float32):
    """Real parameter tensors for ``specs``: normal leaves drawn from
    ``generator`` (which must live on ``device``) at their scale (0.02 when
    none is given), written straight in ``dtype``, one leaf at a time."""
    device = torch.device(device)

    def one(s):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dtype, device=device)
        scale = s.scale if s.scale is not None else 0.02
        return torch.empty(s.shape, dtype=dtype, device=device).normal_(0.0, scale, generator=generator)

    return tree_map(one, specs)


def stack(specs, n: int):
    """Prepend a stacked "layers" dimension to every spec in the subtree."""
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale), specs)


def dense_spec(d_in: int, d_out: int, axes=("embed", None), *, bias: bool = False):
    """A linear layer spec with fan-in init."""
    out = {"w": ParamSpec((d_in, d_out), axes, "normal", 1.0 / math.sqrt(d_in))}
    if bias:
        out["b"] = ParamSpec((d_out,), (axes[-1],), "zeros")
    return out


def count_params(specs) -> int:
    return sum(int(math.prod(s.shape)) for _, s in leaves(specs))


def from_reference(tree, specs, *, device="cuda", dtype=None):
    """The port's parameters from the JAX package's: ``tree`` is a nested
    dict of numpy arrays (``jax.device_get(materialize(spec, key))``) with
    the structure of ``specs``.  Each leaf becomes one tensor of its own on
    ``device``, in ``dtype`` (default: the array's); the stacked leading
    "layers" axis is kept.  Raises ``ValueError`` naming the first leaf that
    is missing, extra, or of another shape than its spec."""
    want, have = {p for p, _ in leaves(specs)}, {p for p, _ in leaves(tree)}
    if have - want:
        raise ValueError(f"from_reference: extra leaves {sorted(have - want)}")
    if want - have:
        raise ValueError(f"from_reference: missing leaves {sorted(want - have)}")

    def one(path, s, a):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(s.shape):
            raise ValueError(f"from_reference: leaf {'/'.join(path)} has shape {a.shape}, the spec {s.shape}")
        return torch.tensor(a, dtype=dtype, device=device)

    return tree_map(one, specs, tree, with_path=True)
