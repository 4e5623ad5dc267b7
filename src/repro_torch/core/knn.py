"""k-best selection.  Counterpart of ``repro.core.knn``.

:func:`running_k_best` folds a tile of squared distances into a running
``(rows, k)`` best set; it keeps duplicates, so its result is the same
multiset as the JAX package's k-pass min-extract merge.
:func:`paper_insertion_knn` is the paper's per-thread insertion sort in
numpy, kept as a test oracle.
"""

from __future__ import annotations

import numpy as np
import torch


def running_k_best(best, d2_tile):
    """The ``k`` smallest of ``cat([best, d2_tile], 1)`` per row, ascending.

    ``best`` is ``(rows, k)`` (any order, +inf for empty slots) and
    ``d2_tile`` is ``(rows, t)``."""
    k = best.shape[1]
    c = torch.cat([best, d2_tile], dim=1)
    return torch.topk(c, k, dim=1, largest=False, sorted=True).values


def k_smallest(values, k: int):
    """k smallest entries of the last axis, ascending."""
    return torch.topk(values, k, dim=-1, largest=False, sorted=True).values


def paper_insertion_knn(d: np.ndarray, k: int) -> np.ndarray:
    """Fig. 1 / Fig. 3 lines 11-32 of the paper (numpy, one query): the k
    smallest of the squared distances ``d``, ascending."""
    m = d.shape[0]
    buf = d[:k].copy()
    # sort the first k distances in ascending order (bubble sort, Fig. 3)
    for i in range(k - 1):
        for j in range(k - 1 - i):
            if buf[j] > buf[j + 1]:
                buf[j], buf[j + 1] = buf[j + 1], buf[j]
    # stream the remaining m-k candidates
    for i in range(k, m):
        dist = d[i]
        if dist < buf[k - 1]:
            buf[k - 1] = dist
            # neighbouring compare-and-swap back to sorted order
            for j in range(k - 2, -1, -1):
                if buf[j] > buf[j + 1]:
                    buf[j], buf[j + 1] = buf[j + 1], buf[j]
                else:
                    break
    return buf
