"""Spatial point-set generators (paper section 4: random points in a
square; clustered variants exercise the adaptive-alpha range).  Numpy, so
the same seed gives the same points as ``repro.data.spatial``."""

from __future__ import annotations

import numpy as np


def uniform_points(m: int, seed: int = 0, dtype=np.float32):
    """The paper's test data: uniform random in the unit square."""
    rng = np.random.default_rng(seed)
    x = rng.random(m).astype(dtype)
    y = rng.random(m).astype(dtype)
    z = (np.sin(6 * x) * np.cos(6 * y) + 2.0).astype(dtype)
    return x, y, z


def clustered_points(m: int, seed: int = 0, n_clusters: int | None = None, spread: float = 0.02, dtype=np.float32):
    """Gaussian clusters (default one per 256 points) clipped to the unit square."""
    rng = np.random.default_rng(seed)
    nc = n_clusters or max(2, m // 256)
    centers = rng.random((nc, 2))
    pts = np.clip(centers[rng.integers(0, nc, m)] + rng.normal(0, spread, (m, 2)), 0, 1)
    x = pts[:, 0].astype(dtype)
    y = pts[:, 1].astype(dtype)
    z = (np.sin(6 * x) * np.cos(6 * y) + 2.0).astype(dtype)
    return x, y, z
