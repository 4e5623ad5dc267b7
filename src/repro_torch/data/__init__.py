"""Synthetic spatial data sets."""

from repro_torch.data.spatial import clustered_points, uniform_points

__all__ = ["clustered_points", "uniform_points"]
