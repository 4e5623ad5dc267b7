"""Math core: layouts, k-best selection, the AIDW and IDW formulas, the
chunked single-host interpolators and the grid."""

from repro_torch.core.aidw import (
    AIDWParams,
    adaptive_alpha,
    aidw_interpolate,
    aidw_reference,
    alpha_from_mu,
    brute_r_obs,
    expected_nn_distance,
    fuzzy_membership,
)
from repro_torch.core.grid import UniformGrid, build_grid, grid_knn, grid_r_obs
from repro_torch.core.idw import idw_interpolate, idw_reference
from repro_torch.core.knn import k_smallest, paper_insertion_knn, running_k_best
from repro_torch.core.layouts import PointSet, aoas_to_soa, coord_sentinel, pad_tail, pad_to, soa_to_aoas

__all__ = [
    "AIDWParams", "adaptive_alpha", "aidw_interpolate", "aidw_reference", "alpha_from_mu",
    "brute_r_obs", "expected_nn_distance", "fuzzy_membership", "UniformGrid", "build_grid",
    "grid_knn", "grid_r_obs", "idw_interpolate", "idw_reference", "k_smallest",
    "paper_insertion_knn", "running_k_best", "PointSet", "aoas_to_soa", "coord_sentinel",
    "pad_tail", "pad_to", "soa_to_aoas",
]
