"""Math core: layouts, k-best selection, the AIDW formulas and the grid."""

from repro_torch.core.aidw import (
    AIDWParams,
    adaptive_alpha,
    aidw_reference,
    alpha_from_mu,
    brute_r_obs,
    expected_nn_distance,
    fuzzy_membership,
)
from repro_torch.core.knn import k_smallest, paper_insertion_knn, running_k_best
from repro_torch.core.layouts import coord_sentinel, pad_tail, pad_to

__all__ = [
    "AIDWParams", "adaptive_alpha", "aidw_reference", "alpha_from_mu",
    "brute_r_obs", "expected_nn_distance", "fuzzy_membership", "k_smallest",
    "paper_insertion_knn", "running_k_best", "coord_sentinel", "pad_tail",
    "pad_to",
]
