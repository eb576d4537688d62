"""The decode of test_step: distances, MNN linkage and the best-k sweep."""
from .linkage import (
    build_cut_tables,
    cosine_distance_matrix,
    cut_roots_sweep,
    linkage_from_distances_mnn,
)
from .scores import adjusted_rand_index, contingency, get_optimal_k, remap_consecutive

__all__ = ["adjusted_rand_index", "build_cut_tables", "contingency", "cosine_distance_matrix",
           "cut_roots_sweep", "get_optimal_k", "linkage_from_distances_mnn",
           "remap_consecutive"]
