"""The decode of test_step (distances, MNN linkage, the best-k sweep) and
the rest of the JAX package's decode API: Euclidean distances, the
sequential linkage, `linkage`, flat cuts and clustering scores."""
from .linkage import (
    build_cut_tables,
    cosine_distance_matrix,
    cut_maxclust,
    cut_maxclust_fcluster,
    cut_maxclust_many,
    cut_roots_sweep,
    decode_leaves,
    euclidean_distance_matrix,
    linkage,
    linkage_from_distances,
    linkage_from_distances_mnn,
)
from .scores import (
    adjusted_rand_index,
    contingency,
    eval_clustering,
    get_optimal_k,
    purity,
    remap_consecutive,
    weighted_jaccard,
)

__all__ = ["adjusted_rand_index", "build_cut_tables", "contingency", "cosine_distance_matrix",
           "cut_maxclust", "cut_maxclust_fcluster", "cut_maxclust_many", "cut_roots_sweep",
           "decode_leaves", "euclidean_distance_matrix", "eval_clustering", "get_optimal_k",
           "linkage", "linkage_from_distances", "linkage_from_distances_mnn", "purity",
           "remap_consecutive", "weighted_jaccard"]
