"""Kernels and graph operations.  The modules `knn` and `edgeconv` hold
the kernels' wrappers (import them as modules: `from hpcs_torch.ops import
knn as KN`); the JAX package's two other public names are exported here."""
from .knn import knn_auto, pairwise_neg_sqdist

__all__ = ["knn_auto", "pairwise_neg_sqdist"]
