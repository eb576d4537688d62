from .cosface import (
    cosface_logits,
    cosface_loss,
    hierarchical_cosface_loss,
    hierarchical_loss,
    hierarchy_sum_matrices,
)
from .hyphc import (
    anneal_temperature,
    hyphc_triplet_loss,
    mean_pairwise_similarity,
    normalize_to_radius,
    triplet_margin_loss,
)
from .joint import LossConfig, compute_losses, get_logits

__all__ = ["cosface_logits", "cosface_loss", "hierarchical_cosface_loss", "hierarchical_loss",
           "hierarchy_sum_matrices", "anneal_temperature", "hyphc_triplet_loss",
           "mean_pairwise_similarity", "normalize_to_radius", "triplet_margin_loss",
           "LossConfig", "compute_losses", "get_logits"]
