from .triplet import (
    Triplets,
    cosine_similarity01,
    margin_filter,
    pairwise_cosine_similarity01,
    sample_balanced_triplets,
    sample_random_triplets,
)

__all__ = ["Triplets", "cosine_similarity01", "margin_filter", "pairwise_cosine_similarity01",
           "sample_balanced_triplets", "sample_random_triplets"]
