"""Static configuration of the model the eval forward builds.

The fields the forward needs, with the defaults of the JAX package's
ModelConfig.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    num_class: int = 50
    num_categories: int = 16
    eucl_dim: int = 2
    hyp_dim: int = 2
    k: int = 10
    pooling: str = "mean"
