"""Static configuration of the model the eval forward and test_step build.

The fields these paths read, with the defaults of the JAX package's
ModelConfig.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    dataset: str = "shapenet"  # 'shapenet' | 'partnet'
    num_class: int = 50
    num_categories: int = 16
    eucl_dim: int = 2
    hyp_dim: int = 2
    k: int = 10
    pooling: str = "mean"
    class_vector: bool = False
    test_rotation: str = "so3"  # 'so3' | 'z' | 'none'
