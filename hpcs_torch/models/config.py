"""Static configuration of the model, its losses and its training.

The fields and defaults of the JAX package's ModelConfig, in its order, so
a config.json written by either package loads with `ModelConfig(**d)`.
`HypHCSystem` refuses the values whose path is not ported yet (`bf16`,
`layout="vc"`).
"""
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    # data / task
    dataset: str = "shapenet"  # 'shapenet' | 'partnet'
    model_name: str = "vn_dgcnn_partseg"
    num_class: int = 50
    num_categories: int = 16
    fixed_points: int = 512
    # embedding dims
    eucl_dim: int = 2
    hyp_dim: int = 2
    # backbone
    k: int = 10
    dropout: float = 0.5
    pooling: str = "mean"
    # loss
    margin: float = 0.05
    t_per_anchor: int = 50
    fraction: float = 1.2
    temperature: float = 1.0
    anneal_factor: float = 2.0
    anneal_step: int = 0
    trade_off: float = 1.0
    miner: bool = True
    cosface: bool = True
    hierarchical: bool = False
    class_vector: bool = False
    num_triplets: Optional[int] = None
    # augmentation: 'so3' | 'z' | 'none'
    train_rotation: str = "so3"
    test_rotation: str = "so3"
    # optimization
    lr: float = 0.005
    bf16: bool = False  # bf16 compute in the backbone (ROADMAP A5b)
    # VN feature layout: "cv" [.., C, 3]; "vc" [.., 3, C] is the JAX
    # package's lane-major layout for the TPU, with the same parameters
    layout: str = "cv"
    # hierarchy (PartNet): nested per-level branch lists of leaf ids
    hierarchy_list: Tuple = ()

    @property
    def use_hierarchical(self) -> bool:
        return self.hierarchical and self.dataset == "partnet" and len(self.hierarchy_list) > 0
