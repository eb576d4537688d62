import torch

from .dgcnn import DGCNNPartSeg
from .pointnet import PointNetPartSeg
from .vn_dgcnn import VNDGCNNPartSeg
from .vn_pointnet import VNPointNetPartSeg


def make_backbone(cfg):
    """The backbone `cfg.model_name` names, as the JAX package's
    make_backbone builds it.  The scalar backbones and VN-PointNet output
    num_class-wide features, so they need eucl_dim == num_class.  cfg.bf16
    sets VN-DGCNN's compute dtype; the other backbones compute in fp32
    whatever it says, as in the JAX package.  The head's label input is the
    decode vector: num_class wide with class_vector (the part-presence
    vector), else num_categories (flax infers the width from the input)."""
    labels = cfg.num_class if cfg.class_vector else cfg.num_categories
    if cfg.model_name == "vn_dgcnn_partseg":
        return VNDGCNNPartSeg(cfg.eucl_dim, k=cfg.k, num_categories=labels,
                              pooling=cfg.pooling, dropout=cfg.dropout,
                              compute_dtype=torch.bfloat16 if cfg.bf16 else None)
    if cfg.model_name in ("dgcnn_partseg", "pointnet_partseg", "vn_pointnet_partseg") \
            and cfg.eucl_dim != cfg.num_class:
        raise ValueError(
            f"{cfg.model_name} outputs num_class={cfg.num_class}-wide features "
            f"(reference train.py:66: out_features=num_class) but "
            f"--eucl_embedding is {cfg.eucl_dim}; set --eucl_embedding "
            f"{cfg.num_class} (and --hyp_embedding accordingly) for this model")
    if cfg.model_name == "dgcnn_partseg":
        return DGCNNPartSeg(cfg.num_class, k=cfg.k, num_categories=labels,
                            dropout=cfg.dropout)
    if cfg.model_name == "pointnet_partseg":
        return PointNetPartSeg(cfg.num_class, num_categories=labels)
    if cfg.model_name == "vn_pointnet_partseg":
        return VNPointNetPartSeg(cfg.num_class, k=cfg.k, num_categories=labels,
                                 pooling=cfg.pooling)
    raise ValueError(f"Not implemented for model_name {cfg.model_name}")


__all__ = ["DGCNNPartSeg", "PointNetPartSeg", "VNDGCNNPartSeg", "VNPointNetPartSeg",
           "make_backbone"]
