from .base import HypHCNet, HypHCSystem, decode_vector_for_batch
from .config import ModelConfig


def build_net(cfg: ModelConfig) -> HypHCNet:
    """The net of `cfg`: backbone, ball embedder and the loss parameters."""
    return HypHCNet(cfg)


def ShapeNetHypHC(device=None, generator=None, **kwargs) -> HypHCSystem:
    """ShapeNet system (reference hpcs/models/shapenet_hyp_hc.py): 16
    categories unless `num_categories` says otherwise."""
    kwargs.setdefault("num_categories", 16)
    return HypHCSystem(ModelConfig(dataset="shapenet", **kwargs), device, generator)


def PartNetHypHC(device=None, generator=None, **kwargs) -> HypHCSystem:
    """PartNet system (reference hpcs/models/partnet_hyp_hc.py): one dummy
    category unless `num_categories` says otherwise."""
    kwargs.setdefault("num_categories", 1)
    return HypHCSystem(ModelConfig(dataset="partnet", **kwargs), device, generator)


__all__ = ["HypHCNet", "HypHCSystem", "ModelConfig", "ShapeNetHypHC", "PartNetHypHC",
           "build_net", "decode_vector_for_batch"]
