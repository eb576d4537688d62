from .base import HypHCNet, HypHCSystem, decode_vector_for_batch
from .config import ModelConfig

__all__ = ["HypHCNet", "HypHCSystem", "ModelConfig", "decode_vector_for_batch"]
