"""The HypHC loss's placement of embeddings in the ball.

Only `normalize_to_radius` is ported so far: the decode's first step.
"""
import torch

from ..geometry.math_ops import l2_normalize


def normalize_to_radius(embeddings, scale):
    """Place embeddings on the sphere of radius clamp(scale, 1e-4, 1)."""
    return l2_normalize(embeddings) * torch.clamp(torch.as_tensor(scale), 1e-4, 1.0)
