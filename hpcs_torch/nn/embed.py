"""Euclidean -> Poincare-ball embedders.

MLPExpMap is a bias-free Linear followed by the exp map at the origin: the
reference's MLP takes a negative_slope but inserts no activation, and that
defines the architecture.  Its weight sits at `mlp.0.0.weight`, the
reference's key.
"""
from torch import nn

from ..geometry import expmap0


class ExpMap(nn.Module):
    """Exponential map at the origin (eucl dim == hyp dim)."""

    def forward(self, x):
        return expmap0(x)


class MLPExpMap(nn.Module):
    """Linear projection to the ball dimension, then the exp map at the origin."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.mlp = nn.Sequential(nn.Sequential(nn.Linear(in_features, out_features, bias=False)))

    def forward(self, x):
        return expmap0(self.mlp(x))


def make_embedder(eucl_dim, hyp_dim):
    """ExpMap when the dimensions match, else MLPExpMap."""
    if eucl_dim == hyp_dim:
        return ExpMap()
    return MLPExpMap(eucl_dim, hyp_dim)
