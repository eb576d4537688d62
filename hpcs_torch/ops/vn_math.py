"""Vector-neuron arithmetic shared by the VN layers and the EdgeConv stage.

Features use the channel-major layout [..., C, 3]: vector components last.
"""
import torch

EPS = 1e-6
NEGATIVE_SLOPE = 0.2
BN_EPS = 1e-5


def channel_mix(x, weight):
    """Apply an [out, in] mixing matrix over the channel axis of [..., in, 3]."""
    return torch.einsum("...cv,dc->...dv", x, weight)


def vn_leaky_relu(p, d, negative_slope=NEGATIVE_SLOPE):
    """Direction-gated leaky ReLU: keep p where <p, d> >= 0, else remove its
    component along d, then blend with p by the slope."""
    dotprod = torch.sum(p * d, dim=-1, keepdim=True)
    d_norm_sq = torch.sum(d * d, dim=-1, keepdim=True)
    mask = (dotprod >= 0).to(p.dtype)
    projected = p - (dotprod / (d_norm_sq + EPS)) * d
    return negative_slope * p + (1 - negative_slope) * (
        mask * p + (1 - mask) * projected)
