"""Vector-Neuron layers (SO(3)-equivariant point features), eval mode.

Features use the channel-major layout [..., C, 3]: vector components last.
Parameter names follow the reference's state_dict keys (`map_to_feat`,
`map_to_dir`, `batchnorm.bn`, `std_feature.{vn1,vn2,vn_lin}`); weights are
[out, in].  Every layer is equivariant: f(x R) = f(x) R on the last axis.

Only the eval-mode forward is ported: BatchNorm uses running statistics.
Train-mode BatchNorm must follow flax (biased variance, momentum 0.9), which
torch's BatchNorm does not, so a module in training mode raises.
"""
import torch
from torch import nn

from ...ops.vn_math import BN_EPS, EPS, NEGATIVE_SLOPE, channel_mix, vn_leaky_relu


def _require_eval(module):
    if module.training:
        raise NotImplementedError(
            f"{type(module).__name__}: only the eval-mode forward is ported; "
            "call .eval() first")


def bn_eval(x, bn):
    """Eval-mode BatchNorm over the last axis of x with `bn`'s running stats."""
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return (x - bn.running_mean) * mul + bn.bias


class VNLinear(nn.Module):
    """Bias-free linear map over vector channels."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.map_to_feat = nn.Linear(in_channels, out_channels, bias=False)

    def forward(self, x):
        return channel_mix(x, self.map_to_feat.weight)


class VNBatchNorm(nn.Module):
    """BatchNorm on vector norms: rescales each vector by bn(|v|) / |v|."""

    def __init__(self, num_features):
        super().__init__()
        self.bn = nn.BatchNorm1d(num_features, eps=BN_EPS)

    def forward(self, x):
        _require_eval(self)
        norm = torch.sqrt(torch.sum(x * x, dim=-1) + EPS * EPS) + EPS
        return x * (bn_eval(norm, self.bn) / norm).unsqueeze(-1)


class VNLinearLeakyReLU(nn.Module):
    """Linear -> norm BatchNorm -> direction-gated leaky ReLU.

    The direction map acts on the layer's input, not on the linear output.
    """

    def __init__(self, in_channels, out_channels, share_nonlinearity=False,
                 negative_slope=NEGATIVE_SLOPE):
        super().__init__()
        self.negative_slope = negative_slope
        self.map_to_feat = nn.Linear(in_channels, out_channels, bias=False)
        self.batchnorm = VNBatchNorm(out_channels)
        dir_channels = 1 if share_nonlinearity else out_channels
        self.map_to_dir = nn.Linear(in_channels, dir_channels, bias=False)

    def forward(self, x):
        p = self.batchnorm(channel_mix(x, self.map_to_feat.weight))
        d = channel_mix(x, self.map_to_dir.weight)
        return vn_leaky_relu(p, d, self.negative_slope)


def mean_pool(x, dim=-3):
    """Mean over the neighbour axis of [..., K, C, 3]."""
    return torch.mean(x, dim=dim)


def invariant_project(x, z0_rows):
    """Contract [..., C, 3] features with a frame [..., F, 3] of row vectors
    into rotation-invariant scalars [..., C, F]."""
    return torch.einsum("...cj,...kj->...ck", x, z0_rows)


class VNStdFeature(nn.Module):
    """Learn an equivariant 3-frame z0 and project the features onto it.

    Returns (x_std [..., C, 3], z0 [..., 3, 3]); x_std is rotation-invariant.
    """

    def __init__(self, in_channels, share_nonlinearity=False,
                 negative_slope=NEGATIVE_SLOPE):
        super().__init__()
        self.vn1 = VNLinearLeakyReLU(in_channels, in_channels // 2,
                                     share_nonlinearity, negative_slope)
        self.vn2 = VNLinearLeakyReLU(in_channels // 2, in_channels // 4,
                                     share_nonlinearity, negative_slope)
        self.vn_lin = nn.Linear(in_channels // 4, 3, bias=False)

    def forward(self, x):
        z0 = channel_mix(self.vn2(self.vn1(x)), self.vn_lin.weight)
        return invariant_project(x, z0), z0
