"""Vector-Neuron layers (SO(3)-equivariant point features).

Features use the channel-major layout [..., C, 3]: vector components last.
Parameter names follow the reference's state_dict keys (`map_to_feat`,
`map_to_dir`, `batchnorm.bn`, `std_feature.{vn1,vn2,vn_lin}`); weights are
[out, in].  Every layer is equivariant: f(x R) = f(x) R on the last axis.
`dense_block` is the scalar backbones' Dense -> BatchNorm -> activation.

BatchNorm follows flax's nn.BatchNorm, not torch's (`BatchNorm`): in
training it normalises by the batch mean and the biased variance
E[x^2] - E[x]^2 and moves the running statistics by 0.1 of the batch's.

bf16 features (VN-DGCNN with ModelConfig.bf16) follow the JAX package:
channel mixes in bf16 with fp32 sums (`channel_mix`), the norm BatchNorm
and the gate in fp32 with their results rounded back, the mean over the
neighbours summed in fp32.  Parameters stay fp32: each layer casts the
weight it uses.
"""
import torch
from torch import nn

from ...ops.vn_math import BN_EPS, EPS, NEGATIVE_SLOPE, channel_mix, upcast, vn_leaky_relu


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over every axis but `channel_dim`, with flax's rule.

    Training: y = (x - mean) rsqrt(var + eps) weight + bias with the batch's
    mean and biased variance max(E[x^2] - E[x]^2, 0); running_mean and
    running_var become 0.9 old + 0.1 batch (the biased variance, where
    torch's BatchNorm1d would take the unbiased one).  Eval: the same with
    the running statistics.  The state_dict keys are BatchNorm1d's.
    """

    def __init__(self, num_features, eps=BN_EPS, channel_dim=-1):
        super().__init__(num_features, eps=eps)
        self.channel_dim = channel_dim

    def forward(self, x):
        shape = [1] * x.dim()
        shape[self.channel_dim] = x.shape[self.channel_dim]
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = [d for d in range(x.dim()) if d != self.channel_dim % x.dim()]
            mean = torch.mean(x, dim=axes)
            var = torch.clamp(torch.mean(x * x, dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(0.1 * mean)
                self.running_var.mul_(0.9).add_(0.1 * var)
                self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


def zero_bias_linear(in_features, out_features):
    """nn.Linear whose bias starts at 0, as flax's Dense does."""
    linear = nn.Linear(in_features, out_features)
    nn.init.zeros_(linear.bias)
    return linear


def dense_block(in_features, out_features, bias=False, activation=None):
    """Linear (its bias, if any, zero) -> BatchNorm -> `activation` (a
    module or None) on channel-last features [..., in_features]; the
    state_dict keys are `0.weight`, `0.bias` and `1.*`."""
    linear = (zero_bias_linear(in_features, out_features) if bias
              else nn.Linear(in_features, out_features, bias=False))
    layers = [linear, BatchNorm(out_features)]
    return nn.Sequential(*layers, *([activation] if activation is not None else []))


class VNLinear(nn.Module):
    """Bias-free linear map over vector channels."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.map_to_feat = nn.Linear(in_channels, out_channels, bias=False)

    def forward(self, x):
        return channel_mix(x, self.map_to_feat.weight)


class VNBatchNorm(nn.Module):
    """BatchNorm on vector norms: rescales each vector by bn(|v|) / |v|,
    in fp32 for bf16 features (the result rounded back)."""

    def __init__(self, num_features):
        super().__init__()
        self.bn = BatchNorm(num_features)

    def forward(self, x):
        xf = upcast(x)
        norm = torch.sqrt(torch.sum(xf * xf, dim=-1) + EPS * EPS) + EPS
        return (xf * (self.bn(norm) / norm).unsqueeze(-1)).to(x.dtype)


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


class VNLeakyReLU(nn.Module):
    """Direction-gated leaky ReLU with a learned direction per channel (one
    shared direction with share_nonlinearity)."""

    def __init__(self, in_channels, share_nonlinearity=False, negative_slope=NEGATIVE_SLOPE):
        super().__init__()
        self.negative_slope = negative_slope
        self.map_to_dir = nn.Linear(in_channels, 1 if share_nonlinearity else in_channels,
                                    bias=False)

    def forward(self, x):
        return vn_leaky_relu(x, channel_mix(x, self.map_to_dir.weight), self.negative_slope)


def first_argmax(x, dim):
    """The index of the largest entry along `dim`, the first one on a tie
    or a NaN, as jnp.argmax gives it on every device (torch.argmax does not
    promise the first on CUDA)."""
    m = x.amax(dim=dim, keepdim=True)
    hit = (x == m) | torch.isnan(x)
    pos = torch.arange(x.shape[dim], device=x.device).reshape(
        [-1] + [1] * (x.dim() - 1 - dim % x.dim()))
    return torch.where(hit, pos, x.shape[dim]).amin(dim=dim)


class VNMaxPool(nn.Module):
    """Max pool over the axis -3 of [..., K, C, 3]: per channel the vector
    whose dot product with its learned direction is the largest."""

    def __init__(self, in_channels):
        super().__init__()
        self.map_to_dir = nn.Linear(in_channels, in_channels, bias=False)

    def forward(self, x):
        dot = torch.sum(x * channel_mix(x, self.map_to_dir.weight), dim=-1)  # [..., K, C]
        idx = first_argmax(dot, dim=-2)  # [..., C]
        return torch.gather(x, -3, idx[..., None, :, None].expand(*idx.shape[:-1], 1,
                                                                   *x.shape[-2:]))[..., 0, :, :]


def mean_pool(x, dim=-3):
    """Mean over the neighbour axis of [..., K, C, 3] (or over `dim`),
    summed in fp32 for bf16 features and rounded back, as jnp.mean does."""
    return torch.mean(upcast(x), dim=dim).to(x.dtype)


def invariant_project(x, z0_rows):
    """Contract [..., C, 3] features with a frame [..., F, 3] of row vectors
    into rotation-invariant scalars [..., C, F]."""
    return torch.einsum("...cj,...kj->...ck", x, z0_rows)


class VNStdFeature(nn.Module):
    """Learn an equivariant 3-frame z0 and project the features onto it.

    Returns (x_std [..., C, 3], z0 [..., 3, 3]); x_std is rotation-invariant.
    VN-PointNet's takes negative_slope 0.
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
