"""Vector-Neuron PointNet part-segmentation backbone.

Cross-product edge features of the points (`graph_feature_cross_vn`, one
kNN graph: kernel B1 on the GPU, through `vn_dgcnn.knn_graph`), VN layers
with slope-0 gates, a VN feature transform (VNSTNkd, pooled over the
points), VNStdFeature, and the 9025-channel invariant head with
log_softmax over the parts.  Features are [B, N, C, 3].  Module names
follow the JAX package's.  Plain PyTorch in training and in eval, as in
the JAX package.

In a point-sharded call (hpcs_torch.nn.point_shard) the graph covers this
rank's rows of the gathered points (`vn_dgcnn.neighbours`), the pools
over the points (VNSTNkd's mean or VNMaxPool, the global mean and max)
are the whole cloud's, and VNSTNkd's fully connected blocks run under
`point_shard.per_cloud`.
"""
import torch
from torch import nn

from ...ops.edgeconv import graph_feature_cross_vn
from .. import point_shard
from ..point_shard import max_over_points
from ..vn.layers import (VNBatchNorm, VNLinear, VNLinearLeakyReLU, VNMaxPool, VNStdFeature,
                         invariant_project, mean_pool, zero_bias_linear)
from .pointnet import conv_bn_relu
from .vn_dgcnn import neighbours


def _vn_relu(in_channels, out_channels):
    return VNLinearLeakyReLU(in_channels, out_channels, negative_slope=0.0)


class VNSTNkd(nn.Module):
    """Equivariant feature transform: [B, N, d, 3] -> a global frame [B, d, 3]."""

    def __init__(self, d, pooling="mean"):
        super().__init__()
        self.conv1 = _vn_relu(d, 64 // 3)
        self.conv2 = _vn_relu(64 // 3, 128 // 3)
        self.conv3 = _vn_relu(128 // 3, 1024 // 3)
        self.pool = VNMaxPool(1024 // 3) if pooling == "max" else None
        self.fc1 = _vn_relu(1024 // 3, 512 // 3)
        self.fc2 = _vn_relu(512 // 3, 256 // 3)
        self.fc3 = VNLinear(256 // 3, d)

    def forward(self, x):
        shard = point_shard.current()
        h = self.conv3(self.conv2(self.conv1(x)))
        if shard is None:
            h = mean_pool(h) if self.pool is None else self.pool(h)  # over N -> [B, C, 3]
        elif self.pool is None:
            h = shard.mean_over_points(h)
        else:
            h = shard.max_pool_over_points(self.pool, h)
        with point_shard.per_cloud():
            return self.fc3(self.fc2(self.fc1(h)))


class VNPointNetPartSeg(nn.Module):
    """Returns per-point log-softmax scores [B, N, num_part]."""

    def __init__(self, num_part, k=20, num_categories=16, pooling="mean"):
        super().__init__()
        self.k = k
        self.conv_pos = _vn_relu(3, 64 // 3)
        self.pool = VNMaxPool(64 // 3) if pooling == "max" else None
        self.conv1 = _vn_relu(64 // 3, 64 // 3)
        self.conv2 = _vn_relu(64 // 3, 128 // 3)
        self.conv3 = _vn_relu(128 // 3, 128 // 3)
        self.fstn = VNSTNkd(128 // 3, pooling)
        self.conv4 = _vn_relu(2 * (128 // 3), 512 // 3)
        self.conv5 = VNLinear(512 // 3, 2048 // 3)
        self.bn5 = VNBatchNorm(2048 // 3)
        self.std_feature = VNStdFeature(2 * (2048 // 3), negative_slope=0.0)
        std = 2 * (2048 // 3) * 3  # VNStdFeature's invariants, 4092
        head_in = 2 * std + num_categories + (21 + 42 + 42 + 170) * 3
        self.convs1 = conv_bn_relu(head_in, 256)
        self.convs2 = conv_bn_relu(256, 256)
        self.convs3 = conv_bn_relu(256, 128)
        self.convs4 = zero_bias_linear(128, num_part)

    def forward(self, points, label, idx_override=None, generator=None):
        """points [B, N, 3], label [B, num_categories] -> [B, N, num_part].
        idx_override: optional one kNN graph [B, N, k] int32, of the points.
        generator is unused: no dropout."""
        shard = point_shard.current()
        B, N, _ = points.shape
        x = points[:, :, None, :]
        idx, table, _ = neighbours(x, self.k, idx_override)
        feat, _ = graph_feature_cross_vn(x, self.k, idx, table=table)
        x = self.conv_pos(feat)  # [B, N, K, 21, 3]
        x = mean_pool(x) if self.pool is None else self.pool(x)
        out1 = self.conv1(x)
        out2 = self.conv2(out1)
        out3 = self.conv3(out2)
        net_global = self.fstn(out3)[:, None].expand(B, N, -1, 3)  # [B, N, 42, 3]
        out4 = self.conv4(torch.cat([out3, net_global], dim=-2))  # [B, N, 170, 3]
        out5 = self.bn5(self.conv5(out4))  # [B, N, 682, 3]
        mean = out5.mean(dim=1) if shard is None else shard.mean_over_points(out5)
        out5 = torch.cat([out5, mean[:, None].expand_as(out5)], dim=-2)
        out5, trans = self.std_feature(out5)
        out5 = out5.reshape(B, N, -1)  # [B, N, 4092]
        out_max = torch.cat([max_over_points(out5), label], dim=-1)
        expand = out_max[:, None, :].expand(B, N, -1)
        out1234 = torch.cat([out1, out2, out3, out4], dim=-2)  # [B, N, 275, 3]
        out1234 = invariant_project(out1234, trans).reshape(B, N, -1)  # [B, N, 825]
        concat = torch.cat([expand, out1234, out5], dim=-1)  # [B, N, 9025]
        net = self.convs4(self.convs3(self.convs2(self.convs1(concat))))
        return torch.log_softmax(net, dim=-1)
