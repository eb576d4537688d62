"""Classic PointNet part-segmentation backbone.

Learned input and feature transforms (STNkd, the identity added to its
output), per-point blocks (Linear with bias -> BatchNorm -> ReLU), a
2048-channel global max and the 4944-channel head.  The output is
log_softmax over the parts, as in the reference: this backbone's
"embedding" is a log-probability vector.  Features are channel-last
[B, N, C]; no kNN graph.  Module names follow the JAX package's (stn,
conv1..conv5, fstn, bn5, convs1..convs4; an STNkd's blocks are `blocks.i`
for its `_ConvBNRelu_i` and `transform` for its `Dense_0`).

In a point-sharded call (hpcs_torch.nn.point_shard) the maxima over the
points (each STN's and the global feature's) are the whole cloud's, and
each STN's blocks after its pool run under `point_shard.per_cloud`.
"""
import torch
from torch import nn

from .. import point_shard
from ..point_shard import max_over_points
from ..vn.layers import BatchNorm, dense_block, zero_bias_linear


def conv_bn_relu(in_features, out_features):
    return dense_block(in_features, out_features, bias=True, activation=nn.ReLU())


class STNkd(nn.Module):
    """A learned k x k transform of [B, N, k] features, identity-added."""

    def __init__(self, k=64):
        super().__init__()
        self.k = k
        widths = (k, 64, 128, 1024, 512, 256)
        self.blocks = nn.ModuleList(conv_bn_relu(a, b) for a, b in zip(widths, widths[1:]))
        self.transform = zero_bias_linear(256, k * k)

    def forward(self, x):
        h = x
        for block in self.blocks[:3]:
            h = block(h)
        h = max_over_points(h)  # over N -> [B, 1024]
        with point_shard.per_cloud():
            for block in self.blocks[3:]:
                h = block(h)
        t = self.transform(h) + torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(1, -1)
        return t.reshape(-1, self.k, self.k)


class PointNetPartSeg(nn.Module):
    """Returns per-point log-softmax scores [B, N, num_part]."""

    def __init__(self, num_part=50, num_categories=16):
        super().__init__()
        self.stn = STNkd(3)
        self.conv1 = conv_bn_relu(3, 64)
        self.conv2 = conv_bn_relu(64, 128)
        self.conv3 = conv_bn_relu(128, 128)
        self.fstn = STNkd(128)
        self.conv4 = conv_bn_relu(128, 512)
        self.conv5 = zero_bias_linear(512, 2048)
        self.bn5 = BatchNorm(2048)
        head_in = 2048 + num_categories + 64 + 128 + 128 + 512 + 2048
        self.convs1 = conv_bn_relu(head_in, 256)
        self.convs2 = conv_bn_relu(256, 256)
        self.convs3 = conv_bn_relu(256, 128)
        self.convs4 = zero_bias_linear(128, num_part)

    def forward(self, points, label, idx_override=None, generator=None):
        """points [B, N, 3], label [B, num_categories] -> [B, N, num_part].
        idx_override and generator are unused: no graph, no dropout."""
        B, N, _ = points.shape
        x = torch.bmm(points, self.stn(points))
        out1 = self.conv1(x)
        out2 = self.conv2(out1)
        out3 = self.conv3(out2)
        out4 = self.conv4(torch.bmm(out3, self.fstn(out3)))
        out5 = self.bn5(self.conv5(out4))
        out_max = torch.cat([max_over_points(out5), label], dim=-1)  # [B, 2048 + categories]
        expand = out_max[:, None, :].expand(B, N, -1)
        concat = torch.cat([expand, out1, out2, out3, out4, out5], dim=-1)  # [B, N, 4944]
        net = self.convs4(self.convs3(self.convs2(self.convs1(concat))))
        return torch.log_softmax(net, dim=-1)
