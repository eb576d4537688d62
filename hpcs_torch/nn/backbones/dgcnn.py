"""Plain (scalar) DGCNN part-segmentation backbone.

A learned 3x3 input alignment (TransformNet, the identity at
initialisation), three scalar EdgeConv stages (Linear without bias ->
BatchNorm -> LeakyReLU 0.2, then the max over the K neighbours), a
1024-channel global feature and the 1280-channel head.  Features are
channel-last: [B, N, C] per point, [B, N, K, C] per edge.  Module names
follow the JAX package's (conv1..conv11, transform_net); each block is
Sequential(Linear, BatchNorm, LeakyReLU) (`nn.vn.layers.dense_block`).

The four kNN graphs (on the points, on the aligned points and on the
64-channel features of stages 1 and 2) come from `vn_dgcnn.neighbours`:
kernel B1 on the GPU, on the detached features.  The stages are plain
PyTorch in training and in eval, as in the JAX package.

In a point-sharded call (hpcs_torch.nn.point_shard) the graphs cover this
rank's rows of the gathered features, the two maxima over the points
(TransformNet's and conv6's) are the whole cloud's, the blocks on
per-cloud tensors (TransformNet's after its pool, conv7) run under
`point_shard.per_cloud`, and the dropout masks are drawn whole.
"""
import torch
from torch import nn

from ...ops.edgeconv import graph_feature_scalar
from .. import point_shard
from ..vn.layers import dense_block
from .vn_dgcnn import dropout, neighbours


def _block(in_features, out_features):
    return dense_block(in_features, out_features, activation=nn.LeakyReLU(0.2))


class TransformNet(nn.Module):
    """Learned 3x3 input alignment from the edge features [B, N, K, 6]."""

    def __init__(self):
        super().__init__()
        self.conv1 = _block(6, 64)
        self.conv2 = _block(64, 128)
        self.conv3 = _block(128, 1024)
        self.linear1 = _block(1024, 512)
        self.linear2 = _block(512, 256)
        self.transform = nn.Linear(256, 9)
        # the identity at initialisation: init_parameters keeps it
        self.transform.keeps_init = True
        with torch.no_grad():
            self.transform.weight.zero_()
            self.transform.bias.copy_(torch.eye(3).reshape(9))

    def forward(self, edge_feat):
        x = self.conv2(self.conv1(edge_feat)).amax(dim=2)  # over K -> [B, N, 128]
        x = point_shard.max_over_points(self.conv3(x))  # over N -> [B, 1024]
        with point_shard.per_cloud():
            return self.transform(self.linear2(self.linear1(x))).reshape(-1, 3, 3)


class DGCNNPartSeg(nn.Module):
    """Scalar DGCNN returning per-point features [B, N, out_features]."""

    def __init__(self, out_features, k=20, num_categories=16, dropout=0.5):
        super().__init__()
        self.k = k
        self.dropout = dropout
        self.transform_net = TransformNet()
        self.conv1 = _block(6, 64)
        self.conv2 = _block(64, 64)
        self.conv3 = _block(128, 64)
        self.conv4 = _block(64, 64)
        self.conv5 = _block(128, 64)
        self.conv6 = _block(192, 1024)
        self.conv7 = _block(num_categories, 64)
        self.conv8 = _block(1280, 256)
        self.conv9 = _block(256, 256)
        self.conv10 = _block(256, 128)
        self.conv11 = nn.Linear(128, out_features, bias=False)

    def forward(self, points, label, idx_override=None, generator=None):
        """points [B, N, 3], label [B, num_categories] -> features [B, N, F].

        idx_override: optional four kNN graphs [B, N, k] int32 (points,
        aligned points, stage-1 and stage-2 features).  generator: draws
        the dropout masks after conv8 and conv9 (training with dropout > 0).
        """
        shard = point_shard.current()
        B, N, _ = points.shape

        def edges(i, x):
            idx, table, _ = neighbours(x, self.k, idx_override, i)
            return graph_feature_scalar(x, self.k, idx, table=table)[0]

        t = self.transform_net(edges(0, points))
        x = torch.bmm(points, t)
        x1 = self.conv2(self.conv1(edges(1, x))).amax(dim=2)  # [B, N, 64]
        x2 = self.conv4(self.conv3(edges(2, x1))).amax(dim=2)
        x3 = self.conv5(edges(3, x2)).amax(dim=2)
        x123 = torch.cat([x1, x2, x3], dim=-1)  # [B, N, 192]
        x_global = point_shard.max_over_points(self.conv6(x123))  # [B, 1024]
        with point_shard.per_cloud():
            l = self.conv7(label)  # [B, 64]
        fused = torch.cat([x_global, l], dim=-1)[:, None, :].expand(B, N, -1)
        h = torch.cat([fused, x123], dim=-1)  # [B, N, 1280]
        p = self.dropout if self.training else 0.0
        if p and generator is None:
            raise ValueError("the training forward draws dropout masks: pass a generator")
        drop = dropout if shard is None else lambda x, p, g: shard.dropout(x, p, g, point_dim=1)
        h = drop(self.conv8(h), p, generator)
        h = drop(self.conv9(h), p, generator)
        return self.conv11(self.conv10(h))
