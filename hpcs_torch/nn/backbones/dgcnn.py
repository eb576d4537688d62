"""Plain (scalar) DGCNN part-segmentation backbone.

A learned 3x3 input alignment (TransformNet, the identity at
initialisation), three scalar EdgeConv stages (Linear without bias ->
BatchNorm -> LeakyReLU 0.2, then the max over the K neighbours), a
1024-channel global feature and the 1280-channel head.  Features are
channel-last: [B, N, C] per point, [B, N, K, C] per edge.  Module names
follow the JAX package's (conv1..conv11, transform_net); each block is
Sequential(Linear, BatchNorm, LeakyReLU) (`nn.vn.layers.dense_block`).

The four kNN graphs (on the points, on the aligned points and on the
64-channel features of stages 1 and 2) come from `vn_dgcnn.knn_graph`:
kernel B1 on the GPU, on the detached features.  The stages are plain
PyTorch in training and in eval, as in the JAX package.
"""
import torch
from torch import nn

from ...ops.edgeconv import graph_feature_scalar
from ..vn.layers import dense_block
from .vn_dgcnn import dropout, knn_graph


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
        x = self.conv3(x).amax(dim=1)  # over N -> [B, 1024]
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
        B, N, _ = points.shape

        def edges(i, x):
            return graph_feature_scalar(x, self.k, knn_graph(x, self.k, idx_override, i))[0]

        t = self.transform_net(edges(0, points))
        x = torch.bmm(points, t)
        x1 = self.conv2(self.conv1(edges(1, x))).amax(dim=2)  # [B, N, 64]
        x2 = self.conv4(self.conv3(edges(2, x1))).amax(dim=2)
        x3 = self.conv5(edges(3, x2)).amax(dim=2)
        x123 = torch.cat([x1, x2, x3], dim=-1)  # [B, N, 192]
        x_global = self.conv6(x123).amax(dim=1)  # [B, 1024]
        l = self.conv7(label)  # [B, 64]
        fused = torch.cat([x_global, l], dim=-1)[:, None, :].expand(B, N, -1)
        h = torch.cat([fused, x123], dim=-1)  # [B, N, 1280]
        p = self.dropout if self.training else 0.0
        if p and generator is None:
            raise ValueError("the training forward draws dropout masks: pass a generator")
        h = dropout(self.conv8(h), p, generator)
        h = dropout(self.conv9(h), p, generator)
        return self.conv11(self.conv10(h))
