"""VN-DGCNN part-segmentation backbone, eval-mode forward.

Channel geometry: 64 // 3 = 21 vector channels per EdgeConv stage, 63 after
the three stages, 1024 // 3 = 341 global channels, doubled to 682 by the
global-mean concat, and 2046 + 64 + 189 = 2299 head inputs.  Module names
follow the reference's state_dict (conv1..conv6, std_feature, conv7..conv11
as Sequential(Conv1d, BatchNorm1d[, LeakyReLU])).

Each EdgeConv stage is a kNN graph (`ops.knn.knn`) and one fused stage
(`ops.edgeconv.edgeconv_infer`) with BatchNorm folded into the gate: on the
GPU these are the two CUDA kernels, on the CPU their plain versions.
"""
import torch
from torch import nn

from ...ops.edgeconv import edgeconv_infer, fold_bn
from ...ops.knn import knn
from ..vn.layers import VNLinearLeakyReLU, VNStdFeature, invariant_project

EDGE_CHANNELS = 64 // 3
GLOBAL_CHANNELS = 1024 // 3


def _head_block(in_features, out_features, relu=True):
    layers = [nn.Conv1d(in_features, out_features, kernel_size=1, bias=False),
              nn.BatchNorm1d(out_features, eps=1e-5)]
    if relu:
        layers.append(nn.LeakyReLU(0.2))
    return nn.Sequential(*layers)


def stage_weights(*convs):
    """(W, Wd, folded BN) of each VNLinearLeakyReLU of one EdgeConv stage."""
    out = []
    for conv in convs:
        bn = conv.batchnorm.bn
        out += [conv.map_to_feat.weight, conv.map_to_dir.weight,
                fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)]
    return out


class VNDGCNNPartSeg(nn.Module):
    """Rotation-equivariant DGCNN returning per-point features [B, N, F]."""

    def __init__(self, out_features, k=20, num_categories=16, pooling="mean"):
        super().__init__()
        if pooling != "mean":
            raise NotImplementedError(
                "VNDGCNNPartSeg is ported for pooling='mean' only: the fused "
                "EdgeConv stage mean-pools over the neighbours")
        self.k = k
        c = EDGE_CHANNELS
        self.conv1 = VNLinearLeakyReLU(2, c)
        self.conv2 = VNLinearLeakyReLU(c, c)
        self.conv3 = VNLinearLeakyReLU(2 * c, c)
        self.conv4 = VNLinearLeakyReLU(c, c)
        self.conv5 = VNLinearLeakyReLU(2 * c, c)
        self.conv6 = VNLinearLeakyReLU(3 * c, GLOBAL_CHANNELS, share_nonlinearity=True)
        self.std_feature = VNStdFeature(2 * GLOBAL_CHANNELS)
        head_in = 2 * GLOBAL_CHANNELS * 3 + 64 + 3 * c * 3
        self.conv7 = _head_block(num_categories, 64)
        self.conv8 = _head_block(head_in, 256)
        self.conv9 = _head_block(256, 256)
        self.conv10 = _head_block(256, 128)
        self.conv11 = _head_block(128, out_features, relu=False)

    def forward(self, points, label, idx_override=None):
        """points [B, N, 3], label [B, num_categories] -> features [B, N, F].

        idx_override: optional three kNN graphs [B, N, k] int32, one per
        EdgeConv stage, used in place of the graphs built from the features.
        """
        if self.training:
            raise NotImplementedError("only the eval-mode forward is ported; call .eval()")
        B, N, _ = points.shape

        def graph(i, metric):
            if idx_override is not None:
                return idx_override[i]
            return knn(metric.reshape(B, N, -1).contiguous(), self.k)

        x = points[:, :, None, :].contiguous()
        x1 = edgeconv_infer(x, graph(0, points), *stage_weights(self.conv1, self.conv2))
        x2 = edgeconv_infer(x1, graph(1, x1), *stage_weights(self.conv3, self.conv4))
        x3 = edgeconv_infer(x2, graph(2, x2), *stage_weights(self.conv5), n_convs=1)
        x123 = torch.cat([x1, x2, x3], dim=-2)  # [B, N, 63, 3]

        x = self.conv6(x123)  # [B, N, 341, 3]
        x = torch.cat([x, x.mean(dim=1, keepdim=True).expand_as(x)], dim=-2)  # 682

        x_std, z0 = self.std_feature(x)
        x_std = x_std.reshape(B, N, -1)  # [B, N, 2046], channel-major
        x123_inv = invariant_project(x123, z0).reshape(B, N, -1)  # [B, N, 189]
        x_global = x_std.max(dim=1).values  # [B, 2046]
        l = self.conv7(label[:, :, None])[:, :, 0]  # [B, 64]

        fused = torch.cat([x_global, l], dim=-1)[:, None, :].expand(B, N, -1)
        h = torch.cat([fused, x123_inv], dim=-1).transpose(1, 2)  # [B, 2299, N]
        h = self.conv11(self.conv10(self.conv9(self.conv8(h))))
        return h.transpose(1, 2)
