"""VN-DGCNN part-segmentation backbone.

Channel geometry: 64 // 3 = 21 vector channels per EdgeConv stage, 63 after
the three stages, 1024 // 3 = 341 global channels, doubled to 682 by the
global-mean concat, and 2046 + 64 + 189 = 2299 head inputs.  Module names
follow the reference's state_dict (conv1..conv6, std_feature, conv7..conv11
as Sequential(Conv1d, BatchNorm[, LeakyReLU])).

Each EdgeConv stage starts from a kNN graph (`ops.knn.knn`, kernel B1 on the
GPU, built on the detached features: no gradient flows through the graph).
In eval mode with mean pooling the stage is one fused call
(`ops.edgeconv.edgeconv_infer`, kernel B2 on the GPU) with BatchNorm folded
into the gate.  Otherwise, in training and with pooling='max' (B2
mean-pools only), the stage is the plain stage, as in the JAX package: the
edge features (`graph_feature_vn`), the VNLinearLeakyReLU modules (batch
statistics in training, running ones in eval), and the mean over the
neighbours or VNMaxPool (`pool1`..`pool3`, max pooling only).  B2 is
eval-only in both packages.

With compute_dtype=torch.bfloat16 (ModelConfig.bf16) the backbone computes
as the JAX package's does with compute_dtype bfloat16: the points are cast
to bf16 first, so stage 1's graph is built on bf16 coordinates; the VN
layers follow their bf16 rules (nn.vn.layers); B1 and B2 read bf16
features (B2 with bf16-rounded weights, fp32 inside, its output rounded to
bf16); the head's conv7-conv10 multiply in bf16 with an fp32 BatchNorm and
round each block's output to bf16; conv11 and the output are fp32 (the
input's dtype).  The parameters stay fp32.

In a point-sharded call (hpcs_torch.nn.point_shard.current(), a
hpcs_torch.parallel.point_parallel.PointShard) this rank holds some of the
points of some of the clouds, and the EdgeConv stages, the mean and max
over the points, the batch statistics and the dropout masks go through the
shard.  Without one the forward is the single-device one.
"""
import contextlib

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.edgeconv import edgeconv_infer, fold_bn, graph_feature_vn
from ...ops.knn import knn
from ...ops.vn_math import upcast
from .. import point_shard
from ..vn.layers import (BatchNorm, VNLinearLeakyReLU, VNMaxPool, VNStdFeature, invariant_project,
                         mean_pool)

EDGE_CHANNELS = 64 // 3
GLOBAL_CHANNELS = 1024 // 3


class _HeadBlock(nn.Sequential):
    """Conv1d -> BatchNorm [-> LeakyReLU] on h [B, C, N]: the Conv1d in
    `dtype` (the weight cast to it), the BatchNorm and activation in at
    least fp32, the output in `dtype` (the JAX package's _ScalarConvBNRelu
    with dtype)."""

    def forward(self, h, dtype):
        y = upcast(F.conv1d(h.to(dtype), self[0].weight.to(dtype)))
        for layer in list(self)[1:]:
            y = layer(y)
        return y.to(dtype)


def _head_block(in_features, out_features, relu=True):
    layers = [nn.Conv1d(in_features, out_features, kernel_size=1, bias=False),
              BatchNorm(out_features, channel_dim=1)]
    if relu:
        layers.append(nn.LeakyReLU(0.2))
    return _HeadBlock(*layers)


def stage_weights(*convs):
    """(W, Wd, folded BN) of each VNLinearLeakyReLU of one EdgeConv stage."""
    out = []
    for conv in convs:
        bn = conv.batchnorm.bn
        out += [conv.map_to_feat.weight, conv.map_to_dir.weight,
                fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)]
    return out


def knn_graph(metric, k, idx_override=None, i=0):
    """Stage i's kNN graph [B, N, k] int32: idx_override[i] when given, else
    `knn` (kernel B1 on the GPU) on the detached metric [B, N, ...]
    flattened to [B, N, D].  Every backbone builds its graphs here."""
    if idx_override is not None:
        return idx_override[i]
    B, N = metric.shape[:2]
    return knn(metric.detach().reshape(B, N, -1).contiguous(), k)


def dropout(x, p, generator):
    """Keep each entry with probability 1 - p and scale it by 1 / (1 - p);
    the mask is drawn from `generator`, on its device."""
    if p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, 0.0)


class VNDGCNNPartSeg(nn.Module):
    """Rotation-equivariant DGCNN returning per-point features [B, N, F]."""

    def __init__(self, out_features, k=20, num_categories=16, pooling="mean", dropout=0.5,
                 compute_dtype=None):
        super().__init__()
        self.k = k
        self.pooling = pooling
        self.dropout = dropout
        self.compute_dtype = compute_dtype  # None: the points' dtype
        c = EDGE_CHANNELS
        self.conv1 = VNLinearLeakyReLU(2, c)
        self.conv2 = VNLinearLeakyReLU(c, c)
        self.conv3 = VNLinearLeakyReLU(2 * c, c)
        self.conv4 = VNLinearLeakyReLU(c, c)
        self.conv5 = VNLinearLeakyReLU(2 * c, c)
        if pooling == "max":
            self.pool1, self.pool2, self.pool3 = (VNMaxPool(c) for _ in range(3))
        self.conv6 = VNLinearLeakyReLU(3 * c, GLOBAL_CHANNELS, share_nonlinearity=True)
        self.std_feature = VNStdFeature(2 * GLOBAL_CHANNELS)
        head_in = 2 * GLOBAL_CHANNELS * 3 + 64 + 3 * c * 3
        self.conv7 = _head_block(num_categories, 64)
        self.conv8 = _head_block(head_in, 256)
        self.conv9 = _head_block(256, 256)
        self.conv10 = _head_block(256, 128)
        self.conv11 = _head_block(128, out_features, relu=False)

    def _edge_stage(self, x, idx, *convs, pool=None):
        """The plain EdgeConv stage: graph features, the convs, then `pool`
        (VNMaxPool) or the mean over the neighbours."""
        e, _ = graph_feature_vn(x, self.k, idx)
        for conv in convs:
            e = conv(e)
        return mean_pool(e) if pool is None else pool(e)

    def forward(self, points, label, idx_override=None, generator=None):
        """points [B, N, 3], label [B, num_categories] -> features [B, N, F].

        idx_override: optional three kNN graphs [B, N, k] int32, one per
        EdgeConv stage, used in place of the graphs built from the features.
        generator: the torch.Generator that draws the dropout masks after
        conv8 and conv9 (training mode with dropout > 0 only).
        """
        shard = point_shard.current()
        B, N, _ = points.shape
        out_dtype = points.dtype
        dtype = self.compute_dtype or out_dtype
        points = points.to(dtype)

        def graph(i, metric):
            return knn_graph(metric, self.k, idx_override, i)

        x = points[:, :, None, :].contiguous()
        if shard is not None:
            x1, x2, x3 = shard.edge_stages(self, x)
        elif self.training or self.pooling == "max":
            pools = (self.pool1, self.pool2, self.pool3) if self.pooling == "max" else (None,) * 3
            x1 = self._edge_stage(x, graph(0, points), self.conv1, self.conv2, pool=pools[0])
            x2 = self._edge_stage(x1, graph(1, x1), self.conv3, self.conv4, pool=pools[1])
            x3 = self._edge_stage(x2, graph(2, x2), self.conv5, pool=pools[2])
        else:
            x1 = edgeconv_infer(x, graph(0, points), *stage_weights(self.conv1, self.conv2))
            x2 = edgeconv_infer(x1, graph(1, x1), *stage_weights(self.conv3, self.conv4))
            x3 = edgeconv_infer(x2, graph(2, x2), *stage_weights(self.conv5), n_convs=1)
        x123 = torch.cat([x1, x2, x3], dim=-2)  # [B, N, 63, 3]

        x = self.conv6(x123)  # [B, N, 341, 3]
        x_mean = mean_pool(x, dim=1) if shard is None else shard.mean_over_points(x)
        x = torch.cat([x, x_mean[:, None].expand_as(x)], dim=-2)  # 682

        x_std, z0 = self.std_feature(x)
        x_std = x_std.reshape(B, N, -1)  # [B, N, 2046], channel-major
        x123_inv = invariant_project(x123, z0).reshape(B, N, -1)  # [B, N, 189]
        x_global = x_std.max(dim=1).values if shard is None else shard.max_over_points(x_std)
        with contextlib.nullcontext() if shard is None else point_shard.use(shard.objects()):
            l = self.conv7(label[:, :, None], dtype)[:, :, 0]  # [B, 64]

        fused = torch.cat([x_global, l], dim=-1)[:, None, :].expand(B, N, -1)
        h = torch.cat([fused, x123_inv], dim=-1).transpose(1, 2)  # [B, 2299, N]
        p = self.dropout if self.training else 0.0
        if p and generator is None:
            raise ValueError("the training forward draws dropout masks: pass a generator")
        drop = dropout if shard is None else shard.dropout
        h = drop(self.conv8(h, dtype), p, generator)
        h = drop(self.conv9(h, dtype), p, generator)
        h = self.conv11(self.conv10(h, dtype), out_dtype)
        return h.transpose(1, 2)
