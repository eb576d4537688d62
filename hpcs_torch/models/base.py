"""The HypHC network and its eval-mode entry point.

Parameter names follow the reference Lightning module (`nn_feat.*` for the
backbone, `nn_emb.*` for the embedder, `scale`, and
`metric_hyp_loss.loss_cosface.W`), so its checkpoints load directly.
"""
import math

import torch
from torch import nn

from ..device import resolve_device
from ..nn.backbones.vn_dgcnn import VNDGCNNPartSeg
from ..nn.embed import make_embedder
from .config import ModelConfig


class _CosFaceWeights(nn.Module):
    def __init__(self, hyp_dim, num_class):
        super().__init__()
        self.W = nn.Parameter(torch.empty(hyp_dim, num_class))


class HypHCNet(nn.Module):
    """Backbone + ball embedder + the learnable loss parameters.

    `scale` is the learnable radius [1] (initialised to 1e-3) and
    `metric_hyp_loss.loss_cosface.W` the CosFace class weights
    [hyp_dim, num_class]; the eval forward does not use them.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.nn_feat = VNDGCNNPartSeg(cfg.eucl_dim, k=cfg.k,
                                      num_categories=cfg.num_categories, pooling=cfg.pooling)
        self.nn_emb = make_embedder(cfg.eucl_dim, cfg.hyp_dim)
        self.scale = nn.Parameter(torch.full((1,), 1e-3))
        self.metric_hyp_loss = nn.ModuleDict(
            {"loss_cosface": _CosFaceWeights(cfg.hyp_dim, cfg.num_class)})

    def forward(self, points, decode_vector, idx_override=None):
        """Returns (x_euclidean [B, N, eucl_dim], x_poincare [B, N, hyp_dim])."""
        x_euclidean = self.nn_feat(points, decode_vector, idx_override)
        return x_euclidean, self.nn_emb(x_euclidean)


@torch.no_grad()
def init_parameters(net, generator):
    """Random weights from `generator` (a CPU torch.Generator).

    Matrices get N(0, 1/fan_in), the CosFace weights N(0, 1); BatchNorm keeps
    weight 1, bias 0 and its running statistics (mean 0, variance 1).
    """
    for name, p in net.named_parameters():
        if name.endswith("loss_cosface.W"):
            p.copy_(torch.randn(p.shape, generator=generator))
        elif p.dim() >= 2:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))


def decode_vector_for_batch(cfg: ModelConfig, category):
    """The backbone head's conditioning vector: the one-hot object category
    [B, num_categories] of ShapeNet, from category ids [B]."""
    category = torch.as_tensor(category, dtype=torch.int64)
    return nn.functional.one_hot(category, cfg.num_categories).to(torch.float32)


class HypHCSystem:
    """The model on its device, with the eval-mode entry point `embed`."""

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        net = HypHCNet(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(net, generator)
        self.net = net.to(self.device).eval()

    @torch.no_grad()
    def embed(self, points, decode_vector, idx_override=None):
        """Per-point embeddings of a batch of clouds.

        points [B, N, 3], decode_vector [B, num_categories] (arrays or
        tensors).  Returns (x_euclidean [B, N, eucl_dim], x_poincare
        [B, N, hyp_dim]) on the system's device.
        """
        points = torch.as_tensor(points, dtype=torch.float32, device=self.device).contiguous()
        dv = torch.as_tensor(decode_vector, dtype=torch.float32, device=self.device)
        return self.net(points, dv, idx_override)
