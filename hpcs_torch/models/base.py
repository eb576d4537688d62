"""The HypHC network, its eval-mode entry point and its test step.

Parameter names follow the reference Lightning module (`nn_feat.*` for the
backbone, `nn_emb.*` for the embedder, `scale`, and
`metric_hyp_loss.loss_cosface.W`), so its checkpoints load directly.
"""
import math

import torch
from torch import nn

from ..decode import cosine_distance_matrix, get_optimal_k, linkage_from_distances_mnn
from ..device import resolve_device
from ..geometry import project
from ..loss.hyphc import normalize_to_radius
from ..nn.backbones.vn_dgcnn import VNDGCNNPartSeg
from ..nn.embed import make_embedder
from ..utils.rotations import augment
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


def decode_vector_for_batch(cfg: ModelConfig, batch):
    """The backbone head's conditioning vector [B, ...] (float32).

    batch: a dict with "points" [B, N, 3] and, as the mode needs them,
    "labels" [B, N] or "category" [B] (arrays or tensors).  PartNet without
    class_vector: a constant [B, 1] of ones.  class_vector: the object's
    part-presence vector [B, num_class].  Otherwise ShapeNet's one-hot
    category [B, num_categories].
    """
    points = batch["points"]
    device = points.device if torch.is_tensor(points) else None
    if cfg.dataset == "partnet" and not cfg.class_vector:
        return torch.ones((points.shape[0], 1), dtype=torch.float32, device=device)
    if cfg.class_vector:
        labels = torch.as_tensor(batch["labels"], dtype=torch.int64, device=device)
        presence = torch.zeros((labels.shape[0], cfg.num_class), dtype=torch.float32,
                               device=labels.device)
        return presence.scatter_(1, labels, 1.0)
    category = torch.as_tensor(batch["category"], dtype=torch.int64, device=device)
    return nn.functional.one_hot(category, cfg.num_categories).to(torch.float32)


def decode_batch(x_poincare, labels, scale, num_class):
    """Decode each object of a batch: its points on the sphere of radius
    `scale` in the ball, their cosine distances, complete linkage by MNN
    rounds, and the best flat cut against the labels (IoU, k = 1 .. C + 4).

    x_poincare [B, N, F], labels [B, N] (< num_class).  Returns (pred [B, N],
    best_k [B], best_score [B], linkage Z [B, N-1, 4]).
    """
    leaves = project(normalize_to_radius(x_poincare, scale))
    Z = linkage_from_distances_mnn(cosine_distance_matrix(leaves), method="complete")
    pred, best_k, best_score = get_optimal_k(labels, Z, num_class=num_class, index="iou")
    return pred, best_k, best_score, Z


class HypHCSystem:
    """The model on its device, with the eval-mode entry points `embed` and
    `test_step`."""

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

    @torch.no_grad()
    def test_step(self, batch, generator):
        """The decode pass over one batch: rotate by `cfg.test_rotation`
        (drawn from `generator`, a torch.Generator), embed, and decode each
        object (`decode_batch`).

        batch: a dict with "points" [B, N, 3], "labels" [B, N] and, for
        ShapeNet, "category" [B].  Returns (logs, extras): logs {"score":
        the mean best score}, extras the per-object "pred", "best_k",
        "best_score", "linkage" and the "x_poincare" and "x_euclidean"
        embeddings, all on the system's device.  The reference's test_step
        also logs its losses; those come with the training slice's
        `compute_losses`.
        """
        points = torch.as_tensor(batch["points"], dtype=torch.float32, device=self.device)
        points = augment(generator, points, self.cfg.test_rotation)
        x_e, x_p = self.embed(points, decode_vector_for_batch(self.cfg, batch))
        labels = torch.as_tensor(batch["labels"], dtype=torch.int64, device=self.device)
        pred, best_k, best_score, Z = decode_batch(x_p, labels, self.net.scale[0],
                                                   self.cfg.num_class)
        logs = {"score": best_score.mean()}
        return logs, {"pred": pred, "best_k": best_k, "best_score": best_score, "linkage": Z,
                      "x_poincare": x_p, "x_euclidean": x_e}
