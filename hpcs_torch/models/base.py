"""The HypHC network and its system: the eval forward, the training step,
validation and the test step.

Parameter names follow the reference Lightning module (`nn_feat.*` for the
backbone, `nn_emb.*` for the embedder, `scale`, and
`metric_hyp_loss.loss_cosface.W`), so its checkpoints load directly.
"""
import copy
import math

import torch
from torch import nn

from ..decode import (cosine_distance_matrix, decode_leaves, get_optimal_k,
                      linkage_from_distances_mnn)
from ..device import resolve_device
from ..loss import LossConfig, compute_losses, get_logits, hierarchy_sum_matrices
from ..loss.hyphc import anneal_temperature
from ..nn.backbones import make_backbone
from ..nn import point_shard
from ..nn.embed import make_embedder
from ..optim import FusedRiemannianAdam, plateau_init, plateau_update
from ..utils.jax_params import ball_dim
from ..utils.metrics import accuracy_top1, multiclass_jaccard
from ..utils.profiling import spanned
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
    [hyp_dim, num_class]; the losses use them, the forward does not.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.nn_feat = make_backbone(cfg)
        self.nn_emb = make_embedder(cfg.eucl_dim, cfg.hyp_dim)
        self.scale = nn.Parameter(torch.full((1,), 1e-3))
        self.metric_hyp_loss = nn.ModuleDict(
            {"loss_cosface": _CosFaceWeights(cfg.hyp_dim, cfg.num_class)})

    def forward(self, points, decode_vector, idx_override=None, generator=None):
        """Returns (x_euclidean [B, N, eucl_dim], x_poincare [B, N, hyp_dim]).
        `generator` draws the training forward's dropout masks."""
        x_euclidean = self.nn_feat(points, decode_vector, idx_override, generator)
        return x_euclidean, self.nn_emb(x_euclidean)


@torch.no_grad()
def init_parameters(net, generator):
    """Random weights from `generator` (a CPU torch.Generator).

    Matrices get N(0, 1/fan_in), the CosFace weights N(0, 1); vectors keep
    what their modules gave them: BatchNorm weight 1, bias 0 and its running
    statistics (mean 0, variance 1), Linear biases 0.  A module marked
    `keeps_init` (DGCNN's identity TransformNet head) keeps its own.
    """
    kept = {id(p) for m in net.modules() if getattr(m, "keeps_init", False)
            for p in m.parameters()}
    for name, p in net.named_parameters():
        if id(p) in kept:
            continue
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


@spanned("decode")
def decode_batch(x_poincare, labels, scale, num_class):
    """Decode each object of a batch: its points on the sphere of radius
    `scale` in the ball, their cosine distances, complete linkage by MNN
    rounds, and the best flat cut against the labels (IoU, k = 1 .. C + 4).

    x_poincare [B, N, F], labels [B, N] (< num_class).  Returns (pred [B, N],
    best_k [B], best_score [B], linkage Z [B, N-1, 4]).
    """
    Z = linkage_from_distances_mnn(cosine_distance_matrix(decode_leaves(x_poincare, scale)),
                                   method="complete")
    pred, best_k, best_score = get_optimal_k(labels, Z, num_class=num_class, index="iou")
    return pred, best_k, best_score, Z


def _refuse_unported(cfg):
    """Raise NotImplementedError, naming the ROADMAP item, for a
    configuration whose path the port does not have yet."""
    if cfg.layout != "cv":
        raise NotImplementedError(f"layout {cfg.layout!r}: the 'vc' layout is the JAX "
                                  "package's TPU layout; the port computes in 'cv'")


class HypHCSystem:
    """The model on its device, with its optimizer and schedules.

    Entry points: `embed` (eval forward), `train_step`, `eval_step`,
    `test_step`, and the epoch hooks `epoch_end` / `set_learning_rate`.
    The system owns its state: the net's parameters and BatchNorm
    statistics, the Riemannian Adam moments (`optimizer`, the packed form
    `FusedRiemannianAdam`, as the JAX package's system), the step count,
    the plateau schedule and the temperature.

    In a point-sharded call (hpcs_torch.nn.point_shard.current(), a
    hpcs_torch.parallel.point_parallel.PointShard) a batch holds this
    rank's points only, the rotations are drawn for the whole batch, the
    class_vector decode vector covers every rank's labels, and the losses
    see every rank's embeddings.
    """

    def __init__(self, cfg: ModelConfig, device=None, generator=None):
        _refuse_unported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        net = HypHCNet(cfg)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_parameters(net, generator)
        self.net = net.to(self.device).eval()
        self.loss_cfg = LossConfig(
            num_class=cfg.num_class, embedding_size=cfg.hyp_dim, margin=cfg.margin,
            t_per_anchor=cfg.t_per_anchor, fraction=cfg.fraction, cosface=cfg.cosface,
            miner=cfg.miner, hierarchical=cfg.use_hierarchical, num_triplets=cfg.num_triplets)
        self.hierarchy_matrices = (
            hierarchy_sum_matrices(cfg.hierarchy_list, cfg.num_class, device=self.device)
            if cfg.use_hierarchical else None)
        groups = {0: [], -1: []}
        for name, p in self.net.named_parameters():
            groups[ball_dim(name, p)].append(p)
        self.optimizer = FusedRiemannianAdam(
            [{"params": ps, "ball_dim": d} for d, ps in groups.items() if ps], lr=cfg.lr)
        self.step = 0
        self.plateau = plateau_init(cfg.lr)
        self.temperature = cfg.temperature

    def _inputs(self, batch, generator, rotation):
        points = torch.as_tensor(batch["points"], dtype=torch.float32, device=self.device)
        shard = point_shard.current()
        rotate = augment if shard is None else shard.augment
        points = rotate(generator, points, rotation).contiguous()
        dv = (torch.as_tensor(decode_vector_for_batch(self.cfg, batch), dtype=torch.float32,
                              device=self.device) if shard is None
              else shard.decode_vector(self.cfg, batch, self.device))
        labels = torch.as_tensor(batch["labels"], dtype=torch.int64, device=self.device)
        return points, dv, labels

    def _losses_and_metrics(self, generator, x_poincare, labels):
        flat = x_poincare.reshape(-1, x_poincare.shape[-1])
        labels_flat = labels.reshape(-1)
        W = self.net.metric_hyp_loss["loss_cosface"].W
        losses = compute_losses(generator, self.loss_cfg, flat, labels_flat, self.net.scale[0],
                                self.temperature, hierarchy_matrices=self.hierarchy_matrices,
                                cosface_W=W)
        out = {"loss_metric": losses["loss_metric"],
               "loss_hyp": losses["loss_hyp"] * self.cfg.trade_off}
        metrics = {}
        if self.cfg.cosface or self.cfg.use_hierarchical:
            with torch.no_grad():
                logits = get_logits(self.loss_cfg, W, flat, labels_flat)
                metrics["acc"] = accuracy_top1(logits, labels_flat)
                metrics["iou"] = multiclass_jaccard(logits, labels_flat, self.cfg.num_class)
        return out, metrics

    @torch.no_grad()
    @spanned("embed")
    def embed(self, points, decode_vector, idx_override=None):
        """Per-point embeddings of a batch of clouds, by the eval forward.

        points [B, N, 3], decode_vector [B, num_categories] (arrays or
        tensors).  Returns (x_euclidean [B, N, eucl_dim], x_poincare
        [B, N, hyp_dim]) on the system's device.
        """
        self.net.eval()
        points = torch.as_tensor(points, dtype=torch.float32, device=self.device).contiguous()
        dv = torch.as_tensor(decode_vector, dtype=torch.float32, device=self.device)
        return self.net(points, dv, idx_override)

    def grads_and_logs(self, batch, generator):
        """The training forward, the losses and their gradients (in the
        parameters' .grad) for one batch; returns the step's logs.

        Draws from `generator` (a torch.Generator): the `cfg.train_rotation`
        rotation, the dropout masks, then the triplets.
        """
        self.net.train()
        points, dv, labels = self._inputs(batch, generator, self.cfg.train_rotation)
        self.optimizer.zero_grad(set_to_none=True)
        _, x_p = self.net(points, dv, generator=generator)
        shard = point_shard.current()
        if shard is not None:
            x_p, labels = shard.whole_batch(x_p, labels)
        losses, metrics = self._losses_and_metrics(generator, x_p, labels)
        total = losses["loss_metric"] + losses["loss_hyp"]
        total.backward()
        return {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()},
                **metrics, "scale": self.net.scale[0].detach().clone()}

    def apply_gradients(self):
        """One Riemannian Adam step on the gradients in .grad."""
        self.optimizer.step()
        self.step += 1

    @spanned("train_step")
    def train_step(self, batch, generator):
        """One training step on `batch` (a dict with "points" [B, N, 3],
        "labels" [B, N] and, for ShapeNet, "category" [B]): the gradients
        (`grads_and_logs`), then the update.  Returns the logs
        {"total_loss", "loss_metric", "loss_hyp" (times trade_off), "acc",
        "iou", "scale" (before the update)} as device scalars."""
        logs = self.grads_and_logs(batch, generator)
        self.apply_gradients()
        return logs

    @torch.no_grad()
    @spanned("eval_step")
    def eval_step(self, batch, generator):
        """Validation: the eval forward on the batch rotated by
        `cfg.train_rotation` (as the reference's validation does), then the
        losses.  Returns {"val_loss", "acc", "iou"}."""
        points, dv, labels = self._inputs(batch, generator, self.cfg.train_rotation)
        _, x_p = self.embed(points, dv)
        losses, metrics = self._losses_and_metrics(generator, x_p, labels)
        return {"val_loss": losses["loss_metric"] + losses["loss_hyp"], **metrics}

    @torch.no_grad()
    @spanned("test_step")
    def test_step(self, batch, generator):
        """The test pass over one batch: rotate by `cfg.test_rotation`
        (drawn from `generator`, a torch.Generator), embed, the losses, and
        decode each object (`decode_batch`).

        batch: a dict with "points" [B, N, 3], "labels" [B, N] and, for
        ShapeNet, "category" [B].  Returns (logs, extras): logs
        {"test_loss", "score" (the mean best score), "test_acc",
        "test_iou"}, extras the per-object "pred", "best_k", "best_score",
        "linkage" and the "x_poincare" and "x_euclidean" embeddings, all on
        the system's device.
        """
        points, dv, labels = self._inputs(batch, generator, self.cfg.test_rotation)
        x_e, x_p = self.embed(points, dv)
        losses, metrics = self._losses_and_metrics(generator, x_p, labels)
        pred, best_k, best_score, Z = decode_batch(x_p, labels, self.net.scale[0],
                                                   self.cfg.num_class)
        logs = {"test_loss": losses["loss_metric"] + losses["loss_hyp"],
                "score": best_score.mean(), **{f"test_{k}": v for k, v in metrics.items()}}
        return logs, {"pred": pred, "best_k": best_k, "best_score": best_score, "linkage": Z,
                      "x_poincare": x_p, "x_euclidean": x_e}

    def epoch_end(self, epoch, val_loss):
        """The epoch's schedules: the plateau LR on val_loss, and the
        temperature annealed every `cfg.anneal_step` epochs.  Returns the
        learning rate for the next epoch."""
        self.plateau = plateau_update(self.plateau, val_loss)
        if epoch and self.cfg.anneal_step > 0 and epoch % self.cfg.anneal_step == 0:
            self.temperature = anneal_temperature(self.temperature, self.cfg.anneal_factor)
        return self.plateau.lr

    def set_learning_rate(self, lr):
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def state_dict(self):
        """A copy of the trained state: the net, the optimizer and the step."""
        return copy.deepcopy({"net": self.net.state_dict(),
                              "optimizer": self.optimizer.state_dict(), "step": self.step})

    def load_state_dict(self, state):
        self.net.load_state_dict(state["net"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = state["step"]
