"""The joint metric + hyperbolic loss, as a function of the embeddings,
the labels and a torch.Generator, driven by a static LossConfig."""
from dataclasses import dataclass
from typing import Optional

from ..miner.triplet import (
    Triplets,
    margin_filter,
    sample_balanced_triplets,
    sample_random_triplets,
)
from .cosface import cosface_logits, cosface_loss, hierarchical_cosface_loss
from .hyphc import hyphc_triplet_loss, triplet_margin_loss


@dataclass(frozen=True)
class LossConfig:
    num_class: int
    embedding_size: int
    margin: float = 1.0
    t_per_anchor: int = 50
    fraction: float = 1.2
    cosface: bool = True
    miner: bool = True
    hierarchical: bool = False
    cosface_margin: float = 0.35
    cosface_scale: float = 2.0
    num_triplets: Optional[int] = None  # triplets per step; t_per_anchor * M when None


def compute_losses(generator, cfg: LossConfig, x_poincare, labels, scale, temperature,
                   hierarchy_matrices=None, cosface_W=None):
    """{"loss_hyp", "loss_metric"} of flattened ball embeddings x_poincare
    [M, D] with labels [M]; `scale` is the learnable radius, cosface_W
    [D, L] the CosFace weights (needed unless the metric part is the
    triplet margin loss).  The caller weighs loss_hyp by its trade-off.

    The triplets are drawn from `generator`: the hyperbolic part's first
    (balanced and 'easy'-filtered at margin 0 with the miner, else uniform),
    then the triplet margin loss's ('semihard' at cfg.margin).
    """
    M = x_poincare.shape[0]
    if cfg.miner:
        trip = sample_balanced_triplets(generator, labels, cfg.num_class, cfg.t_per_anchor,
                                        cfg.fraction, num_triplets=cfg.num_triplets)
        trip = margin_filter(x_poincare, trip, margin=0.0, type_of_triplets="easy")
    else:
        trip = sample_random_triplets(generator, M, cfg.t_per_anchor, num_triplets=cfg.num_triplets)
        trip = Triplets(*(t.to(x_poincare.device) for t in trip))
    loss_hyp = hyphc_triplet_loss(x_poincare, trip, scale, temperature)

    if cfg.hierarchical:
        loss_metric = hierarchical_cosface_loss(cosface_W, x_poincare, labels, hierarchy_matrices,
                                                margin=cfg.cosface_margin, scale=cfg.cosface_scale)
    elif cfg.cosface:
        loss_metric = cosface_loss(cosface_W, x_poincare, labels, margin=cfg.cosface_margin,
                                   scale=cfg.cosface_scale)
    else:
        trip_m = sample_balanced_triplets(generator, labels, cfg.num_class, cfg.t_per_anchor,
                                          cfg.fraction, num_triplets=cfg.num_triplets)
        trip_m = margin_filter(x_poincare, trip_m, margin=cfg.margin, type_of_triplets="semihard")
        loss_metric = triplet_margin_loss(x_poincare, trip_m, cfg.margin)
    return {"loss_hyp": loss_hyp, "loss_metric": loss_metric}


def get_logits(cfg: LossConfig, cosface_W, embeddings, labels):
    """The CosFace logits the accuracy and IoU metrics read (the training
    logits, margin included)."""
    return cosface_logits(cosface_W, embeddings, labels, margin=cfg.cosface_margin,
                          scale=cfg.cosface_scale)
