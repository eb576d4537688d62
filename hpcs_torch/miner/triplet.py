"""Fixed-shape balanced random triplet mining.

T = t_per_anchor * M triplets (or num_triplets) are drawn at once, with a
validity mask in place of dropping triplets, so no shape depends on the
data:
- an anchor's label is drawn with weight n_l (max_l n_l / n_l)^fraction, so
  an element's expected share of anchors goes as (max / n_label)^fraction
  (zero for labels with fewer than 2 members or no negatives), then a
  uniform member of that label;
- positives and negatives are exactly uniform by the label-sorted segment
  trick: a uniform draw from [0, n_l - 1) shifted past the anchor's rank is
  uniform over the other members, one from [0, M - n_l) shifted past the
  label's segment is uniform over the other labels' elements.

Every draw comes from the caller's torch.Generator, on its device; the
triplets are returned on the labels' device.  A draw below a per-triplet
bound is floor(u * bound) of a uniform float64 u, clipped to bound - 1.
"""
from typing import NamedTuple

import torch

from ..geometry.math_ops import l2_normalize


class Triplets(NamedTuple):
    anchor: torch.Tensor  # [T] int64
    positive: torch.Tensor  # [T] int64
    negative: torch.Tensor  # [T] int64
    mask: torch.Tensor  # [T] float32, 1 for valid triplets


def cosine_similarity01(x, y=None):
    """Similarity rescaled to [0, 1]: 0.5 (1 + cos(x, y)) over the last axis."""
    xn = l2_normalize(x)
    yn = xn if y is None else l2_normalize(y)
    return 0.5 * (1.0 + torch.sum(xn * yn, dim=-1))


def pairwise_cosine_similarity01(x):
    """[M, M] matrix of cosine_similarity01 between the rows of x [M, F]."""
    xn = l2_normalize(x)
    return 0.5 * (1.0 + xn @ xn.T)


def _uniforms(generator, rows, T, device):
    u = torch.rand((rows, T), generator=generator, device=generator.device, dtype=torch.float64)
    return u.to(device)


def _below(u, bound):
    """floor(u * bound) in [0, bound - 1], per element (bound >= 1)."""
    return torch.minimum(torch.floor(u * bound).long(), bound - 1)


def sample_balanced_triplets(generator, labels, num_classes, t_per_anchor=50, fraction=1.2,
                             num_triplets=None):
    """T class-balanced random triplets with a validity mask.

    labels: [M] integers in [0, num_classes).  Returns Triplets of length
    T = num_triplets, or t_per_anchor * M.
    """
    labels = labels.long()
    M = labels.shape[0]
    T = num_triplets if num_triplets is not None else t_per_anchor * M
    u = _uniforms(generator, 4, T, labels.device)

    counts = torch.bincount(labels, minlength=num_classes)[:num_classes]  # [L]
    n_i = counts[labels]
    valid_elem = (n_i >= 2) & ((M - n_i) >= 1)

    counts_d = counts.double()
    label_valid = (counts >= 2) & ((M - counts) >= 1)
    weight = counts_d * (counts_d.max().clamp(min=1.0) / counts_d.clamp(min=1.0)) ** fraction
    cdf = torch.cumsum(torch.where(label_valid, weight, 0.0), 0)
    a_lab = torch.searchsorted(cdf, u[0] * cdf[-1], right=True).clamp(max=num_classes - 1)

    order = torch.argsort(labels, stable=True)
    seg_start = torch.cumsum(counts, 0) - counts
    a_cnt, a_seg = counts[a_lab], seg_start[a_lab]
    a_pos = _below(u[1], a_cnt.clamp(min=1))
    anchors = order[(a_seg + a_pos).clamp(0, M - 1)]

    j = _below(u[2], (a_cnt - 1).clamp(min=1))
    j = torch.where(j >= a_pos, j + 1, j)
    positive = order[(a_seg + j).clamp(0, M - 1)]

    m = _below(u[3], (M - a_cnt).clamp(min=1))
    m = torch.where(m >= a_seg, m + a_cnt, m)
    negative = order[m.clamp(0, M - 1)]

    mask = (valid_elem[anchors] & valid_elem.any()).float()
    return Triplets(anchors, positive, negative, mask)


def margin_filter(embeddings, triplets, margin=0.0, type_of_triplets="easy"):
    """The miner's margin filter as a mask multiplier.

    With tm = sim(a, p) - sim(a, n): 'easy' keeps tm > margin, 'semihard'
    0 < tm <= margin, 'hard' tm <= min(margin, 0), 'all' tm <= margin.
    """
    a = embeddings[triplets.anchor]
    tm = (cosine_similarity01(a, embeddings[triplets.positive])
          - cosine_similarity01(a, embeddings[triplets.negative]))
    if type_of_triplets == "easy":
        keep = tm > margin
    elif type_of_triplets == "semihard":
        keep = (tm <= margin) & (tm > 0)
    elif type_of_triplets == "hard":
        keep = (tm <= margin) & (tm <= 0)
    else:
        keep = tm <= margin
    return triplets._replace(mask=triplets.mask * keep.float())


def sample_random_triplets(generator, num_samples, t_per_anchor, num_triplets=None):
    """Unmined uniform triplets (i, j, k) with i != j exactly and the triplets
    where k meets i or j masked.  Returned on the generator's device."""
    M = num_samples
    T = num_triplets if num_triplets is not None else t_per_anchor * M
    kw = dict(generator=generator, device=generator.device)
    i = torch.randint(0, M, (T,), **kw)
    j = torch.randint(0, M - 1, (T,), **kw)
    j = torch.where(j >= i, j + 1, j)
    k = torch.randint(0, M, (T,), **kw)
    return Triplets(i, j, k, ((k != i) & (k != j)).float())
