"""The HypHC hyperbolic LCA triplet loss (Chami et al.'s relaxation).

Per triplet: cosine similarities (w_ij, w_ik, w_jk) of the raw embeddings;
the embeddings normalised to the learnable radius; the three pairwise LCA
depths; loss = sum(w) - <w, softmax(depths / temperature)>, mask-weighted
over the triplets, plus the mean of the full similarity matrix in closed
form: 0.5 + 0.5 |sum_i x̂_i|^2 / M^2.
"""
import numpy as np
import torch

from ..geometry import hyp_lca
from ..geometry.math_ops import l2_normalize
from ..miner.triplet import cosine_similarity01


def normalize_to_radius(embeddings, scale):
    """Place embeddings on the sphere of radius clamp(scale, 1e-4, 1)."""
    return l2_normalize(embeddings) * torch.clamp(torch.as_tensor(scale), 1e-4, 1.0)


def mean_pairwise_similarity(x):
    """Closed-form mean of the full [M, M] cosine_similarity01 matrix."""
    s = torch.sum(l2_normalize(x), dim=0)
    M = x.shape[0]
    return 0.5 + 0.5 * torch.sum(s * s) / (M * M)


def hyphc_triplet_loss(x_poincare, triplets, scale, temperature):
    """The continuous-hierarchy loss over a masked triplet set."""
    a, p, n, mask = triplets
    e1, e2, e3 = x_poincare[a], x_poincare[p], x_poincare[n]
    sim = torch.stack([cosine_similarity01(e1, e2), cosine_similarity01(e1, e3),
                       cosine_similarity01(e2, e3)], dim=-1)  # [T, 3]
    e1, e2, e3 = (normalize_to_radius(e, scale) for e in (e1, e2, e3))
    lca = torch.cat([hyp_lca(e1, e2, return_coord=False), hyp_lca(e1, e3, return_coord=False),
                     hyp_lca(e2, e3, return_coord=False)], dim=-1)
    weights = torch.softmax(lca / temperature, dim=-1)
    total = torch.sum(sim, dim=-1) - torch.sum(sim * weights, dim=-1)
    loss = torch.sum(total * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + mean_pairwise_similarity(x_poincare)


def triplet_margin_loss(embeddings, triplets, margin):
    """Similarity-space triplet margin loss, relu(sim(a, n) - sim(a, p) +
    margin) masked, averaged over the nonzero terms."""
    a = embeddings[triplets.anchor]
    ap = cosine_similarity01(a, embeddings[triplets.positive])
    an = cosine_similarity01(a, embeddings[triplets.negative])
    losses = torch.relu(an - ap + margin) * triplets.mask
    return torch.sum(losses) / torch.clamp(torch.sum((losses > 0).float()), min=1.0)


def anneal_temperature(temperature, anneal_factor, min_scale=0.2, max_scale=1.0):
    """temperature * clamp(anneal_factor, 0.2, 1), the factor clamped in fp32."""
    return temperature * float(np.clip(np.float32(anneal_factor), min_scale, max_scale))
