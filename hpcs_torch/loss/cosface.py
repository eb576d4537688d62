"""CosFace (large-margin cosine) loss and its hierarchical variant.

logits = s (cos(theta) - m onehot(target)), loss = mean cross-entropy, with
margin 0.35 and scale 2.  The class weights W [embedding_size, num_classes]
are a parameter of the caller's model (`metric_hyp_loss.loss_cosface.W`).
"""
import torch
import torch.nn.functional as F

from ..geometry.math_ops import l2_normalize


def cosface_logits(W, embeddings, labels, margin=0.35, scale=2.0):
    """Scaled margin-modified cosine logits [M, L]."""
    cosine = l2_normalize(embeddings) @ l2_normalize(W, dim=0)
    onehot = F.one_hot(labels.long(), W.shape[1]).to(cosine.dtype)
    return scale * (cosine - margin * onehot)


def _nll(logp, labels):
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]


def cosface_loss(W, embeddings, labels, margin=0.35, scale=2.0, weights=None):
    """Mean cross-entropy over margin-modified cosine logits."""
    nll = _nll(torch.log_softmax(cosface_logits(W, embeddings, labels, margin, scale), -1), labels)
    if weights is not None:
        return torch.sum(nll * weights) / torch.clamp(torch.sum(weights), min=1e-12)
    return torch.mean(nll)


def hierarchy_sum_matrices(hierarchy_list, num_classes, device=None):
    """One [L, L] branch-summing matrix per level of the hierarchy.

    S[j, c] = 1 iff class j is in the branch holding class c; a class in no
    branch keeps its own probability (identity column).
    """
    mats = []
    for level in hierarchy_list:
        S = torch.eye(num_classes, device=device)
        for branch in level:
            ind = torch.zeros(num_classes, device=device)
            ind[list(branch)] = 1.0
            for c in branch:
                S[:, c] = ind
        mats.append(S)
    return mats


def _level_nlls(probabilities, labels, sum_matrices):
    for S in sum_matrices:
        yield _nll(torch.log(torch.clamp(probabilities @ S, min=1e-12)), labels)


def hierarchical_loss(probabilities, labels, sum_matrices):
    """Tree-consistent NLL: at each level a class's probability is the summed
    probability of its branch; the levels' mean NLLs are added."""
    loss = 0.0
    for nll in _level_nlls(probabilities, labels, sum_matrices):
        loss = loss + torch.mean(nll)
    return loss


def hierarchical_cosface_loss(W, embeddings, labels, sum_matrices, margin=0.35, scale=2.0,
                              weights=None):
    """CosFace probabilities pushed through the per-level branch sums."""
    probabilities = torch.softmax(cosface_logits(W, embeddings, labels, margin, scale), -1)
    loss, n_lvls = 0.0, 0
    for nll in _level_nlls(probabilities, labels, sum_matrices):
        loss = loss + (nll * weights if weights is not None else nll)
        n_lvls += 1
    if weights is not None:
        return (torch.sum(loss) / torch.clamp(torch.sum(weights) * max(n_lvls, 1), min=1e-12)
                * n_lvls)
    return torch.mean(loss)
