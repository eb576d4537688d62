"""Clustering scores and the best-k sweep of the decode.

Every function takes a batch of objects.  Contingency tables are counted
by plain indexing (exact); the scores repeat the reference's fp32
arithmetic operation for operation, so equal tables give equal scores.
`purity`, `weighted_jaccard` and `eval_clustering`, which no entry point
calls, score one flat cut at the true cluster count.
"""
import torch

from ..geometry.math_ops import fma
from .linkage import (_batched, _relabel_consecutive, build_cut_tables, cut_maxclust,
                      cut_maxclust_fcluster, cut_roots_sweep)


def remap_consecutive(y, upper):
    """Labels y [B, N] (< upper) -> 0..C-1 in order of value, and C [B]."""
    present = torch.zeros((y.shape[0], upper), dtype=torch.int64, device=y.device)
    present.scatter_(1, y, 1)
    new_id = torch.cumsum(present, dim=1) - 1
    return new_id.gather(1, y), present.sum(dim=1)


def contingency(y_true, y_pred, c_max, k_max):
    """Co-occurrence counts [..., c_max, k_max] (float32) of y_true [..., N]
    (< c_max) against y_pred [..., N] (< k_max)."""
    lead, n = y_true.shape[:-1], y_true.shape[-1]
    cell = (y_true * k_max + y_pred).reshape(-1, n)
    cont = torch.zeros((cell.shape[0], c_max * k_max), dtype=torch.float32, device=cell.device)
    cont.scatter_add_(1, cell, torch.ones_like(cell, dtype=torch.float32))
    return cont.reshape(*lead, c_max, k_max)


def adjusted_rand_index(y_true, y_pred, c_max, k_max):
    """ARI [...] from the contingency table (1 where the index is undefined)."""
    cont = contingency(y_true, y_pred, c_max, k_max)
    n = cont.sum(dim=(-2, -1))
    a, b = cont.sum(dim=-1), cont.sum(dim=-2)

    def comb2(x):
        return x * (x - 1.0) / 2.0

    sum_ij = comb2(cont).sum(dim=(-2, -1))
    sum_a, sum_b = comb2(a).sum(dim=-1), comb2(b).sum(dim=-1)
    expected = sum_a * sum_b / torch.clamp(comb2(n), min=1.0)
    denom = 0.5 * (sum_a + sum_b) - expected
    return torch.where(denom.abs() < 1e-6, torch.ones_like(denom), (sum_ij - expected) / denom)


def purity(y_true, y_pred, c_max, k_max):
    """Majority-vote purity [...]: each predicted cluster counts its most
    common true label, over all points."""
    cont = contingency(y_true, y_pred, c_max, k_max)
    return cont.amax(dim=-2).sum(dim=-1) / torch.clamp(cont.sum(dim=(-2, -1)), min=1.0)


def weighted_jaccard(y_true, y_pred, c_max, k_max):
    """sklearn's jaccard_score(average="weighted") of cluster ids read as
    class predictions [...]: per class TP / (TP + FP + FN), 0 where the
    union is empty, weighted by the class's support.  The value depends on
    which number each cluster gets; `eval_clustering(fcluster_ids=True)`
    numbers them as scipy's fcluster does.  The weighted sum runs as FMAs
    in class order, so every device gives the same bits."""
    m = max(c_max, k_max)
    cont = contingency(y_true, y_pred, m, m)
    tp = cont.diagonal(dim1=-2, dim2=-1)
    support = cont.sum(dim=-1)
    denom = support + cont.sum(dim=-2) - tp
    j = torch.where(denom > 0, tp / torch.clamp(denom, min=1e-12), torch.zeros_like(tp))
    acc = torch.zeros_like(tp[..., 0])
    for c in range(m):
        acc = fma(support[..., c], j[..., c], acc)
    return acc / torch.clamp(support.sum(dim=-1), min=1.0)


def eval_clustering(y, Z, num_class, fcluster_ids=False):
    """Cut each dendrogram at its object's true cluster count and score the
    cut: (ARI, weighted IoU, purity), each [B] (or 0-d for y [N], Z [N-1, 4]).

    The first two are the reference's eval_clustering pair (the adjusted
    Rand index and the weighted Jaccard of consecutively renumbered ids).
    fcluster_ids=True cuts with `cut_maxclust_fcluster` (fcluster's ties
    and numbering), so the numbering-sensitive weighted IoU is the
    reference's; the default `cut_maxclust` is cheaper, and ARI and purity
    are the same either way.
    """
    y = torch.as_tensor(y, device=Z.device).long()
    y, unbatched = _batched(y, 1)
    Z, _ = _batched(Z, 2)
    y_true, n_true = remap_consecutive(y, num_class)
    cut = cut_maxclust_fcluster if fcluster_ids else cut_maxclust
    y_pred_raw = cut(Z, n_true)
    k_max = min(num_class + 4, Z.shape[1] + 1) + 1
    y_pred, _ = remap_consecutive(y_pred_raw, k_max)
    out = (adjusted_rand_index(y_true, y_pred, num_class, k_max),
           weighted_jaccard(y_true, y_pred, num_class, k_max),
           purity(y_true, y_pred, num_class, k_max))
    return tuple(v[0] for v in out) if unbatched else out


def _iou_matching_score(y_true, y_pred, n_true, c_max, k_max):
    """The reference's greedy IoU matching score [...]: each true cluster
    claims its best-IoU predicted cluster (first among equal IoUs; later
    true clusters overwrite earlier claims), then the binary IoU of the
    matched encodings, eq / (2 N - eq).  n_true [...]: true clusters."""
    cont = contingency(y_true, y_pred, c_max, k_max)
    union = cont.sum(dim=-1, keepdim=True) + cont.sum(dim=-2, keepdim=True) - cont
    iou = torch.where(union > 0, cont / torch.clamp(union, min=1e-12), torch.zeros_like(cont))
    ind = iou.argmax(dim=-1)  # [..., c_max]
    i_range = torch.arange(c_max, device=cont.device)
    p_range = torch.arange(k_max, device=cont.device)
    hit = (ind[..., None, :] == p_range[:, None]) & (i_range < n_true[..., None, None])
    winner = torch.where(hit, i_range, -1).amax(dim=-1)  # [..., k_max]
    match = winner[..., None, :] == i_range[:, None]  # [..., c_max, k_max]
    eq = torch.where(match, cont, torch.zeros_like(cont)).sum(dim=(-2, -1))
    n = y_true.shape[-1]
    return eq / torch.clamp(2 * n - eq, min=1.0)


def get_optimal_k(y, Z, num_class, index="iou"):
    """The best flat cut of each dendrogram, sweeping k = 1 .. C + 4.

    y [B, N] labels (< num_class), Z [B, N-1, 4].  Returns (pred [B, N],
    best_k [B], best_score [B]); among equal scores the smallest k wins.
    Cuts beyond k = C + 4 (C the object's true cluster count) score -1.
    """
    y = torch.as_tensor(y, device=Z.device).long()
    n = y.shape[-1]
    k_hi = min(num_class + 4, n)
    y_true, n_true = remap_consecutive(y, num_class)
    child_row, up, is_b = build_cut_tables(Z)
    roots, preds, ks = cut_roots_sweep(Z, child_row, up, is_b, k_hi)
    yk = y_true[:, None, :].expand_as(preds)
    if index == "iou":
        scores = _iou_matching_score(yk, preds, n_true[:, None], num_class, 2 * k_hi)
    elif index == "ri":
        scores = adjusted_rand_index(yk, preds, num_class, 2 * k_hi)
    else:
        raise ValueError(f"unknown index {index!r}")
    scores = torch.where(ks <= n_true[:, None] + 4, scores, torch.full_like(scores, -1.0))
    # ks run k_hi .. 1, so the last of the equal maxima is the smallest k
    best = k_hi - 1 - scores.flip(-1).argmax(dim=-1)
    rows = torch.arange(Z.shape[0], device=Z.device)
    return _relabel_consecutive(roots[rows, best]), ks[best], scores[rows, best]
