"""Kernel B1's selection, replayed on the CPU.

`hpcs_torch/ops/csrc/knn.cu` selects each row's k best scores with a warp
queue.  `warp_queue_select` below replays that schedule lane by lane on one
row of scores: 32-column groups in order, the ballot of columns that beat the
threshold (entry k-1), insertion of those columns lowest lane first, each
re-checked against the threshold as the queue moves.  Fed the scores of
knn_plain's formula, it must give knn_plain's stable-sort order exactly, on
rows with ties within and across groups, rising rows, equal rows and ragged
N.  Imports no JAX.
"""
import numpy as np
import pytest
import torch

from _torch_port import adjacent_dup_cloud, lattice_cloud, line_cloud, tie_cloud
from hpcs_torch.ops import knn as K
from hpcs_torch.testing import knn_queue_insertions

WARP = 32
INT_MAX = 2 ** 31 - 1
LANES = np.arange(WARP)


def ranks_above(s, i, s2, i2):
    """(s, i) ranks above (s2, i2): a higher score, or an equal score and a
    smaller index."""
    return (s > s2) | ((s == s2) & (i < i2))


def warp_queue_select(row, k):
    """The kernel's selection on one row of fp32 scores: (indices [k] with
    -1 for a slot no score reached, number of insertions)."""
    n = row.shape[0]
    qs = np.full(WARP, -np.inf, np.float32)  # lane q's queue entry
    qi = np.full(WARP, INT_MAX, np.int64)
    ts, ti = np.float32(-np.inf), INT_MAX    # the threshold: entry k-1
    below_k = LANES < k
    inserted = 0
    for c0 in range(0, n, WARP):
        c = c0 + LANES
        v = np.where(c < n, row[np.minimum(c, n - 1)], np.float32(-np.inf))
        cand = (c < n) & ranks_above(v, c, ts, ti)  # the ballot
        for src in np.flatnonzero(cand):            # __ffs order: lowest lane first
            cv, ci = v[src], c0 + int(src)
            if not ranks_above(cv, ci, ts, ti):     # the queue moved past it
                continue
            above = ranks_above(qs, qi, cv, ci)
            pos = int(np.count_nonzero(above & below_k))
            us = np.concatenate([qs[:1], qs[:-1]])  # __shfl_up_sync(..., 1)
            ui = np.concatenate([qi[:1], qi[:-1]])
            qs = np.where(LANES == pos, cv, np.where(LANES > pos, us, qs))
            qi = np.where(LANES == pos, ci, np.where(LANES > pos, ui, qi))
            ts, ti = qs[k - 1], int(qi[k - 1])
            inserted += 1
    out = qi[:k]
    return np.where(out < n, out, -1), inserted


def _cloud(name, n, rng):
    if name == "random_d3":
        return rng.standard_normal((1, n, 3)).astype(np.float32)
    if name == "random_d63":
        return rng.standard_normal((1, n, 63)).astype(np.float32)
    if name == "adjacent_dups":  # x[2m] == x[2m+1]: ties inside one group
        return adjacent_dup_cloud(rng, 1, n, 3)
    if name == "ties_across":    # x[m] == x[m + n/2]: ties across groups
        return np.round(tie_cloud(rng, 1, n, 3) * 2)
    if name == "lattice":        # many distinct points at exactly equal distance
        return lattice_cloud(rng, 1, n)
    if name == "line":           # rising scores up to the row's own column
        return line_cloud(1, n)
    if name == "all_equal":
        return np.full((1, n, 3), 0.5, np.float32)
    raise ValueError(name)


@pytest.mark.parametrize("n", [256, 100])
@pytest.mark.parametrize("k", [1, 20, 32])
@pytest.mark.parametrize("cloud", ["random_d3", "random_d63", "adjacent_dups", "ties_across",
                                   "lattice", "line", "all_equal"])
def test_warp_queue_matches_knn_plain(cloud, k, n):
    x = torch.from_numpy(_cloud(cloud, n, np.random.default_rng(n + k)))
    scores = K.knn_scores(x)[0].numpy()
    want = K.knn_plain(x, k)[0].numpy()
    total = 0
    for i in range(n):
        got, inserted = warp_queue_select(scores[i], k)
        np.testing.assert_array_equal(got, want[i], err_msg=f"row {i}")
        total += inserted
        if cloud == "line" and i == n - 1:
            # the last row's scores rise all the way: every column goes in
            assert inserted == n
    # chip_smoke.py reports the queue's work by this closed form
    assert knn_queue_insertions(x, k) == total / n


def test_warp_queue_skips_nan_and_reports_empty_slots():
    """NaN never ranks; a slot no score reached reports -1."""
    row = np.array([np.nan, 2.0, np.nan, 1.0] + [np.nan] * 30, np.float32)
    got, inserted = warp_queue_select(row, 4)
    np.testing.assert_array_equal(got, [1, 3, -1, -1])
    assert inserted == 2
