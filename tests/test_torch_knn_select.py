"""Kernel B1's selection, replayed on the CPU.

`hpcs_torch/ops/csrc/knn.cu` selects each row's k best scores in three
steps; `warm_start_select` below replays them lane by lane on one row of
scores: (1) lane l's best of columns l, l + 32, ..., and a bitonic sort of
the 32 lane maxima across the warp, whose k-th is the threshold T; (2) each
lane's columns that rank at or above T, in two register slots; (3) the
slots gathered in lane order (first slots, then second), the first 32
sorted (bitonic) and the rest merged in (a bitonic merge), or, where a lane
holds more than two, the row scanned again with the columns compacted by
ballot 32 at a time and merged 32 at a time.  Fed the scores of knn_plain's
formula, it must give knn_plain's stable-sort order exactly, on rows with
ties within and across lanes, rising rows, equal rows, ragged N and lanes
with no column; on rows with NaN or fewer than k real scores, the order of
the real ones and -1 after them.  Imports no JAX.
"""
import numpy as np
import pytest
import torch

from _torch_port import adjacent_dup_cloud, lattice_cloud, line_cloud, tie_cloud
from hpcs_torch.ops import knn as K
from hpcs_torch.testing import knn_candidates, knn_queue_insertions, ranks_above, warp_sort

WARP = 32
INT_MAX = 2 ** 31 - 1
LANES = np.arange(WARP)


def warp_merge(qs, qi, cs, ci):
    """The kernel's warp_merge of a sorted 32 into the sorted best 32."""
    rs, ri = cs[WARP - 1 - LANES], ci[WARP - 1 - LANES]
    take = ranks_above(rs, ri, qs, qi)
    qs, qi = np.where(take, rs, qs), np.where(take, ri, qi)
    stride = WARP // 2
    while stride:
        os, oi = qs[LANES ^ stride], qi[LANES ^ stride]
        low = (LANES & stride) == 0
        take = np.where(low, ranks_above(os, oi, qs, qi), ranks_above(qs, qi, os, oi))
        qs, qi = np.where(take, os, qs), np.where(take, oi, qi)
        stride //= 2
    return qs, qi


def warm_start_select(row, k):
    """The kernel's selection on one row of fp32 scores: (indices [k] with
    -1 for a slot no score reached, number of candidates, number of 32-wide
    sorts, whether the row was scanned again)."""
    n = row.shape[0]

    def group(c0):  # one load a lane: column c0 + l (the score row runs past n)
        c = c0 + LANES
        return np.where(c < n, row[np.minimum(c, n - 1)], np.float32(0)), c

    # 1. each lane's best column, then T = the k-th best of the 32
    ms = np.full(WARP, -np.inf, np.float32)
    mi = np.full(WARP, INT_MAX, np.int64)
    for c0 in range(0, n, WARP):
        v, c = group(c0)
        better = (c < n) & ranks_above(v, c, ms, mi)
        ms, mi = np.where(better, v, ms), np.where(better, c, mi)
    ms, mi = warp_sort(ms, mi)
    ts, ti = ms[k - 1], mi[k - 1]
    empty_s, empty_i = np.float32(-np.inf), INT_MAX

    def cand_of(v, c):  # at or above T, (v, c) == T included
        return (c < n) & ((v > ts) | ((v == ts) & (c <= ti)))

    def chunk(s, i):  # up to 32 entries, one a lane, empty slots after them
        pad = WARP - len(s)
        return (np.array(list(s) + [empty_s] * pad, np.float32),
                np.array(list(i) + [empty_i] * pad, np.int64))

    # 2. each lane's candidates in four slots (two registers, two in the
    # row's buffer), and a count of them all
    slots_s = np.full((4, WARP), empty_s, np.float32)
    slots_i = np.full((4, WARP), empty_i, np.int64)
    cn = np.zeros(WARP, np.int64)
    for c0 in range(0, -(-n // WARP) * WARP, WARP):
        v, c = group(c0)
        cand = cand_of(v, c)
        for q in range(4):
            put = cand & (cn == q)
            slots_s[q], slots_i[q] = np.where(put, v, slots_s[q]), np.where(put, c, slots_i[q])
        cn += cand
    candidates = int(cn.sum())
    if (cn <= 4).all():
        # 3. gathered in lane order, first slots, then second, third, fourth;
        # the first 32 sorted, the rest merged in 32 at a time
        buf_s = [x for q in range(4) for x in slots_s[q][cn > q]]
        buf_i = [x for q in range(4) for x in slots_i[q][cn > q]]
        qs, qi = warp_sort(*chunk(buf_s[:WARP], buf_i[:WARP]))
        sorts = 1
        for m in range(WARP, len(buf_s), WARP):
            qs, qi = warp_merge(qs, qi, *warp_sort(*chunk(buf_s[m:m + WARP], buf_i[m:m + WARP])))
            sorts += 1
        rescanned = False
    else:
        # the rescan: columns compacted by ballot, lowest lane first, and
        # merged 32 at a time into the best 32 so far (empty at first)
        qs, qi = chunk([], [])
        buf_s, buf_i = [], []
        sorts = 0
        for c0 in range(0, -(-n // WARP) * WARP, WARP):
            v, c = group(c0)
            cand = cand_of(v, c)
            buf_s += list(v[cand])
            buf_i += list(c[cand])
            if len(buf_s) >= WARP:
                qs, qi = warp_merge(qs, qi, *warp_sort(*chunk(buf_s[:WARP], buf_i[:WARP])))
                buf_s, buf_i = buf_s[WARP:], buf_i[WARP:]
                sorts += 1
        if buf_s:
            qs, qi = warp_merge(qs, qi, *warp_sort(*chunk(buf_s, buf_i)))
            sorts += 1
        rescanned = True
    out = qi[:k]
    return np.where(out < n, out, -1), candidates, sorts, rescanned


def ranked(row, k):
    """The non-NaN columns of a row by (score descending, index ascending),
    the first k, -1 past them."""
    real = np.flatnonzero(~np.isnan(row))
    order = real[np.lexsort((real, -row[real].astype(np.float64)))][:k]
    return np.concatenate([order, np.full(k - len(order), -1)])


def _cloud(name, n, rng):
    if name == "random_d3":
        return rng.standard_normal((1, n, 3)).astype(np.float32)
    if name == "random_d63":
        return rng.standard_normal((1, n, 63)).astype(np.float32)
    if name == "adjacent_dups":  # x[2m] == x[2m+1]: ties inside one group
        return adjacent_dup_cloud(rng, 1, n, 3)
    if name == "ties_across":    # x[m] == x[m + n/2]: ties across groups (one lane at n = 256)
        return np.round(tie_cloud(rng, 1, n, 3) * 2)
    if name == "lattice":        # many distinct points at exactly equal distance
        return lattice_cloud(rng, 1, n)
    if name == "line":           # rising scores up to the row's own column
        return line_cloud(1, n)
    if name == "all_equal":
        return np.full((1, n, 3), 0.5, np.float32)
    raise ValueError(name)


def _check_rows(x, k):
    """Every row of x [1, n, D] through the replay against knn_plain; the
    candidates per row."""
    scores = K.knn_scores(x)[0].numpy()
    want = K.knn_plain(x, k)[0].numpy()
    candidates = []
    for i in range(x.shape[1]):
        got, cands, sorts, _ = warm_start_select(scores[i], k)
        np.testing.assert_array_equal(got, want[i], err_msg=f"row {i}")
        assert sorts == max(1, -(-cands // WARP))
        candidates.append(cands)
    # chip_smoke.py reports the selection's work by this closed form
    assert knn_candidates(x, k) == sum(candidates) / len(candidates)
    return np.array(candidates)


@pytest.mark.parametrize("n", [256, 100])
@pytest.mark.parametrize("k", [1, 20, 32])
@pytest.mark.parametrize("cloud", ["random_d3", "random_d63", "adjacent_dups", "ties_across",
                                   "lattice", "line", "all_equal"])
def test_warm_start_selection_matches_knn_plain(cloud, k, n):
    x = torch.from_numpy(_cloud(cloud, n, np.random.default_rng(n + k)))
    candidates = _check_rows(x, k)
    assert (candidates >= k).all()
    if cloud in ("line", "all_equal"):
        # a row's lane maxima are its 32 best columns (the line's nearest;
        # the equal row's first 32): T is the k-th best itself, whatever the
        # order of the columns
        assert (candidates == k).all()


@pytest.mark.parametrize("n,k", [(1, 1), (5, 1), (5, 5), (31, 1), (31, 31), (32, 1), (32, 32),
                                 (33, 1), (33, 32), (20, 20)])
def test_lanes_without_columns_and_k_equal_to_n(n, k):
    """N < 32 leaves lanes with no column (their maximum is the empty slot,
    which T becomes where fewer than k lanes saw a score); N = k takes every
    column; N = 33 puts two columns in lane 0."""
    x = torch.from_numpy(np.random.default_rng(n * 100 + k).integers(-3, 4, size=(1, n, 3))
                         .astype(np.float32))
    _check_rows(x, k)


def test_ties_at_the_threshold():
    """Columns tied with T at smaller and larger indices than T's own: those
    at or below T's index go in, and the order keeps them in index order."""
    n, k = 256, 20
    row = np.zeros(n, np.float32)
    row[::7] = 1.0      # 37 columns tied at 1, spread over the lanes
    row[[3, 90, 200]] = 2.0
    got, cands, _, _ = warm_start_select(row, k)
    np.testing.assert_array_equal(got, ranked(row, k))
    _, mi = warp_sort(*_lane_maxima(row))
    assert cands == 3 + np.count_nonzero((row == 1.0) & (np.arange(n) <= mi[k - 1]))


@pytest.mark.parametrize("case", ["one_lane_holds_the_neighbours", "twins_in_one_lane", "k32"])
def test_rows_where_a_lane_holds_more_than_four_are_scanned_again(case):
    """A lane with more than four candidates sends its row down the rescan
    (ballot compaction): the near points all in one lane's columns, a cloud
    whose twins (x[m] == x[m + 128]) share lanes, and k = 32 (T the worst
    of the 32 lane maxima)."""
    n = 256
    rng = np.random.default_rng(7)
    if case == "one_lane_holds_the_neighbours":
        x = np.zeros((1, n, 3), np.float32)
        x[0, :, 0] = 100 + np.arange(n)
        x[0, ::32, 0] = np.arange(0, n, 32) / 32
        k = 20
    elif case == "twins_in_one_lane":
        half = rng.integers(-6, 7, size=(1, n // 2, 3)).astype(np.float32)
        x, k = np.concatenate([half, half], 1), 20
    else:
        x, k = rng.integers(-60, 61, size=(1, n, 3)).astype(np.float32), 32
    x = torch.from_numpy(x)
    scores = K.knn_scores(x)[0].numpy()
    rescanned = [warm_start_select(r, k)[3] for r in scores]
    assert any(rescanned)
    _check_rows(x, k)


def _lane_maxima(row):
    ms, mi = np.full(WARP, -np.inf, np.float32), np.full(WARP, INT_MAX, np.int64)
    for c in range(row.shape[0]):
        if ranks_above(row[c], c, ms[c % WARP], mi[c % WARP]):
            ms[c % WARP], mi[c % WARP] = row[c], c
    return ms, mi


@pytest.mark.parametrize("case", ["nan_and_empty", "few_real", "minus_inf", "all_nan"])
def test_nan_never_ranks_and_empty_slots_report_minus_one(case):
    """NaN never ranks; -inf is a real score; a slot no score reached
    reports -1."""
    if case == "nan_and_empty":
        row = np.array([np.nan, 2.0, np.nan, 1.0] + [np.nan] * 30, np.float32)
        want = [1, 3, -1, -1]
    elif case == "few_real":     # 3 real scores in 100 columns, k = 20
        row = np.full(100, np.nan, np.float32)
        row[[70, 5, 41]] = [0.5, 0.5, 3.0]
        want = [41, 5, 70] + [-1] * 17
    elif case == "minus_inf":    # -inf columns rank after the finite ones, in index order
        row = np.full(70, -np.inf, np.float32)
        row[[60, 2]] = [1.0, 1.0]
        row[33] = np.nan
        want = [2, 60, 0, 1, 3, 4]
    else:
        row = np.full(40, np.nan, np.float32)
        want = [-1] * 8
    got, cands, _, _ = warm_start_select(row, len(want))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ranked(row, len(want)))
    # fewer than k lanes saw a real score: T is the empty slot and every real
    # column goes in; with -inf scores in every lane, T is a real -inf
    assert cands == {"nan_and_empty": 2, "few_real": 3, "minus_inf": 6, "all_nan": 0}[case]


def _queue_insertions(row, k):
    """A sequential top-k queue over the columns in index order: the number
    of columns it inserts."""
    best, inserted = [], 0
    for c, v in enumerate(row):
        if np.isnan(v):
            continue
        if len(best) < k or v > best[-1][0]:  # an earlier equal score wins a tie
            best = sorted(best + [(v, c)], key=lambda t: (-t[0], t[1]))[:k]
            inserted += 1
    return inserted


@pytest.mark.parametrize("cloud", ["random_d3", "line", "all_equal"])
def test_queue_insertions_counts_a_sequential_queue(cloud):
    """knn_queue_insertions, reported beside knn_candidates, is the work of
    a top-k queue that takes the columns in index order."""
    x = torch.from_numpy(_cloud(cloud, 100, np.random.default_rng(5)))
    scores = K.knn_scores(x)[0].numpy()
    want = sum(_queue_insertions(r, 20) for r in scores) / len(scores)
    assert knn_queue_insertions(x, 20) == want
