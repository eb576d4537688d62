"""The wide route's streamed selection, replayed on the CPU.

`knn_wide_kernel` (hpcs_torch/ops/csrc/knn.cu) keeps each row's best
32 ceil(k / 32) in a sorted list and streams the columns past it in tiles:
a tile's columns that rank above T, the list's k-th, are merged in 32 at a
time (sorted across the warp, then merged into the list chunk by chunk),
the rest filtered again against the raised T, while more than 8 are left;
the last few are inserted one at a time.
`hpcs_torch.testing.knn_stream_select` replays that lane by lane, with the
tile width and the first tile as parameters, so that a small N spans many
tiles.  Fed the scores of knn_plain's formula it must give knn_plain's
order exactly: on ties within and across tiles, rising rows, equal rows,
any first tile, k past 32 and 64, NaN rows and rows with fewer than k
real scores; and, on whole clouds with k > 32 over several tiles,
hpcs_tpu's XLA knn and its Pallas kernel in interpret mode.  Imports JAX
only in that last test.
"""
import numpy as np
import pytest
import torch

from _torch_port import adjacent_dup_cloud, lattice_cloud, line_cloud, tie_cloud
from hpcs_torch.ops import knn as K
from hpcs_torch.testing import knn_stream_select, knn_stream_work, wide_first_chunk

KS = [1, 20, 32, 33, 40, 64]


def _cloud(name, n, rng):
    if name == "random_d3":
        return rng.standard_normal((1, n, 3)).astype(np.float32)
    if name == "random_d63":
        return rng.standard_normal((1, n, 63)).astype(np.float32)
    if name == "adjacent_dups":  # x[2m] == x[2m+1]: ties inside one tile
        return adjacent_dup_cloud(rng, 1, n, 3)
    if name == "ties_across":    # x[m] == x[m + n/2]: ties across tiles
        return np.round(tie_cloud(rng, 1, n, 3) * 2)
    if name == "lattice":        # many distinct points at exactly equal distance
        return lattice_cloud(rng, 1, n)
    if name == "line":           # rising scores up to the row's own column
        return line_cloud(1, n)
    if name == "all_equal":
        return np.full((1, n, 3), 0.5, np.float32)
    raise ValueError(name)


def ranked(row, k):
    """The non-NaN columns of a row by (score descending, index ascending),
    the first k, -1 past them."""
    real = np.flatnonzero(~np.isnan(row))
    order = real[np.lexsort((real, -row[real].astype(np.float64)))][:k]
    return np.concatenate([order, np.full(k - len(order), -1)])


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("cloud", ["random_d3", "random_d63", "adjacent_dups", "ties_across",
                                   "lattice", "line", "all_equal"])
def test_stream_selection_matches_knn_plain(cloud, k):
    """Every 3rd row of a 130-point cloud (tiles of 32 and of 64, the last
    one ragged), from each row's own tile and from tile 0: knn_plain's
    indices exactly."""
    n = 130
    x = torch.from_numpy(_cloud(cloud, n, np.random.default_rng(n + k)))
    scores = K.knn_scores(x)[0].numpy()
    want = K.knn_plain(x, k)[0].numpy()
    for i in range(0, n, 3):
        for chunk in (32, 64):
            for first in (i // chunk, 0):
                got, merges, insertions = knn_stream_select(scores[i], k, chunk, first)
                np.testing.assert_array_equal(got, want[i], err_msg=f"row {i}, {chunk}, {first}")
                assert 32 * merges + insertions >= min(k, n)


@pytest.mark.parametrize("k", [20, 40])
def test_a_row_tile_started_at_its_own_neighbours_does_little_work(k):
    """On the line (scores rise up to the row's own column) from tile 0 a
    row's every column up to its own passes the filter; from its own tile
    its k nearest come first and T is tight from then on: the first tile's
    merges (its 64 columns, filtered again after each merge), then next to
    nothing."""
    n, chunk = 512, 64
    scores = K.knn_scores(torch.from_numpy(line_cloud(1, n)))[0].numpy()
    rows = range(300, 400, 20)
    own = [knn_stream_select(scores[i], k, chunk, i // chunk)[1:] for i in rows]
    first = [knn_stream_select(scores[i], k, chunk, 0)[1:] for i in rows]
    assert max(m for m, _ in own) <= 3 and max(i for _, i in own) <= 8
    assert min(m for m, _ in first) >= 3 * max(m for m, _ in own)


def test_few_survivors_go_in_one_at_a_time_and_many_are_merged():
    """A tile with at most 8 survivors inserts each that still ranks above
    T; more are merged 32 at a time, the rest filtered again."""
    row = np.full(96, np.nan, np.float32)  # tiles of 32; k = 4; NaN never passes
    row[:4] = 1.0                   # tile 0: 4 survivors on an empty list
    row[[40, 45, 50]] = [3.0, 2.0, 1.0]  # tile 1: 3, the last tied with T at a larger index
    row[64:96] = np.arange(32, dtype=np.float32) + 10  # tile 2: 32 survivors
    got, merges, insertions = knn_stream_select(row, 4, 32, 0)
    np.testing.assert_array_equal(got, [95, 94, 93, 92])
    assert (merges, insertions) == (1, 4 + 2)


@pytest.mark.parametrize("n,k", [(1, 1), (5, 5), (31, 31), (33, 33), (64, 64), (65, 40),
                                 (97, 64), (20, 20)])
def test_k_equal_to_n_and_lists_past_one_warp(n, k):
    """k = N takes every column; a list of two or more 32s (k > 32) at N
    in and past one tile of 32."""
    x = torch.from_numpy(np.random.default_rng(n * 100 + k).integers(-3, 4, size=(1, n, 3))
                         .astype(np.float32))
    scores = K.knn_scores(x)[0].numpy()
    want = K.knn_plain(x, k)[0].numpy()
    for i in range(n):
        np.testing.assert_array_equal(knn_stream_select(scores[i], k, 32, i // 32)[0], want[i])


@pytest.mark.parametrize("k", [4, 33, 40])
@pytest.mark.parametrize("case", ["nan_and_empty", "few_real", "minus_inf", "all_nan"])
def test_nan_never_ranks_and_empty_slots_report_minus_one(case, k):
    """NaN never ranks; -inf is a real score, after the finite ones in index
    order; a slot no score reached reports -1."""
    rng = np.random.default_rng(k)
    if case == "nan_and_empty":
        row = np.array([np.nan, 2.0, np.nan, 1.0] + [np.nan] * 70, np.float32)
    elif case == "few_real":     # 3 real scores in 100 columns
        row = np.full(100, np.nan, np.float32)
        row[[70, 5, 41]] = [0.5, 0.5, 3.0]
    elif case == "minus_inf":
        row = np.full(90, -np.inf, np.float32)
        row[[60, 2]] = [1.0, 1.0]
        row[33] = np.nan
        row[rng.integers(0, 90, 10)] = rng.integers(-2, 3, 10)
    else:
        row = np.full(80, np.nan, np.float32)
    for first in (0, 1, 2):
        got = knn_stream_select(row, k, 32, first)[0]
        np.testing.assert_array_equal(got, ranked(row, k))


def test_work_per_row_is_the_replay_from_each_rows_own_tile():
    """knn_stream_work, which chip_smoke.py reports beside the wide route's
    times, is the replay's mean merges and insertions from each row's own
    first tile (the kernel's: its row tile of 32 rows, in tiles of 256
    columns)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 600, 3)).astype(np.float32))
    assert [wide_first_chunk(i, 600) for i in (0, 31, 255, 256, 287, 288, 599)] == [
        0, 0, 0, 1, 1, 1, 2]
    assert wide_first_chunk(40, 600, row_begin=20) == 0  # its tile starts at row 20
    scores = K.knn_scores(x).numpy()
    work = np.array([knn_stream_select(scores[b, i], 20, first=wide_first_chunk(i, 600))[1:]
                     for b in range(2) for i in range(0, 600, 50)])
    assert knn_stream_work(x, 20, row_step=50) == tuple(work.mean(0))


@pytest.mark.parametrize("k", [33, 40])
def test_stream_selection_matches_hpcs_tpu(k):
    """Whole clouds with k > 32 over several tiles of 32: the replay equals
    hpcs_tpu's XLA knn and knn_pallas(interpret=True, mode="exact")."""
    import jax.numpy as jnp

    from hpcs_tpu.ops.knn import knn as j_knn
    from hpcs_tpu.ops.pallas import knn_pallas

    rng = np.random.default_rng(k)
    for x in (rng.standard_normal((1, 128, 3)).astype(np.float32),
              np.round(tie_cloud(rng, 1, 128, 3) * 2)):
        scores = K.knn_scores(torch.from_numpy(x))[0].numpy()
        got = np.stack([knn_stream_select(scores[i], k, 32, i // 32)[0] for i in range(128)])
        np.testing.assert_array_equal(got, np.asarray(j_knn(jnp.asarray(x), k))[0])
        np.testing.assert_array_equal(got, np.asarray(knn_pallas(jnp.asarray(x), k, interpret=True,
                                                                 mode="exact"))[0])
