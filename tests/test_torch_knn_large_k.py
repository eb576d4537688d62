"""k > 256: the radix route, replayed on the CPU, and the slice against hpcs_tpu.

For k > 256 the wide route (hpcs_torch/ops/csrc/knn.cu) stores a group of
rows' scores as order-preserving keys, tile by tile (knn_keys_kernel), and
selects each row by a radix select on (key << 32 | ~column), then sorts the
k emitted columns (knn_radix_kernel).  `hpcs_torch.testing.knn_radix_route`
replays that, with the tile width, the group of rows and the candidate cap
as parameters, so that a 640-point cloud spans many tiles and groups and
both the row passes and the copied candidates are taken.  Fed the scores of
knn_plain's formula it must give knn_plain's order exactly: random clouds
(D = 3 and 63), ties within and across tiles, a lattice, a line, equal
points, k in {257, 300, 512, N}; NaN rows and rows with fewer than k real
scores give knn_plain's order over the non-NaN scores, -1 past them; -0.0
ranks with +0.0.  knn_plain at k > 256 equals hpcs_tpu's XLA knn and its
Pallas kernel in interpret mode, and the port's forward at k = 260 equals
hpcs_tpu's on shared weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (adjacent_dup_cloud, lattice_cloud, line_cloud, randomize_batch_stats,
                         tie_cloud, to_numpy_tree)
from hpcs_torch.ops import knn as K
from hpcs_torch.testing import (RADIX_CAND_CAP, knn_radix_route, knn_radix_select,
                                radix_score_keys)
from test_torch_long_cloud import TOL, _same_up_to_near_ties

N = 640


def _cloud(name, rng):
    if name == "random_d3":
        return rng.standard_normal((1, N, 3)).astype(np.float32)
    if name == "random_d63":
        return rng.standard_normal((1, N, 63)).astype(np.float32)
    if name == "adjacent_dups":  # x[2m] == x[2m+1]: ties inside one tile
        return adjacent_dup_cloud(rng, 1, N, 3)
    if name == "ties_across":    # x[m] == x[m + N/2]: ties across tiles and groups
        return np.round(tie_cloud(rng, 1, N, 3) * 2)
    if name == "lattice":        # many distinct points at exactly equal distance
        return lattice_cloud(rng, 1, N)
    if name == "line":           # scores rise with the column up to the row's own
        return line_cloud(1, N)
    if name == "all_equal":
        return np.full((1, N, 3), 0.5, np.float32)
    raise ValueError(name)


def ranked(row, k):
    """knn_plain's order over a row's non-NaN columns (score descending,
    index ascending), the first k, -1 past them."""
    real = np.flatnonzero(~np.isnan(row))
    order = real[np.lexsort((real, -row[real].astype(np.float64)))][:k]
    return np.concatenate([order, np.full(k - len(order), -1)])


@pytest.mark.parametrize("cap", [64, RADIX_CAND_CAP])
@pytest.mark.parametrize("k", [257, 300, 512, N])
@pytest.mark.parametrize("cloud", ["random_d3", "random_d63", "adjacent_dups", "ties_across",
                                   "lattice", "line", "all_equal"])
def test_radix_route_matches_knn_plain(cloud, k, cap):
    """Every 9th row of a 640-point cloud, in groups of 16 rows and tiles of
    64 columns (the last ragged), candidates copied at most `cap`, the
    emitted columns placed by count up to 256 (cap 64) or 8192: knn_plain's
    indices exactly."""
    x = torch.from_numpy(_cloud(cloud, np.random.default_rng(k)))
    rows = slice(0, N, 9)
    got, row_passes, _ = knn_radix_route(K.knn_scores(x)[0].numpy()[rows], k, tile=64, group=16,
                                         cand_cap=cap, threads=4 * cap)
    np.testing.assert_array_equal(got, K.knn_plain(x, k)[0].numpy()[rows])
    assert 2 <= row_passes <= 7  # the first digit's count, then at most six digits' passes


def test_a_random_row_is_read_twice_and_equal_points_to_the_last_digit():
    """Work that does not grow with k or depend on column order: on a
    Gaussian cloud the first digit's bucket fits the candidates, so a row is
    read twice whatever k and whichever way its columns are ordered; equal
    points keep every column in play through the key's three digits and the
    index's three: two passes over the row (its 640 columns fit the
    candidates), five over the copy."""
    x = torch.from_numpy(_cloud("random_d63", np.random.default_rng(0)))
    scores = K.knn_scores(x)[0].numpy()[::40]
    perm = np.random.default_rng(1).permutation(N)
    for k in (257, 300, 512):
        assert knn_radix_route(scores, k)[1] == 2
        assert knn_radix_route(scores[:, perm], k)[1] == 2
    equal = K.knn_scores(torch.from_numpy(_cloud("all_equal", None)))[0].numpy()[:2]
    assert knn_radix_route(equal, 300)[1:] == (2, 5)


@pytest.mark.parametrize("k", [257, 300])
@pytest.mark.parametrize("case", ["nan_and_empty", "few_real", "minus_inf", "all_nan",
                                  "signed_zeros"])
def test_nan_never_ranks_and_empty_slots_report_minus_one(case, k):
    """NaN never ranks; -inf is a real score, after the finite ones in index
    order; a slot no score reached reports -1; -0.0 ties with +0.0 (index
    order), as knn_plain's sort holds them."""
    rng = np.random.default_rng(k)
    row = np.full(600, np.nan, np.float32)
    if case == "nan_and_empty":
        row[[1, 3]] = [2.0, 1.0]
    elif case == "few_real":     # 290 real scores in 600 columns, ties among them
        cols = rng.permutation(600)[:290]
        row[cols] = rng.integers(-3, 4, 290)
    elif case == "minus_inf":
        row[:] = -np.inf
        row[[60, 2]] = [1.0, 1.0]
        row[33] = np.nan
        row[rng.integers(0, 600, 100)] = rng.integers(-2, 3, 100)
    elif case == "signed_zeros":
        row[:] = rng.integers(-2, 3, 600)
        row[row == 0] = np.where(rng.random(int((row == 0).sum())) < 0.5, -0.0, 0.0)
    for cap, threads in ((4, 256), (RADIX_CAND_CAP, 1024)):  # both orderings of the emitted
        got = knn_radix_select(radix_score_keys(row), k, cap, threads)[0]
        np.testing.assert_array_equal(got, ranked(row, k))
    if case == "signed_zeros":  # knn_plain's own order of the same row
        want = torch.sort(torch.from_numpy(row), descending=True, stable=True).indices[:k]
        np.testing.assert_array_equal(got, want.numpy())


def test_nan_points_in_a_cloud():
    """Points with a NaN coordinate: their rows all -1, their columns never
    ranked in the other rows."""
    x = np.random.default_rng(5).standard_normal((1, 400, 3)).astype(np.float32)
    x[0, np.random.default_rng(6).permutation(400)[:150], 1] = np.nan
    scores = K.knn_scores(torch.from_numpy(x))[0].numpy()
    got = knn_radix_route(scores, 300, tile=64, group=32)[0]
    np.testing.assert_array_equal(got, np.stack([ranked(s, 300) for s in scores]))


@pytest.mark.parametrize("k", [257, 260])
def test_knn_plain_matches_hpcs_tpu(k):
    """knn_plain at k > 256 on two 264-point clouds with exact fp32 scores (a
    lattice, and Gaussian points rounded to eighths): hpcs_tpu's XLA knn and
    (at k = 260, the shape of the forward's first graph below)
    knn_pallas(interpret=True, mode="exact"), index for index."""
    from hpcs_tpu.ops.knn import knn as j_knn
    from hpcs_tpu.ops.pallas import knn_pallas

    rng = np.random.default_rng(k)
    x = np.concatenate([lattice_cloud(rng, 1, 264),
                        np.round(rng.standard_normal((1, 264, 3)) * 8) / 8]).astype(np.float32)
    got = K.knn_plain(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_knn(jnp.asarray(x), k)))
    if k == 260:
        np.testing.assert_array_equal(got, np.asarray(knn_pallas(jnp.asarray(x), k, interpret=True,
                                                                 mode="exact")))


def test_embed_at_k260_matches_flax_graph(monkeypatch):
    """The port's eval forward at k = 260 (B = 2, N = 264, eucl = hyp = 8, 4
    categories) against hpcs_tpu's flax graph on weights carried across by
    from_jax_params: within atol 2e-4 / rtol 1e-3; each graph (knn_plain
    here; the radix route on the card) against knn_pallas in interpret mode,
    the coordinates' equal index for index, the features' up to near-ties
    (test_torch_long_cloud.py's rule)."""
    from hpcs_tpu.models import HypHCSystem as JSystem
    from hpcs_tpu.models import ModelConfig as JConfig
    from hpcs_tpu.ops.pallas import knn_pallas
    from hpcs_torch.data import SyntheticPartDataset
    from hpcs_torch.models import HypHCSystem, ModelConfig, decode_vector_for_batch
    from hpcs_torch.nn.backbones import vn_dgcnn
    from hpcs_torch.utils.jax_params import from_jax_params

    B, n, C, k = 2, 264, 4, 260
    kw = dict(num_class=10, num_categories=C, eucl_dim=8, hyp_dim=8, k=k)
    jsys = JSystem(JConfig(dataset="shapenet", fixed_points=n, **kw))
    pts, cat, _ = SyntheticPartDataset(B, n, C, seed=2).batch(0, B)
    batch = {"points": jnp.asarray(pts), "labels": jnp.zeros((B, n), jnp.int32),
             "category": jnp.asarray(cat.astype(np.int32))}
    state = jsys.init(jax.random.PRNGKey(2), batch)
    params = to_numpy_tree(state.params)
    stats = randomize_batch_stats(to_numpy_tree(state.batch_stats), np.random.default_rng(2))
    tsys = HypHCSystem(ModelConfig(**kw), device="cpu")
    tsys.net.load_state_dict(from_jax_params(params, stats))

    graphs = []
    real = vn_dgcnn.knn

    def recorded(x, kk, **kw_):
        graphs.append((x.numpy().copy(), real(x, kk, **kw_)))
        return graphs[-1][1]

    monkeypatch.setattr(vn_dgcnn, "knn", recorded)
    dv = decode_vector_for_batch(tsys.cfg, {"points": pts, "category": cat})
    got_e, got_p = tsys.embed(pts, dv)
    assert [g[0].shape[-1] for g in graphs] == [3, 63, 63]
    for x, idx in graphs:
        assert idx.shape == (B, n, k)
        want = np.asarray(knn_pallas(jnp.asarray(x), k, interpret=True, mode="exact"))
        _same_up_to_near_ties(x, idx.numpy(), want, exact=x.shape[-1] == 3)

    apply = jax.jit(lambda v, p, d: jsys.net.apply(v, p, d, train=False))
    want_e, want_p = apply({"params": params, "batch_stats": stats}, jnp.asarray(pts),
                           jnp.asarray(dv.numpy()))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
