"""The rest of hpcs_tpu.decode's API in the port, against hpcs_tpu on a
shared D or Z: the sequential linkage, `linkage`, Euclidean distances, the
flat cuts (and scipy's fcluster), purity, weighted Jaccard and
eval_clustering; and the port's copy of hpcs_tpu/utils/arrays.py.

Z and labels must be equal exactly, the scores within 1e-6.  The port runs
two objects as one batch, hpcs_tpu one object at a time."""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.cluster.hierarchy import fcluster

import hpcs_tpu.decode as J
import hpcs_torch.decode as T
from hpcs_tpu.utils import arrays as j_arrays
from hpcs_torch.utils import arrays as t_arrays

JL = sys.modules["hpcs_tpu.decode.linkage"]  # the module, not the `linkage` function
JS = sys.modules["hpcs_tpu.decode.scores"]
N, B = 48, 2
METHODS = ["complete", "single", "average"]


def _points(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "untied":
        return rng.standard_normal((B, N, 5)).astype(np.float32)
    # duplicate-point groups, as tests/test_decode.py's tie-heavy case: 6
    # groups of 8 equal points, distances bit-zero inside a group
    base = rng.standard_normal((B, 6, 5)).astype(np.float32)
    return np.repeat(base, N // 6, axis=1)


def _distances(kind, seed=0):
    """D [B, N, N] (float32) shared by both packages: hpcs_tpu's cosine
    distances of the points, or all NaN."""
    if kind == "nan":
        return np.full((B, N, N), np.nan, np.float32)
    x = _points(kind, seed)
    return np.stack([np.asarray(J.cosine_distance_matrix(jnp.asarray(o))) for o in x])


def _jax_z(D, method, algorithm="sequential"):
    fn = J.linkage_from_distances if algorithm == "sequential" else J.linkage_from_distances_mnn
    return np.stack([np.asarray(fn(jnp.asarray(d), method=method)) for d in D])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["untied", "tied", "nan"])
def test_sequential_linkage_equals_jax(kind, method):
    D = _distances(kind)
    got = T.linkage_from_distances(torch.from_numpy(D), method).numpy()
    np.testing.assert_array_equal(got, _jax_z(D, method))
    # one object alone, unbatched, is its row of the batch
    np.testing.assert_array_equal(T.linkage_from_distances(torch.from_numpy(D[1]), method).numpy(),
                                  got[1])
    if kind != "nan":
        # the sequential and the MNN dendrograms have the same heights (the
        # average's weighted means rounded in another grouping: within 1e-6)
        mnn = T.linkage_from_distances_mnn(torch.from_numpy(D), method).numpy()
        np.testing.assert_allclose(np.sort(got[..., 2], -1), np.sort(mnn[..., 2], -1), rtol=0,
                                   atol=1e-6 if method == "average" else 0)


def _ks():
    return [1, 2, N // 2, N - 1, N]


@pytest.mark.parametrize("algorithm", ["sequential", "mnn"])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["untied", "tied"])
def test_flat_cuts_equal_jax_and_fcluster(kind, method, algorithm):
    """cut_maxclust, cut_maxclust_many and cut_maxclust_fcluster at k = 1, 2,
    N/2, N-1 and N, on hpcs_tpu's Z; the fcluster cut also equals scipy's
    fcluster(Z, k, 'maxclust') - 1 (tie blocks across the boundary on the
    tied data)."""
    Z = _jax_z(_distances(kind, seed=1), method, algorithm)
    Zt = torch.from_numpy(Z)
    ks = _ks()
    many = T.cut_maxclust_many(Zt, torch.tensor(ks)).numpy()
    for b in range(B):
        want_many = np.asarray(JL.cut_maxclust_many(jnp.asarray(Z[b]), jnp.asarray(ks)))
        np.testing.assert_array_equal(many[b], want_many)
    for i, k in enumerate(ks):
        cut = T.cut_maxclust(Zt, k).numpy()
        fc = T.cut_maxclust_fcluster(Zt, k).numpy()
        np.testing.assert_array_equal(many[:, i], cut)
        for b in range(B):
            zj = jnp.asarray(Z[b])
            np.testing.assert_array_equal(cut[b], np.asarray(J.cut_maxclust(zj, k)), err_msg=k)
            np.testing.assert_array_equal(fc[b], np.asarray(J.cut_maxclust_fcluster(zj, k)),
                                          err_msg=k)
            np.testing.assert_array_equal(
                fc[b], fcluster(Z[b].astype(np.float64), k, "maxclust") - 1, err_msg=k)
    # a k per object
    per = T.cut_maxclust_fcluster(Zt, torch.tensor([2, N // 2])).numpy()
    np.testing.assert_array_equal(per[1], T.cut_maxclust_fcluster(Zt[1], N // 2).numpy())


@pytest.mark.parametrize("fcluster_ids", [False, True])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["untied", "tied"])
def test_eval_clustering_equals_jax(kind, method, fcluster_ids):
    Z = _jax_z(_distances(kind, seed=2), method)
    y = np.random.default_rng(3).integers(0, 7, size=(B, N))
    y[1, :5] = 9  # labels need not be consecutive
    got = T.eval_clustering(torch.from_numpy(y), torch.from_numpy(Z), 10, fcluster_ids)
    for b in range(B):
        want = J.eval_clustering(jnp.asarray(y[b]), jnp.asarray(Z[b]), 10,
                                 fcluster_ids=fcluster_ids)
        for g, w in zip(got, want):
            assert abs(float(g[b]) - float(w)) <= 1e-6
        one = T.eval_clustering(torch.from_numpy(y[b]), torch.from_numpy(Z[b]), 10, fcluster_ids)
        assert [float(v) for v in one] == [float(g[b]) for g in got]


@pytest.mark.parametrize("c_max,k_max", [(6, 6), (4, 9), (9, 3)])
def test_purity_and_weighted_jaccard_equal_jax(c_max, k_max):
    rng = np.random.default_rng(c_max * 10 + k_max)
    y_true = rng.integers(0, c_max, size=(3, 200))
    y_pred = rng.integers(0, k_max, size=(3, 200))
    y_pred[2] = np.minimum(y_true[2], k_max - 1)  # a near-perfect cut
    p = T.purity(torch.from_numpy(y_true), torch.from_numpy(y_pred), c_max, k_max)
    w = T.weighted_jaccard(torch.from_numpy(y_true), torch.from_numpy(y_pred), c_max, k_max)
    for b in range(3):
        yt, yp = jnp.asarray(y_true[b]), jnp.asarray(y_pred[b])
        assert abs(float(p[b]) - float(JS.purity(yt, yp, c_max, k_max))) <= 1e-6
        assert abs(float(w[b]) - float(JS.weighted_jaccard(yt, yp, c_max, k_max))) <= 1e-6


def test_euclidean_distances_match_jax():
    x = np.random.default_rng(4).standard_normal((B, N, 7)).astype(np.float32)
    got = T.euclidean_distance_matrix(torch.from_numpy(x)).numpy()
    want = np.stack([np.asarray(J.euclidean_distance_matrix(jnp.asarray(o))) for o in x])
    # the expansion form cancels on the diagonal: there both are the root of
    # a few ulps of |x|^2
    sq = (x.astype(np.float64) ** 2).sum(-1).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=np.sqrt(8 * 2.0 ** -23 * sq))
    exact = np.sqrt(((x[:, :, None].astype(np.float64) - x[:, None]) ** 2).sum(-1))
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=np.sqrt(8 * 2.0 ** -23 * sq))


@pytest.mark.parametrize("algorithm", ["mnn", "sequential"])
@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_linkage_from_observations(metric, algorithm):
    """linkage(x) is the port's distances, then the chosen linkage; on the
    port's D hpcs_tpu's linkage gives the same Z, and hpcs_tpu's
    linkage(x) (its own distances, within an ulp) the same heights within
    1e-6."""
    x = _points("untied", 5)
    got = T.linkage(torch.from_numpy(x), "complete", metric, algorithm).numpy()
    dist = T.cosine_distance_matrix if metric == "cosine" else T.euclidean_distance_matrix
    D = dist(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _jax_z(D, "complete", algorithm))
    for b in range(B):
        want = np.asarray(J.linkage(jnp.asarray(x[b]), "complete", metric, algorithm))
        np.testing.assert_allclose(np.sort(got[b, :, 2]), np.sort(want[:, 2]), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="metric"):
        T.linkage(torch.from_numpy(x), metric="cityblock")


def test_decode_exports_every_name_of_hpcs_tpu():
    assert set(J.__all__) <= set(T.__all__)
    assert {"weighted_jaccard", "cut_maxclust_many"} <= set(T.__all__)
    for name in T.__all__:
        assert callable(getattr(T, name)), name


def _arrays_cases(m):
    """The cases of tests/test_arrays.py, on module m (either package's
    arrays.py): name -> result."""
    y_true = np.array([0, 0, 1, 1, 2, 2])
    y_pred = np.array([0, 1, 1, 1, 2, 0])
    conf, renorm = m.get_confusion_matrix(y_true, y_pred, [0, 1, 2])
    return {
        "cartesian_product": m.cartesian_product([np.array([0, 1]), np.array([5, 6, 7])]),
        "set_distance": m.set_distance(np.array([[0.0, 0.0], [1.0, 0.0]]),
                                       np.array([[3.0, 4.0], [1.0, 1.0]]), return_amin=True),
        "subset_backprojection": m.subset_backprojection([True, False, True]),
        "mat_renorm_rows": m.mat_renorm_rows(np.array([[2.0, 2.0], [0.0, 0.0]])),
        "confusion": (conf, renorm, m.condense_confusion_matrix(conf, [0, 1, 2], [[0, 1], [2]])),
        # labels outside the selection are dropped, and the selection's order kept
        "confusion_subset": m.get_confusion_matrix(np.array([0, 3, 1, 2, 2]),
                                                   np.array([1, 1, 3, 2, 0]), [2, 0, 1]),
    }


@pytest.mark.parametrize("case", list(_arrays_cases(t_arrays)))
def test_arrays_equal_hpcs_tpu(case):
    got, want = _arrays_cases(t_arrays)[case], _arrays_cases(j_arrays)[case]
    _assert_same(got, want)
    if case == "confusion":
        assert got[2][0, 0] == 4 and got[2].sum() == got[0].sum()


def _assert_same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert type(got) is type(want)
        np.testing.assert_array_equal(got, want)
