"""Port kNN vs hpcs_tpu: knn_plain must equal knn_pallas(interpret, exact)
and the XLA knn exactly, ties included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import lattice_cloud, tie_cloud
from hpcs_tpu.ops.knn import gather_neighbors as j_gather_neighbors
from hpcs_tpu.ops.knn import knn as j_knn
from hpcs_tpu.ops.pallas import knn_pallas
from hpcs_torch.ops import knn as K


def _cloud(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("D,N,k", [(3, 128, 8), (3, 256, 20), (63, 128, 8), (63, 256, 20)])
def test_knn_plain_matches_jax_exactly(D, N, k):
    x = _cloud((2, N, D), seed=D + N)
    got = K.knn_plain(torch.from_numpy(x), k).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(knn_pallas(jnp.asarray(x), k, interpret=True,
                                                             mode="exact")))
    np.testing.assert_array_equal(got, np.asarray(j_knn(jnp.asarray(x), k)))


@pytest.mark.parametrize("D", [3, 63])
def test_knn_plain_ties_match_pallas(D):
    """Every point appears twice: the tied copy must come in index order."""
    x = tie_cloud(np.random.default_rng(D), 2, 128, D)
    got = K.knn_plain(torch.from_numpy(x), 8).numpy()
    want = np.asarray(knn_pallas(jnp.asarray(x), 8, interpret=True, mode="exact"))
    np.testing.assert_array_equal(got, want)
    i = np.arange(64)
    np.testing.assert_array_equal(got[:, :64, :2], np.broadcast_to(np.stack([i, i + 64], -1),
                                                                   (2, 64, 2)))


def test_knn_plain_lattice_ties_match_pallas():
    """Many distinct neighbours at exactly equal distance: smallest index first."""
    x = lattice_cloud(np.random.default_rng(0), 2, 128)
    got = K.knn_plain(torch.from_numpy(x), 20).numpy()
    want = np.asarray(knn_pallas(jnp.asarray(x), 20, interpret=True, mode="exact"))
    np.testing.assert_array_equal(got, want)


def test_gather_neighbors_matches_jax():
    x = _cloud((2, 32, 5, 3), 1)
    idx = np.random.default_rng(2).integers(0, 32, (2, 32, 6)).astype(np.int32)
    got = K.gather_neighbors(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    want = j_gather_neighbors(jnp.asarray(x), jnp.asarray(idx))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_knn_on_cpu_takes_the_plain_version():
    x = torch.from_numpy(_cloud((1, 64, 3), 3))
    before = K.knn.launches
    torch.testing.assert_close(K.knn(x, 5), K.knn_plain(x, 5), rtol=0, atol=0)
    assert K.knn.launches == before

