"""The port's decode (hpcs_torch.decode) against hpcs_tpu.decode on the CPU.

Both sides get the same inputs, made with numpy from a seed; linkages are
fed one shared fp32 distance matrix.  The MNN linkage must give hpcs_tpu's
Z exactly, on tie-free data and on exact-duplicate groups; so must the cut
tables and the best-k sweep on a shared Z.  Fast cases keep N <= 300, so
one passes the compaction stages 300 -> 150 -> 128; N = 1024 is `slow`.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcs_tpu.decode import get_optimal_k as j_get_optimal_k
from hpcs_tpu.decode.linkage import build_cut_tables as j_build_cut_tables
from hpcs_tpu.decode.linkage import cosine_distance_matrix as j_cosine
from hpcs_tpu.decode.linkage import cut_maxclust as j_cut_maxclust
from hpcs_tpu.decode.linkage import cut_roots_sweep as j_cut_roots_sweep
from hpcs_tpu.decode.linkage import linkage_from_distances_mnn as j_mnn
from hpcs_tpu.decode.scores import remap_consecutive as j_remap
from hpcs_torch.decode import (
    build_cut_tables,
    cosine_distance_matrix,
    cut_roots_sweep,
    get_optimal_k,
    linkage_from_distances_mnn,
    remap_consecutive,
)
from hpcs_torch.decode.linkage import pair_hash
from hpcs_torch.geometry.math_ops import fma, l2_normalize_rn, sqrt_rn

# the module: the package's `linkage` is the function, as in hpcs_tpu.decode
linkage_module = sys.modules["hpcs_torch.decode.linkage"]

METHODS = ["complete", "single", "average"]


def _points(kind, n=300, f=8, seed=0):
    if kind == "tie_free":
        return np.random.default_rng(seed).standard_normal((n, f)).astype(np.float32)
    # tests/test_decode.py's tie-heavy data: 6 groups of 32 exact duplicates
    base = np.random.RandomState(11).randn(6, 5).astype(np.float32)
    return np.repeat(base, 32, axis=0)


def _shared_d(x):
    """hpcs_tpu's distance matrix of x, as numpy fp32."""
    return np.array(jax.jit(j_cosine)(jnp.asarray(x)), np.float32)


def _both_linkages(D, method):
    want = np.asarray(j_mnn(jnp.asarray(D), method=method))
    got = linkage_from_distances_mnn(torch.from_numpy(D), method)
    return got.numpy(), want


@pytest.mark.parametrize("F", [3, 8, 32])
@pytest.mark.parametrize("N", [64, 300])
def test_cosine_distance_matrix_matches_jax(F, N):
    x = np.random.default_rng(F * N).standard_normal((2, N, F)).astype(np.float32)
    got = cosine_distance_matrix(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.vmap(j_cosine))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, np.swapaxes(got, 1, 2))  # exactly symmetric


def test_cosine_distance_matrix_chunks_agree(monkeypatch):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 50, 6)).astype(np.float32))
    whole = cosine_distance_matrix(x)
    monkeypatch.setattr(linkage_module, "_CHUNK_PAIRS", 7 * 150)  # 7 rows a chunk
    torch.testing.assert_close(cosine_distance_matrix(x), whole, rtol=0, atol=0)


def test_fma_rounds_once():
    """fp32 a * b + c with one rounding, where two roundings differ."""
    a = torch.tensor([1 + 2 ** -12, 3.0, -(1 + 2 ** -23)], dtype=torch.float32)
    c = torch.tensor([-1.0, 1e-8, 1.0], dtype=torch.float32)
    want = (a.double() * a.double() + c.double()).float()  # exact in float64 here
    torch.testing.assert_close(fma(a, a, c), want, rtol=0, atol=0)
    assert fma(a, a, c)[0] != (a * a + c)[0]


def test_sqrt_rn_is_correctly_rounded():
    x = np.random.default_rng(4).uniform(0, 4, 10000).astype(np.float32)
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(), np.sqrt(x))


def test_l2_normalize_matches_jax():
    from hpcs_tpu.geometry.math_ops import l2_normalize as j_l2

    x = np.random.default_rng(2).standard_normal((4, 40, 32)).astype(np.float32)
    x[0, 0] = 0.0
    got = l2_normalize_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(j_l2)(jnp.asarray(x))))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", ["tie_free", "duplicates"])
def test_mnn_linkage_equals_jax_exactly(method, kind):
    got, want = _both_linkages(_shared_d(_points(kind)), method)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["tie_free", "duplicates"])
def test_mnn_average_linkage_matches_jax(kind):
    """Heights within 1e-6 and the same flat cuts at every k <= 20."""
    got, want = _both_linkages(_shared_d(_points(kind)), "average")
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    Z = torch.from_numpy(got)[None]
    _, labels, ks = cut_roots_sweep(Z, *build_cut_tables(Z), 20)
    for i, k in enumerate(ks.tolist()):
        _assert_same_partition(labels[0, i].numpy(),
                               np.asarray(j_cut_maxclust(jnp.asarray(want), k)))


def _assert_same_partition(a, b):
    pairs = set(zip(a.tolist(), b.tolist()))
    assert len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("method", METHODS)
def test_mnn_linkage_batch_runs_each_object_as_alone(method):
    """Objects that need different rounds, run in lockstep, give each its own Z."""
    Ds = np.stack([_shared_d(_points("tie_free", n=150, seed=3)),
                   _shared_d(_points("duplicates")[:150])])
    Z, lockstep, rounds = linkage_from_distances_mnn(torch.from_numpy(Ds), method,
                                                     return_rounds=True)
    for b in range(2):
        one, r1 = linkage_from_distances_mnn(torch.from_numpy(Ds[b:b + 1]), method,
                                             return_rounds=True)[::2]
        torch.testing.assert_close(Z[b], one[0], rtol=0, atol=0)
        assert int(rounds[b]) == int(r1[0])
    assert lockstep >= int(rounds.max())


@pytest.mark.parametrize("N", [32, 300])
def test_mnn_linkage_ends_on_all_nan(N):
    """All-NaN D merges nothing; the N-round bound ends the loop, with
    hpcs_tpu's rows."""
    D = np.full((N, N), np.nan, np.float32)
    got, want = _both_linkages(D, "complete")
    assert got.shape == (N - 1, 4)
    np.testing.assert_array_equal(got, want)


def test_pair_hash_matches_uint32_arithmetic():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 2 ** 16, size=(2, 64)).astype(np.int64)
    ids[0, :3] = [0, 2 ** 16 - 1, 2 ** 16]
    u = ids.astype(np.uint32)
    a, b = u[:, None, :], u[:, :, None]
    with np.errstate(over="ignore"):
        h = ((a + b) * np.uint32(0x9E3779B1)) ^ ((a * b) * np.uint32(0x85EBCA77))
    want = (h ^ (h >> np.uint32(13))) & np.uint32(0x7FFFFFFF)
    np.testing.assert_array_equal(pair_hash(torch.from_numpy(ids)).numpy(), want.astype(np.int64))


def test_cut_tables_and_sweep_equal_jax():
    Z = np.array(j_mnn(jnp.asarray(_shared_d(_points("tie_free", n=97, seed=4)))))
    want = j_build_cut_tables(jnp.asarray(Z))
    got = build_cut_tables(torch.from_numpy(Z)[None])
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][:, 0].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(want[2]))
    want_sweep = j_cut_roots_sweep(jnp.asarray(Z), *want, 12)
    got_sweep = cut_roots_sweep(torch.from_numpy(Z)[None], *got, 12)
    for g, w in zip(got_sweep[:2], want_sweep[:2]):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    np.testing.assert_array_equal(got_sweep[2].numpy(), np.asarray(want_sweep[2]))


def test_remap_consecutive_matches_jax():
    y = np.array([[7, 3, 3, 9, 0], [1, 1, 1, 1, 1]])
    got, count = remap_consecutive(torch.from_numpy(y), 10)
    for b in range(2):
        w, c = j_remap(jnp.asarray(y[b]), 10)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(w))
        assert int(count[b]) == int(c)


def _optimal_k_pair(y, Z, num_class, index):
    want = j_get_optimal_k(jnp.asarray(y), jnp.asarray(Z), num_class=num_class, index=index)
    got = get_optimal_k(torch.from_numpy(y)[None], torch.from_numpy(Z)[None], num_class, index)
    return [g[0].numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("index", ["iou", "ri"])
@pytest.mark.parametrize("kind", ["tie_free", "duplicates"])
def test_get_optimal_k_equals_jax(index, kind):
    x = _points(kind, n=192)
    y = np.random.default_rng(6).integers(0, 7, len(x))
    y[: len(x) // 2] = np.repeat(np.arange(6), 32)[: len(x) // 2]
    Z = np.array(j_mnn(jnp.asarray(_shared_d(x))))
    got, want = _optimal_k_pair(y, Z, 8, index)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("trial", range(4))
def test_get_optimal_k_keeps_smallest_k_among_ties(trial):
    """tests/test_decode.py's tie case: random labels give equal-score cuts,
    and the smallest k wins on both sides."""
    rng = np.random.RandomState(11)
    for _ in range(trial + 1):
        x = rng.randn(48, 6).astype(np.float32)
        y = rng.randint(0, 5, 48)
    Z = np.array(j_mnn(jnp.asarray(_shared_d(x))))
    got, want = _optimal_k_pair(y, Z, 5, "iou")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_get_optimal_k_batch_equals_each_object():
    Zs, ys = [], []
    for seed in range(3):
        Zs.append(np.array(j_mnn(jnp.asarray(_shared_d(_points("tie_free", 80, 5, seed))))))
        ys.append(np.random.default_rng(seed).integers(0, 6, 80))
    batch = get_optimal_k(torch.from_numpy(np.stack(ys)), torch.from_numpy(np.stack(Zs)), 6)
    for b in range(3):
        one = get_optimal_k(torch.from_numpy(ys[b])[None], torch.from_numpy(Zs[b])[None], 6)
        for g, o in zip(batch, one):
            torch.testing.assert_close(g[b], o[0], rtol=0, atol=0)


@pytest.mark.slow
@pytest.mark.parametrize("method", ["complete", "single"])
def test_mnn_linkage_equals_jax_at_flagship_size(method):
    x = np.random.default_rng(8).standard_normal((1024, 32)).astype(np.float32)
    got, want = _both_linkages(_shared_d(x), method)
    np.testing.assert_array_equal(got, want)
