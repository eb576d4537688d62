"""The port's triplet miner (hpcs_torch.miner) held to the laws that
tests/test_miner.py holds hpcs_tpu's to, and its margin filter and
similarities against hpcs_tpu's on the same triplets.

The two packages draw from different random streams, so no draw is
compared: the laws are validity, the masks of singleton and single-class
labels, the rare-class up-weighting, uniform positives and negatives,
distinct random triplets and the filter's keep rule.  The similarities
match within atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcs_tpu.miner import cosine_similarity01 as j_cos01
from hpcs_tpu.miner import margin_filter as j_margin_filter
from hpcs_tpu.miner import pairwise_cosine_similarity01 as j_pairwise
from hpcs_tpu.miner.triplet import Triplets as JTriplets
from hpcs_torch.miner import (
    Triplets,
    cosine_similarity01,
    margin_filter,
    pairwise_cosine_similarity01,
    sample_balanced_triplets,
    sample_random_triplets,
)


def _gen(seed=11):
    return torch.Generator().manual_seed(seed)


def _labels(counts, shuffle_seed=None):
    lab = np.concatenate([np.full(c, i) for i, c in enumerate(counts)])
    if shuffle_seed is not None:  # the sampler must not rely on sorted labels
        lab = np.random.default_rng(shuffle_seed).permutation(lab)
    return torch.from_numpy(lab)


def _np(trip):
    return [t.numpy() for t in trip]


@pytest.mark.parametrize("shuffle", [None, 3])
def test_triplet_validity_laws(shuffle):
    labels = _labels([10, 20, 5], shuffle)
    a, p, n, mask = _np(sample_balanced_triplets(_gen(), labels, 3, t_per_anchor=20))
    lab = labels.numpy()
    assert a.shape == (20 * 35,) and mask.dtype == np.float32
    assert (mask == 1).all()  # every label has >= 2 members and negatives exist
    assert (lab[a] == lab[p]).all() and (a != p).all()
    assert (lab[a] != lab[n]).all()


def test_triplet_singleton_label_masked():
    labels = _labels([1, 8])
    a, p, n, mask = _np(sample_balanced_triplets(_gen(), labels, 2, t_per_anchor=30))
    lab = labels.numpy()
    assert (lab[a[mask > 0]] == 1).all() and (mask > 0).any()
    assert (a[mask > 0] != p[mask > 0]).all()
    assert (lab[a] == 1).all()  # a label that cannot form a triplet gets no anchor


def test_triplet_single_class_all_masked():
    trip = sample_balanced_triplets(_gen(), _labels([16]), 1, t_per_anchor=10)
    assert trip.mask.sum() == 0 and trip.anchor.shape == (160,)


def test_num_triplets_sets_the_count():
    trip = sample_balanced_triplets(_gen(), _labels([5, 7]), 2, num_triplets=33)
    assert all(t.shape == (33,) for t in trip)


@pytest.mark.parametrize("fraction,want", [(1.0, 0.5), (0.0, 10 / 110)])
def test_balanced_sampling_upweights_rare_classes(fraction, want):
    """fraction 1: each label draws ~equally many anchors; fraction 0: in
    proportion to its size."""
    labels = _labels([100, 10])
    a = sample_balanced_triplets(_gen(0), labels, 2, t_per_anchor=50, fraction=fraction).anchor
    frac_rare = (labels.numpy()[a.numpy()] == 1).mean()
    assert abs(frac_rare - want) < 0.03


def test_positive_and_negative_sampling_uniform():
    labels = _labels([4, 4])
    a, p, n, _ = _np(sample_balanced_triplets(_gen(1), labels, 2, t_per_anchor=4000))
    counts = np.bincount(p[a == 0], minlength=8)[1:4]  # the other members of label 0
    assert counts.min() > 0.8 * counts.mean()
    assert np.bincount(p[a == 0], minlength=8)[[0, 4, 5, 6, 7]].sum() == 0
    neg = np.bincount(n[a == 0], minlength=8)[4:]
    assert neg.min() > 0.8 * neg.mean()
    members = np.bincount(a[labels.numpy()[a] == 1], minlength=8)[4:]
    assert members.min() > 0.8 * members.mean()


def test_same_generator_seed_same_triplets():
    labels = _labels([6, 9, 3], shuffle_seed=1)
    t1 = sample_balanced_triplets(_gen(5), labels, 3, t_per_anchor=7)
    t2 = sample_balanced_triplets(_gen(5), labels, 3, t_per_anchor=7)
    for x, y in zip(t1, t2):
        assert torch.equal(x, y)


def _triplets(rng, M, T):
    return Triplets(*(torch.from_numpy(rng.integers(0, M, T)) for _ in range(3)),
                    torch.from_numpy((rng.uniform(size=T) > 0.2).astype(np.float32)))


@pytest.mark.parametrize("kind,margin", [("easy", 0.0), ("semihard", 0.05), ("hard", 0.05),
                                         ("all", 0.05)])
def test_margin_filter_matches_jax(kind, margin):
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((40, 6)).astype(np.float32)
    trip = _triplets(rng, 40, 500)
    got = margin_filter(torch.from_numpy(emb), trip, margin=margin, type_of_triplets=kind)
    want = j_margin_filter(jnp.asarray(emb), JTriplets(*(jnp.asarray(t.numpy()) for t in trip)),
                           margin=margin, type_of_triplets=kind)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.anchor is trip.anchor
    # the rule itself, on the port's similarities
    a = torch.from_numpy(emb)[trip.anchor]
    tm = (cosine_similarity01(a, torch.from_numpy(emb)[trip.positive])
          - cosine_similarity01(a, torch.from_numpy(emb)[trip.negative]))
    kept = got.mask > 0
    assert kept.sum() > 0 and bool((trip.mask[kept] == 1).all())
    if kind == "easy":
        assert bool((tm[kept] > margin).all())
        assert bool((tm[~kept & (trip.mask > 0)] <= margin).all())


def test_margin_filter_easy_on_the_reference_cloud():
    emb = torch.tensor([[1.0, 0], [1.0, 0.01], [-1.0, 0], [0.0, 1.0]])
    trip = sample_balanced_triplets(_gen(), torch.tensor([0, 0, 1, 1]), 2, t_per_anchor=50)
    a, p, n, mask = _np(margin_filter(emb, trip, margin=0.0, type_of_triplets="easy"))
    tm = (cosine_similarity01(emb[a], emb[p]) - cosine_similarity01(emb[a], emb[n])).numpy()
    assert (tm[mask > 0] > 0).all() and (tm[(mask == 0) & (trip.mask.numpy() > 0)] <= 0).all()


def test_sample_random_triplets_distinct():
    a, p, n, mask = _np(sample_random_triplets(_gen(), 32, t_per_anchor=10))
    assert a.shape == (320,) and (a != p).all()
    v = mask > 0
    assert (n[v] != a[v]).all() and (n[v] != p[v]).all()
    assert ((n[~v] == a[~v]) | (n[~v] == p[~v])).all()
    assert np.bincount(p, minlength=32).min() > 0


def test_similarities_match_jax():
    x = np.random.default_rng(4).standard_normal((16, 4)).astype(np.float32)
    y = np.random.default_rng(5).standard_normal((16, 4)).astype(np.float32)
    np.testing.assert_allclose(pairwise_cosine_similarity01(torch.from_numpy(x)).numpy(),
                               np.asarray(j_pairwise(jnp.asarray(x))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(cosine_similarity01(torch.from_numpy(x), torch.from_numpy(y)),
                               np.asarray(j_cos01(jnp.asarray(x), jnp.asarray(y))), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(cosine_similarity01(torch.from_numpy(x)).numpy(), 1.0, atol=1e-6)
