"""The port's losses (hpcs_torch.loss) and metrics (hpcs_torch.utils.metrics)
against hpcs_tpu's on the same embeddings, weights and triplets: values and
gradients (jax.grad against autograd).

compute_losses draws its triplets from a torch.Generator; here each of its
branches gets hpcs_tpu's own triplets (drawn from the JAX key as
hpcs_tpu's compute_losses splits it), handed to the port by patching its
sampler.  Tolerance atol 1e-5 / rtol 1e-4 on values and gradients: the
same fp32 formulas, reduced in another order.  Where the learnable radius
puts the leaves near the ball's edge (0.996, as far as the optimizer's
projection lets it go), the LCA is ill-conditioned in fp32 (see
test_torch_poincare.py): there both packages are held to the port's loss
in float64, the port's error at most 4 times JAX's plus 1e-6 and 1e-5 of
the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcs_tpu import loss as JL
from hpcs_tpu.miner import sample_balanced_triplets as j_balanced
from hpcs_tpu.miner import sample_random_triplets as j_random
from hpcs_tpu.miner.triplet import Triplets as JTriplets
from hpcs_tpu.utils import metrics as JM
from hpcs_torch import loss as TL
from hpcs_torch.loss import joint as TJ
from hpcs_torch.miner import Triplets
from hpcs_torch.utils import metrics as TM

TOL = dict(atol=1e-5, rtol=1e-4)
M, D, L = 120, 6, 7
HIERARCHY = [[[0, 1, 2], [3, 4]], [[0, 1], [5, 6]]]


def _data(seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    x = (np.tanh(np.linalg.norm(x, axis=-1, keepdims=True)) * x
         / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # in the ball
    labels = rng.integers(0, L, M).astype(np.int32)
    labels[:3] = [0, 3, 6]
    W = rng.standard_normal((D, L)).astype(np.float32)
    return x, labels, W, np.float32(scale)


def _injected(seed=1, T=900):
    """T triplets of three distinct points (repeated triplets included) and a
    random mask.  No point is paired with itself: the LCA of a leaf with
    itself is a point geodesic, rounding noise in either package."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, M, T)
    p = (a + rng.integers(1, M, T)) % M
    n = (a + rng.integers(1, M - 1, T)) % M
    n = np.where(n == p, (n + 1) % M, n)
    n = np.where(n == a, (n + 1) % M, n)
    assert ((a != p) & (a != n) & (p != n)).all()
    return a, p, n, (rng.uniform(size=T) > 0.25).astype(np.float32)


def _torch(trip):
    return Triplets(*(torch.from_numpy(np.asarray(t)) for t in trip))


def _jax(trip):
    return JTriplets(*(jnp.asarray(np.asarray(t)) for t in trip))


def _torch_vg(fn_t, args, argnums, dtype=torch.float32):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=i in argnums)
          if isinstance(a, np.ndarray) else a for i, a in enumerate(args)]
    y = fn_t(*ts)
    y.backward()
    return [float(y.detach())] + [ts[i].grad.double().numpy() for i in argnums]


def _jax_vg(fn_j, args, argnums):
    js = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    yj, gj = jax.jit(jax.value_and_grad(fn_j, argnums=tuple(argnums)))(*js)
    return [float(yj)] + [np.asarray(g) for g in gj]


def _check_vg(fn_t, fn_j, args, argnums):
    """fn(*args) and its gradients in the arguments `argnums`."""
    for got, want in zip(_torch_vg(fn_t, args, argnums), _jax_vg(fn_j, args, argnums)):
        np.testing.assert_allclose(got, want, **TOL)


def _check_vg_vs_float64(fn_t, fn_j, args, argnums):
    ref = _torch_vg(fn_t, args, argnums, torch.float64)
    for got, want, r in zip(_torch_vg(fn_t, args, argnums), _jax_vg(fn_j, args, argnums), ref):
        assert np.isfinite(got).all()
        assert np.abs(got - r).max() <= 4 * np.abs(want - r).max() + 1e-6 + 1e-5 * np.abs(r).max()


def test_cosface_logits_and_loss_match_jax():
    x, labels, W, _ = _data()
    got = TL.cosface_logits(torch.from_numpy(W), torch.from_numpy(x), torch.from_numpy(labels))
    want = JL.cosface_logits(jnp.asarray(W), jnp.asarray(x), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lab_t, lab_j = torch.from_numpy(labels), jnp.asarray(labels)
    _check_vg(lambda w, e: TL.cosface_loss(w, e, lab_t), lambda w, e: JL.cosface_loss(w, e, lab_j),
              (W, x), (0, 1))
    weights = np.random.default_rng(3).uniform(size=M).astype(np.float32)
    _check_vg(lambda w, e: TL.cosface_loss(w, e, lab_t, weights=torch.from_numpy(weights)),
              lambda w, e: JL.cosface_loss(w, e, lab_j, weights=jnp.asarray(weights)),
              (W, x), (0, 1))


def test_hierarchy_sum_matrices_equal_jax():
    got = TL.hierarchy_sum_matrices(HIERARCHY, L)
    want = JL.hierarchy_sum_matrices(HIERARCHY, L)
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("weighted", [False, True])
def test_hierarchical_losses_match_jax(weighted):
    x, labels, W, _ = _data()
    lab_t, lab_j = torch.from_numpy(labels), jnp.asarray(labels)
    S_t = TL.hierarchy_sum_matrices(HIERARCHY, L)
    S_j = JL.hierarchy_sum_matrices(HIERARCHY, L)
    wt = np.random.default_rng(4).uniform(size=M).astype(np.float32) if weighted else None
    kw_t = {"weights": torch.from_numpy(wt)} if weighted else {}
    kw_j = {"weights": jnp.asarray(wt)} if weighted else {}
    _check_vg(lambda w, e: TL.hierarchical_cosface_loss(w, e, lab_t, S_t, **kw_t),
              lambda w, e: JL.hierarchical_cosface_loss(w, e, lab_j, S_j, **kw_j), (W, x), (0, 1))
    probs = jax.nn.softmax(jnp.asarray(x @ W), -1)
    np.testing.assert_allclose(
        float(TL.hierarchical_loss(torch.from_numpy(np.array(probs)), lab_t, S_t)),
        float(JL.hierarchical_loss(probs, lab_j, S_j)), **TOL)


@pytest.mark.parametrize("scale", [1e-5, 1e-3, 0.3, 0.9, 0.996])
def test_hyphc_triplet_loss_matches_jax(scale):
    """Value and gradients in the embeddings and the learnable radius, on
    injected masked triplets; 1e-5 is below the radius's clamp."""
    x, _, _, s = _data(scale=scale)
    trip = _injected()
    # at the edge the radius's gradient (~1e-4) is fp32 noise in both
    # packages (hpcs_tpu's changes sign between eager and jit): only the
    # value and the embeddings' gradient are held there
    check, argnums = (_check_vg, (0, 1)) if scale <= 0.9 else (_check_vg_vs_float64, (0,))
    for T in (0.05, 1.0):
        check(lambda e, r: TL.hyphc_triplet_loss(e, _torch(trip), r, T),
              lambda e, r: JL.hyphc_triplet_loss(e, _jax(trip), r, T),
              (x, np.asarray([s], np.float32)), argnums)


def test_hyphc_loss_with_every_triplet_masked():
    x, _, _, s = _data()
    a, p, n, mask = _injected()
    trip = (a, p, n, np.zeros_like(mask))
    got = TL.hyphc_triplet_loss(torch.from_numpy(x), _torch(trip), torch.tensor(s), 0.1)
    torch.testing.assert_close(got, TL.mean_pairwise_similarity(torch.from_numpy(x)))


def test_mean_pairwise_similarity_is_the_matrix_mean():
    x, *_ = _data()
    xt = torch.from_numpy(x).double()
    xn = xt / xt.norm(dim=-1, keepdim=True)
    want = (0.5 * (1 + xn @ xn.T)).mean()
    torch.testing.assert_close(TL.mean_pairwise_similarity(xt), want)
    _check_vg(TL.mean_pairwise_similarity, JL.mean_pairwise_similarity, (x,), (0,))


@pytest.mark.parametrize("margin", [0.0, 0.05, 1.0])
def test_triplet_margin_loss_matches_jax(margin):
    x, *_ = _data()
    trip = _injected(2)
    _check_vg(lambda e: TL.triplet_margin_loss(e, _torch(trip), margin),
              lambda e: JL.triplet_margin_loss(e, _jax(trip), margin), (x,), (0,))


@pytest.mark.parametrize("factor", [0.5, 0.3, 0.1, 2.0])
def test_anneal_temperature_matches_jax(factor):
    assert TL.anneal_temperature(0.07, factor) == JL.anneal_temperature(0.07, factor)


BRANCHES = {"miner_cosface": dict(miner=True, cosface=True),
            "random_cosface": dict(miner=False, cosface=True),
            "miner_triplet": dict(miner=True, cosface=False, margin=0.05),
            "miner_hierarchical": dict(miner=True, cosface=True, hierarchical=True)}


@pytest.mark.parametrize("branch", BRANCHES)
def test_compute_losses_matches_jax_on_its_triplets(branch, monkeypatch):
    kw = dict(num_class=L, embedding_size=D, t_per_anchor=5, **BRANCHES[branch])
    x, labels, W, s = _data()
    key = jax.random.PRNGKey(7)
    k_hyp, k_metric = jax.random.split(key)  # as hpcs_tpu's compute_losses splits it
    if kw["miner"]:
        draws = [j_balanced(k_hyp, jnp.asarray(labels), L, 5, 1.2)]
    else:
        draws = [j_random(k_hyp, M, 5)]
    if not kw["cosface"]:
        draws.append(j_balanced(k_metric, jnp.asarray(labels), L, 5, 1.2))
    draws = [_torch(d) for d in draws]
    monkeypatch.setattr(TJ, "sample_balanced_triplets", lambda *a, **k: draws.pop(0))
    monkeypatch.setattr(TJ, "sample_random_triplets", lambda *a, **k: draws.pop(0))
    S = HIERARCHY if kw.get("hierarchical") else None
    mats_t = TL.hierarchy_sum_matrices(S, L) if S else None
    mats_j = JL.hierarchy_sum_matrices(S, L) if S else None

    def port(e, w):
        out = TL.compute_losses(torch.Generator(), TL.LossConfig(**kw), e,
                                torch.from_numpy(labels), torch.tensor(s), 0.1,
                                hierarchy_matrices=mats_t, cosface_W=w)
        return out["loss_hyp"] + 3 * out["loss_metric"]

    def ref(e, w):
        out = JL.compute_losses(key, JL.LossConfig(**kw), e, jnp.asarray(labels), s, 0.1,
                                hierarchy_matrices=mats_j, cosface_W=w)
        return out["loss_hyp"] + 3 * out["loss_metric"]

    _check_vg(port, ref, (x, W), (0, 1) if kw["cosface"] else (0,))
    assert not draws  # each branch drew what hpcs_tpu's draws


def test_get_logits_and_metrics_match_jax():
    x, labels, W, _ = _data()
    cfg_t, cfg_j = TL.LossConfig(num_class=L, embedding_size=D), JL.LossConfig(L, D)
    logits = TL.get_logits(cfg_t, torch.from_numpy(W), torch.from_numpy(x),
                           torch.from_numpy(labels))
    logits_j = JL.get_logits(cfg_j, jnp.asarray(W), jnp.asarray(x), jnp.asarray(labels))
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
    lab_t, lab_j = torch.from_numpy(labels), jnp.asarray(labels)
    # on the same logits: every class, and classes absent from both sides
    for lg in (logits_j, logits_j[:, :5] * 0 + jnp.arange(5.0), logits_j.at[:, 6].set(-9.0)):
        lt = torch.from_numpy(np.array(lg))
        assert float(TM.accuracy_top1(lt, lab_t)) == pytest.approx(
            float(JM.accuracy_top1(lg, lab_j)), abs=1e-7)
        assert float(TM.multiclass_jaccard(lt, lab_t, L)) == pytest.approx(
            float(JM.multiclass_jaccard(lg, lab_j, L)), abs=1e-6)
