"""The port's eval forward at k = 40 against hpcs_tpu's, on shared weights.

k > 32 sends every kNN graph of the forward down the wide route on the card
(chip_smoke.py's long_cloud phase); here, on the CPU, the port's graphs come
from knn_plain.  HypHCSystem.embed at a small width (eucl = hyp = 8, 4
categories, B = 2, N = 192) against hpcs_tpu's flax graph
(system.net.apply, train=False) on weights carried across by
utils/jax_params.from_jax_params, with random batch statistics: the output
within test_torch_forward.py's tolerance (atol 2e-4 / rtol 1e-3), and each
of the three graphs against hpcs_tpu's kNN kernel on the same stage input
(knn_pallas in interpret mode, mode="exact": the ranking key 2 x_i.x_j -
|x_j|^2 of B1 and the wide route): the coordinates' graph (D = 3) equal
index for index; the features' (D = 63) equal but where two columns' exact
scores lie within the fp32 rounding of the two packages' sums, taken in
another order (chip_smoke.py's knn_check rule).  At this seed one such
pair, 7.2e-8 apart at 1.42 (under one fp32 ulp), comes out swapped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import randomize_batch_stats, to_numpy_tree
from hpcs_tpu.models import HypHCSystem as JSystem
from hpcs_tpu.models import ModelConfig as JConfig
from hpcs_tpu.ops.pallas import knn_pallas
from hpcs_torch.data import SyntheticPartDataset
from hpcs_torch.models import HypHCSystem, ModelConfig, decode_vector_for_batch
from hpcs_torch.nn.backbones import vn_dgcnn
from hpcs_torch.utils.jax_params import from_jax_params

TOL = dict(atol=2e-4, rtol=1e-3)  # test_torch_forward.py's


def _same_up_to_near_ties(x, got, want, exact):
    """got == want, or (not exact) each differing entry's two columns'
    float64 scores within (D + 2) 2^-23 of their terms' magnitudes."""
    b, i, j = np.nonzero(got != want)
    if exact or not len(b):
        np.testing.assert_array_equal(got, want)
        return
    xd = x.astype(np.float64)
    xi = xd[b, i]

    def score(c):
        xc = xd[b, c]
        return 2 * (xi * xc).sum(-1) - (xc * xc).sum(-1)

    def magnitude(c):
        xc = xd[b, c]
        return 2 * np.abs(xi * xc).sum(-1) + (xc * xc).sum(-1)

    gap = np.abs(score(got[b, i, j]) - score(want[b, i, j]))
    rounding = (x.shape[-1] + 2) * 2.0 ** -23 * (magnitude(got[b, i, j]) + magnitude(want[b, i, j]))
    assert (gap <= rounding).all(), (gap, rounding)
    assert len(b) <= 1e-3 * got.size


@pytest.mark.parametrize("k", [40])
def test_embed_at_k40_matches_flax_graph(k, monkeypatch):
    B, N, C = 2, 192, 4
    kw = dict(num_class=10, num_categories=C, eucl_dim=8, hyp_dim=8, k=k)
    jsys = JSystem(JConfig(dataset="shapenet", fixed_points=N, **kw))
    pts, cat, _ = SyntheticPartDataset(B, N, C, seed=1).batch(0, B)
    batch = {"points": jnp.asarray(pts), "labels": jnp.zeros((B, N), jnp.int32),
             "category": jnp.asarray(cat.astype(np.int32))}
    state = jsys.init(jax.random.PRNGKey(1), batch)
    params = to_numpy_tree(state.params)
    stats = randomize_batch_stats(to_numpy_tree(state.batch_stats), np.random.default_rng(1))
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
        assert idx.shape == (B, N, k)
        want = np.asarray(knn_pallas(jnp.asarray(x), k, interpret=True, mode="exact"))
        _same_up_to_near_ties(x, idx.numpy(), want, exact=x.shape[-1] == 3)

    apply = jax.jit(lambda v, p, d: jsys.net.apply(v, p, d, train=False))
    want_e, want_p = apply({"params": params, "batch_stats": stats}, jnp.asarray(pts),
                           jnp.asarray(dv.numpy()))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
