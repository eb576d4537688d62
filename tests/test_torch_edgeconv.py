"""Port EdgeConv stage vs hpcs_tpu's fused_edgeconv_infer (interpret mode)
and _edgeconv_xla.  Tolerance atol 1e-5 / rtol 1e-4: the same fp32 math,
summed in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rand_bn, rand_vn_llr
from hpcs_tpu.ops.edgeconv import graph_feature_vn as j_graph_feature_vn
from hpcs_tpu.ops.pallas.edgeconv_pallas import (_affine_from_bn, _edgeconv_xla,
                                                 fused_edgeconv_infer)
from hpcs_torch.nn.vn.layers import VNLinearLeakyReLU, mean_pool
from hpcs_torch.ops import edgeconv as E
from hpcs_torch.ops.vn_math import channel_mix
from hpcs_torch.testing import check_planted_eps, planted_eps_stage

TOL = dict(atol=1e-5, rtol=1e-4)


def _inputs(B, N, K, C, C1, C2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, C, 3)).astype(np.float32)
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)

    def w(o, i):
        return (rng.standard_normal((o, i)) * 0.3).astype(np.float32)

    return dict(x=x, idx=idx, W1=w(C1, 2 * C), Wd1=w(C1, 2 * C), bn1=rand_bn(rng, C1),
                W2=w(C2, C1), Wd2=w(C2, C1), bn2=rand_bn(rng, C2))


def _torch_args(a):
    t = {k: torch.from_numpy(v) for k, v in a.items() if not k.startswith("bn")}
    for i in ("1", "2"):
        bn = {k: torch.from_numpy(v) for k, v in a["bn" + i].items()}
        t["ab" + i] = E.fold_bn(bn["scale"], bn["bias"], bn["mean"], bn["var"])
    return t


def _plain(a, n_convs, fn=E.edgeconv_infer_plain):
    t = _torch_args(a)
    return fn(t["x"], t["idx"], t["W1"], t["Wd1"], t["ab1"], t["W2"], t["Wd2"], t["ab2"],
              n_convs=n_convs)


def _jax_xla(a, n_convs):
    ab = [jnp.stack(_affine_from_bn(**{k: jnp.asarray(v) for k, v in a[b].items()}))
          for b in ("bn1", "bn2")]
    return _edgeconv_xla(jnp.asarray(a["x"]), jnp.asarray(a["idx"]), a["W1"].T, a["Wd1"].T,
                         ab[0], a["W2"].T, a["Wd2"].T, ab[1], 0.2, n_convs)


@pytest.mark.parametrize("n_convs", [1, 2])
@pytest.mark.parametrize("C,C1,C2", [(4, 6, 5), (1, 21, 21), (21, 21, 21)])
def test_edgeconv_plain_matches_xla(n_convs, C, C1, C2):
    a = _inputs(2, 64, 8, C, C1, C2, seed=C)
    got = _plain(a, n_convs)
    assert got.shape == (2, 64, C2 if n_convs == 2 else C1, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_xla(a, n_convs)), **TOL)


@pytest.mark.parametrize("n_convs", [1, 2])
def test_edgeconv_plain_matches_pallas_interpret(n_convs):
    a = _inputs(1, 32, 4, 21, 21, 21, seed=7)
    bns = [{k: jnp.asarray(v) for k, v in a[b].items()} for b in ("bn1", "bn2")]
    want = fused_edgeconv_infer(jnp.asarray(a["x"]), jnp.asarray(a["idx"]), a["W1"].T,
                                a["Wd1"].T, bns[0], a["W2"].T, a["Wd2"].T, bns[1],
                                interpret=True, n_convs=n_convs)
    np.testing.assert_allclose(_plain(a, n_convs).numpy(), np.asarray(want), **TOL)


PLANTED = [(1, 2, "conv1"), (1, 2, "conv2"), (21, 2, "conv1"), (21, 2, "conv2"), (21, 1, "conv1")]


@pytest.mark.parametrize("C,n_convs,variant", PLANTED)
def test_edgeconv_plain_matches_xla_near_gate_eps(C, n_convs, variant):
    """Pre-BatchNorm vectors of order EPS, exact in fp32: the port's gate
    places EPS as hpcs_tpu's does (atol 1e-5 / rtol 1e-4 against
    _edgeconv_xla), and agrees with itself in float64."""
    x, idx, w = planted_eps_stage(2, 64, 8, C, n_convs, variant, seed=C)
    got = E.edgeconv_infer_plain(x, idx, *w, n_convs=n_convs)
    j = [jnp.asarray(t.numpy()) for t in w]
    want = _edgeconv_xla(jnp.asarray(x.numpy()), jnp.asarray(idx.numpy()), j[0].T, j[1].T, j[2],
                         j[3].T, j[4].T, j[5], 0.2, n_convs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    check_planted_eps(E.edgeconv_infer, 2, 64, 8, C, n_convs, variant, "cpu", seed=C)


def _gate_without(eps_term):
    """A select-style EdgeConv stage, as the CUDA kernel computes it, with one
    of the gate's EPS terms left out."""
    def gate(e, W, Wd, ab):
        p, d = channel_mix(e, W), channel_mix(e, Wd)
        eps = 0.0 if eps_term == "norm" else 1e-6
        norm = torch.sqrt((p * p).sum(-1) + eps * eps) + eps
        p = p * ((ab[0] * norm + ab[1]) / norm)[..., None]
        dot, dsq = (p * d).sum(-1, keepdim=True), (d * d).sum(-1, keepdim=True)
        coeff = torch.where(dot < 0, dot / (dsq + (0.0 if eps_term == "dsq" else 1e-6)), 0.0)
        return 0.2 * p + 0.8 * (p - coeff * d)

    def stage(x, idx, W1, Wd1, ab1, W2, Wd2, ab2, n_convs=2):
        B, N, K = idx.shape
        e = E.graph_feature_vn(x, K, idx)[0].reshape(B * N * K, -1, 3)
        h = gate(e, W1, Wd1, ab1)
        if n_convs == 2:
            h = gate(h, W2, Wd2, ab2)
        return h.reshape(B, N, K, -1, 3).mean(dim=2)

    return stage


@pytest.mark.parametrize("eps_term", ["norm", "dsq", None])
@pytest.mark.parametrize("C,n_convs,variant", PLANTED)
def test_planted_check_catches_a_gate_without_eps(eps_term, C, n_convs, variant):
    """The check the GPU kernel is held to fails a stage that drops either
    EPS term of the gate, and passes the stage that keeps both."""
    args = (_gate_without(eps_term), 2, 64, 8, C, n_convs, variant, "cpu")
    if eps_term is None:
        check_planted_eps(*args)
    else:
        with pytest.raises(AssertionError):
            check_planted_eps(*args)


def test_graph_feature_vn_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 64, 4, 3)).astype(np.float32)
    got, idx = E.graph_feature_vn(torch.from_numpy(x), 8)
    want, want_idx = j_graph_feature_vn(jnp.asarray(x), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_fused_stage_matches_unfused_layers():
    """Folded-BN stage == graph features -> two VNLinearLeakyReLU -> mean pool."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 64, 4, 3)).astype(np.float32))
    c1, c2 = VNLinearLeakyReLU(8, 6).eval(), VNLinearLeakyReLU(6, 5).eval()
    c1.load_state_dict(rand_vn_llr(rng, 8, 6)[2])
    c2.load_state_dict(rand_vn_llr(rng, 6, 5)[2])
    e, idx = E.graph_feature_vn(x, 8)
    want = mean_pool(c2(c1(e)))
    args = []
    for c in (c1, c2):
        bn = c.batchnorm.bn
        args += [c.map_to_feat.weight, c.map_to_dir.weight,
                 E.fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var)]
    with torch.no_grad():
        torch.testing.assert_close(E.edgeconv_infer(x, idx, *args), want, **TOL)


def test_edgeconv_on_cpu_takes_the_plain_version():
    a = _inputs(1, 32, 4, 1, 21, 21)
    before = E.edgeconv_infer.launches
    torch.testing.assert_close(_plain(a, 2, E.edgeconv_infer), _plain(a, 2), rtol=0, atol=0)
    assert E.edgeconv_infer.launches == before

