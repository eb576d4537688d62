"""Kernel B2's order of operations, replayed on the CPU.

`hpcs_torch/ops/csrc/edgeconv.cu` splits conv1 by linearity (per point
U = Wa x and Pc = Wb x, per edge p = (U_j - U_i) + Pc_i), runs one thread
per edge with conv2 accumulated one conv1 channel at a time, and takes the
mean over K as a sum in edge order.  `hpcs_torch.testing.edgeconv_split_model`
replays that order in plain PyTorch; here it is held against the plain twin,
hpcs_tpu's `_edgeconv_xla` and `fused_edgeconv_infer(interpret=True)`, at
atol 1e-5 / rtol 1e-4 (the same fp32 function summed in another order), and
against the float64 twin on the planted near-EPS inputs.

On bf16 features the two-conv stages run conv2 on the tensor cores, on three
bf16 limbs of conv1's output (`testing.bf16_limbs`, `testing.limb_conv2`):
the split is held exact, and the model of that route against the plain
version (check_edgeconv, one bf16 ulp wider), hpcs_tpu's bf16 stage (the
witness of test_torch_bf16) and the float64 twin on the planted inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bf16_einsum_on_cpu, rand_bn
from hpcs_tpu.nn.vn import layers as FL
from hpcs_tpu.ops import edgeconv as JE
from hpcs_tpu.ops.pallas.edgeconv_pallas import _edgeconv_xla, fused_edgeconv_infer
from hpcs_torch.nn.backbones import vn_dgcnn
from hpcs_torch.nn.vn import layers as TL
from hpcs_torch.ops import edgeconv as E
from hpcs_torch.ops.knn import knn_plain
from hpcs_torch.ops.vn_math import channel_mix
from hpcs_torch.testing import (TC_K_STEPS, bf16_limbs, check_edgeconv, check_planted_eps,
                                edgeconv_split_model, limb_conv2, split_conv1)
from test_torch_bf16 import STAGE_DIRECT_SHARE, _both, _np, _stage_weights, _witness, _x

TOL = dict(atol=1e-5, rtol=1e-4)
STAGES = [(1, 2), (21, 2), (21, 1), (1, 1)]  # (C, n_convs) of the kernel's four instances


def _inputs(B, N, K, C, seed):
    """x, idx with the self-edge first (as a kNN graph has it) and the
    stage's weights [W1, Wd1, ab1, W2, Wd2, ab2], as numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N, C, 3)).astype(np.float32)
    idx = rng.integers(0, N, (B, N, K)).astype(np.int32)
    idx[..., 0] = np.arange(N)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.3).astype(np.float32)

    def ab():
        return np.stack([1 + w(21), w(21)])

    return x, idx, [w(21, 2 * C), w(21, 2 * C), ab(), w(21, 21), w(21, 21), ab()]


def _torch(x, idx, w):
    return torch.from_numpy(x), torch.from_numpy(idx), [torch.from_numpy(t) for t in w]


@pytest.mark.parametrize("K", [7, 20])
@pytest.mark.parametrize("C,n_convs", STAGES)
def test_split_model_matches_plain(C, n_convs, K):
    x, idx, w = _torch(*_inputs(2, 128, K, C, seed=C + K))
    got = edgeconv_split_model(x, idx, *w, n_convs=n_convs)
    want = E.edgeconv_infer_plain(x, idx, *w, n_convs=n_convs)
    assert got.shape == want.shape == (2, 128, 21, 3)
    # atol 1e-5 / rtol 1e-4, or the conditioning-scaled bound where a
    # pre-BatchNorm norm is below 1e-4 (hpcs_torch.testing.min_prenorm)
    check_edgeconv(got, want, x, idx, w, n_convs)


@pytest.mark.parametrize("K", [7, 20])
@pytest.mark.parametrize("C,n_convs", STAGES)
def test_split_model_matches_xla(C, n_convs, K):
    x, idx, w = _inputs(2, 64, K, C, seed=10 + C + K)
    tx, tidx, tw = _torch(x, idx, w)
    got = edgeconv_split_model(tx, tidx, *tw, n_convs=n_convs)
    want = _edgeconv_xla(jnp.asarray(x), jnp.asarray(idx), w[0].T, w[1].T, jnp.asarray(w[2]),
                         w[3].T, w[4].T, jnp.asarray(w[5]), 0.2, n_convs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("C,n_convs", [(21, 2), (21, 1), (1, 2)])
def test_split_model_matches_pallas_interpret(C, n_convs):
    x, idx, w = _inputs(1, 32, 7, C, seed=20 + C)
    rng = np.random.default_rng(C)
    bns = [rand_bn(rng, 21), rand_bn(rng, 21)]
    want = fused_edgeconv_infer(jnp.asarray(x), jnp.asarray(idx), w[0].T, w[1].T,
                                {k: jnp.asarray(v) for k, v in bns[0].items()}, w[3].T, w[4].T,
                                {k: jnp.asarray(v) for k, v in bns[1].items()},
                                interpret=True, n_convs=n_convs)
    ab = [E.fold_bn(*(torch.from_numpy(b[k]) for k in ("scale", "bias", "mean", "var")))
          for b in bns]
    tx, tidx, tw = _torch(x, idx, w)
    got = edgeconv_split_model(tx, tidx, tw[0], tw[1], ab[0], tw[3], tw[4], ab[1],
                               n_convs=n_convs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("C", [1, 21])
def test_self_edge_conv1_is_the_centre_half_exactly(C):
    """On the self-edge the split gives p = Wb x_i and d = Wdb x_i bit for
    bit: stage 1's ill-conditioned outputs live there."""
    x, idx, w = _torch(*_inputs(2, 64, 7, C, seed=30 + C))
    p, d = split_conv1(x, idx, w[0], w[1])
    assert torch.equal(p[:, :, 0], channel_mix(x, w[0][:, C:]))
    assert torch.equal(d[:, :, 0], channel_mix(x, w[1][:, C:]))


@pytest.mark.parametrize("K", [7, 20])
@pytest.mark.parametrize("C,n_convs,variant", [(1, 2, "conv1"), (1, 2, "conv2"), (21, 2, "conv1"),
                                               (21, 2, "conv2"), (21, 1, "conv1")])
def test_split_model_gate_eps_on_planted_inputs(C, n_convs, variant, K):
    """The split stays exact on the planted inputs (U_j - U_i + Pc_i is a
    short dyadic sum), so every output holds to the float64 twin."""
    check_planted_eps(edgeconv_split_model, 2, 64, K, C, n_convs, variant, "cpu", seed=C + K)


@pytest.mark.parametrize("C,n_convs", STAGES)
def test_split_model_out_of_cloud_index_gives_nan_for_its_point_only(C, n_convs):
    x, idx, w = _torch(*_inputs(2, 64, 7, C, seed=40 + C))
    idx[0, 5, 3], idx[1, 9, 6] = 64, -1
    got = edgeconv_split_model(x, idx, *w, n_convs=n_convs)
    nan = torch.isnan(got).all(-1).all(-1)
    assert nan[0, 5] and nan[1, 9] and int(nan.sum()) == 2
    assert torch.isfinite(got).sum() == got.numel() - 2 * 63


BF16 = torch.bfloat16


def test_bf16_limbs_are_exact_from_1e_30_to_1e30():
    """h0 + h1 + h2 == h in float64 for fp32 h of either sign from 1e-30 to
    1e30 and 0; each limb is a bf16 value, and each bf16 weight times a limb
    is exact in fp32 (the tensor cores' products)."""
    rng = np.random.default_rng(0)
    mag = np.exp(rng.uniform(np.log(1e-30), np.log(1e30), 20000)).astype(np.float32)
    h = torch.from_numpy(np.concatenate([mag, -mag, [0.0, 1e-30, 1e30, -1e-30, -1e30]])
                         .astype(np.float32))
    limbs = bf16_limbs(h)
    assert torch.equal(sum(t.double() for t in limbs), h.double())
    for limb in limbs:
        assert torch.equal(limb.to(BF16).float(), limb)
    w = torch.from_numpy(rng.standard_normal(h.shape).astype(np.float32)).to(BF16).float()
    for limb in limbs:
        assert torch.equal((w * limb).double(), w.double() * limb.double())


def test_limb_conv2_is_conv2_on_the_bf16_weights():
    """The three limb products, one fp32 rounding a K-step, against W h in
    float64 on the bf16-rounded weights: a few fp32 ulps of the products."""
    rng = np.random.default_rng(1)
    h = torch.from_numpy(rng.standard_normal((64, 21, 3)).astype(np.float32))
    W = torch.from_numpy((rng.standard_normal((21, 21)) * 0.3).astype(np.float32))
    want = torch.einsum("oc,...cv->...ov", W.to(BF16).double(), h.double())
    scale = torch.einsum("oc,...cv->...ov", W.to(BF16).double().abs(), h.double().abs())
    got = limb_conv2(h, W)
    assert got.dtype == torch.float32
    assert ((got.double() - want).abs() <= 2 * len(TC_K_STEPS) * 3 * 2.0 ** -24 * scale).all()


@pytest.mark.parametrize("C,n_convs", [(1, 2), (21, 2), (21, 1)])
def test_bf16_split_model_matches_plain(C, n_convs):
    x, idx, w = _torch(*_inputs(2, 64, 8, C, seed=50 + C))
    x = x.to(BF16)
    got = edgeconv_split_model(x, idx, *w, n_convs=n_convs)
    want = E.edgeconv_infer_plain(x, idx, *w, n_convs=n_convs)
    assert got.dtype == want.dtype == BF16
    check_edgeconv(got, want, x, idx, w, n_convs, rounding=2.0 ** -7)


@pytest.fixture
def _bf16_einsum():
    with pytest.MonkeyPatch.context() as mp:
        bf16_einsum_on_cpu(mp)
        yield


@pytest.mark.usefixtures("_bf16_einsum")
@pytest.mark.parametrize("c,n_convs", [(1, 2), (21, 2)])
def test_bf16_split_model_matches_jax_in_bf16(c, n_convs):
    """The model of the bf16 route's two-conv stage against hpcs_tpu's bf16
    stage on the same weights and graph, by test_torch_bf16's witness: at
    most WITNESS times hpcs_tpu's distance from the float64 stage, and
    within STAGE_DIRECT_SHARE of it."""
    rng = np.random.default_rng(10 + c)
    x_t, x_j = _both(_x((2, 48, c, 3), c))
    idx = knn_plain(x_t.reshape(2, 48, -1), 8)
    convs = _stage_weights(rng, c, n_convs)
    modules = []
    for _, _, sd in convs:
        m = TL.VNLinearLeakyReLU(sd["map_to_feat.weight"].shape[1], 21).eval()
        m.load_state_dict(sd)
        modules.append(m)
    e_j, _ = JE.graph_feature_vn(x_j, 8, idx=jnp.asarray(idx.numpy()))
    for params, stats, _ in convs:
        e_j = FL.VNLinearLeakyReLU(21).apply({"params": params, "batch_stats": stats}, e_j,
                                             train=False)
    want = FL.mean_pool(e_j)
    weights = [w.detach() for w in vn_dgcnn.stage_weights(*modules)]
    got = edgeconv_split_model(x_t, idx, *weights, n_convs=n_convs)
    assert got.dtype == BF16
    ref = E.edgeconv_infer_plain(x_t.double(), idx, *[w.double() for w in weights],
                                 n_convs=n_convs).numpy()
    _witness(_np(got), _np(want), ref, "B2's bf16 route (model)", STAGE_DIRECT_SHARE)


@pytest.mark.parametrize("C,n_convs,variant", [(1, 2, "conv1"), (1, 2, "conv2"), (21, 2, "conv1"),
                                               (21, 2, "conv2")])
def test_bf16_split_model_gate_eps_on_planted_inputs(C, n_convs, variant):
    """The bf16 route's model on the planted inputs: within one bf16 ulp of
    the float64 twin on the bf16-rounded mixes (the limbs keep conv2's input
    whole at p and d near EPS)."""
    check_planted_eps(edgeconv_split_model, 2, 64, 8, C, n_convs, variant, "cpu", seed=C,
                      dtype=BF16)
