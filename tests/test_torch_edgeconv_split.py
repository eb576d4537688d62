"""Kernel B2's order of operations, replayed on the CPU.

`hpcs_torch/ops/csrc/edgeconv.cu` splits conv1 by linearity (per point
U = Wa x and Pc = Wb x, per edge p = (U_j - U_i) + Pc_i), runs one thread
per edge with conv2 accumulated one conv1 channel at a time, and takes the
mean over K as a sum in edge order.  `hpcs_torch.testing.edgeconv_split_model`
replays that order in plain PyTorch; here it is held against the plain twin,
hpcs_tpu's `_edgeconv_xla` and `fused_edgeconv_infer(interpret=True)`, at
atol 1e-5 / rtol 1e-4 (the same fp32 function summed in another order), and
against the float64 twin on the planted near-EPS inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import rand_bn
from hpcs_tpu.ops.pallas.edgeconv_pallas import _edgeconv_xla, fused_edgeconv_infer
from hpcs_torch.ops import edgeconv as E
from hpcs_torch.ops.vn_math import channel_mix
from hpcs_torch.testing import (check_edgeconv, check_planted_eps, edgeconv_split_model,
                                split_conv1)

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
