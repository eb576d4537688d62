"""The port's training-mode modules against flax's with
mutable=["batch_stats"]: the VN BatchNorm, the head's BatchNorm, the
VNLinearLeakyReLU, and the backbone's training forward (dropout 0); and
the dropout law.

BatchNorm follows flax: the batch mean and biased variance E[x^2] - E[x]^2
over every axis but the channel axis, running statistics 0.9 old + 0.1
batch.  Outputs and new statistics agree within atol 1e-5 / rtol 1e-4 (the
same fp32 math, reduced in another order).

The backbone's training forward is ill-conditioned in fp32 (ROADMAP §C):
in stage 1 the self-edge makes conv1's p parallel to x_i, a few of its
norms are tiny, and conv2's gate turns their rounding into O(1e-3) errors;
the global max and the head's batch statistics carry them to every point.
Against the port's own forward in float64 on the same kNN graphs, both
packages' fp32 embeddings are 4-6e-3 off at B=2, N=96.  So the port is
held to that float64 forward at least as closely as JAX is (at most 4
times JAX's error, plus 1e-5), and to JAX itself within 1e-2 at most and
1e-3 on average; its new running statistics within atol 2e-4 / rtol 1e-3.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from _torch_port import jax_port_pair, rand_bn, rand_vn_llr, to_numpy_tree
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_tpu.nn.vn import layers as FL
from hpcs_torch.models import decode_vector_for_batch
from hpcs_torch.nn.backbones import vn_dgcnn
from hpcs_torch.nn.backbones.vn_dgcnn import dropout
from hpcs_torch.nn.vn import layers as TL
from hpcs_torch.ops.knn import knn_plain
from hpcs_torch.utils.jax_params import from_jax_params

TOL = dict(atol=1e-5, rtol=1e-4)
TOL_NET = dict(atol=2e-4, rtol=1e-3)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _load_bn(bn, p):
    with torch.no_grad():
        for name, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                          ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(p[key]))


@pytest.mark.parametrize("shape", [(2, 16, 5, 6, 3), (3, 40, 6, 3)])  # edge and point stages
def test_vn_batchnorm_train_mode_matches_flax(shape):
    x = _x(shape)
    bn = rand_bn(np.random.default_rng(2), shape[-2])
    m = TL.VNBatchNorm(shape[-2]).train()
    _load_bn(m.bn, bn)
    variables = {"params": {"bn": {"scale": bn["scale"], "bias": bn["bias"]}},
                 "batch_stats": {"bn": {"mean": bn["mean"], "var": bn["var"]}}}
    want, new = FL.VNBatchNorm().apply(variables, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
    _close(m(torch.from_numpy(x)), want)
    _close(m.bn.running_mean, new["batch_stats"]["bn"]["mean"])
    _close(m.bn.running_var, new["batch_stats"]["bn"]["var"])
    assert int(m.bn.num_batches_tracked) == 1


@pytest.mark.parametrize("rows", [(5,), (3, 17)])  # conv7 over B, conv8-11 over B and N
def test_head_batchnorm_train_mode_matches_flax(rows):
    C = 9
    x = 2 + _x((*rows, C), 3)  # flax layout [..., C]
    bn = rand_bn(np.random.default_rng(4), C)
    m = TL.BatchNorm(C, channel_dim=1).train()
    _load_bn(m, bn)
    flax_bn = nn.BatchNorm(momentum=0.9, epsilon=1e-5)
    want, new = flax_bn.apply({"params": {"scale": bn["scale"], "bias": bn["bias"]},
                               "batch_stats": {"mean": bn["mean"], "var": bn["var"]}},
                              jnp.asarray(x), use_running_average=False, mutable=["batch_stats"])
    xt = torch.from_numpy(x)
    xt = xt[:, :, None] if len(rows) == 1 else xt.transpose(1, 2)  # the port's [B, C, N]
    got = m(xt)
    got = got[:, :, 0] if len(rows) == 1 else got.transpose(1, 2)
    _close(got, want)
    _close(m.running_mean, new["batch_stats"]["mean"])
    _close(m.running_var, new["batch_stats"]["var"])
    # eval mode: the new running statistics
    m.eval()
    want_eval = flax_bn.apply({"params": {"scale": bn["scale"], "bias": bn["bias"]},
                               "batch_stats": new["batch_stats"]}, jnp.asarray(x),
                              use_running_average=True)
    got_eval = m(xt)
    _close(got_eval[:, :, 0] if len(rows) == 1 else got_eval.transpose(1, 2), want_eval)


def test_batchnorm_variance_is_biased_and_clipped():
    m = TL.BatchNorm(2, channel_dim=-1).train()
    x = torch.tensor([[1.0, 5.0], [3.0, 5.0]])
    y = m(x)
    torch.testing.assert_close(m.running_var, torch.tensor([0.9 + 0.1 * 1.0, 0.9]))
    torch.testing.assert_close(m.running_mean, torch.tensor([0.2, 0.5]))
    assert torch.isfinite(y).all() and (y[:, 1] == 0).all()  # a constant channel


@pytest.mark.parametrize("share", [False, True])
def test_vn_linear_leaky_relu_train_mode_matches_flax(share):
    x = _x((2, 16, 4, 9, 3), 5)
    params, stats, sd = rand_vn_llr(np.random.default_rng(6), 9, 12, share)
    m = TL.VNLinearLeakyReLU(9, 12, share_nonlinearity=share).train()
    m.load_state_dict(sd)
    xt = torch.from_numpy(x).requires_grad_()
    got = m(xt)
    want, new = FL.VNLinearLeakyReLU(12, share_nonlinearity=share).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        mutable=["batch_stats"])
    _close(got, want)
    _close(m.batchnorm.bn.running_var, new["batch_stats"]["batchnorm"]["bn"]["var"])
    # the gradient of a weighted sum, in the input and the weights
    w = _x(got.shape, 7)
    (got * torch.from_numpy(w)).sum().backward()

    def f(x_, p_):
        out, _ = FL.VNLinearLeakyReLU(12, share_nonlinearity=share).apply(
            {"params": p_, "batch_stats": stats}, x_, train=True, mutable=["batch_stats"])
        return jnp.sum(out * w)

    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), params)
    _close(xt.grad, gx)
    _close(m.map_to_feat.weight.grad, np.asarray(gp["linear"]["kernel"]).T)
    _close(m.batchnorm.bn.weight.grad, gp["batchnorm"]["bn"]["scale"])


def test_backbone_training_forward_matches_flax(monkeypatch):
    """The whole net in training mode, dropout 0, on shared weights with
    random running statistics: embeddings, and every new running statistic
    (through from_jax_params's mapping)."""
    jsys, state, tsys, batch = jax_port_pair(eucl=8, hyp=4, N=96, random_stats=True, dropout=0.0)
    dv = decode_vector_for_batch(tsys.cfg, batch)
    pts = torch.from_numpy(batch["points"])
    net64 = copy.deepcopy(tsys.net).double().train()
    graphs = []
    monkeypatch.setattr(vn_dgcnn, "knn", lambda x, k: graphs.append(knn_plain(x, k)) or graphs[-1])
    tsys.net.train()
    got = tsys.net(pts, dv)
    ref = net64(pts.double(), dv.double(), idx_override=graphs)

    def apply(params, stats, pts, d):
        return jsys.net.apply({"params": params, "batch_stats": stats}, pts, d, train=True,
                              rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])

    want, new = jax.jit(apply)(state.params, state.batch_stats, jnp.asarray(batch["points"]),
                               j_decode_vector(jsys.cfg, batch))
    for g, w, r in zip(got, want, ref):
        g, w, r = g.detach().double().numpy(), np.asarray(w, np.float64), r.detach().numpy()
        assert np.abs(g - r).max() <= 4 * np.abs(w - r).max() + 1e-5
        assert np.abs(g - w).max() <= 1e-2 and np.abs(g - w).mean() <= 1e-3
    want_sd = from_jax_params(to_numpy_tree(state.params), to_numpy_tree(new["batch_stats"]))
    got_sd = tsys.net.state_dict()
    for name, w in want_sd.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got_sd[name].numpy(), w.numpy(), err_msg=name, **TOL_NET)
        if name.endswith("num_batches_tracked"):
            assert int(got_sd[name]) == 1


def test_dropout_law():
    x = torch.ones(200, 300)
    for p in (0.5, 0.2):
        y = dropout(x, p, torch.Generator().manual_seed(3))
        kept = y != 0
        assert abs(float(kept.float().mean()) - (1 - p)) < 0.01
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
        torch.testing.assert_close(dropout(x, p, torch.Generator().manual_seed(3)), y)
        assert not torch.equal(dropout(x, p, torch.Generator().manual_seed(4)), y)
    assert dropout(x, 0.0, None) is x


def test_dropout_masks_follow_the_generator_in_the_forward():
    _, _, tsys, batch = jax_port_pair(eucl=4, hyp=4, N=48, dropout=0.5)
    pts, dv = torch.from_numpy(batch["points"]), decode_vector_for_batch(tsys.cfg, batch)
    tsys.net.train()
    with pytest.raises(ValueError, match="generator"):
        tsys.net(pts, dv)
    a = tsys.net(pts, dv, generator=torch.Generator().manual_seed(1))[0]
    b = tsys.net(pts, dv, generator=torch.Generator().manual_seed(1))[0]
    c = tsys.net(pts, dv, generator=torch.Generator().manual_seed(2))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)
    tsys.net.eval()  # eval mode draws nothing
    torch.testing.assert_close(tsys.net(pts, dv)[0], tsys.net(pts, dv)[0], rtol=0, atol=0)
