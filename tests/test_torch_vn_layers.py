"""Port VN layers vs the flax layers on shared weights, plus SO(3) equivariance.

Tolerance atol 1e-5 / rtol 1e-4: the same fp32 math, summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from _torch_port import rand_bn, rand_vn_llr
from hpcs_tpu.nn.vn import layers as FL
from hpcs_torch.nn.vn import layers as TL

TOL = dict(atol=1e-5, rtol=1e-4)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _llr(cin, cout, share, seed=1):
    params, stats, sd = rand_vn_llr(np.random.default_rng(seed), cin, cout, share)
    m = TL.VNLinearLeakyReLU(cin, cout, share_nonlinearity=share).eval()
    m.load_state_dict(sd)
    return m, params, stats


def _rotation(seed=0):
    return torch.from_numpy(Rotation.random(random_state=seed).as_matrix().astype(np.float32))


def test_vn_linear_matches_flax():
    x = _x((2, 16, 5, 3))
    W = _x((7, 5), 1)
    m = TL.VNLinear(5, 7)
    m.map_to_feat.weight.data = torch.from_numpy(W)
    want = FL.VNLinear(7).apply({"params": {"kernel": W.T}}, jnp.asarray(x))
    _close(m(torch.from_numpy(x)), want)


def test_vn_batchnorm_matches_flax():
    x = _x((2, 16, 6, 3))
    bn = rand_bn(np.random.default_rng(2), 6)
    m = TL.VNBatchNorm(6).eval()
    m.bn.weight.data, m.bn.bias.data = torch.from_numpy(bn["scale"]), torch.from_numpy(bn["bias"])
    m.bn.running_mean.data, m.bn.running_var.data = (torch.from_numpy(bn["mean"]),
                                                     torch.from_numpy(bn["var"]))
    want = FL.VNBatchNorm().apply(
        {"params": {"bn": {"scale": bn["scale"], "bias": bn["bias"]}},
         "batch_stats": {"bn": {"mean": bn["mean"], "var": bn["var"]}}},
        jnp.asarray(x), train=False)
    _close(m(torch.from_numpy(x)), want)


@pytest.mark.parametrize("share", [False, True])
def test_vn_linear_leaky_relu_matches_flax(share):
    x = _x((2, 32, 9, 3))
    m, params, stats = _llr(9, 12, share)
    want = FL.VNLinearLeakyReLU(12, share_nonlinearity=share).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    _close(m(torch.from_numpy(x)), want)


def test_vn_leaky_relu_and_mean_pool_match_flax():
    p, d = _x((4, 10, 7, 3), 3), _x((4, 10, 7, 3), 4)
    _close(TL.vn_leaky_relu(torch.from_numpy(p), torch.from_numpy(d)),
           FL._vn_leaky_relu(jnp.asarray(p), jnp.asarray(d), 0.2))
    _close(TL.mean_pool(torch.from_numpy(p)), FL.mean_pool(jnp.asarray(p)))


def test_vn_std_feature_matches_flax():
    x = _x((2, 16, 12, 3))
    rng = np.random.default_rng(5)
    p1, s1, sd1 = rand_vn_llr(rng, 12, 6)
    p2, s2, sd2 = rand_vn_llr(rng, 6, 3)
    frame = _x((3, 3), 6)
    m = TL.VNStdFeature(12).eval()
    m.vn1.load_state_dict(sd1)
    m.vn2.load_state_dict(sd2)
    m.vn_lin.weight.data = torch.from_numpy(frame)
    want_std, want_z0 = FL.VNStdFeature().apply(
        {"params": {"vn1": p1, "vn2": p2, "frame_kernel": frame.T},
         "batch_stats": {"vn1": s1, "vn2": s2}}, jnp.asarray(x), train=False)
    got_std, got_z0 = m(torch.from_numpy(x))
    _close(got_std, want_std)
    _close(got_z0, want_z0)
    _close(TL.invariant_project(torch.from_numpy(x), got_z0),
           FL.invariant_project(jnp.asarray(x), want_z0))


def test_vn_layers_so3_equivariant():
    x = torch.from_numpy(_x((2, 32, 9, 3)))
    R = _rotation(1)
    m, _, _ = _llr(9, 12, False)
    torch.testing.assert_close(m(x @ R), m(x) @ R, atol=1e-5, rtol=1e-4)
    std = TL.VNStdFeature(12).eval()
    y = torch.cat([x, x[..., :3, :]], dim=-2)  # 12 channels
    inv, _ = std(y)
    inv_rot, _ = std(y @ R)
    torch.testing.assert_close(inv_rot, inv, atol=1e-4, rtol=1e-4)


def test_train_mode_is_not_ported():
    m = TL.VNLinearLeakyReLU(3, 4)
    with pytest.raises(NotImplementedError):
        m(torch.zeros(1, 3, 3))
