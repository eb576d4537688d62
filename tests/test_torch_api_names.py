"""The rest of hpcs_tpu's exported names in the port, on the CPU, each held
against its hpcs_tpu counterpart on the same inputs:

- hpcs_torch.geometry.cosh, sinh (with their +-15 clamp) and rot_3d, with
  math_ops.yaw_rot, pitch_rot and roll_rot: within 1e-6 (fp32 rounding of
  the transcendental functions);
- hpcs_torch.ops.knn_auto (B1's routes: the function knn) and
  pairwise_neg_sqdist: equal indices on tie-free clouds, scores within
  rtol 1e-6 / atol 1e-5;
- hpcs_torch.models.ShapeNetHypHC, PartNetHypHC and build_net: the configs
  of hpcs_tpu's aliases, the net's parameters, and on a state carried from
  hpcs_tpu after training steps the same best k and labels from test_step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import to_state_dict

from _torch_port import synthetic_batch, torch_threads
from hpcs_tpu import geometry as jg
from hpcs_tpu import models as jm
from hpcs_tpu import ops as jops
from hpcs_tpu.geometry import math_ops as jmath
from hpcs_torch import geometry, models, ops
from hpcs_torch.geometry import math_ops
from hpcs_torch.ops import knn as K
from hpcs_torch.utils.checkpoint import load_jax_state


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("name", ["cosh", "sinh"])
def test_cosh_and_sinh_are_hpcs_tpus(name):
    x = np.random.default_rng(0).uniform(-20, 20, 1000).astype(np.float32)
    for clamp in (15.0, 3.0):
        got = getattr(geometry, name)(torch.from_numpy(x), clamp=clamp)
        _close(got, getattr(jg, name)(jnp.asarray(x), clamp=clamp), rtol=1e-6, atol=0)
    assert float(geometry.cosh(torch.tensor(30.0))) == float(geometry.cosh(torch.tensor(15.0)))


@pytest.mark.parametrize("name", ["yaw_rot", "pitch_rot", "roll_rot"])
def test_euler_rotations_are_hpcs_tpus(name):
    a = np.random.default_rng(1).uniform(-np.pi, np.pi, (4, 5)).astype(np.float32)
    got = getattr(math_ops, name)(torch.from_numpy(a))
    assert got.shape == (4, 5, 3, 3)
    _close(got, getattr(jmath, name)(jnp.asarray(a)), rtol=0, atol=1e-6)


def test_rot_3d_is_hpcs_tpus():
    yaw, pitch, roll = np.random.default_rng(2).uniform(-np.pi, np.pi, (3, 8)).astype(np.float32)
    got = geometry.rot_3d(*(torch.from_numpy(v) for v in (yaw, pitch, roll)))
    _close(got, jg.rot_3d(*(jnp.asarray(v) for v in (yaw, pitch, roll))), rtol=0, atol=1e-6)
    eye = torch.eye(3).expand(8, 3, 3)
    torch.testing.assert_close(got @ got.transpose(1, 2), eye, rtol=0, atol=1e-6)


@pytest.mark.parametrize("d,same", [(3, True), (21, False)])
def test_pairwise_neg_sqdist_is_hpcs_tpus(d, same):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, d)).astype(np.float32)
    y = x if same else rng.standard_normal((2, 30, d)).astype(np.float32)
    got = ops.pairwise_neg_sqdist(torch.from_numpy(x), None if same else torch.from_numpy(y))
    want = jops.pairwise_neg_sqdist(jnp.asarray(x), None if same else jnp.asarray(y))
    assert got.shape == tuple(want.shape)
    _close(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("d,k", [(3, 10), (63, 20)])
def test_knn_auto_is_knn_and_hpcs_tpus(d, k):
    assert ops.knn_auto is K.knn
    x = np.random.default_rng(4).standard_normal((2, 128, d)).astype(np.float32)
    got = ops.knn_auto(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.knn_auto(jnp.asarray(x), k)))


ALIAS_KW = dict(num_class=6, eucl_dim=8, hyp_dim=8, k=8, t_per_anchor=8, temperature=0.1,
                test_rotation="none")


@pytest.mark.parametrize("alias,categories", [("ShapeNetHypHC", 16), ("PartNetHypHC", 1)])
def test_the_aliases_build_hpcs_tpus_systems(alias, categories):
    got = getattr(models, alias)(device="cpu", **ALIAS_KW)
    want = getattr(jm, alias)(**ALIAS_KW)
    assert got.cfg.num_categories == categories
    assert dataclasses.asdict(got.cfg) == dataclasses.asdict(want.cfg)
    net = models.build_net(got.cfg)
    assert isinstance(net, models.HypHCNet)
    assert {k: v.shape for k, v in net.state_dict().items()} == \
        {k: v.shape for k, v in got.net.state_dict().items()}


@pytest.mark.parametrize("alias", ["ShapeNetHypHC", "PartNetHypHC"])
def test_the_aliases_systems_decode_as_hpcs_tpus(alias):
    """test_step of the alias's system on a state carried from hpcs_tpu's
    after 100 steps: the best k and labels of hpcs_tpu's."""
    categories = 16 if alias == "ShapeNetHypHC" else 1
    jsys = getattr(jm, alias)(fixed_points=64, **ALIAS_KW)
    batch = synthetic_batch(2, 64, categories=2, seed=5)
    if categories == 1:
        batch["category"][:] = 0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state = jsys.init(jax.random.PRNGKey(0), jb)
    for i in range(100):
        state, _ = jsys.train_step(state, jb, jax.random.PRNGKey(i), jnp.float32(0.1))
    _, want = jsys.test_step(state, jb, jax.random.PRNGKey(0), jnp.float32(0.1))

    system = getattr(models, alias)(device="cpu", **ALIAS_KW)
    load_jax_state(system, jax.tree_util.tree_map(np.asarray, to_state_dict(state)))
    _, got = system.test_step(batch, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got["best_k"].numpy(), np.asarray(want["best_k"]))
    np.testing.assert_array_equal(got["pred"].numpy(), np.asarray(want["pred"]))
