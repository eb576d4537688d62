"""The port's Riemannian Adam (hpcs_torch.optim) against hpcs_tpu's
riemannian_adam_fused, the optimizer HypHCSystem trains with, on every
parameter of a small HypHCNet; the plateau schedule against plateau_update;
and from_jax_opt_state.

The port updates each parameter along its ball axis, which for a weight
that from_jax_params transposes is dim 0 (map_to_feat, map_to_dir, vn_lin,
the head's Conv1d, the embedder) and the last axis otherwise (BatchNorm
weight and bias, `scale`, the CosFace W, [hyp, L] in both layouts).  The
BatchNorm weights start as ones, outside the ball.  Parameters after each
step agree within atol 1e-6 / rtol 1e-5: the same fp32 update, its norms
reduced in another order (the JAX package's over zero-padded 128-lane rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import jax_port_pair, load_opt_state, numpy_opt_state, to_numpy_tree
from hpcs_tpu.optim import plateau_init as j_plateau_init
from hpcs_tpu.optim import plateau_update as j_plateau_update
from hpcs_tpu.optim import riemannian_adam_fused
from hpcs_torch.optim import RiemannianAdam, plateau_init, plateau_update
from hpcs_torch.utils.jax_params import _params_sd, ball_dim, from_jax_opt_state

TOL = dict(atol=1e-6, rtol=1e-5)


def _grads(params, step):
    """Random gradients shaped like the flax params (numpy), from a seed."""
    rng = np.random.default_rng(100 + step)
    return jax.tree_util.tree_map(
        lambda p: (0.3 * rng.standard_normal(np.shape(p))).astype(np.float32), params)


def _port_step(tsys, grads, skip=()):
    for name, g in _params_sd(grads).items():
        p = tsys.net.get_parameter(name)
        p.grad = None if name in skip else g.reshape(p.shape)
    tsys.optimizer.step()


def _assert_params_equal(tsys, params):
    want = _params_sd(to_numpy_tree(params))
    got = dict(tsys.net.named_parameters())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), err_msg=name, **TOL)


@pytest.mark.parametrize("hyp", [8, 4])  # equal widths: ExpMap; else an MLP embedder
def test_three_steps_match_fused_radam_on_every_parameter(hyp):
    _, state, tsys, _ = jax_port_pair(hyp=hyp)
    params = to_numpy_tree(state.params)
    tx = riemannian_adam_fused(learning_rate=0.005)
    opt = tx.init(state.params)
    jparams = state.params
    update = jax.jit(tx.update)
    for step in range(3):
        g = _grads(params, step)
        g["cosface_W"] = np.zeros_like(g["cosface_W"])  # no gradient: the port's None
        deltas, opt = update(jax.tree_util.tree_map(jnp.asarray, g), opt, jparams)
        jparams = optax.apply_updates(jparams, deltas)
        _port_step(tsys, g, skip=("metric_hyp_loss.loss_cosface.W",))
        _assert_params_equal(tsys, jparams)
    # every leaf moved, the BatchNorm weights of ones were pulled into the ball
    for name, p in tsys.net.named_parameters():
        norms = torch.linalg.vector_norm(p.detach(), dim=ball_dim(name, p))
        assert (norms <= 1 - 4e-3 + 1e-6).all(), name


def test_a_leaf_of_ones_is_pulled_into_the_ball():
    """riemannian_adam_fused(0.005) maps a [21] leaf of ones to 0.217345 per
    entry (norm 0.996) in one step: lambda takes its MIN_NORM floor."""
    w = torch.nn.Parameter(torch.ones(21))
    w.grad = torch.full((21,), 0.1)
    RiemannianAdam([w], lr=0.005).step()
    tx = riemannian_adam_fused(0.005)
    p = {"w": jnp.ones(21)}
    deltas, _ = tx.update({"w": jnp.full(21, 0.1)}, tx.init(p), p)
    want = np.asarray(optax.apply_updates(p, deltas)["w"])
    np.testing.assert_allclose(w.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(w.detach().numpy(), 0.217345, atol=1e-6)


@pytest.mark.parametrize("shape,dim", [((7, 5), 0), ((7, 5), -1), ((4, 6, 1), 0), ((3,), -1)])
def test_ball_axis_of_a_single_leaf(shape, dim):
    """A port leaf updated along `dim` equals the JAX leaf with that axis
    last, updated in its own layout."""
    rng = np.random.default_rng(1)
    x = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    w = torch.nn.Parameter(torch.from_numpy(x.copy()))
    opt = RiemannianAdam([{"params": [w], "ball_dim": dim}], lr=0.05)
    tx = riemannian_adam_fused(0.05)
    p = {"w": jnp.asarray(np.moveaxis(x, dim, -1))}
    s = tx.init(p)
    for step in range(3):
        g = rng.standard_normal(shape).astype(np.float32)
        w.grad = torch.from_numpy(g)
        opt.step()
        deltas, s = tx.update({"w": jnp.asarray(np.moveaxis(g, dim, -1))}, s, p)
        p = optax.apply_updates(p, deltas)
        np.testing.assert_allclose(w.detach().numpy(), np.moveaxis(np.asarray(p["w"]), -1, dim),
                                   **TOL)
    assert opt.state[w]["exp_avg_sq"].shape[dim] == 1


def test_plateau_trace_matches_jax():
    metrics = [1.0, 0.9, 0.8] + [0.8 - 1e-9, 0.8 + 1e-9] * 6 + [0.4, 0.4 * (1 - 5e-5)]
    metrics += [0.5] * 12 + [float("nan"), float("inf"), 0.1] + [2.0] * 120
    s, sj = plateau_init(0.05), j_plateau_init(0.05)
    for m in metrics:
        s, sj = plateau_update(s, m), j_plateau_update(sj, m)
        assert tuple(s) == tuple(sj), m
    assert s.lr == 1e-6


def test_from_jax_opt_state_continues_the_jax_trajectory():
    """Two JAX steps, the state carried across, then one more step in each:
    the moments equal JAX's (transposed where the weights are) and the
    parameters after the third step agree."""
    _, state, tsys, _ = jax_port_pair(hyp=4)
    params = to_numpy_tree(state.params)
    tx = optax.inject_hyperparams(riemannian_adam_fused)(learning_rate=0.005)
    opt, jparams = tx.init(state.params), state.params
    update = jax.jit(tx.update)
    for step in range(2):
        deltas, opt = update(jax.tree_util.tree_map(jnp.asarray, _grads(params, step)), opt,
                             jparams)
        jparams = optax.apply_updates(jparams, deltas)
    tsys.net.load_state_dict({**tsys.net.state_dict(),
                              **_params_sd(to_numpy_tree(jparams))})
    moments = from_jax_opt_state(numpy_opt_state(opt), to_numpy_tree(jparams))
    assert set(moments) == {n for n, _ in tsys.net.named_parameters()}
    load_opt_state(tsys, moments)
    for name, p in tsys.net.named_parameters():
        st = tsys.optimizer.state[p]
        assert st["step"] == 2 and st["exp_avg"].shape == p.shape
        assert st["exp_avg_sq"].shape[ball_dim(name, p)] == 1
    g = _grads(params, 2)
    deltas, opt = update(jax.tree_util.tree_map(jnp.asarray, g), opt, jparams)
    _port_step(tsys, g)
    _assert_params_equal(tsys, optax.apply_updates(jparams, deltas))
