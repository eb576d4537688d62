"""The port's packed Riemannian Adam (hpcs_torch.optim.FusedRiemannianAdam,
what HypHCSystem trains with) against its per-parameter form
(RiemannianAdam) bit for bit, and both against hpcs_tpu's
riemannian_adam_fused / riemannian_adam, with their options: weight decay,
amsgrad (per-parameter form only, as in hpcs_tpu) and a learning rate that
is a schedule of the step count.  Then the state: a per-parameter
state_dict, as the port's checkpoints hold it, and hpcs_tpu's optimizer
state through load_jax_state, each continued by the packed form.

Against hpcs_tpu the parameters and moments agree within atol 1e-6 / rtol
1e-5 (test_torch_radam.py's TOL): the same fp32 update, its norms reduced
in another order.  Against the per-parameter form the packed one gives the
same bits: both reduce each row over its own D contiguous entries.
"""
import copy

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import jax_port_pair, numpy_opt_state, to_numpy_tree
from hpcs_tpu.optim import riemannian_adam, riemannian_adam_fused
from hpcs_torch.models import HypHCSystem, ModelConfig
from hpcs_torch.optim import FusedRiemannianAdam, RiemannianAdam
from hpcs_torch.testing import check_packed_update
from hpcs_torch.utils.checkpoint import load_jax_state
from hpcs_torch.utils.jax_params import _params_sd, ball_dim, from_jax_opt_state

TOL = dict(atol=1e-6, rtol=1e-5)
COSFACE = "metric_hyp_loss.loss_cosface.W"
FLAGSHIP = dict(fixed_points=1024, eucl_dim=32, hyp_dim=32, k=20)
FLAGSHIP_WIDTHS = {1, 3, 21, 32, 50, 64, 128, 170, 256, 341}


def _groups(net):
    groups = {0: [], -1: []}
    for name, p in net.named_parameters():
        groups[ball_dim(name, p)].append(p)
    return [{"params": ps, "ball_dim": d} for d, ps in groups.items() if ps]


def _set_grads(nets, step, skip=(COSFACE,)):
    """The same random gradients (a seed per step) on every net's
    parameters; none on the names in `skip`."""
    rng = np.random.default_rng(100 + step)
    for named in zip(*(net.named_parameters() for net in nets)):
        name, p0 = named[0]
        g = torch.from_numpy((0.3 * rng.standard_normal(p0.shape)).astype(np.float32))
        for _, p in named:
            p.grad = None if name in skip else g.clone()


def _jax_grads(params, step, scale=0.3):
    """Random gradients shaped like the flax params, from a seed; zero for
    the CosFace W (the port's None)."""
    rng = np.random.default_rng(100 + step)
    g = jax.tree_util.tree_map(
        lambda p: (scale * rng.standard_normal(np.shape(p))).astype(np.float32), params)
    g["cosface_W"] = np.zeros_like(g["cosface_W"])
    return g


def _port_grads(tsys, g):
    for name, x in _params_sd(g).items():
        p = tsys.net.get_parameter(name)
        p.grad = None if name == COSFACE else x.reshape(p.shape)


def _assert_state_equal(net_a, opt_a, net_b, opt_b):
    for (name, a), b in zip(net_a.named_parameters(), net_b.parameters()):
        assert torch.equal(a, b), name
        sa, sb = opt_a.state[a], opt_b.state[b]
        assert sa["step"] == sb["step"], name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[key], sb[key]), (name, key)


@pytest.mark.parametrize("layout,weight_decay", [("small", 0.0), ("flagship", 0.0),
                                                 ("flagship", 0.01)])
def test_packed_equals_per_parameter_bit_for_bit(layout, weight_decay):
    """HypHCSystem's optimizer is the packed form; over 3 steps it gives
    every parameter, and its moments, the per-parameter form's bits: both
    ball axes, the CosFace W without a gradient, BatchNorm weights of ones
    outside the ball.  At the flagship the 50 leaves form 10 packs."""
    cfg = ModelConfig(**FLAGSHIP) if layout == "flagship" else ModelConfig(
        num_class=6, num_categories=2, eucl_dim=8, hyp_dim=8, k=8)
    system = HypHCSystem(cfg, device="cpu")
    assert isinstance(system.optimizer, FusedRiemannianAdam)
    for group in system.optimizer.param_groups:
        group["weight_decay"] = weight_decay
    net = copy.deepcopy(system.net)
    plain = RiemannianAdam(_groups(net), lr=cfg.lr, weight_decay=weight_decay)
    dims = {ball_dim(n, p) for n, p in net.named_parameters()}
    assert dims == {0, -1}
    norms = {n: float(torch.linalg.vector_norm(p.detach(), dim=ball_dim(n, p)).max())
             for n, p in net.named_parameters()}
    assert max(norms.values()) > 1, "some leaf starts outside the ball"
    if layout == "flagship":
        widths = {p.shape[g["ball_dim"]] for g in system.optimizer.param_groups
                  for p in g["params"]}
        assert len(norms) == 50 and widths == FLAGSHIP_WIDTHS
    for step in range(3):
        _set_grads([system.net, net], step)
        system.apply_gradients()
        plain.step()
        _assert_state_equal(net, plain, system.net, system.optimizer)
    for name, p in system.net.named_parameters():
        assert float(torch.linalg.vector_norm(p.detach(), dim=ball_dim(name, p)).max()) < 1, name


def test_check_packed_update_on_the_cpu_finds_no_difference():
    """testing.check_packed_update, which chip_smoke.py runs on the card's
    gradients: on the CPU the two forms agree to the bit, and the system's
    own parameters and state are left as they were."""
    system = HypHCSystem(ModelConfig(**FLAGSHIP), device="cpu")
    _set_grads([system.net], 0)
    system.apply_gradients()
    _set_grads([system.net], 1)
    before = copy.deepcopy(system.state_dict())
    packed, plain, out = check_packed_update(system.optimizer)
    assert isinstance(packed, FusedRiemannianAdam) and isinstance(plain, RiemannianAdam)
    assert out == {"max_abs_err_params": 0.0, "max_abs_err_moments": 0.0, "parameters": 50}
    assert all(s["step"] == 2 for s in packed.state.values())
    after = system.state_dict()
    for k, v in before["net"].items():
        assert torch.equal(after["net"][k], v), k
    for i, st in before["optimizer"]["state"].items():
        assert all(torch.equal(after["optimizer"]["state"][i][k], v) for k, v in st.items()
                   if torch.is_tensor(v))


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_packed_matches_jax_riemannian_adam_fused(weight_decay):
    _, state, tsys, _ = jax_port_pair(hyp=4)
    for group in tsys.optimizer.param_groups:
        group["lr"], group["weight_decay"] = 0.005, weight_decay
    tx = riemannian_adam_fused(learning_rate=0.005, weight_decay=weight_decay)
    params = to_numpy_tree(state.params)
    jparams, opt, update = state.params, tx.init(state.params), jax.jit(tx.update)
    for step in range(3):
        g = _jax_grads(params, step)
        deltas, opt = update(jax.tree_util.tree_map(jnp.asarray, g), opt, jparams)
        jparams = optax.apply_updates(jparams, deltas)
        _port_grads(tsys, g)
        tsys.apply_gradients()
        want = _params_sd(to_numpy_tree(jparams))
        for name, p in tsys.net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=name,
                                       **TOL)


def test_amsgrad_and_weight_decay_match_jax_riemannian_adam():
    """RiemannianAdam(amsgrad=True, weight_decay=0.01) against hpcs_tpu's
    riemannian_adam with the same options on one tree: the parameters, both
    moments and max_exp_avg_sq after each of 3 steps.  The third step's
    gradients are small, so its second moments fall below their maximum."""
    _, state, tsys, _ = jax_port_pair(hyp=4)
    opt_port = RiemannianAdam(_groups(tsys.net), lr=0.005, weight_decay=0.01, amsgrad=True)
    tx = riemannian_adam(learning_rate=0.005, weight_decay=0.01, amsgrad=True)
    params = to_numpy_tree(state.params)
    jparams, opt, update = state.params, tx.init(state.params), jax.jit(tx.update)
    for step in range(3):
        g = _jax_grads(params, step, scale=0.3 if step < 2 else 1e-3)
        deltas, opt = update(jax.tree_util.tree_map(jnp.asarray, g), opt, jparams)
        jparams = optax.apply_updates(jparams, deltas)
        _port_grads(tsys, g)
        opt_port.step()
        want = {"param": _params_sd(to_numpy_tree(jparams)),
                "exp_avg": _params_sd(to_numpy_tree(opt.exp_avg)),
                "exp_avg_sq": _params_sd(to_numpy_tree(opt.exp_avg_sq)),
                "max_exp_avg_sq": _params_sd(to_numpy_tree(opt.max_exp_avg_sq))}
        for name, p in tsys.net.named_parameters():
            st = opt_port.state[p]
            assert st["step"] == int(opt.count) == step + 1
            dim = ball_dim(name, p)
            for key, w in want.items():
                got = p if key == "param" else st[key]
                w = w[name].reshape(p.shape)
                if key in ("exp_avg_sq", "max_exp_avg_sq"):  # equal along the ball axis
                    w = w.narrow(dim, 0, 1)
                np.testing.assert_allclose(got.detach().numpy(), w.numpy(),
                                           err_msg=f"{name} {key}", **TOL)
    vmax = [opt_port.state[p]["max_exp_avg_sq"] for p in tsys.net.parameters()]
    v = [opt_port.state[p]["exp_avg_sq"] for p in tsys.net.parameters()]
    assert any(bool((a > b).any()) for a, b in zip(vmax, v)), "amsgrad's maximum took effect"


@pytest.mark.parametrize("form", ["packed", "per_parameter"])
def test_a_callable_lr_matches_an_optax_schedule(form):
    """lr(step count) against an optax schedule of the same count: the
    JAX package's forms take `learning_rate` as either."""
    _, state, tsys, _ = jax_port_pair(hyp=4)
    schedule = optax.exponential_decay(0.02, transition_steps=1, decay_rate=0.5)
    if form == "packed":
        opt_port = FusedRiemannianAdam(_groups(tsys.net), lr=lambda count: 0.02 * 0.5 ** count)
        tx = riemannian_adam_fused(learning_rate=schedule)
    else:
        opt_port = RiemannianAdam(_groups(tsys.net), lr=lambda count: 0.02 * 0.5 ** count)
        tx = riemannian_adam(learning_rate=schedule)
    params = to_numpy_tree(state.params)
    jparams, opt, update = state.params, tx.init(state.params), jax.jit(tx.update)
    for step in range(3):
        g = _jax_grads(params, step)
        deltas, opt = update(jax.tree_util.tree_map(jnp.asarray, g), opt, jparams)
        jparams = optax.apply_updates(jparams, deltas)
        _port_grads(tsys, g)
        opt_port.step()
        want = _params_sd(to_numpy_tree(jparams))
        for name, p in tsys.net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=name,
                                       **TOL)
    # the schedule did act: the same steps at the first step's rate end elsewhere
    _, state, fixed, _ = jax_port_pair(hyp=4)
    opt_fixed = FusedRiemannianAdam(_groups(fixed.net), lr=0.01)
    for step in range(3):
        _port_grads(fixed, _jax_grads(params, step))
        opt_fixed.step()
    assert not torch.equal(fixed.net.scale, tsys.net.scale)


def test_a_per_parameter_state_dict_continues_in_the_packed_form():
    """What the port's checkpoints hold (the per-parameter optimizer's
    state_dict, param groups without weight_decay) loads into HypHCSystem's
    packed optimizer, and the next steps give the per-parameter form's bits."""
    cfg = ModelConfig(num_class=6, num_categories=2, eucl_dim=8, hyp_dim=4, k=8)
    old = HypHCSystem(cfg, device="cpu")
    old_opt = RiemannianAdam(_groups(old.net), lr=cfg.lr)
    for step in range(2):
        _set_grads([old.net], step)
        old_opt.step()
    saved = copy.deepcopy(old_opt.state_dict())
    for group in saved["param_groups"]:  # the layout the port's checkpoints were written in
        del group["weight_decay"], group["amsgrad"]
    assert set(saved["state"][0]) == {"step", "exp_avg", "exp_avg_sq"}
    new = HypHCSystem(cfg, device="cpu", generator=torch.Generator().manual_seed(9))
    new.load_state_dict({"net": copy.deepcopy(old.net.state_dict()), "optimizer": saved,
                         "step": 2})
    assert all(g["weight_decay"] == 0.0 for g in new.optimizer.param_groups)
    _assert_state_equal(old.net, old_opt, new.net, new.optimizer)
    for step in range(2, 4):
        _set_grads([old.net, new.net], step)
        old_opt.step()
        new.apply_gradients()
        _assert_state_equal(old.net, old_opt, new.net, new.optimizer)
    # and the packed form's own state_dict round-trips
    again = HypHCSystem(cfg, device="cpu")
    again.load_state_dict(new.state_dict())
    _set_grads([new.net, again.net], 4)
    new.apply_gradients()
    again.apply_gradients()
    _assert_state_equal(new.net, new.optimizer, again.net, again.optimizer)


def test_load_jax_state_then_packed_steps_continue_the_jax_trajectory():
    """hpcs_tpu's TrainState after 2 of its optimizer's steps, through
    load_jax_state (which replaces optimizer.state), then 2 more steps on
    each side: the parameters and moments agree after each."""
    jsys, state, tsys, _ = jax_port_pair(hyp=4)
    params = to_numpy_tree(state.params)
    opt, jparams, update = state.opt_state, state.params, jax.jit(jsys.tx.update)
    for step in range(2):
        deltas, opt = update(jax.tree_util.tree_map(jnp.asarray, _jax_grads(params, step)), opt,
                             jparams)
        jparams = optax.apply_updates(jparams, deltas)
    load_jax_state(tsys, to_numpy_tree(flax.serialization.to_state_dict(
        state.replace(params=jparams, opt_state=opt, step=jnp.int32(2)))))
    assert tsys.step == 2
    for step in range(2, 4):
        g = _jax_grads(params, step)
        deltas, opt = update(jax.tree_util.tree_map(jnp.asarray, g), opt, jparams)
        jparams = optax.apply_updates(jparams, deltas)
        _port_grads(tsys, g)
        tsys.apply_gradients()
        want = _params_sd(to_numpy_tree(jparams))
        moments = from_jax_opt_state(numpy_opt_state(opt), to_numpy_tree(jparams))
        for name, p in tsys.net.named_parameters():
            st = tsys.optimizer.state[p]
            assert st["step"] == int(opt.inner_state.count) == step + 1
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=name,
                                       **TOL)
            for key in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(st[key].numpy(), moments[name][key].numpy(),
                                           err_msg=f"{name} {key}", **TOL)
