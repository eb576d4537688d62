"""The port's training slice against hpcs_tpu on the CPU: two train_steps,
eval_step, the epoch hooks and fit.

Both systems start from the same weights (from_jax_params), with dropout
0 and train_rotation 'none' on clouds rotated beforehand, so the only
randomness is the triplets.  hpcs_tpu's triplets are drawn from its key
(split(key, 3), then split(k_loss), as its grads_and_logs and
compute_losses do) and handed to the port by patching its sampler.  The
'easy' margin filter's mask is JAX's too, after the port's own mask is
shown to differ from it only where |sim(a,p) - sim(a,n)| < 1e-3, the
largest gap between the two packages' values of it.

Tolerances.  The training forward is ill-conditioned in fp32 (see
test_torch_train_mode.py): both packages' embeddings are ~1e-3 from
float64.  The losses average much of that out: the port's losses at
least as close to its float64 losses as JAX's are (4 times JAX's
distance, plus 1e-5 relative; at the second step the port is 1e-5 from
float64 and JAX 6e-4), and within rtol 1e-3 (atol 1e-5) of JAX's;
accuracy and IoU within 0.02 (a point or two of 192 on the other side of
an argmax near-tie).
Gradients: the port's at least as close to its own float64 gradient as
JAX's is (4 times JAX's distance, plus 1e-4 of the leaf's largest
entry), and within a share of the leaf's largest entry of JAX's: 10 % at
the first step, 50 % at the second.  JAX's own distance from that float64
gradient reaches 5 % of it at the first step (conv7's weight, whose
BatchNorm over B = 2 samples leaves it almost no gradient; the port's is
0.1-5 %) and 36 % at the second (conv2's map_to_feat), where the port
stays within 2 %.
The new parameters and running statistics: the port's at least as close
to its own float64 step's as JAX's are (4 times, plus 1e-6), and within
a stated distance of JAX's.  Riemannian Adam divides each row's moment by
its norm, so a row moves ~lr whatever its gradient's size: parameters
within atol 2e-4 (4 % of lr 0.005) / rtol 1e-4 of JAX's at the first step
and atol 5e-4 (10 % of lr; 3.2e-4 measured, conv1's BatchNorm bias) at
the second; running statistics within atol 2e-4 / rtol 1e-3 at both.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (
    InjectedTriplets,
    grad_close,
    jax_port_pair,
    load_opt_state,
    numpy_opt_state,
    rotated_batch,
    to_numpy_tree,
)
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_torch import trainer
from hpcs_torch.nn.backbones import vn_dgcnn
from hpcs_torch.ops.knn import knn_plain
from hpcs_torch.testing import (check_train_step_card_vs_cpu, float64_train_step,
                                permute_step_inputs)
from hpcs_torch.utils.jax_params import _params_sd, from_jax_opt_state, from_jax_params

CFG = dict(dropout=0.0, train_rotation="none", t_per_anchor=10, temperature=0.1,
           trade_off=0.1, lr=0.005)
TOL_LOGS = dict(atol=1e-5, rtol=1e-3)
TOL_METRICS = dict(atol=0.02, rtol=0)  # an argmax near-tie or two among the points
TOL_PARAMS = [dict(atol=2e-4, rtol=1e-4), dict(atol=5e-4, rtol=1e-4)]  # by step
GRAD_SHARE = [0.1, 0.5]  # |port - JAX| / the leaf's largest float64 entry, by step
TOL_STATS = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def shared():
    jsys, state, _, batch = jax_port_pair(eucl=8, hyp=8, B=2, N=96, k=8, **CFG)
    return jsys, state, rotated_batch(batch)


@pytest.fixture
def pair(shared):
    """(JAX system, its initial state, a fresh port system on its weights,
    batch)."""
    from hpcs_torch.models import HypHCSystem

    jsys, state, batch = shared
    tsys = HypHCSystem(port_config(jsys.cfg), device="cpu")
    tsys.net.load_state_dict(from_jax_params(to_numpy_tree(state.params),
                                             to_numpy_tree(state.batch_stats)))
    return jsys, state, tsys, batch


def port_config(jcfg):
    from dataclasses import fields

    from hpcs_torch.models import ModelConfig

    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in fields(ModelConfig)})


def test_two_train_steps_match_jax(pair, monkeypatch):
    """Each step starts both packages from the same state: before the
    second, the port takes JAX's parameters, batch statistics and Adam
    moments (from_jax_params, from_jax_opt_state).  Left to run on, the
    port's second step sees embeddings up to ~0.1 off JAX's (the
    similarity margins of its triplets differ by 5e-3 at the median): the
    first step's 1e-4 parameter differences, through the ill-conditioned
    forward (ROADMAP §C)."""
    jsys, state, tsys, batch = pair
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    dv = j_decode_vector(jsys.cfg, jbatch)
    apply_net = jax.jit(lambda st, k: jsys._apply(st.params, st.batch_stats, jbatch["points"], dv,
                                                  True, k)[1])
    grads_and_logs = jax.jit(jsys.grads_and_logs)
    apply_gradients = jax.jit(jsys.apply_gradients)
    inject = InjectedTriplets(monkeypatch)
    graphs = []
    monkeypatch.setattr(vn_dgcnn, "knn", lambda x, k: graphs.append(knn_plain(x, k)) or graphs[-1])
    gen = torch.Generator().manual_seed(0)
    for step in range(2):
        if step:
            params = to_numpy_tree(state.params)
            tsys.net.load_state_dict(from_jax_params(params, to_numpy_tree(state.batch_stats)))
            load_opt_state(tsys, from_jax_opt_state(numpy_opt_state(state.opt_state), params))
        key = jax.random.PRNGKey(10 + step)
        _, k_drop, k_loss = jax.random.split(key, 3)
        inject.add(k_loss, jbatch["labels"], apply_net(state, k_drop), jsys.cfg)
        grads, jlogs, new_bs = grads_and_logs(state, jbatch, key, jnp.float32(0.1))
        state = apply_gradients(state, grads, new_bs)

        graphs.clear()
        before = copy.deepcopy(tsys)
        logs = tsys.grads_and_logs(batch, gen)
        assert set(logs) == set(jlogs) == {"total_loss", "loss_metric", "loss_hyp", "acc", "iou",
                                           "scale"}
        ref_logs, ref, ref_sd = float64_train_step(before, batch, list(graphs))
        for k, v in jlogs.items():
            got, want = float(logs[k]), float(v)
            if k in ref_logs:
                r = ref_logs[k]
                assert abs(got - r) <= 4 * abs(want - r) + 1e-5 * abs(r), k
            tol = TOL_METRICS if k in ("acc", "iou") else TOL_LOGS
            np.testing.assert_allclose(got, want, err_msg=k, **tol)
        jgrads = _params_sd(to_numpy_tree(grads))
        for name, p in tsys.net.named_parameters():
            grad_close(p.grad.numpy(), jgrads[name].reshape(p.shape).numpy(), ref[name], name,
                        GRAD_SHARE[step])
        tsys.apply_gradients()

        want = from_jax_params(to_numpy_tree(state.params), to_numpy_tree(state.batch_stats))
        got = tsys.net.state_dict()
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            g, w, r = got[name].double().numpy(), w.double().numpy(), ref_sd[name]
            assert np.abs(g - r).max() <= 4 * np.abs(w - r).max() + 1e-6, name
            tol = TOL_STATS if "running" in name else TOL_PARAMS[step]
            np.testing.assert_allclose(g, w, err_msg=name, **tol)
    assert int(state.step) == 2 and all(s["step"] == 2 for s in tsys.optimizer.state.values())


def test_eval_step_matches_jax(pair, monkeypatch):
    """JAX's triplets; the 'easy' mask is JAX's filter on the port's
    embeddings (JAX's eval_step filters on its own, which may differ at a
    near-tie: one triplet of 1,920 in the mean)."""
    jsys, state, tsys, batch = pair
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    _, k_loss = jax.random.split(key)  # as hpcs_tpu's eval_step splits it
    _, x_p = tsys.embed(batch["points"], j_decode_vector(jsys.cfg, jbatch))
    InjectedTriplets(monkeypatch).add(k_loss, jbatch["labels"], jnp.asarray(x_p.numpy()),
                                      jsys.cfg)
    want = jax.jit(jsys.eval_step)(state, jbatch, key, jnp.float32(0.1))
    got = tsys.eval_step(batch, torch.Generator().manual_seed(0))
    assert set(got) == set(want) == {"val_loss", "acc", "iou"}
    for k in want:
        tol = TOL_METRICS if k in ("acc", "iou") else TOL_LOGS
        np.testing.assert_allclose(float(got[k]), float(want[k]), err_msg=k, **tol)


def test_epoch_end_schedules_match_jax(pair):
    """The plateau LR and the temperature annealing over a val_loss trace."""
    from hpcs_tpu.models import HypHCSystem as JSystem
    from hpcs_tpu.models import ModelConfig as JConfig
    from hpcs_torch.models import HypHCSystem, ModelConfig

    kw = dict(num_class=6, num_categories=2, eucl_dim=4, hyp_dim=4, k=4, temperature=0.2,
              anneal_step=2, anneal_factor=0.5)
    jsys, tsys = JSystem(JConfig(**kw)), HypHCSystem(ModelConfig(**kw), device="cpu")
    for epoch, v in enumerate([1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.98, 0.99, 0.5, 0.6]):
        assert tsys.epoch_end(epoch, v) == jsys.epoch_end(epoch, v)
        assert tsys.temperature == jsys.temperature
        tsys.set_learning_rate(tsys.plateau.lr)
        assert all(g["lr"] == jsys.plateau.lr for g in tsys.optimizer.param_groups)
    assert tsys.plateau.lr < 0.005 and tsys.temperature < 0.2


def _small_system(**over):
    from hpcs_torch.models import HypHCSystem, ModelConfig

    fields = dict(num_class=6, num_categories=2, eucl_dim=4, hyp_dim=4, k=6, t_per_anchor=5,
                  temperature=0.1)
    cfg = ModelConfig(**{**fields, **over})
    return HypHCSystem(cfg, device="cpu")


def _batches(n, seed=0):
    from _torch_port import synthetic_batch

    return [synthetic_batch(2, 48, seed=seed + i) for i in range(n)]


def test_fit_runs_two_epochs_and_returns_the_best_state():
    tsys = _small_system()
    lines = []
    state, best = trainer.fit(tsys, _batches(2), _batches(1, seed=7), epochs=2, seed=1,
                              log=lines.append)
    assert len(lines) == 2 and np.isfinite(best) and state["step"] in (2, 4)
    assert set(state) == {"net", "optimizer", "step"}
    for k, v in tsys.net.state_dict().items():  # the system is left in the returned state
        torch.testing.assert_close(v, state["net"][k], rtol=0, atol=0)


def test_fit_without_a_finite_val_loss_returns_the_last_state():
    tsys = _small_system()
    lines = []
    state, best = trainer.fit(tsys, _batches(1), [], epochs=2, log=lines.append)
    assert best == float("inf") and state["step"] == 2 and "no finite val_loss" in lines[-1]
    torch.testing.assert_close(state["net"]["scale"], tsys.net.scale.detach(), rtol=0, atol=0)
    assert float(state["net"]["scale"][0]) != 1e-3  # trained, not the initial state


def test_fit_stops_early(monkeypatch):
    tsys = _small_system()
    monkeypatch.setattr(tsys, "eval_step", lambda batch, gen: {"val_loss": torch.tensor(1.0)})
    lines = []
    _, best = trainer.fit(tsys, _batches(1), _batches(1, seed=9), epochs=5, patience=2,
                          log=lines.append)
    assert len(lines) == 3 and best == 1.0  # the best first, then two epochs without a better


def test_card_vs_cpu_check_rehearsed_on_the_cpu():
    """chip_smoke's and the GPU tests' comparison of a card step with the
    CPU's, run here with a CPU system in the card's place: the same step
    twice, so every error is the backward's order of scatter-adds."""
    from _torch_port import synthetic_batch

    tsys = _small_system(dropout=0.0, train_rotation="none")
    out = check_train_step_card_vs_cpu(tsys, synthetic_batch(2, 64, seed=4))
    assert out["filter_flips"] == 0 and out["max_rel_err_logs"] < 1e-5
    assert tsys.step == 1
    with pytest.raises(ValueError, match="dropout"):
        check_train_step_card_vs_cpu(_small_system(), synthetic_batch(2, 64))


# Bottle's level tree at levels 1 and 3 (tools/make_mini_datasets_torch.py's,
# as get_hierarchy_list remaps it)
BOTTLE_HIERARCHY = (((0,), (1, 2), (3, 4, 5, 6, 7)),
                    ((0,), (1,), (2,), (3,), (4,), (5,), (6,), (7,)))


@pytest.mark.parametrize("class_vector", [False, True])
def test_card_vs_cpu_check_rehearsed_on_a_hierarchical_partnet_system(class_vector):
    """The same rehearsal on PartNet's configuration: the hierarchical
    CosFace over two levels (and the part-presence decode vector).  The
    check's float64 witness runs the loss on float64 embeddings, so it
    needs the level sum matrices in float64 as well."""
    from _torch_port import synthetic_batch

    tsys = _small_system(dataset="partnet", num_class=9, num_categories=1, hierarchical=True,
                         hierarchy_list=BOTTLE_HIERARCHY, class_vector=class_vector,
                         dropout=0.0, train_rotation="none")
    assert tsys.cfg.use_hierarchical and len(tsys.hierarchy_matrices) == 2
    out = check_train_step_card_vs_cpu(tsys, synthetic_batch(2, 64, categories=3, seed=4))
    assert out["filter_flips"] == 0 and out["max_rel_err_logs"] < 1e-5
    assert all(m.dtype == torch.float32 for m in tsys.hierarchy_matrices)


def test_reordered_points_give_the_same_float64_step(monkeypatch):
    """permute_step_inputs reorders the points, graphs and triplets of a
    step consistently: in float64 the step's logs and gradients are those of
    the given order within 1e-10 (relative, and of each leaf's largest
    entry), its running statistics within 1e-12."""
    from _torch_port import synthetic_batch
    from hpcs_torch.loss import joint
    from hpcs_torch.miner import sample_balanced_triplets

    tsys = _small_system(dropout=0.0, train_rotation="none")
    batch = synthetic_batch(2, 64, seed=4)
    labels = torch.as_tensor(batch["labels"]).reshape(-1).long()
    trip = sample_balanced_triplets(torch.Generator().manual_seed(0), labels, 6, 5, 0.5)
    trip = trip._replace(mask=torch.ones_like(trip.mask))
    monkeypatch.setattr(joint, "margin_filter", lambda emb, t, *a, **kw: t)
    pts = torch.as_tensor(batch["points"])
    graphs = [knn_plain(pts, 6)]  # any graphs serve; stage 1's and the others' alike
    graphs = graphs * 3
    perm = torch.stack([torch.randperm(64, generator=torch.Generator().manual_seed(s))
                        for s in range(2)])
    p_batch, p_graphs, p_trip = permute_step_inputs(batch, graphs, trip, perm)
    runs = []
    for b, gs, t in ((batch, graphs, trip), (p_batch, p_graphs, p_trip)):
        monkeypatch.setattr(joint, "sample_balanced_triplets", lambda *a, t=t, **kw: t)
        runs.append(float64_train_step(tsys, b, gs))
    (logs, grads, sd), (p_logs, p_grads, p_sd) = runs
    for k, v in logs.items():
        assert abs(p_logs[k] - v) <= 1e-10 * abs(v), k
    for name, g in grads.items():
        assert np.abs(p_grads[name] - g).max() <= 1e-10 * np.abs(g).max(), name
    for name, v in sd.items():
        if "running" in name:
            np.testing.assert_allclose(p_sd[name], v, rtol=0, atol=1e-12, err_msg=name)
    assert not torch.equal(p_batch["points"], torch.as_tensor(batch["points"]))
