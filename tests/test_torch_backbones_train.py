"""One training step of each other backbone (DGCNN, PointNet, VN-PointNet)
and of VN-DGCNN with max pooling against hpcs_tpu's, on the CPU.

As in tests/test_torch_train_step.py: both packages start from the same
weights (from_jax_params) with dropout 0 and train_rotation 'none' on
clouds rotated beforehand; the triplets and the 'easy' mask are hpcs_tpu's
(InjectedTriplets); the port's kNN graphs are recorded and its float64
step runs on them.

These steps are ill-conditioned in fp32 at B = 2: the BatchNorms over
the batch alone ([B, C]: PointNet's STNkd blocks 3-4, VN-PointNet's
fstn.fc1 / fc2, DGCNN's transform_net.linear1 / linear2) see two nearly
equal global features (variance / mean^2 of 1e-9 to 1e-6), and flax's
variance E[x^2] - E[x]^2 cancels in fp32 in both packages.  A PointNet
gradient lies up to 1.8e9 times its leaf's largest float64 entry from
float64 in JAX (a bias before a BatchNorm, zero in exact arithmetic) and
loss_hyp 2.6e-4 from it; VN-DGCNN's VNMaxPool may pick another neighbour
where the stage-1 self-edge leaves two near-equal.  So the port's 'easy'
mask is JAX's without comparing its own, and the step is held by the
float64 witness of tests/test_torch_train_step.py made two-sided: beside
JAX's fp32 step, the port's fp32 step also runs on the clouds with their
points reordered (ORDERS orders, `permute_step_inputs`), which measures
fp32's own noise.  For each log, gradient leaf, parameter and running
statistic, with d the distance from the port's float64 step and noise the
largest d of the reordered steps:
- the port: d <= 4 max(d_JAX, noise) + slack, that test's witness with
  the port's own noise beside JAX's distance (its fp32 step is as good as fp32
  can be here);
- JAX against the port's float64 step (hpcs_tpu computes the port's
  float64 function): the losses within rtol 1e-2, each gradient entry
  within 50 % of its leaf's largest float64 entry plus 4 noise (that
  test's second-step share: hpcs_tpu's own gradient lay 36 % from float64
  there).  JAX's fp32 steps are the noisier ones here too: a VN-PointNet
  gradient lies 3 times as far from float64 as the port's farthest order,
  a running variance 0.03 from it;
- accuracy and IoU within 0.02 of JAX's.
The parameters after the update keep the first rule only, and only on
the ball points whose float64 gradient exceeds 1e-6 of the net's largest
entry (`_decided_points`; the others have a zero gradient in exact
arithmetic, and Riemannian Adam moves them by ~lr along their rounding):
the first step moves each ball point by ~lr along its gradient whatever
the gradient's size, so a point whose gradient is near zero may move
either way (JAX's VN-DGCNN conv6.map_to_dir entries lie 4.7e-3 from
float64 where the port's orders stay within 1.4e-7).  The update itself,
from equal gradients, is held by
test_torch_backbones.py::test_riemannian_adam_state_matches_jax.
Slack: logs 1e-5 relative; gradients 1e-4 of the leaf's scale, its
largest float64 entry or 1e-6 of the net's largest, whichever is larger
(biases before a batch-statistics BatchNorm have a zero gradient);
parameters and statistics 1e-6.  A VNMaxPool's direction map has no
gradient in either package (the argmax): zero in JAX, None in the port.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (InjectedTriplets, jax_port_pair, rotated_batch, to_numpy_tree,
                         torch_threads)
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_torch.nn.backbones import vn_dgcnn
from hpcs_torch.ops.knn import knn_plain
from hpcs_torch.testing import float64_train_step, grad_array, permute_step_inputs
from hpcs_torch.utils.jax_params import _params_sd, ball_dim, from_jax_params

CFG = dict(dropout=0.0, train_rotation="none", t_per_anchor=10, temperature=0.1,
           trade_off=0.1, lr=0.005)
ORDERS = 3
FACTOR = 4.0
CONFIGS = {
    "dgcnn": dict(model_name="dgcnn_partseg", eucl=6),
    "pointnet": dict(model_name="pointnet_partseg", eucl=6),
    "vn_pointnet": dict(model_name="vn_pointnet_partseg", eucl=6),
    "vn_dgcnn_max": dict(model_name="vn_dgcnn_partseg", pooling="max", eucl=8),
}
GRAPHS = {"dgcnn": 4, "pointnet": 0, "vn_pointnet": 1, "vn_dgcnn_max": 3}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Small models: more intra-op threads per test worker only contend."""
    with torch_threads(2):
        yield


def _decided_points(grad64, dim, top):
    """A mask, shaped like the gradient, of the entries of the ball points
    (vectors along `dim`, Riemannian Adam's axis) whose float64 gradient
    exceeds 1e-6 of `top`, the net's largest float64 entry; the others
    have a zero gradient in exact arithmetic."""
    big = np.abs(grad64).max(axis=dim, keepdims=True) > 1e-6 * top
    return np.broadcast_to(big, np.shape(grad64))


def _port_step(tsys, batch, graphs, triplets, inject, monkeypatch):
    """A copy of the port system's fp32 step on the given kNN graphs (an
    empty list: knn_plain's, recorded into it) and triplets: (logs,
    gradients, state_dict after the update) as numpy."""
    sys_ = copy.deepcopy(tsys)
    if graphs:
        it = iter(list(graphs))
        monkeypatch.setattr(vn_dgcnn, "knn", lambda x, k: next(it))
    else:
        monkeypatch.setattr(vn_dgcnn, "knn",
                            lambda x, k: graphs.append(knn_plain(x, k)) or graphs[-1])
    inject.trip = triplets
    logs = sys_.grads_and_logs(batch, torch.Generator().manual_seed(0))
    grads = {n: grad_array(p) for n, p in sys_.net.named_parameters()}
    sys_.apply_gradients()
    return ({k: float(v) for k, v in logs.items()}, grads,
            {n: v.double().numpy() for n, v in sys_.net.state_dict().items()})


def _witness(got, want, others, ref, slack, what, jax_tol=None):
    """The float64 witness (module docstring): the port's fp32 step `got`
    at most FACTOR times as far from the float64 step `ref` as JAX's `want`
    or the farthest reordered step of `others` (plus slack), and JAX's
    within jax_tol + FACTOR noise of `ref` entry by entry (if given)."""
    d, d_jax = np.abs(got - ref).max(), np.abs(want - ref).max()
    noise = max(np.abs(o - ref).max() for o in others)
    assert d <= FACTOR * max(d_jax, noise) + slack, f"{what}: port {d:.3e} from float64, " \
        f"JAX {d_jax:.3e}, noise {noise:.3e}"
    if jax_tol is not None:
        assert (np.abs(want - ref) <= jax_tol + FACTOR * noise).all(), \
            f"{what}: JAX {d_jax:.3e} from float64, noise {noise:.3e}"


@pytest.mark.parametrize("config", list(CONFIGS))
def test_train_step_matches_jax(config, monkeypatch):
    over = dict(CONFIGS[config])
    eucl = over.pop("eucl")
    jsys, state, tsys, batch = jax_port_pair(eucl=eucl, hyp=4, B=2, N=96, k=8, **CFG, **over)
    batch = rotated_batch(batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    dv = j_decode_vector(jsys.cfg, jbatch)
    key = jax.random.PRNGKey(10)
    _, k_drop, k_loss = jax.random.split(key, 3)
    x_p = jax.jit(lambda st: jsys._apply(st.params, st.batch_stats, jbatch["points"], dv, True,
                                         k_drop)[1])(state)
    inject = InjectedTriplets(monkeypatch)
    inject.NEAR_TIE = np.inf  # the masks are not compared (module docstring)
    inject.add(k_loss, jbatch["labels"], x_p, jsys.cfg)
    grads, jlogs, new_bs = jax.jit(jsys.grads_and_logs)(state, jbatch, key, jnp.float32(0.1))
    state = jax.jit(jsys.apply_gradients)(state, grads, new_bs)

    graphs, trip = [], inject.trip
    logs, port_grads, port_sd = _port_step(tsys, batch, graphs, trip, inject, monkeypatch)
    assert len(graphs) == GRAPHS[config]
    ref_logs, ref, ref_sd = float64_train_step(tsys, batch, graphs)
    perm_gen = torch.Generator().manual_seed(1)
    reordered = []
    for _ in range(ORDERS):
        perm = torch.stack([torch.randperm(96, generator=perm_gen) for _ in range(2)])
        p_batch, p_graphs, p_trip = permute_step_inputs(batch, graphs, trip, perm)
        reordered.append(_port_step(tsys, p_batch, p_graphs, p_trip, inject, monkeypatch))

    assert set(logs) == {k for k in jlogs}
    for k, v in jlogs.items():
        if k in ref_logs:
            r = ref_logs[k]
            _witness(logs[k], float(v), [lg[k] for lg, _, _ in reordered], r, 1e-5 * abs(r), k,
                     jax_tol=1e-2 * abs(r))
        else:
            tol = 0.02 if k in ("acc", "iou") else 0.0
            assert abs(logs[k] - float(v)) <= tol, k
    jgrads = _params_sd(to_numpy_tree(grads))
    top = max(np.abs(g).max() for g in ref.values())
    for name, p in tsys.net.named_parameters():
        want = jgrads[name].reshape(p.shape).numpy().astype(np.float64)
        if name.endswith("map_to_dir.weight") and ".pool" in f".{name}":
            assert not want.any() and not port_grads[name].any(), name
        scale = max(np.abs(ref[name]).max(), 1e-6 * top)
        _witness(port_grads[name], want, [g[name] for _, g, _ in reordered], ref[name],
                 1e-4 * scale, f"gradient of {name}", jax_tol=0.5 * scale)

    want_sd = from_jax_params(to_numpy_tree(state.params), to_numpy_tree(state.batch_stats))
    assert set(want_sd) == set(port_sd)
    params = dict(tsys.net.named_parameters())
    for name, w in want_sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        held = (_decided_points(ref[name], ball_dim(name, params[name]), top)
                if name in params else np.ones(w.shape, bool))
        if held.any():
            _witness(port_sd[name][held], w.double().numpy()[held],
                     [sd[name][held] for _, _, sd in reordered], ref_sd[name][held], 1e-6, name)
