"""Training VN-DGCNN in bf16 (ModelConfig.bf16) against hpcs_tpu on the CPU:
two steps of HypHCSystem.grads_and_logs and the update, on shared weights,
with mean and with max pooling.

As tests/test_torch_train_step.py: dropout 0 and train_rotation 'none' on
clouds rotated beforehand, hpcs_tpu's triplets and 'easy' mask
(InjectedTriplets), and before the second step the port takes hpcs_tpu's
state.  hpcs_tpu's bf16 programs run here through `bf16_einsum_on_cpu` and
are compiled to round where their source does (`jit_as_written`).  Each
package builds its kNN graphs from its own bf16 stage inputs, which differ
where a bf16 rounding flips: the port takes hpcs_tpu's graphs of each step
(recorded in hpcs_tpu's training forward), and its own kNN on its own
stage inputs shares at least GRAPH_SHARE of their neighbours.

The bf16 training forward at this size is noise: it amplifies rounding
~1e4-fold (the fp32 forward lies ~1e-3 from float64, ROADMAP §C), so in
bf16 both packages' embeddings lie O(1) from the float64 forward (max
|x_poincare - float64| 1.25 of its largest entry in the port, 1.23 in
hpcs_tpu; mean 0.32 and 0.31; tools/bf16_readings.py), and their own
'easy' masks differ at any margin: the port's own mask is not held to
hpcs_tpu's.  The check is
therefore the float64 witness with a noise floor.  The reference is the
port's step in float64 on the same graphs, triplets and mask
(`testing.float64_train_step`, which drops the bf16 compute dtype); the
floor is the farther of hpcs_tpu's bf16 step and the port's own bf16 step
run with each cloud's points in ORDERS other orders (`permute_step_inputs`:
the same function, other sums).  The port's bf16 losses, gradients (per
leaf, as shares of the leaf's largest float64 entry), new parameters and
running statistics are each at most WITNESS times the floor from float64
(plus 1e-5 relative for losses, 1e-4 of a leaf's scale, 1e-6 for the
state).  Directly: the losses within LOSS_RTOL of hpcs_tpu's, accuracy
and IoU within METRIC_ATOL: loose, for losses averaged over that noise.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (InjectedTriplets, bf16_einsum_on_cpu, jax_port_pair, jit_as_written,
                         load_opt_state, numpy_opt_state, rotated_batch, to_numpy_tree,
                         torch_threads)
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_tpu.ops import edgeconv as JE
from hpcs_torch.nn.backbones import vn_dgcnn
from hpcs_torch.ops.knn import knn_plain
from hpcs_torch.testing import float64_train_step, grad_array, permute_step_inputs
from hpcs_torch.utils.jax_params import _params_sd, from_jax_opt_state, from_jax_params

CFG = dict(dropout=0.0, train_rotation="none", t_per_anchor=10, temperature=0.1,
           trade_off=0.1, lr=0.005, bf16=True)
WITNESS = 4.0
ORDERS = 2
LOSS_RTOL = 0.1
METRIC_ATOL = 0.1
GRAPH_SHARE = 0.9


class _Triplets(InjectedTriplets):
    NEAR_TIE = float("inf")  # the port's own mask is not held (see the module's docstring)


@pytest.fixture(scope="module", autouse=True)
def _bf16_on_cpu():
    with pytest.MonkeyPatch.context() as mp, torch_threads(2):
        bf16_einsum_on_cpu(mp)
        yield


def _farthest(ref, *others):
    """The largest max |other - ref| over `others`."""
    return max(float(np.abs(np.asarray(o, np.float64) - ref).max()) for o in others)


@pytest.mark.parametrize("pooling", ["mean", "max"])
def test_two_bf16_train_steps_match_jax(pooling, monkeypatch):
    jsys, state, tsys, batch = jax_port_pair(eucl=8, hyp=8, B=2, N=96, k=8, pooling=pooling,
                                             **CFG)
    batch = rotated_batch(batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    dv = j_decode_vector(jsys.cfg, jbatch)
    real_knn = JE.knn

    def forward_and_graphs(st, k_drop):
        graphs = []
        JE.knn = lambda x, k: graphs.append(real_knn(x, k)) or graphs[-1]
        try:
            x_p = jsys._apply(st.params, st.batch_stats, jbatch["points"], dv, True, k_drop)[1]
        finally:
            JE.knn = real_knn
        return x_p, graphs

    apply_gradients = jax.jit(jsys.apply_gradients)
    inject = _Triplets(monkeypatch)
    given, own = [], []

    def port_knn(x, k):
        own.append(knn_plain(x, k))
        return given.pop(0)

    def port_step(system, b, graphs, trip):
        """A copy of `system` takes one bf16 step on b: (logs, gradients,
        new state) as numpy."""
        system = copy.deepcopy(system)
        given[:], inject.trip = list(graphs), trip
        logs = system.grads_and_logs(b, torch.Generator())
        grads = {n: grad_array(p) for n, p in system.net.named_parameters()}
        system.apply_gradients()
        return ({k: float(v) for k, v in logs.items()}, grads,
                {k: v.double().numpy() for k, v in system.net.state_dict().items()})

    monkeypatch.setattr(vn_dgcnn, "knn", port_knn)
    perm_gen = torch.Generator().manual_seed(1)
    forward = None
    for step in range(2):
        if step:
            params = to_numpy_tree(state.params)
            tsys.net.load_state_dict(from_jax_params(params, to_numpy_tree(state.batch_stats)))
            load_opt_state(tsys, from_jax_opt_state(numpy_opt_state(state.opt_state), params))
        key = jax.random.PRNGKey(10 + step)
        _, k_drop, k_loss = jax.random.split(key, 3)
        forward = forward or jit_as_written(forward_and_graphs, state, k_drop)
        x_p, jgraphs = forward(state, k_drop)
        inject.add(k_loss, jbatch["labels"], x_p, jsys.cfg)
        it = iter(jgraphs)
        monkeypatch.setattr(JE, "knn", lambda x, k: next(it))
        args = (state, jbatch, key, jnp.float32(0.1))
        grads, jlogs, new_bs = jit_as_written(jsys.grads_and_logs, *args)(*args)
        monkeypatch.setattr(JE, "knn", real_knn)
        new_state = apply_gradients(state, grads, new_bs)

        graphs = [torch.from_numpy(np.array(g)) for g in jgraphs]
        trip = inject.trip
        own[:] = []
        logs, got_grads, got_sd = port_step(tsys, batch, graphs, trip)
        for g, o in zip(graphs, own):
            agree = np.mean([len(np.intersect1d(a, b)) for a, b in
                             zip(g.numpy().reshape(-1, 8), o.numpy().reshape(-1, 8))]) / 8
            assert agree >= GRAPH_SHARE, f"step {step}: the port's graph shares {agree:.4f}"
        ref_logs, ref, ref_sd = float64_train_step(tsys, batch, graphs)
        orders = []
        for _ in range(ORDERS):
            perm = torch.stack([torch.randperm(96, generator=perm_gen) for _ in range(2)])
            orders.append(port_step(tsys, *permute_step_inputs(batch, graphs, trip, perm)))
        inject.trip = trip

        for k, r in ref_logs.items():
            got, want = logs[k], float(jlogs[k])
            floor = _farthest(r, want, *(lg[k] for lg, _, _ in orders))
            assert abs(got - r) <= WITNESS * floor + 1e-5 * abs(r), k
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=k)
        for k in ("acc", "iou"):
            np.testing.assert_allclose(logs[k], float(jlogs[k]), rtol=0, atol=METRIC_ATOL)
        jgrads = _params_sd(to_numpy_tree(grads))
        top = max(float(np.abs(v).max()) for v in ref.values())
        for name, g in got_grads.items():
            r = ref[name]
            scale = max(float(np.abs(r).max()), 1e-6 * top)
            floor = _farthest(r, jgrads[name].reshape(g.shape).numpy(),
                              *(gs[name] for _, gs, _ in orders))
            assert np.abs(g - r).max() <= WITNESS * floor + 1e-4 * scale, name

        state = new_state
        want = from_jax_params(to_numpy_tree(state.params), to_numpy_tree(state.batch_stats))
        for name, w in want.items():
            if name.endswith("num_batches_tracked"):
                continue
            g, r = got_sd[name], ref_sd[name]
            floor = _farthest(r, w.double().numpy(), *(sd[name] for _, _, sd in orders))
            assert np.abs(g - r).max() <= WITNESS * floor + 1e-6, name
    assert int(state.step) == 2
