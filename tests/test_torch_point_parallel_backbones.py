"""The port's point sharding of every configuration hpcs_tpu shards
(hpcs_torch.parallel.point_parallel) against hpcs_tpu.parallel's and the
port's unsharded forward and step on the CPU: DGCNN, PointNet,
VN-PointNet with mean and with max pooling, VN-DGCNN with max pooling,
VN-DGCNN in bf16, and VN-DGCNN with class_vector (its part-presence
vector over every rank's labels: point_parallel.decode_vector).

The port's ranks are gloo processes at 1 intra-op thread each
(tests/_torch_parallel_ranks.point_parallel_backbones_job, one job per
mesh for all configurations) on ("data", "points") meshes (1, 2) and
(2, 2), started before the JAX side compiles (EarlyRanks); the JAX side
runs on the virtual CPU devices of tests/conftest.py.  Every configuration
is 6 classes, 2 categories, hyp 4, k 8 (eucl 4 for VN-DGCNN, 6 = the
classes for the others), its weights from hpcs_tpu's init
(tests/_torch_port.jax_port_pair), on B = 4 synthetic part clouds of
N = 64 points, rotated.

- The sharded eval forward within atol 2e-5 of the port's unsharded
  forward and of make_point_sharded_forward's on mesh (1, 2) (GSPMD's
  program; its other meshes compute the same function).  bf16: hpcs_tpu's
  sharded program is compiled as written (`jit_as_written`'s option, with
  the same shardings) through `bf16_einsum_on_cpu`; each package builds
  its graphs on its own bf16 stage inputs, and the two outputs are held
  within BF16_DIRECT_SHARE of the largest entry, the direct bound of
  tests/test_torch_bf16.py's forward; against the port's unsharded bf16
  forward the sharded one is held within one bf16 ulp (2^-7) of the
  largest entry (the sums over the points run in another order; measured:
  equal).
- The sharded training step is the unsharded step in float64 on both
  meshes (dropout 0, no rotation, each on its own kNN graphs): logs within
  FLOAT64_WITNESS relative, gradients within FLOAT64_WITNESS of each
  leaf's scale, running statistics within FLOAT64_WITNESS relative (the
  heads' E[x^2] - E[x]^2 cancel: VN-PointNet's convs1 variance 3.8e-12
  relative apart on mesh (1, 2)).
- The fp32 step (dropout 0.5, so3, one generator seed on every rank)
  leaves every rank's parameters equal bit for bit and its loss finite.
- DGCNN and VN-PointNet with max pooling, on hpcs_tpu's triplets and mask
  (dropout 0, no rotation), against make_point_sharded_train_step on mesh
  (1, 2), at tests/test_torch_point_parallel.py's tolerances, the
  gradients by a float64 witness (slow: its JAX programs take most of a
  minute to compile; see the test).
"""
import contextlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from _torch_port import (bf16_einsum_on_cpu, jax_params_like, jax_port_pair, jax_triplets,
                         rotated_batch, to_numpy_tree, torch_threads)
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_torch.models import ModelConfig, decode_vector_for_batch
from hpcs_torch.testing import FACTOR, FLOAT64_WITNESS, GRAD_FLOOR, float64_train_step
from hpcs_torch.utils.jax_params import _params_sd, from_jax_params

B, N = 4, 64
BASE = dict(dataset="shapenet", num_class=6, num_categories=2, hyp_dim=4, k=8, t_per_anchor=5,
            num_triplets=512, temperature=0.1)
CONFIGS = {
    "dgcnn": dict(model_name="dgcnn_partseg", eucl_dim=6),
    "pointnet": dict(model_name="pointnet_partseg", eucl_dim=6),
    "vn_pointnet_mean": dict(model_name="vn_pointnet_partseg", eucl_dim=6),
    "vn_pointnet_max": dict(model_name="vn_pointnet_partseg", eucl_dim=6, pooling="max"),
    "vn_dgcnn_max": dict(eucl_dim=4, pooling="max"),
    "vn_dgcnn_bf16": dict(eucl_dim=4, bf16=True),
    "vn_dgcnn_class_vector": dict(eucl_dim=4, class_vector=True),
}
GIVEN = ("dgcnn", "vn_pointnet_max")  # held against hpcs_tpu's sharded step
PLAIN = dict(dropout=0.0, train_rotation="none")
MESHES = [(1, 2), (2, 2)]
BF16_DIRECT_SHARE = 0.03
BF16_ULP = 2.0 ** -7


def _place(parts, shape, like):
    """Every rank's [b, n, ...] part of a [B, N, ...] array put together."""
    D, P = shape
    out = np.zeros_like(like)
    b, n = B // D, N // P
    for r, part in enumerate(parts):
        d, p = divmod(r, P)
        out[d * b:(d + 1) * b, p * n:(p + 1) * n] = part
    return out


def _jax_sharded_bf16_forward(jsys, mesh, state, points, dv):
    """make_point_sharded_forward's program (its shardings, the kNN pinned
    to XLA), compiled to round where its source casts to bf16."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from hpcs_tpu.ops.knn import force_xla_knn

    repl = NamedSharding(mesh, P())
    sharded = NamedSharding(mesh, P(None, "points", None))

    def forward(params, batch_stats, pts, d):
        return jsys.net.apply({"params": params, "batch_stats": batch_stats}, pts, d,
                              train=False)

    args = (state.params, state.batch_stats, points, dv)
    with force_xla_knn():
        return jax.jit(forward, in_shardings=(repl, repl, sharded, NamedSharding(mesh, P())),
                       out_shardings=(sharded, sharded)).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    directory = tmp_path_factory.mktemp("ppb")
    with contextlib.ExitStack() as stack:  # the ranks start while JAX compiles
        jobs = {shape: stack.enter_context(ranks.EarlyRanks(
            ranks.point_parallel_backbones_job, shape[0] * shape[1], directory, threads=1))
            for shape in MESHES}
        with pytest.MonkeyPatch.context() as mp:
            bf16_einsum_on_cpu(mp)
            return _pp(jobs)


def _pp(jobs):
    from hpcs_tpu.parallel import make_mesh_2d as j_mesh_2d
    from hpcs_tpu.parallel import make_point_sharded_forward as j_forward

    mesh = j_mesh_2d(1, 2)
    key = jax.random.PRNGKey(11)
    _, k_drop, k_loss = jax.random.split(key, 3)
    cases, out = {shape: {} for shape in MESHES}, {}
    for name, over in CONFIGS.items():
        jsys, state, _, batch = jax_port_pair(B=B, N=N, seed=11, **BASE, **over, **PLAIN)
        batch = rotated_batch(batch)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        dv = j_decode_vector(jsys.cfg, jbatch)
        given = None
        if name in GIVEN:
            x_p = jax.jit(lambda st: jsys._apply(st.params, st.batch_stats, jbatch["points"], dv,
                                                 True, k_drop)[1])(state)
            given = jax_triplets(k_loss, jbatch["labels"], x_p, jsys.cfg)
        sd = {k: v.numpy() for k, v in from_jax_params(to_numpy_tree(state.params),
                                                       to_numpy_tree(state.batch_stats)).items()}
        cfg, plain = ModelConfig(**BASE, **over), ModelConfig(**BASE, **over, **PLAIN)
        for shape in MESHES:
            cases[shape][name] = (cfg, plain, sd, batch, given if shape == (1, 2) else None)
        out[name] = dict(jsys=jsys, state=state, jbatch=jbatch, batch=batch, sd=sd, cfg=cfg,
                         plain=plain, given=given)
    for shape, job in jobs.items():
        job.give(shape, cases[shape])
    for name, o in out.items():
        args = (o["state"].params, o["state"].batch_stats, o["jbatch"]["points"],
                j_decode_vector(o["jsys"].cfg, o["jbatch"]))
        run = (partial(_jax_sharded_bf16_forward, o["jsys"], mesh, o["state"])
               if o["cfg"].bf16 else partial(j_forward(o["jsys"], mesh), *args[:2]))
        o["jforward"] = [np.asarray(a, np.float32) for a in run(*args[2:])]
    with torch_threads(2):  # small models: more threads per test worker only contend
        for o in out.values():
            system = _system(o, "cfg")
            o["unsharded"] = [t.numpy() for t in system.embed(
                o["batch"]["points"], decode_vector_for_batch(system.cfg, o["batch"]))]
            o["float64"] = float64_train_step(_system(o, "plain"), o["batch"], None)
    ranks_out = {shape: job.result() for shape, job in jobs.items()}
    return dict(cases=out, out=ranks_out)


def _system(case, cfg):
    return ranks.system_from(case[cfg], case["sd"])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_point_sharded_forward_matches_jax_and_unsharded(pp, name, shape):
    case = pp["cases"][name]
    for i, (u, j) in enumerate(zip(case["unsharded"], case["jforward"])):
        got = _place([r[name]["forward"][i] for r in pp["out"][shape]], shape, u)
        if case["cfg"].bf16:
            scale = float(np.abs(u).max())
            assert np.abs(got - u).max() <= BF16_ULP * scale
            assert np.abs(got - j).max() <= BF16_DIRECT_SHARE * scale
        else:
            np.testing.assert_allclose(got, u, rtol=0, atol=2e-5)
            np.testing.assert_allclose(got, j, rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_point_sharded_step_is_the_unsharded_step_in_float64(pp, name, shape):
    logs, grads, state = pp["cases"][name]["float64"]
    top = max(float(np.abs(g).max()) for g in grads.values())
    for rank in pp["out"][shape]:
        for k, v in logs.items():
            assert abs(rank[name]["float64"][0][k] - v) <= FLOAT64_WITNESS * abs(v), k
    _, got_grads, got_state = pp["out"][shape][0][name]["float64"]
    for k, g in grads.items():
        scale = max(float(np.abs(g).max()), GRAD_FLOOR * top)
        assert np.abs(got_grads[k] - g).max() <= FLOAT64_WITNESS * scale, k
    for k, v in state.items():
        if "running" in k:
            np.testing.assert_allclose(got_state[k], v, rtol=FLOAT64_WITNESS, atol=1e-12,
                                       err_msg=k)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_point_sharded_steps_leave_the_ranks_replicated(pp, name, shape):
    first, *others = (r[name] for r in pp["out"][shape])
    assert np.isfinite(first["logs"]["total_loss"])
    assert all(r[name]["replicated"] for r in pp["out"][shape])
    for other in others:
        assert other["logs"] == first["logs"]


def _unsharded_steps(case, monkeypatch):
    """The port's unsharded fp32 step of the case's plain config on its
    JAX triplets (recording its kNN graphs) and its float64 step on the
    same triplets and graphs: (gradients, running statistics) of each."""
    from hpcs_torch.nn.backbones import vn_dgcnn
    from hpcs_torch.ops.knn import knn_plain

    system = _system(case, "plain")
    graphs = []
    with monkeypatch.context() as mp:
        mp.setattr(vn_dgcnn, "knn", lambda x, k: graphs.append(knn_plain(x, k)) or graphs[-1])
        ranks._with_given(case["given"], lambda: system.grads_and_logs(case["batch"],
                                                                       torch.Generator()))
    fp32 = ({n: p.grad.numpy().astype(np.float64) for n, p in system.net.named_parameters()
             if p.grad is not None},
            {n: v.numpy().astype(np.float64) for n, v in system.net.state_dict().items()})
    _, grads, state = ranks._with_given(case["given"], lambda: float64_train_step(
        _system(case, "plain"), case["batch"], graphs))
    return fp32, (grads, state)


@pytest.mark.slow
@pytest.mark.parametrize("name", GIVEN)
def test_point_sharded_step_matches_jax_with_its_triplets(pp, name, monkeypatch):
    """The port's sharded step on hpcs_tpu's triplets and mask against
    make_point_sharded_train_step on mesh (1, 2): logs atol 1e-5 / rtol
    1e-3 (accuracy and IoU atol 0.02), and parameters atol 2e-4 / rtol
    1e-4 of what hpcs_tpu's apply_gradients makes of the gradients the
    port applies (tests/test_torch_parallel.py on the update).  The
    gradients and running statistics are held by
    tests/test_torch_backbones_train.py's float64 witness (these steps are
    ill-conditioned in fp32: VN-PointNet's bn5 bias gradient lies 14 % of
    its leaf's largest entry from hpcs_tpu's, its convs1 running mean
    5.4e-4 from hpcs_tpu's): each leaf of the sharded step at most FACTOR
    times as far from the port's float64 step on the same triplets and
    graphs as hpcs_tpu's or the port's unsharded fp32 step's (the same
    function, its sums in another order), plus 1e-4 of the leaf's scale
    (gradients) or 1e-6 (statistics)."""
    from hpcs_tpu.parallel import make_mesh_2d as j_mesh_2d
    from hpcs_tpu.parallel import make_point_sharded_train_step as j_step
    from hpcs_tpu.parallel import shard_points_batch as j_shard

    case = pp["cases"][name]
    jsys, state, jbatch = case["jsys"], case["state"], case["jbatch"]
    key, temp = jax.random.PRNGKey(11), jnp.float32(0.1)
    mesh = j_mesh_2d(1, 2)
    jstate, jlogs = j_step(jsys, mesh)(state, j_shard(mesh, jbatch), key, temp)
    jgrads = {n: np.asarray(g, np.float64) for n, g in _params_sd(to_numpy_tree(
        jax.jit(jsys.grads_and_logs)(state, jbatch, key, temp)[0])).items()}
    with torch_threads(2):
        (fp32, fp32_state), (float64, float64_state) = _unsharded_steps(case, monkeypatch)
    want = from_jax_params(to_numpy_tree(jstate.params), to_numpy_tree(jstate.batch_stats))
    assert all(rank[name]["given_replicated"] for rank in pp["out"][(1, 2)])
    r = pp["out"][(1, 2)][0][name]  # the ranks' states are equal
    top = max(float(np.abs(g).max()) for g in float64.values())
    for k, g in r["given_grads"].items():
        ref = float64[k]
        scale = max(float(np.abs(ref).max()), GRAD_FLOOR * top)
        d = np.abs(g - ref).max()
        d_jax = np.abs(jgrads[k].reshape(ref.shape) - ref).max()
        d_order = np.abs(fp32.get(k, np.zeros_like(ref)) - ref).max()
        assert d <= FACTOR * max(d_jax, d_order) + 1e-4 * scale, (k, d, d_jax, d_order)
    update = from_jax_params(to_numpy_tree(jax.jit(jsys.apply_gradients)(
        state, jax_params_like(r["given_grads"], state.params), jstate.batch_stats).params),
        to_numpy_tree(jstate.batch_stats))
    for k, v in jlogs.items():
        tol = dict(atol=0.02, rtol=0) if k in ("acc", "iou") else dict(atol=1e-5, rtol=1e-3)
        np.testing.assert_allclose(r["given_logs"][k], float(v), err_msg=k, **tol)
    for k, w in want.items():
        if "running" in k:
            ref = float64_state[k]
            d = np.abs(r["given_state"][k] - ref).max()
            d_jax, d_order = np.abs(w.numpy() - ref).max(), np.abs(fp32_state[k] - ref).max()
            assert d <= FACTOR * max(d_jax, d_order) + 1e-6, (k, d, d_jax, d_order)
        elif not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(r["given_state"][k], update[k].numpy(), atol=2e-4,
                                       rtol=1e-4, err_msg=k)
