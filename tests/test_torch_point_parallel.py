"""The port's point-sharded forward and training step
(hpcs_torch.parallel.point_parallel) against hpcs_tpu.parallel's and the
port's unsharded ones on the CPU.

The port's ranks are gloo processes at 1 intra-op thread each
(tests/_torch_parallel_ranks.py) on ("data", "points") meshes (1, 2) and
(2, 2), both jobs at once and started before the JAX side compiles
(tests/_torch_parallel_ranks.EarlyRanks); the JAX side runs on the
virtual CPU devices of tests/conftest.py.  The tests on these jobs are
marked slow (the full suite runs them).
The model is tests/test_point_parallel.py's (VN-DGCNN, eucl = hyp = 4,
k = 8, 6 classes, 512 triplets, its weights from hpcs_tpu's init) on B = 4
synthetic part clouds of N = 64 points (tests/_torch_port.jax_port_pair's,
rotated), the port tests' data.

- The sharded eval forward equals make_point_sharded_forward's and the
  port's unsharded forward within atol 2e-5 (test_point_parallel.py).
- The sharded training step (dropout 0.5, so3 rotations, from one
  generator seed on every rank) against the port's unsharded step on both
  meshes: loss rtol 2e-5, parameters and running statistics atol 5e-5 /
  rtol 5e-4 (test_point_parallel.py).  The fp32 training step is
  ill-conditioned (ROADMAP §C): on test_point_parallel.py's own data
  (Gaussian clouds, all of category 0, so conv7's BatchNorm sees one input
  and its exact gradient is 0) the port's sharded and unsharded fp32 steps
  lie farther apart than that (conv1's weight gradient 13 % of its leaf's
  largest entry, conv8's running mean 2.4e-3 relative; two point orders of
  one step: up to 18 %, hpcs_torch.testing), which is why the equivalence
  is also held in float64:
- the sharded step is the unsharded step in float64 on both meshes
  (dropout 0, no rotation, each step on its own kNN graphs): logs within
  FLOAT64_WITNESS relative, gradients within FLOAT64_WITNESS of each
  leaf's scale (hpcs_torch.testing's float64 witness; a leaf's scale is
  its largest entry, or GRAD_FLOOR of the net's largest where that is
  more), running statistics within 1e-12 (absolute and relative).
- With hpcs_tpu's triplets and mask injected (dropout 0, no rotation), the
  sharded step on mesh (1, 2) against make_point_sharded_train_step at the
  first step's tolerances of tests/test_torch_train_step.py: logs atol 1e-5
  / rtol 1e-3 (accuracy and IoU atol 0.02), running statistics atol 2e-4 /
  rtol 1e-3, the gradients it applies within 10 % of each leaf's scale of
  hpcs_tpu's (unsharded, which GSPMD's sharded step computes), and
  parameters atol 2e-4 / rtol 1e-4 of what hpcs_tpu's apply_gradients
  makes of those gradients (see tests/test_torch_parallel.py on the
  update).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from _torch_port import jax_params_tree, jax_port_pair, jax_triplets, rotated_batch, to_numpy_tree
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_torch.models import HypHCSystem, ModelConfig, decode_vector_for_batch
from hpcs_torch.parallel.point_parallel import (make_point_sharded_forward,
                                                make_point_sharded_train_step, shard_points_batch)
from hpcs_torch.testing import FLOAT64_WITNESS, GRAD_FLOOR, float64_train_step
from hpcs_torch.utils.jax_params import _params_sd, from_jax_params

B, N = 4, 64
KW = dict(dataset="shapenet", num_class=6, num_categories=2, eucl_dim=4, hyp_dim=4, k=8,
          t_per_anchor=5, num_triplets=512, temperature=0.1)
PLAIN = dict(dropout=0.0, train_rotation="none")
MESHES = [(1, 2), (2, 2)]
# the tests on the module's rank jobs and JAX programs (~15 s on one
# worker, its JAX compiles most of it) run in the full suite only, which
# keeps the port's parallel tests in the default run under a minute
SLOW = pytest.mark.slow


def _place(parts, shape, full):
    """Every rank's [b, n, ...] part of a [B, N, ...] array put together."""
    D, P = shape
    out = np.zeros_like(full)
    b, n = B // D, N // P
    for r, part in enumerate(parts):
        d, p = divmod(r, P)
        out[d * b:(d + 1) * b, p * n:(p + 1) * n] = part
    return out


@pytest.fixture(scope="module")
def pp(tmp_path_factory):
    directory = tmp_path_factory.mktemp("pp")
    with contextlib.ExitStack() as stack:  # the ranks start while JAX compiles
        jobs = {shape: stack.enter_context(ranks.EarlyRanks(
            ranks.point_parallel_job, shape[0] * shape[1], directory, threads=1))
            for shape in MESHES}
        return _pp(jobs)


def _pp(jobs):
    from hpcs_tpu.parallel import make_mesh_2d as j_mesh_2d
    from hpcs_tpu.parallel import make_point_sharded_forward as j_forward
    from hpcs_tpu.parallel import make_point_sharded_train_step as j_step
    from hpcs_tpu.parallel import shard_points_batch as j_shard

    jsys, state, _, batch = jax_port_pair(B=B, N=N, seed=11, **KW, **PLAIN)
    batch = rotated_batch(batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    dv = j_decode_vector(jsys.cfg, jbatch)
    key, temp = jax.random.PRNGKey(11), jnp.float32(0.1)
    _, k_drop, k_loss = jax.random.split(key, 3)
    x_p = jax.jit(lambda st: jsys._apply(st.params, st.batch_stats, jbatch["points"], dv, True,
                                         k_drop)[1])(state)
    given = jax_triplets(k_loss, jbatch["labels"], x_p, jsys.cfg)
    sd = {k: v.numpy() for k, v in from_jax_params(to_numpy_tree(state.params),
                                                   to_numpy_tree(state.batch_stats)).items()}
    cfg, plain = ModelConfig(**KW), ModelConfig(**KW, **PLAIN)

    for shape, job in jobs.items():
        job.give(shape, cfg, sd, batch, plain, given if shape == (1, 2) else None)
    jforward = {shape: j_forward(jsys, j_mesh_2d(*shape))(
        state.params, state.batch_stats, jbatch["points"], dv) for shape in MESHES}
    mesh = j_mesh_2d(1, 2)
    jstate, jlogs = j_step(jsys, mesh)(state, j_shard(mesh, jbatch), key, temp)
    jgrads = _params_sd(to_numpy_tree(jax.jit(jsys.grads_and_logs)(state, jbatch, key,
                                                                    temp)[0]))
    out = {shape: job.result() for shape, job in jobs.items()}
    return dict(jsys=jsys, state=state, jstate=jstate, jlogs=jlogs, jgrads=jgrads,
                jforward=jforward,
                given=given, out=out, batch=batch, sd=sd, cfg=cfg, plain=plain)


def _system(pp, cfg):
    return ranks.system_from(cfg, pp["sd"])


@SLOW
@pytest.mark.parametrize("shape", MESHES)
def test_point_sharded_forward_matches_jax_and_unsharded(pp, shape):
    system = _system(pp, pp["cfg"])
    x_e, x_p = system.embed(pp["batch"]["points"], decode_vector_for_batch(system.cfg, pp["batch"]))
    ranks_out = pp["out"][shape]
    got_e = _place([r["forward"][0] for r in ranks_out], shape, x_e.numpy())
    got_p = _place([r["forward"][1] for r in ranks_out], shape, x_p.numpy())
    je, jp = (np.asarray(a) for a in pp["jforward"][shape])
    for got, unsharded, jax_out in ((got_e, x_e.numpy(), je), (got_p, x_p.numpy(), jp)):
        np.testing.assert_allclose(got, unsharded, rtol=0, atol=2e-5)
        np.testing.assert_allclose(got, jax_out, rtol=0, atol=2e-5)


def _grads_within(got, want, share):
    """Each leaf of `got` within `share` of its scale from `want`."""
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        w = np.asarray(w).reshape(got[name].shape)
        scale = max(float(np.abs(w).max()), GRAD_FLOOR * top)
        assert np.abs(got[name] - w).max() <= share * scale, name


@SLOW
@pytest.mark.parametrize("shape", MESHES)
def test_point_sharded_step_matches_unsharded_in_fp32(pp, shape):
    system = _system(pp, pp["cfg"])
    logs = system.train_step(pp["batch"], torch.Generator().manual_seed(3))
    for rank in pp["out"][shape]:
        np.testing.assert_allclose(rank["logs"]["total_loss"], float(logs["total_loss"]),
                                   rtol=2e-5)
        for name, v in system.net.state_dict().items():
            if not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(rank["state"][name], v.numpy(), atol=5e-5, rtol=5e-4,
                                           err_msg=name)


@SLOW
@pytest.mark.parametrize("shape", MESHES)
def test_point_sharded_step_is_the_unsharded_step_in_float64(pp, shape):
    logs, grads, state = float64_train_step(_system(pp, pp["plain"]), pp["batch"], None)
    for rank in pp["out"][shape]:
        got_logs, got_grads, got_state = rank["float64"]
        for k, v in logs.items():
            assert abs(got_logs[k] - v) <= FLOAT64_WITNESS * abs(v), k
        _grads_within(got_grads, grads, FLOAT64_WITNESS)
        for name, v in state.items():
            if "running" in name:
                np.testing.assert_allclose(got_state[name], v, rtol=1e-12, atol=1e-12,
                                           err_msg=name)


@SLOW
@pytest.mark.parametrize("shape", MESHES)
def test_point_sharded_steps_leave_the_ranks_replicated(pp, shape):
    first, *others = pp["out"][shape]
    assert np.isfinite(first["logs"]["total_loss"])
    for other in others:
        assert other["logs"] == first["logs"]
        for name, v in first["state"].items():
            np.testing.assert_array_equal(other["state"][name], v, err_msg=name)


@SLOW
def test_point_sharded_step_matches_jax_with_its_triplets(pp):
    """The port's sharded step on hpcs_tpu's triplets and mask against
    make_point_sharded_train_step on mesh (1, 2) (module docstring)."""
    state, jstate = pp["state"], pp["jstate"]
    want = from_jax_params(to_numpy_tree(jstate.params), to_numpy_tree(jstate.batch_stats))
    apply_gradients = jax.jit(pp["jsys"].apply_gradients)
    jgrads = {n: g.numpy() for n, g in pp["jgrads"].items()}
    for rank in pp["out"][(1, 2)]:
        _grads_within(rank["given_grads"], jgrads, 0.1)
        update = from_jax_params(to_numpy_tree(apply_gradients(
            state, jax_params_tree(rank["given_grads"], state.params),
            jstate.batch_stats).params), to_numpy_tree(jstate.batch_stats))
        for k, v in pp["jlogs"].items():
            tol = dict(atol=0.02, rtol=0) if k in ("acc", "iou") else dict(atol=1e-5, rtol=1e-3)
            np.testing.assert_allclose(rank["given_logs"][k], float(v), err_msg=k, **tol)
        for name, w in want.items():
            if "running" in name:
                np.testing.assert_allclose(rank["given_state"][name], w.numpy(), atol=2e-4,
                                           rtol=1e-3, err_msg=name)
            elif not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(rank["given_state"][name], update[name].numpy(),
                                           atol=2e-4, rtol=1e-4, err_msg=name)


class _StubMesh:
    """A ("data", "points") mesh's shape and this rank's coordinate, without
    a process group: what make_point_sharded_* and shard_points_batch read
    before any collective."""

    mesh_dim_names = ("data", "points")
    device_type = "cpu"

    def __init__(self, shape, coordinate=(0, 0)):
        self.shape, self.coordinate = shape, coordinate

    def get_coordinate(self):
        return list(self.coordinate)

    def get_group(self, name):
        return None


ACCEPTED = [dict(model_name="dgcnn_partseg", eucl_dim=6),
            dict(model_name="pointnet_partseg", eucl_dim=6),
            dict(model_name="vn_pointnet_partseg", eucl_dim=6),
            dict(model_name="vn_pointnet_partseg", eucl_dim=6, pooling="max"),
            dict(pooling="max"), dict(bf16=True), dict(class_vector=True),
            dict(model_name="dgcnn_partseg", eucl_dim=6, class_vector=True)]


@pytest.mark.parametrize("over", ACCEPTED, ids=lambda o: "-".join(f"{v}" for v in o.values()))
def test_point_sharding_accepts_every_configuration(over):
    """Every backbone, max pooling, bf16 and class_vector: the sharded
    forward and step are made (on a (1, 1) mesh, before any collective);
    tests/test_torch_point_parallel_backbones.py runs them on the ranks."""
    system = HypHCSystem(ModelConfig(**{**KW, **over}), device="cpu")
    mesh = _StubMesh((1, 1))
    assert callable(make_point_sharded_forward(system, mesh))
    assert callable(make_point_sharded_train_step(system, mesh))


@pytest.mark.parametrize("shape,coordinate,size", [((1, 2), (0, 1), (4, 63)),
                                                   ((2, 1), (1, 0), (3, 64)),
                                                   ((2, 2), (1, 1), (6, 63))])
def test_a_batch_that_does_not_split_over_the_mesh_raises(shape, coordinate, size):
    batch = {"points": np.zeros((*size, 3), np.float32), "labels": np.zeros(size, np.int32),
             "category": np.zeros(size[0], np.int32)}
    with pytest.raises(ValueError, match="does not split"):
        shard_points_batch(_StubMesh(shape, coordinate), batch)
    B, N = size[0] - size[0] % shape[0], size[1] - size[1] % shape[1]
    part = shard_points_batch(_StubMesh(shape, coordinate),
                              {k: v[:B, :N] if v.ndim > 1 else v[:B] for k, v in batch.items()})
    assert part["points"].shape == (B // shape[0], N // shape[1], 3)
