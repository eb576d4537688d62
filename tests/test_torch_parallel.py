"""The port's data-parallel paths (hpcs_torch.parallel.data_parallel and
multihost) against hpcs_tpu.parallel on the CPU.

The port's ranks are gloo processes (hpcs_torch.parallel.multihost.
run_ranks, tests/_torch_parallel_ranks.py) at 2 intra-op threads each;
the JAX side runs on the virtual CPU devices of tests/conftest.py.  Both
start from the same weights (from_jax_params) with dropout 0 and
train_rotation 'none' on clouds rotated beforehand, so the only
randomness is the triplets: each of the port's ranks takes the triplets
and 'easy' mask that hpcs_tpu's shard i draws from fold_in(key, i)
(tests/_torch_port.jax_triplets, served by
hpcs_torch.testing.install_given_triplets).  Tolerances are the first
step's of tests/test_torch_train_step.py: logs atol 1e-5 / rtol 1e-3
(accuracy and IoU atol 0.02), the gradients the step applies within 10 %
of each leaf's largest entry of hpcs_tpu's pmean'd gradients, running
statistics atol 2e-4 / rtol 1e-3, and parameters atol 2e-4 / rtol 1e-4
of what hpcs_tpu's apply_gradients makes of the port's gradients.  The
parameters are held through the update and not to hpcs_tpu's new ones
directly: Riemannian Adam moves each entry of a [1, C] direction map
(conv6's, a ball of width 1) by ~lr whatever its gradient's size, so an
entry whose gradient is rounding noise in both packages moves by lr in
one and not in the other (conv6.map_to_dir 4.97e-3 apart at lr 5e-3 on
this batch, where its gradients agree within the 10 %).
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_ranks as ranks
from _torch_port import (jax_params_tree, jax_port_pair, jax_triplets, rotated_batch,
                         synthetic_batch, to_numpy_tree, torch_threads)
from hpcs_tpu.models.base import decode_vector_for_batch as j_decode_vector
from hpcs_torch import cli, infer, train, trainer
from hpcs_torch.data import DataLoader, SyntheticPartDataset
from hpcs_torch.models import ModelConfig
from hpcs_torch.models.base import decode_batch
from hpcs_torch.parallel import multihost
from hpcs_torch.testing import check_same_test_outputs, record_test_steps
from hpcs_torch.utils.jax_params import _params_sd, from_jax_params

CFG = dict(dropout=0.0, train_rotation="none", test_rotation="none", t_per_anchor=10,
           temperature=0.1, trade_off=0.1, lr=0.005)
TOL_LOGS = dict(atol=1e-5, rtol=1e-3)
TOL_METRICS = dict(atol=0.02, rtol=0)
TOL_PARAMS = dict(atol=2e-4, rtol=1e-4)
TOL_STATS = dict(atol=2e-4, rtol=1e-3)
GRAD_SHARE = 0.1
B, N, RANKS = 4, 64, 2


def _port_config(jcfg):
    from dataclasses import fields

    return ModelConfig(**{f.name: getattr(jcfg, f.name) for f in fields(ModelConfig)})


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """hpcs_tpu's data-parallel train and test steps on a 2-device mesh, and
    the port's 2-rank job from the same weights, batch and triplets."""
    with ranks.EarlyRanks(ranks.data_parallel_job, RANKS, tmp_path_factory.mktemp("dp"),
                          threads=2) as job:  # the ranks start while JAX compiles
        return _dp(job)


def _dp(job):
    jsys, state, _, batch = jax_port_pair(eucl=8, hyp=8, B=B, N=N, k=8, **CFG)
    batch = rotated_batch(batch)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key, temp = jax.random.PRNGKey(10), jnp.float32(0.1)
    apply_net = jax.jit(lambda st, pts, dv, k: jsys._apply(st.params, st.batch_stats, pts, dv,
                                                          True, k)[1])
    given, b = [], B // RANKS
    for i in range(RANKS):
        _, k_drop, k_loss = jax.random.split(jax.random.fold_in(key, i), 3)
        part = {k: v[i * b:(i + 1) * b] for k, v in jbatch.items()}
        x_p = apply_net(state, part["points"], j_decode_vector(jsys.cfg, part), k_drop)
        given.append(jax_triplets(k_loss, part["labels"], x_p, jsys.cfg))
    cfg = _port_config(jsys.cfg)
    sd = {k: v.numpy() for k, v in from_jax_params(to_numpy_tree(state.params),
                                                   to_numpy_tree(state.batch_stats)).items()}
    ragged = {k: v[:3] for k, v in synthetic_batch(B, N, seed=5).items()}
    rehearsal = (ModelConfig(num_class=6, num_categories=2, eucl_dim=4, hyp_dim=4, k=6,
                             t_per_anchor=5, temperature=0.1, dropout=0.0,
                             train_rotation="none"), synthetic_batch(2, 64, seed=4))
    job.give(cfg, sd, batch, given, ragged, cfg, rehearsal)
    new_state, jlogs, jgrads, jtest_logs, jtest = _jax_side(jsys, state, jbatch, key, temp)
    out = job.result()
    want = {k: v.numpy() for k, v in from_jax_params(
        to_numpy_tree(new_state.params), to_numpy_tree(new_state.batch_stats)).items()}
    apply_gradients = jax.jit(jsys.apply_gradients)
    updates = [{k: v.numpy() for k, v in from_jax_params(to_numpy_tree(apply_gradients(
        state, jax_params_tree(rank["grads"], state.params), new_state.batch_stats).params),
        to_numpy_tree(new_state.batch_stats)).items()} for rank in out]
    return dict(jsys=jsys, jlogs=jlogs, jgrads=jgrads, want=want, updates=updates,
                jtest_logs=jtest_logs, jtest=jtest, out=out, batch=batch, cfg=cfg, sd=sd)


def _jax_side(jsys, state, jbatch, key, temp):
    """hpcs_tpu's data-parallel train step on a 2-device mesh, its shards'
    mean gradients (its pmean'd ones) and its data-parallel test_step."""
    from hpcs_tpu.parallel import make_data_parallel_test_step as j_test_step
    from hpcs_tpu.parallel import make_data_parallel_train_step as j_train_step
    from hpcs_tpu.parallel import make_mesh as j_mesh
    from hpcs_tpu.parallel import shard_batch as j_shard

    mesh, b = j_mesh(RANKS), B // RANKS
    new_state, jlogs = j_train_step(jsys, mesh=mesh)(state, j_shard(mesh, jbatch), key, temp)
    grads_and_logs = jax.jit(jsys.grads_and_logs)
    shard_grads = [grads_and_logs(state, {k: v[i * b:(i + 1) * b] for k, v in jbatch.items()},
                                  jax.random.fold_in(key, i), temp)[0] for i in range(RANKS)]
    jgrads = _params_sd(to_numpy_tree(jax.tree_util.tree_map(lambda *g: sum(g) / RANKS,
                                                             *shard_grads)))
    jtest_logs, jtest = j_test_step(jsys, mesh=mesh)(state, j_shard(mesh, jbatch), key, temp)
    return new_state, jlogs, jgrads, jtest_logs, jtest


def _gradient_mismatches(grads, want):
    """The leaves of `grads` farther than GRAD_SHARE of the leaf's largest
    entry from hpcs_tpu's `want`."""
    return [name for name, g in grads.items()
            if np.abs(g - want[name].reshape(g.shape).numpy()).max()
            > GRAD_SHARE * np.abs(want[name].numpy()).max()]


def test_two_ranks_match_jax_data_parallel_step(dp):
    for rank, update in zip(dp["out"], dp["updates"]):
        assert set(rank["logs"]) == set(dp["jlogs"])
        for k, v in dp["jlogs"].items():
            tol = TOL_METRICS if k in ("acc", "iou") else TOL_LOGS
            np.testing.assert_allclose(rank["logs"][k], float(v), err_msg=k, **tol)
        assert _gradient_mismatches(rank["grads"], dp["jgrads"]) == []
        for name, w in dp["want"].items():
            if "running" in name:
                np.testing.assert_allclose(rank["state"][name], w, err_msg=name, **TOL_STATS)
            elif not name.endswith("num_batches_tracked"):
                np.testing.assert_allclose(rank["state"][name], update[name], err_msg=name,
                                           **TOL_PARAMS)


def test_a_step_without_the_gradient_all_reduce_fails_the_check(dp):
    """The negative control: each rank applies its own shard's gradients."""
    for rank in dp["out"]:
        assert _gradient_mismatches(rank["mutant_grads"], dp["jgrads"]), \
            "the check misses a missing all-reduce"


@pytest.mark.parametrize("when", ["state", "after_ragged_state", "final_state"])
def test_parameters_stay_replicated_bit_for_bit(dp, when):
    """After the step, after a ragged batch (3 objects on 2 ranks: every
    rank trains it whole from one broadcast seed) and after one more."""
    first, *others = (rank[when] for rank in dp["out"])
    for other in others:
        for name, v in first.items():
            np.testing.assert_array_equal(other[name], v, err_msg=name)
    assert all(rank["warned"] for rank in dp["out"])
    assert np.isfinite(dp["out"][0]["ragged_logs"]["total_loss"])


def test_sharded_test_step_is_each_shards_test_step(dp):
    """The port's sharded test_step: the extras of every shard's own
    test_step concatenated exactly, the logs their mean."""
    got, shards = dp["out"][0], dp["out"][0]["test_shards"]
    for name, v in got["test_extras"].items():
        np.testing.assert_array_equal(v, np.concatenate([s[1][name] for s in shards]), name)
    for k, v in got["test_logs"].items():
        np.testing.assert_allclose(v, np.mean([s[0][k] for s in shards]), rtol=1e-6, err_msg=k)
    assert all(r["test_logs"] == got["test_logs"] for r in dp["out"])


def test_sharded_test_step_matches_jax(dp):
    """Against make_data_parallel_test_step: x_poincare within atol 1e-6,
    and the port's decode of hpcs_tpu's embeddings gives its per-object
    prediction, best k and best score exactly and its linkage's merges and
    sizes exactly, heights within 2e-9 (test_torch_test_step.py: inside
    hpcs_tpu's one XLA program the distances are not those its returned
    x_poincare gives)."""
    got, jtest = dp["out"][0]["test_extras"], dp["jtest"]
    np.testing.assert_allclose(got["x_poincare"], np.asarray(jtest["x_poincare"]), rtol=0,
                               atol=1e-6)
    x_p = np.array(jtest["x_poincare"])
    scale = torch.tensor(float(dp["sd"]["scale"][0]))
    pred, best_k, best_score, Z = decode_batch(torch.from_numpy(x_p),
                                               torch.from_numpy(dp["batch"]["labels"]), scale,
                                               dp["cfg"].num_class)
    for g, name in ((pred, "pred"), (best_k, "best_k"), (best_score, "best_score")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(jtest[name]), err_msg=name)
    jZ = np.asarray(jtest["linkage"])
    np.testing.assert_array_equal(Z.numpy()[..., [0, 1, 3]], jZ[..., [0, 1, 3]])
    np.testing.assert_allclose(Z.numpy()[..., 2], jZ[..., 2], rtol=0, atol=2e-9)


def test_world_size_one_is_the_single_device_step_bit_for_bit(dp):
    """The data-parallel step on a one-rank mesh (a group of one rank of the
    job) against the single-device train_step."""
    for rank in dp["out"]:
        single, data_parallel = rank["world_size_one"]
        assert data_parallel[0] == single[0]
        for name, v in single[1].items():
            np.testing.assert_array_equal(data_parallel[1][name], v, err_msg=name)


def test_card_vs_cpu_check_of_the_two_rank_step_rehearsed_on_the_cpu(dp):
    """chip_smoke's parallel phase holds the card's 2-rank step against the
    CPU port's 2-rank step (check_train_step_card_vs_cpu with the group);
    here a CPU system stands in for the card, so every error is the
    backward's order of scatter-adds, and the ranks end replicated."""
    for rank in dp["out"]:  # the check raises on a failure; it returns its largest errors
        assert rank["card_vs_cpu"]["max_rel_err_logs"] < 1e-5
    first, other = (rank["card_vs_cpu_state"] for rank in dp["out"])
    for name, v in first.items():
        np.testing.assert_array_equal(other[name], v, err_msg=name)


def test_collectives_values_and_gradients(dp):
    """all_gather, all_reduce_sum and all_max with their gradients,
    mean_all_reduce_, broadcast_ and gather_slots over 2 gloo ranks on CPU
    tensors (tests/test_torch_cuda.py runs the same on the card)."""
    for rank in dp["out"]:
        assert all(rank["collectives"].values()), rank["collectives"]


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_process_indices_are_jax_packages(P, monkeypatch):
    from hpcs_tpu.parallel import multihost as jmultihost

    monkeypatch.setattr(jax, "process_count", lambda: P)
    for r in range(P):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        for n in range(1, 14):
            want_idx, want_valid = jmultihost.process_indices_with_mask(n)
            got_idx, got_valid = multihost.process_indices_with_mask(n, P, r)
            np.testing.assert_array_equal(got_idx, want_idx)
            np.testing.assert_array_equal(got_valid, want_valid)
            np.testing.assert_array_equal(multihost.process_indices(n, P, r),
                                          jmultihost.process_indices(n))


def test_multihost_dryrun_prints_its_line(tmp_path, monkeypatch, capsys):
    """python -m hpcs_torch.multihost_dryrun (its main, in this process): 2
    "hosts" x 2 local gloo ranks, each reading its own objects, two steps;
    one JSON line, and no file written."""
    from hpcs_torch import multihost_dryrun

    monkeypatch.chdir(tmp_path)
    multihost_dryrun.main()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ok"] and line["mesh"] == {"dcn": 2, "data": 2} and line["replicated"]
    assert line["objects_per_rank"] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11],
                                        [12, 13, 14, 15]]
    assert list(tmp_path.iterdir()) == []


def test_run_ranks_ends_a_run_at_its_deadline_and_none_sets_none():
    """A deadline ends ranks that outlast it; timeout None lets a run take
    as long as its work (train's --data_parallel passes None)."""
    with pytest.raises(RuntimeError, match="ranks timed out after 1 s"):
        multihost.run_ranks(time.sleep, 1, args=(60,), timeout=1)
    start = time.time()
    assert multihost.run_ranks(time.sleep, 1, args=(1.5,), timeout=None) == [None]
    assert time.time() - start > 1.5


ENTRY = ("--dataset synthetic --fixed_points 64 --k 8 --eucl_embedding 4 --hyp_embedding 4 "
         "--t_per_anchor 5 --batch 4 --epochs 1 --accelerator cpu --log logs").split()
RUN = os.path.join("logs", "synthetic_vn_dgcnn_partseg")


def test_train_data_parallel_2_writes_a_checkpoint_infer_serves(tmp_path, monkeypatch):
    """python -m hpcs_torch.train --data_parallel 2 --accelerator cpu: one
    epoch on 2 gloo ranks, rank 0's logs and checkpoints; the returned
    system is final/, and single-device infer serves final/ as
    trainer.test serves it in memory."""
    monkeypatch.chdir(tmp_path)
    with torch_threads(4):
        system, results = train.main(ENTRY + ["--data_parallel", "2"])
        with open(os.path.join(RUN, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        assert [r.get("epoch") for r in records] == [0, None] and records[0]["step"] == 16
        assert set(results) == {"test_loss", "score", "test_acc", "test_iou"}
        final = os.path.join(RUN, "checkpoints", "final")
        with record_test_steps() as served:
            infer.main(["synthetic", "--model_path", final, "--fixed_points", "64", "--batch",
                        "4", "--test_batches", "2", "--accelerator", "cpu"])
        loader = DataLoader(SyntheticPartDataset(num_objects=32, npoints=64, seed=3), 4,
                            shuffle=True, seed=0)
        with record_test_steps() as in_memory:
            trainer.test(system, loader, seed=0, limit_batches=2)
    check_same_test_outputs(served, in_memory)
    assert system.step == 16


def test_train_data_parallel_sets_no_deadline(tmp_path, monkeypatch):
    """A training run takes as long as its epochs: train starts its ranks
    with no deadline (a run_ranks deadline would kill it midway)."""
    class Started(Exception):
        pass

    def run_ranks(fn, world, **kw):
        raise Started(world, kw)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(multihost, "run_ranks", run_ranks)
    with pytest.raises(Started) as started:
        train.main(ENTRY + ["--data_parallel", "2"])
    world, kw = started.value.args
    assert world == 2 and kw["timeout"] is None and kw["backend"] == "gloo"


def test_train_data_parallel_indivisible_batch_trains_on_one_device(tmp_path, monkeypatch,
                                                                    capsys):
    monkeypatch.chdir(tmp_path)
    with torch_threads(2):
        system, _ = train.main(ENTRY + ["--data_parallel", "3"])
    out = capsys.readouterr().out
    assert "warning: --data_parallel 3 ignored — batch 4 is not divisible by 3" in out
    assert "data-parallel over" not in out and system.step == 16


def test_data_parallel_beyond_the_visible_gpus_raises(monkeypatch):
    """hpcs_tpu builds a smaller mesh; the port names both counts."""
    args = cli.add_train_args(__import__("argparse").ArgumentParser()).parse_args(
        ["--data_parallel", "4", "--batch", "8"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="--data_parallel 4: 2 GPUs are visible"):
        cli.data_parallel_size(args)
    args.data_parallel = 0
    assert cli.data_parallel_size(args) == 2
