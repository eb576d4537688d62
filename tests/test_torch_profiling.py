"""The port's tracing, step timing and NaN debugging (hpcs_torch.utils.
profiling, and train's --profile / --debug_nans) against hpcs_tpu's on the
CPU.

StepTimer gives hpcs_tpu's summary on the same sequence of steps;
check_finite raises the same exception with the same message on the same
tree, as numpy and as tensors.  A trace on the CPU writes one Chrome trace
holding a span for every module of a small VN-DGCNN, for the system's steps
and for the kernels' plain twins (`knn`, `edgeconv`), and leaves no span
open.  NaN debugging: a 2-step `train.main --debug_nans` runs clean where
hpcs_tpu's fit with jax_debug_nans runs clean on the same batches; a NaN
planted in the input points or in a conv weight raises FloatingPointError
in both packages; and afterwards anomaly mode, the dispatch mode and
jax_debug_nans are off.
"""
import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from _torch_port import jax_port_pair, torch_threads
from hpcs_tpu import cli as jcli
from hpcs_tpu.trainer import fit as jfit
from hpcs_tpu.utils.profiling import StepTimer as JStepTimer
from hpcs_tpu.utils.profiling import check_finite as jcheck_finite
from hpcs_torch import train
from hpcs_torch.nn.backbones.vn_dgcnn import VNDGCNNPartSeg
from hpcs_torch.testing import write_mini_shapenet
from hpcs_torch.utils import profiling

N, BATCH = 64, 4
FLAGS = (f"--dataset shapenet --fixed_points {N} --k 4 --eucl_embedding 8 --hyp_embedding 8 "
         f"--margin 0.35 --t_per_anchor 10 --temperature 0.1 --trade_off 0.1 --batch {BATCH} "
         "--epochs 1 --log logs").split()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A working directory with a ShapeNet-Part tree of 2 categories, 4 / 2
    / 2 objects each: 2 training batches of 4, 1 validation and 1 test."""
    cwd = tmp_path_factory.mktemp("cwd")
    write_mini_shapenet(str(cwd / "data" / "ShapeNet" / "raw"), ("Airplane", "Chair"), (4, 2, 2),
                        seed=5, points=300)
    return cwd


def _all_off():
    return dict(anomaly=torch.is_anomaly_enabled(),
                dispatch_mode=_get_current_dispatch_mode() is not None,
                nan_debugging=profiling.nan_debugging_enabled(),
                jax_debug_nans=bool(jax.config.jax_debug_nans), open_spans=profiling.open_spans())


def _assert_all_off():
    assert not any(_all_off().values()), _all_off()


@pytest.mark.parametrize("warmup,steps", [(1, 4), (0, 3), (2, 2), (3, 7)])
def test_step_timer_matches_jax(warmup, steps):
    port, ref = profiling.StepTimer(warmup), JStepTimer(warmup)
    for _ in range(steps):
        with port.step(torch.ones(8) * 2):
            pass
        with ref.step(jnp.ones((8,)) * 2):
            pass
    got, want = port.summary(), ref.summary()
    assert set(got) == set(want)
    assert got.get("steps_timed") == want.get("steps_timed") == (max(steps - warmup, 0) or None)
    assert all(v > 0 for k, v in got.items() if k != "steps_timed")
    assert profiling.barrier({"a": [torch.ones(2)]})["a"][0].sum() == 2


def _trees():
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    return {
        "clean": {"a": np.ones(3, np.float32), "b": {"c": np.zeros(2, np.float32)},
                  "n": np.arange(3)},
        "nested_nan": {"a": np.ones(3, np.float32), "b": {"c": np.array([1.0, nan], np.float32)}},
        "list_inf": {"w": [np.ones(2, np.float32), np.array([inf, -inf, nan], np.float32)]},
        "sorted_keys": {"z": np.array([nan], np.float32), "b": {"y": np.array([inf], np.float32)}},
        "state_dict": {"conv6.map_to_feat.weight": np.array([[0.5, nan]], np.float32),
                       "conv6.batchnorm.bn.num_batches_tracked": np.array(3)},
    }


@pytest.mark.parametrize("case", list(_trees()))
@pytest.mark.parametrize("as_tensors", [False, True], ids=["numpy", "tensors"])
def test_check_finite_matches_jax(case, as_tensors):
    tree = _trees()[case]
    port_tree = jax.tree_util.tree_map(torch.from_numpy, tree) if as_tensors else tree
    ref_tree = jax.tree_util.tree_map(jnp.asarray, tree)

    def outcome(fn, t):
        try:
            fn(t, name="params")
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            return type(e), str(e)
        return None

    got, want = outcome(profiling.check_finite, port_tree), outcome(jcheck_finite, ref_tree)
    assert got == want
    assert (got is None) == (case == "clean")


def _small_system():
    from hpcs_torch.models import HypHCSystem, ModelConfig

    return HypHCSystem(ModelConfig(num_class=6, num_categories=2, eucl_dim=8, hyp_dim=8, k=4,
                                   t_per_anchor=4), device="cpu")


def _batch(B=2, n=N):
    from _torch_port import synthetic_batch

    return synthetic_batch(B, n)


def test_trace_writes_spans_of_every_module_and_kernel_twin(tmp_path):
    system, batch = _small_system(), _batch()
    gen = torch.Generator().manual_seed(0)
    with profiling.trace(str(tmp_path / "trace")):
        system.train_step(batch, gen)
        system.eval_step(batch, gen)
        system.test_step(batch, gen)
        assert profiling.open_spans() == []
    _assert_all_off()
    files = profiling.trace_files(str(tmp_path / "trace"))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in spans}
    modules = {f"nn_feat.{m}" for m, _ in VNDGCNNPartSeg(8, 4, 2).named_children()}
    assert modules | {"HypHCNet", "nn_emb", "knn", "edgeconv", "train_step", "eval_step",
                      "test_step", "embed", "decode", "optimizer.step",
                      "nn_feat.conv1.batchnorm.bn", "nn_feat.conv8.1"} <= names
    assert all(e.get("ph") == "X" and e.get("dur", -1) >= 0 for e in spans)
    # every span closed inside its parent: a train step holds its modules
    step = next(e for e in spans if e["name"] == "train_step")
    inner = [e for e in spans if e["name"] == "nn_feat.conv6"]
    assert any(step["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"]
               for e in inner)


def test_spans_close_when_a_module_raises(tmp_path):
    system = _small_system()
    with profiling.trace(str(tmp_path)):
        with pytest.raises(RuntimeError):
            # a conditioning vector of the wrong width: conv7 raises
            system.embed(_batch()["points"], np.ones((2, 5), np.float32))
        assert profiling.open_spans() == []
    assert profiling.span("x").__class__.__name__ == "nullcontext"


def _jax_configure(argv):
    parser = jcli.add_train_args(argparse.ArgumentParser())
    return jcli.configure(parser.parse_args(argv))


def test_train_debug_nans_runs_clean_where_jax_does(tree, monkeypatch):
    monkeypatch.chdir(tree)
    system, results = train.main(FLAGS + ["--debug_nans", "--accelerator", "cpu"])
    _assert_all_off()
    assert system.step == 2 and np.isfinite(results["test_loss"])
    jsystem, jtrain, jvalid, _ = _jax_configure(FLAGS)
    jax.config.update("jax_debug_nans", True)
    try:
        state, _ = jfit(jsystem, jtrain, jvalid, epochs=1, log_dir=str(tree / "jlogs"))
    finally:
        jax.config.update("jax_debug_nans", False)
    assert int(state.step) == 2
    _assert_all_off()


@pytest.mark.parametrize("where", ["points", "conv_weight"])
def test_planted_nan_raises_in_both_packages(where):
    jsys, state, tsys, batch = jax_port_pair(B=2, N=N, k=4)
    if where == "points":
        batch = {**batch, "points": batch["points"].copy()}
        batch["points"][1, 7, 2] = np.nan
    else:
        params = jax.tree_util.tree_map(np.array, state.params)
        params["backbone"]["conv6"]["linear"]["kernel"][0, 0] = np.nan
        state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, params))
        with torch.no_grad():
            tsys.net.nn_feat.conv6.map_to_feat.weight[0, 0] = float("nan")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            jsys.train_step(state, jbatch, jax.random.PRNGKey(0), jnp.float32(0.1))
    finally:
        jax.config.update("jax_debug_nans", False)
    with pytest.raises(FloatingPointError) as e:
        with profiling.nan_debugging():
            tsys.train_step(batch, torch.Generator().manual_seed(0))
    assert "invalid value (nan)" in str(e.value)
    if where == "conv_weight":
        assert "nn_feat.conv6" in str(e.value)
    _assert_all_off()


def test_nan_errors_name_the_kernel_twin_and_the_backward():
    system, batch = _small_system(), _batch()
    with torch.no_grad():
        system.net.nn_feat.conv3.map_to_feat.weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="edgeconv"):
        with profiling.nan_debugging():
            system.embed(batch["points"], np.eye(2, dtype=np.float32)[batch["category"]])
    _assert_all_off()
    # a NaN made in the backward only: d sqrt(x) / dx at 0 times 0
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="backward"):
        with profiling.nan_debugging():
            (torch.sqrt(x) * 0).sum().backward()
    _assert_all_off()
    profiling.enable_nan_debugging()
    profiling.disable_nan_debugging()
    _assert_all_off()


def test_train_profile_debug_nans_and_plots_run_to_the_end(tree, monkeypatch):
    monkeypatch.chdir(tree)
    pytest.importorskip("matplotlib")
    system, results = train.main(FLAGS + ["--profile", "trace_dir", "--debug_nans",
                                          "--plot_inference", "--accelerator", "cpu"])
    _assert_all_off()
    assert len(profiling.trace_files("trace_dir")) == 1
    plots = sorted(os.listdir(os.path.join("logs", "shapenet_vn_dgcnn_partseg", "plots")))
    assert plots == [f"{i}.png" for i in range(BATCH)]
