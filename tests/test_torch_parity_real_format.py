"""tools/parity_real_format_torch.py, the port's counterpart of
tools/parity_real_format.py's jax and report stages, on the CPU.

- Its evaluation (`evaluate`), on a state carried from hpcs_tpu after 150
  hpcs_tpu training steps on the mini ShapeNet-Part tree (test_rotation
  'none', N = 64), gives the numbers of run_jax's evaluation loop (its
  lines redone here with hpcs_tpu on the same state and test batches,
  purity by hpcs_tpu's purity_host): test loss, accuracy, IoU, raw-cosine
  accuracy, mean decode score and purity within the eval forward's
  tolerance, atol 2e-4 / rtol 1e-3, the test loss on hpcs_tpu's own
  triplets (InjectedTriplets);
- its purity_score is hpcs_tpu's purity_host;
- the whole torch stage runs at --epochs 1 --device cpu for both datasets
  into tmp_path with finite results and a checkpoint the port restores,
  and report sets them beside hpcs_tpu's recorded 8 seeds;
- without --device the stage runs on the card, so here it raises.
"""
import contextlib
import io
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.serialization import to_state_dict

from _torch_notebooks import NPOINTS, write_tree
from _torch_port import InjectedTriplets, jax_trained_on_mini, torch_threads
from hpcs_tpu.decode.host import purity_host
from hpcs_tpu.loss.cosface import cosface_logits as j_cosface_logits
from hpcs_torch.cli import freeze_hierarchy
from hpcs_torch.data import DataLoader
from hpcs_torch.models import HypHCSystem, ModelConfig
from hpcs_torch.utils.checkpoint import load_config, load_jax_state, restore_checkpoint

import parity_real_format_torch as prf  # noqa: E402  (tools/, on the path)

TOL = dict(atol=2e-4, rtol=1e-3)
SEED = 0


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("parity"))


def _jax_evaluation(jsys, state, batches, seed):
    """run_jax's evaluation loop (tools/parity_real_format.py:364-385) on
    hpcs_tpu, its purity by purity_host; also each batch's loss key,
    labels and embeddings, for the port's injected triplets."""
    from scipy.cluster.hierarchy import fcluster

    key = jax.random.PRNGKey(seed + 777)
    scores, purities, tlosses, accs, accs_nm, ious, draws = [], [], [], [], [], [], []
    for bi, batch in enumerate(batches):
        key = jax.random.fold_in(key, bi)
        logs, extras = jsys.test_step(state, batch, key, jnp.float32(jsys.cfg.temperature))
        draws.append((jax.random.split(key)[1], batch["labels"], extras["x_poincare"]))
        tlosses.append(float(logs["test_loss"]))
        accs.append(float(logs["test_acc"]))
        ious.append(float(logs["test_iou"]))
        flat = extras["x_poincare"].reshape(-1, extras["x_poincare"].shape[-1])
        labels_flat = jnp.asarray(batch["labels"]).reshape(-1)
        raw = j_cosface_logits(state.params["cosface_W"], flat, labels_flat, margin=0.0,
                               scale=1.0)
        accs_nm.append(float(jnp.mean((jnp.argmax(raw, -1) == labels_flat).astype(jnp.float32))))
        Zs = np.asarray(extras["linkage"])
        bscores = np.asarray(extras["best_score"])
        for oi in range(Zs.shape[0]):
            scores.append(float(bscores[oi]))
            y = np.asarray(batch["labels"][oi])
            y_pred = fcluster(Zs[oi], len(np.unique(y)), criterion="maxclust") - 1
            purities.append(purity_host(y, y_pred))
    result = {"test_loss": float(np.mean(tlosses)), "test_acc": float(np.mean(accs)),
              "test_iou": float(np.mean(ious)), "test_acc_nomargin": float(np.mean(accs_nm)),
              "decode_score_mean": float(np.mean(scores)),
              "decode_purity_mean": float(np.mean(purities)), "n_test_objects": len(scores)}
    return result, draws


def test_evaluation_matches_run_jaxs_loop(tree, monkeypatch):
    jsys, state, cfg, sets = jax_trained_on_mini("shapenet", str(tree / "data"), NPOINTS, 150,
                                                 test_rotation="none")
    loader = DataLoader(sets[2], prf.CFGS["shapenet"]["batch_size"])
    want, draws = _jax_evaluation(jsys, state, [{k: jnp.asarray(v) for k, v in b.items()}
                                                for b in loader], SEED)

    system = HypHCSystem(cfg, device="cpu")
    load_jax_state(system, jax.tree_util.tree_map(np.asarray, to_state_dict(state)))
    injected, test_step, queue = InjectedTriplets(monkeypatch), system.test_step, list(draws)

    def on_jax_triplets(batch, generator):
        injected.add(*queue.pop(0), jsys.cfg)
        return test_step(batch, generator)

    monkeypatch.setattr(system, "test_step", on_jax_triplets)
    got = prf.evaluate(system, loader, SEED)
    assert not queue and got["n_test_objects"] == want["n_test_objects"] == 4
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, **TOL, err_msg=key)


def test_purity_score_is_hpcs_tpus():
    rng = np.random.default_rng(0)
    for _ in range(20):
        y = rng.integers(0, 50, 300)
        pred = rng.integers(0, 7, 300)
        assert prf.purity_score(y, pred) == purity_host(y, pred)


def _checkpoint_config(ckpt):
    d = load_config(ckpt)
    return ModelConfig(**{**d, "hierarchy_list": freeze_hierarchy(d["hierarchy_list"])})


@pytest.mark.parametrize("dataset", ["shapenet", "partnet"])
def test_the_torch_stage_runs_whole_on_the_cpu(tree, tmp_path, dataset):
    out = str(tmp_path / "out")
    with contextlib.redirect_stdout(io.StringIO()):
        got = prf.main(["torch", "--dataset", dataset, "--epochs", "1", "--device", "cpu",
                        "--seed", "3", "--out", out, "--data", str(tree / "data")])
    with open(prf.json_path(out, dataset, 3)) as f:
        assert json.load(f) == got
    assert got["n_test_objects"] == (4 if dataset == "shapenet" else 2)
    assert got["device"] == "cpu" and got["epochs"] == 1
    for key in prf.RESULT_KEYS + ("test_loss",):
        assert math.isfinite(got[key]), key
    assert 0.0 <= got["decode_score_mean"] <= 1.0 and 0.0 < got["decode_purity_mean"] <= 1.0
    system = HypHCSystem(_checkpoint_config(got["checkpoint"]), device="cpu")
    assert restore_checkpoint(got["checkpoint"], system)[0] == 1
    assert system.cfg.use_hierarchical == (dataset == "partnet")

    with contextlib.redirect_stdout(io.StringIO()):
        summary = prf.main(["report", "--dataset", dataset, "--seeds", "3", "--out", out])
    with open(prf.TPU_RESULTS[dataset]) as f:
        tpu = json.load(f)["hpcs_tpu"]
    for key in ("purity", "score"):
        assert set(summary[key]) == {"delta_port_minus_hpcs_tpu", "combined_stderr", "z",
                                     "verdict"}
    assert summary["hpcs_tpu"]["decode_purity_mean"] == tpu["decode_purity_mean"]
    assert summary["hpcs_torch"]["decode_score_mean"]["per_seed"] == [got["decode_score_mean"]]
    assert os.path.exists(prf.report_path(out, dataset))


def test_the_default_device_is_the_card(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        prf.main(["torch", "--epochs", "1", "--out", str(tmp_path), "--data",
                  str(tree / "data")])
