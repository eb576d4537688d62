"""tools/parity_experiment_torch.py, the quality-parity experiment on the
port, against tools/parity_experiment.py and hpcs_tpu on the CPU:

- its recipe is parity_experiment.CFG, and its data stage's arrays equal
  those of hpcs_tpu's SyntheticPartDataset at CFG's seed, sliced as
  make_data slices them (in process: no stored file is read);
- its ModelConfig equals, field by field, the one run_jax builds;
- its decode, run on the embeddings hpcs_tpu's test_step makes (a tiny
  system, N = 64), gives test_step's best k, its best score within 1e-6
  and the purity of its linkage's cut, object by object;
- report, on per-seed JSONs written to tmp_path, gives the deltas, z
  values and parity_experiment.report()'s booleans computed here by hand;
- a 1-epoch torch stage on the CPU writes every key of run_jax's result;
- the tool imports no JAX and nothing of hpcs_tpu (a subprocess with both
  unimportable).
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.cluster.hierarchy import fcluster

from _torch_port import jax_port_pair, torch_threads
from hpcs_tpu.data import SyntheticPartDataset as JDataset
from hpcs_tpu.models import ModelConfig as JConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import parity_experiment as pe  # noqa: E402
import parity_experiment_torch as pet  # noqa: E402
from parity_real_format_torch import purity_score  # noqa: E402

# run_jax's result (tools/parity_experiment.py:286-296)
RUN_JAX_KEYS = {"train_loss_curve", "val_loss_curve", "train_wall_s", "test_loss", "test_acc",
                "test_iou", "decode_score_mean", "decode_purity_mean", "n_test_objects"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def test_the_recipe_and_data_are_parity_experiments():
    assert pet.CFG == pe.CFG
    c = pe.CFG
    total = c["n_train"] + c["n_val"] + c["n_test"]
    ds = JDataset(num_objects=total, npoints=c["npoints"], num_categories=c["num_categories"],
                  parts_per_object=c["parts_per_object"], seed=c["seed"])
    pts = np.stack([ds[i][0] for i in range(total)])
    cat = np.array([ds[i][1] for i in range(total)])
    seg = np.stack([ds[i][2] for i in range(total)])
    cuts = {"train": slice(0, c["n_train"]),
            "val": slice(c["n_train"], c["n_train"] + c["n_val"]),
            "test": slice(c["n_train"] + c["n_val"], total)}
    got = pet.make_data()
    assert set(got) == {f"{s}_{k}" for s in cuts for k in ("points", "cat", "seg")}
    for split, cut in cuts.items():
        for key, want in (("points", pts[cut]), ("cat", cat[cut]), ("seg", seg[cut])):
            g = got[f"{split}_{key}"]
            assert g.dtype == want.dtype and np.array_equal(g, want), (split, key)


def test_the_model_config_is_run_jaxs():
    c = pe.CFG
    want = JConfig(  # run_jax's (tools/parity_experiment.py:257-266)
        dataset="shapenet", model_name="vn_dgcnn_partseg",
        num_class=c["num_class"], num_categories=c["num_categories"],
        fixed_points=c["npoints"], eucl_dim=c["eucl_dim"],
        hyp_dim=c["hyp_dim"], k=c["k"], t_per_anchor=c["t_per_anchor"],
        fraction=c["fraction"], num_triplets=c["npoints"] * c["batch_size"] * c["t_per_anchor"],
        temperature=c["temperature"], lr=c["lr"], margin=c["margin"],
        trade_off=c["trade_off"], miner=True, cosface=True,
        train_rotation=c["train_rotation"], test_rotation=c["test_rotation"],
    )
    got = dataclasses.asdict(pet.make_config())
    assert got.keys() == dataclasses.asdict(want).keys()
    for field, value in dataclasses.asdict(want).items():
        assert got[field] == value, field


def test_the_decode_gives_hpcs_tpus_test_step_results_object_by_object():
    jsys, state, _, batch = jax_port_pair(eucl=8, hyp=8, B=4, N=64, k=10, seed=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, extras = jsys.test_step(state, jbatch, jax.random.PRNGKey(5), jnp.float32(0.1))
    x_p, labels = np.asarray(extras["x_poincare"]), np.asarray(batch["labels"])
    scale = float(np.asarray(state.params["scale"])[0])
    rows = pet.decode_objects(x_p, labels, scale, device="cpu")
    Zs = np.asarray(extras["linkage"], np.float64)
    assert len(rows) == 4
    for i, row in enumerate(rows):
        assert row["best_k"] == int(extras["best_k"][i]), i
        assert abs(row["score"] - float(extras["best_score"][i])) <= 1e-6, i
        want = purity_score(labels[i], fcluster(Zs[i], len(np.unique(labels[i])),
                                                criterion="maxclust") - 1)
        assert row["purity"] == want, i


def _run(purity, score, acc, iou, loss):
    return {"decode_purity_mean": purity, "decode_score_mean": score, "test_acc": acc,
            "test_iou": iou, "test_loss": loss, "train_loss_curve": [], "val_loss_curve": []}


def test_report_gives_the_deltas_z_and_verdicts_by_hand(tmp_path):
    bench, out = tmp_path / "bench", tmp_path / "out"
    bench.mkdir()
    out.mkdir()
    rng = np.random.default_rng(0)
    sides = {side: [_run(*rng.uniform(0.3, 0.9, 4), rng.uniform(1, 2)) for _ in range(5)]
             for side in ("jax", "ref")}
    port = [_run(*rng.uniform(0.3, 0.9, 4), rng.uniform(1, 2)) for _ in range(3)]
    for side, runs in sides.items():
        for s, r in enumerate(runs):
            (bench / f"_parity_{side}{'' if s == 0 else f'_s{s}'}.json").write_text(json.dumps(r))
    for s, r in enumerate(port):
        with open(pet.json_path(str(out), s), "w") as f:
            json.dump(r, f)
    with open(out / "decode_torch.json", "w") as f:
        json.dump({"max_abs_purity_delta": 0.0}, f)
    with contextlib.redirect_stdout(io.StringIO()):
        got = pet.report(range(3), str(out), bench=str(bench))
    assert got["seeds"] == {"hpcs_torch": [0, 1, 2], "hpcs_tpu": [0, 1, 2, 3, 4],
                            "reference": [0, 1, 2, 3, 4]}

    def mean_se(values):
        m, sd = sum(values) / len(values), math.sqrt(
            sum((v - sum(values) / len(values)) ** 2 for v in values) / (len(values) - 1))
        return m, sd / math.sqrt(len(values))

    for key in pet.RESULT_KEYS:
        p = mean_se([r[key] for r in port])
        for side, name in (("ref", "vs_reference"), ("jax", "vs_hpcs_tpu")):
            o = mean_se([r[key] for r in sides[side]])
            se = math.sqrt(p[1] ** 2 + o[1] ** 2)
            cmp = got["summary"][key][name]
            assert math.isclose(cmp["delta"], p[0] - o[0], rel_tol=1e-12)
            assert math.isclose(cmp["z"], (p[0] - o[0]) / se, rel_tol=1e-12)
    for side, name in (("ref", "vs_reference"), ("jax", "vs_hpcs_tpu")):
        a = [r["decode_purity_mean"] for r in port]
        b = [r["decode_purity_mean"] for r in sides[side]]

        def pop_sd(v):
            return math.sqrt(sum((x - sum(v) / len(v)) ** 2 for x in v) / len(v))

        delta = 100 * abs(sum(b) / 5 - sum(a) / 3)
        noise = 100 * math.hypot(pop_sd(b), pop_sd(a))
        v = got[name]
        assert math.isclose(v["purity_delta_pct_points"], delta, rel_tol=1e-12)
        assert math.isclose(v["purity_run_noise_pct_points"], noise, rel_tol=1e-12)
        assert v["north_star_decode_parity_exact"] is True
        assert v["north_star_purity_delta_le_0.5pct"] == (delta <= 0.5 or sum(a) / 3 >= sum(b) / 5)
        assert v["purity_delta_within_run_noise"] == (delta <= 2 * noise)
    assert (out / "parity_vs_reference_torch.json").exists()


def test_a_one_epoch_torch_stage_writes_run_jaxs_keys(tmp_path):
    out = str(tmp_path / "out")
    with contextlib.redirect_stdout(io.StringIO()):
        got = pet.main(["torch", "--epochs", "1", "--device", "cpu", "--draws", "cpu", "--seed", "1",
                        "--out", out])
    with open(pet.json_path(out, 1)) as f:
        assert json.load(f) == got
    assert RUN_JAX_KEYS <= set(got)
    assert got["n_test_objects"] == pe.CFG["n_test"] and got["device"] == got["draws"] == "cpu"
    assert len(got["train_loss_curve"]) == len(got["val_loss_curve"]) == 1
    for key in RUN_JAX_KEYS - {"train_loss_curve", "val_loss_curve", "n_test_objects"}:
        assert math.isfinite(got[key]), key
    assert 0 <= got["decode_score_mean"] <= 1 and 0 < got["decode_purity_mean"] <= 1
    assert os.path.exists(os.path.join(out, "parity_torch_s1", "metrics.csv"))


def test_the_tool_imports_no_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['hpcs_tpu'] = None\n"
            "sys.modules['flax'] = None\n"
            "sys.path.insert(0, 'tools')\n"
            "import parity_experiment_torch as t, make_hdf5_fixtures_torch as f\n"
            "t.make_config(); t.make_data(); f.partnet_arrays(); f.dense_arrays()\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'hpcs_tpu', 'flax', 'h5py'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=300)
