"""The port's entry points end to end on the CPU: `hpcs_torch.train.main`
trains 2 epochs on a ShapeNet-Part tree in a temporary working directory,
then `hpcs_torch.infer.main` serves its final checkpoint.  Infer must give
what `trainer.test` gives on the trained system in memory, and the
restored system's embeddings must match hpcs_tpu's flax graph on the same
weights."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcs_tpu.models import HypHCSystem as JSystem
from hpcs_tpu.models import ModelConfig as JConfig
from hpcs_tpu.utils.torch_import import convert_lightning_checkpoint
from _torch_port import torch_threads
from hpcs_torch import infer, train, trainer
from hpcs_torch.data import DataLoader, ShapeNetDataset
from hpcs_torch.models import decode_vector_for_batch
from hpcs_torch.testing import check_same_test_outputs, record_test_steps, write_mini_shapenet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-4, rtol=1e-3)  # as tests/test_torch_forward.py
N, BATCH = 64, 4
TRAIN = (f"--dataset shapenet --fixed_points {N} --k 8 --eucl_embedding 8 --hyp_embedding 8 "
         f"--margin 0.35 --t_per_anchor 10 --temperature 0.1 --trade_off 0.1 --batch {BATCH} "
         "--epochs 2 --accelerator cpu --log logs").split()
RUN = os.path.join("logs", "shapenet_vn_dgcnn_partseg")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def entry(tmp_path_factory):
    """Train, then infer, in a working directory of their own."""
    cwd = tmp_path_factory.mktemp("cwd")
    # 2 categories, 4 / 2 / 5 objects: 2 training batches, 1 validation
    # batch, and test batches of 4, 4 and a ragged 2
    write_mini_shapenet(str(cwd / "data" / "ShapeNet" / "raw"), ("Airplane", "Chair"), (4, 2, 5),
                        seed=3, points=500)
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        trained, results = train.main(TRAIN)
        final = os.path.join(RUN, "checkpoints", "final")
        with record_test_steps() as served:
            restored, served_results = infer.main(
                ["shapenet", "--model_path", final, "--fixed_points", str(N), "--batch",
                 str(BATCH), "--test_batches", "3", "--accelerator", "cpu"])
        loader = DataLoader(ShapeNetDataset("data/ShapeNet/raw", N, "test"), BATCH, shuffle=True,
                            seed=0)
        with record_test_steps() as in_memory:
            in_memory_results = trainer.test(trained, loader, seed=0, limit_batches=3)
        first = next(iter(DataLoader(ShapeNetDataset("data/ShapeNet/raw", N, "test"), BATCH,
                                     shuffle=True, seed=0)))
    return dict(cwd=cwd, trained=trained, results=results, restored=restored, served=served,
                served_results=served_results, in_memory=in_memory,
                in_memory_results=in_memory_results, first=first)


def test_train_writes_its_logs_and_checkpoints(entry):
    run = entry["cwd"] / RUN
    with open(run / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r.get("epoch") for r in records] == [0, 1, None]
    for r in records[:2]:
        assert set(r) == {"epoch", "train_total_loss", "loss_metric", "loss_hyp", "train_acc",
                          "train_iou", "scale", "val_loss", "acc", "iou", "lr", "temperature",
                          "epoch_time_s", "step", "_time"}
        assert r["scale"] != 1e-3 and np.isfinite(r["train_total_loss"])
    assert records[2].keys() == {"test_loss", "score", "test_acc", "test_iou", "_time"}
    assert {k: records[2][k] for k in entry["results"]} == entry["results"]
    for name in ("best", "last", "final"):
        assert sorted(os.listdir(run / "checkpoints" / name)) == ["config.json", "model.ckpt"]
    assert sorted(os.listdir(run)) == ["checkpoints", "metrics.csv", "metrics.jsonl",
                                       "metrics_1.csv"]


def test_infer_serves_the_trained_state(entry):
    want = entry["trained"].state_dict()
    got = entry["restored"].state_dict()
    for k, v in want["net"].items():
        assert torch.equal(got["net"][k], v), k
    # fit keeps the state after the epoch of the lowest val_loss (2 steps an epoch)
    with open(entry["cwd"] / RUN / "metrics.jsonl") as f:
        val_loss = [r["val_loss"] for r in map(json.loads, f) if "epoch" in r]
    assert got["step"] == want["step"] == 2 * (int(np.argmin(val_loss)) + 1)
    # 10 test clouds in batches of 4: the last batch has 2
    assert [len(c["pred"]) for c in entry["served"]] == [BATCH, BATCH, 2]
    check_same_test_outputs(entry["served"], entry["in_memory"])
    assert entry["served_results"] == pytest.approx(entry["in_memory_results"], rel=1e-5)
    for c in entry["served"]:
        assert c["linkage"].shape == (c["pred"].shape[0], N - 1, 4)


def test_restored_embeddings_match_the_jax_package(entry):
    system, batch = entry["restored"], entry["first"]
    cfg = system.cfg
    jsys = JSystem(JConfig(**dataclasses.asdict(cfg)))
    # the parameters' shapes only (no compile), as the importer's template
    shapes = jax.eval_shape(lambda: jsys.init(jax.random.PRNGKey(0), {
        k: jnp.asarray(v) for k, v in batch.items()}).params)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.numpy() for k, v in system.net.state_dict().items()}
    params, stats = convert_lightning_checkpoint(sd, zeros, {"backbone": {}})
    dv = decode_vector_for_batch(cfg, batch)
    got_e, got_p = system.embed(batch["points"], dv)
    apply = jax.jit(lambda v, p, d: jsys.net.apply(v, p, d, train=False))
    want_e, want_p = apply({"params": params, "batch_stats": stats},
                           jnp.asarray(batch["points"]), jnp.asarray(dv.numpy()))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)


def test_port_imports_and_runs_without_jax(tmp_path):
    """Every module of hpcs_torch imports, and both entry points run as
    `python -m`, with jax, flax, msgpack and hpcs_tpu unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['hpcs_tpu'] = None\n"
        "sys.modules['flax'] = None; sys.modules['msgpack'] = None\n"
        "import importlib, pkgutil, runpy, hpcs_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(hpcs_torch.__path__, 'hpcs_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'hpcs_torch.train', 'hpcs_torch.infer', 'hpcs_torch.cli',\n"
        "        'hpcs_torch.parallel.collectives', 'hpcs_torch.parallel.data_parallel',\n"
        "        'hpcs_torch.parallel.multihost', 'hpcs_torch.parallel.point_parallel',\n"
        "        'hpcs_torch.multihost_dryrun'} <= set(names)\n"
        "sys.argv = ['train', '--dataset', 'synthetic', '--fixed_points', '32', '--k', '4', "
        "'--batch', '16', '--epochs', '1', '--t_per_anchor', '4', '--accelerator', 'cpu']\n"
        "runpy.run_module('hpcs_torch.train', run_name='__main__')\n"
        "sys.argv = ['infer', 'synthetic', '--model_path', "
        "'logs/synthetic_vn_dgcnn_partseg/checkpoints/final', '--fixed_points', '32', "
        "'--batch', '16', '--test_batches', '1', '--accelerator', 'cpu']\n"
        "runpy.run_module('hpcs_torch.infer', run_name='__main__')\n"
        "bad = [k for k, v in sys.modules.items() if v is not None\n"
        "       and (k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'msgpack', 'hpcs_tpu'))]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, check=True,
                         timeout=300, capture_output=True, text=True)
    assert "End Training" in out.stdout
    assert (tmp_path / "logs" / "synthetic_vn_dgcnn_partseg" / "metrics.jsonl").exists()
