"""The entry points with each other backbone on the CPU:
`python -m hpcs_torch.train --model <name>` trains 1 epoch on the synthetic
set in a temporary working directory, `python -m hpcs_torch.infer` serves
its final checkpoint, and infer must give what `trainer.test` gives on the
trained system in memory (prediction, best k, best score and linkage
exactly, the losses within rtol 1e-5: testing.check_same_test_outputs).
The checkpoint's config.json restores the backbone it was trained with.
"""
import os
import subprocess
import sys

import pytest
import torch

from _torch_port import torch_threads
from hpcs_torch import infer, train, trainer
from hpcs_torch.data import DataLoader, SyntheticPartDataset
from hpcs_torch.testing import check_same_test_outputs, record_test_steps
from hpcs_torch.utils.checkpoint import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BATCH = 32, 16
FLAGS = {
    "dgcnn_partseg": ["--eucl_embedding", "12"],
    "pointnet_partseg": ["--eucl_embedding", "12"],
    "vn_pointnet_partseg": ["--eucl_embedding", "12", "--hyp_embedding", "6"],
    "vn_dgcnn_partseg": ["--eucl_embedding", "6"],
}


@pytest.mark.parametrize("model", list(FLAGS))
def test_train_then_infer_serves_the_trained_model(model, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--dataset", "synthetic", "--model", model, "--fixed_points", str(N), "--k", "4",
            "--t_per_anchor", "4", "--batch", str(BATCH), "--epochs", "1", "--accelerator",
            "cpu", "--log", "logs"] + FLAGS[model]
    if model == "vn_dgcnn_partseg":
        argv += ["--dropout", "0.3"]
    final = os.path.join("logs", f"synthetic_{model}", "checkpoints", "final")
    with torch_threads(2):
        trained, _ = train.main(argv)
        cfg = load_config(final)
        assert (cfg["model_name"], cfg["pooling"]) == (model, "mean")
        with record_test_steps() as served:
            restored, served_results = infer.main(
                ["synthetic", "--model_path", final, "--fixed_points", str(N), "--batch",
                 str(BATCH), "--test_batches", "1", "--accelerator", "cpu"])
        loader = DataLoader(SyntheticPartDataset(num_objects=32, npoints=N, seed=3), BATCH,
                            shuffle=True, seed=0)
        with record_test_steps() as in_memory:
            in_memory_results = trainer.test(trained, loader, seed=0, limit_batches=1)
    assert type(restored.net.nn_feat) is type(trained.net.nn_feat)
    for k, v in trained.net.state_dict().items():
        assert torch.equal(restored.net.state_dict()[k], v), k
    assert restored.step == trained.step == 64 // BATCH
    check_same_test_outputs(served, in_memory)
    assert served_results == pytest.approx(in_memory_results, rel=1e-5)


def test_max_pooling_checkpoint_restores_its_pools(tmp_path):
    """A VN-DGCNN trained with pooling='max' is served with it: config.json
    carries the pooling, and the checkpoint the pools' weights."""
    from hpcs_torch.models import HypHCSystem, ModelConfig
    from hpcs_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cfg = ModelConfig(pooling="max", num_class=6, num_categories=2, eucl_dim=4, hyp_dim=4, k=4)
    system = HypHCSystem(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    save_checkpoint(str(tmp_path / "ck"), system, cfg)
    loaded = load_config(str(tmp_path / "ck"))
    fresh = HypHCSystem(ModelConfig(**{**loaded, "hierarchy_list": ()}), device="cpu")
    restore_checkpoint(str(tmp_path / "ck"), fresh)
    assert fresh.cfg.pooling == "max"
    assert torch.equal(fresh.net.nn_feat.pool2.map_to_dir.weight,
                       system.net.nn_feat.pool2.map_to_dir.weight)


def test_other_backbone_trains_and_serves_without_jax(tmp_path):
    """`python -m hpcs_torch.train --model dgcnn_partseg` and `.infer` with
    jax and hpcs_tpu unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['hpcs_tpu'] = None\n"
        "sys.modules['flax'] = None\n"
        "import runpy\n"
        "sys.argv = ['train', '--dataset', 'synthetic', '--model', 'dgcnn_partseg', "
        "'--fixed_points', '32', '--k', '4', '--eucl_embedding', '12', '--batch', '16', "
        "'--epochs', '1', '--t_per_anchor', '4', '--accelerator', 'cpu']\n"
        "runpy.run_module('hpcs_torch.train', run_name='__main__')\n"
        "sys.argv = ['infer', 'synthetic', '--model_path', "
        "'logs/synthetic_dgcnn_partseg/checkpoints/final', '--fixed_points', '32', "
        "'--batch', '16', '--test_batches', '1', '--accelerator', 'cpu']\n"
        "runpy.run_module('hpcs_torch.infer', run_name='__main__')\n"
        "bad = [k for k, v in sys.modules.items() if v is not None\n"
        "       and (k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'hpcs_tpu'))]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, check=True,
                         timeout=300, capture_output=True, text=True)
    assert "End Training" in out.stdout
