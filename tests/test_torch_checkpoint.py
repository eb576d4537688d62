"""The port's checkpoints, metric logs and the full `fit` / `test` loops,
against hpcs_tpu's files and records."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import synthetic_batch, torch_threads
from hpcs_tpu.data import DataLoader as JDataLoader
from hpcs_tpu.data import SyntheticPartDataset as JSyntheticPartDataset
from hpcs_tpu.models import HypHCSystem as JSystem
from hpcs_tpu.models import ModelConfig as JConfig
from hpcs_tpu.trainer import fit as jfit
from hpcs_tpu.utils.logging import MetricLogger as JMetricLogger
from hpcs_torch import trainer
from hpcs_torch.cli import freeze_hierarchy
from hpcs_torch.data import DataLoader, SyntheticPartDataset
from hpcs_torch.models import HypHCSystem, ModelConfig
from hpcs_torch.utils.checkpoint import load_config, restore_checkpoint, save_checkpoint
from hpcs_torch.utils.logging import MetricLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dataset="shapenet", num_class=6, num_categories=2, fixed_points=32, eucl_dim=4,
            hyp_dim=4, k=4, t_per_anchor=5, num_triplets=128, temperature=0.1)
HIERARCHY = (((0,), (1, 2)), ((0,), (1,), (2,)))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    with torch_threads(2):
        yield


def _system(**over):
    return HypHCSystem(ModelConfig(**{**TINY, **over}), device="cpu",
                       generator=torch.Generator().manual_seed(3))


def _assert_states_equal(got, want):
    """Equal nested state: dicts, lists, tensors (exactly) and scalars."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_states_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_states_equal(g, w)
    elif torch.is_tensor(want):
        assert torch.equal(got, want)
    else:
        assert got == want


def test_save_then_restore_gives_the_state_back(tmp_path):
    system = _system()
    batch = synthetic_batch(2, 32)
    system.train_step(batch, torch.Generator().manual_seed(0))
    system.set_learning_rate(0.0025)
    save_checkpoint(str(tmp_path / "ck"), system, system.cfg, epoch=4, extra={"note": "x"})
    assert sorted(os.listdir(tmp_path / "ck")) == ["config.json", "model.ckpt"]
    fresh = _system()
    for path in (tmp_path / "ck", tmp_path / "ck" / "model.ckpt"):
        assert restore_checkpoint(str(path), fresh) == (4, {"note": "x"})
        _assert_states_equal(fresh.state_dict(), system.state_dict())
        assert fresh.optimizer.param_groups[0]["lr"] == 0.0025 and fresh.step == 1
    # the restored system steps on as the saved one does
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a, b = fresh.train_step(batch, g1), system.train_step(batch, g2)
    assert all(torch.equal(a[k], b[k]) for k in b)


def _loaders(port=True):
    DL, DS = (DataLoader, SyntheticPartDataset) if port else (JDataLoader, JSyntheticPartDataset)
    train = DL(DS(4, 32, 2, seed=1), 2, shuffle=True, drop_last=True, seed=0)
    valid = DL(DS(2, 32, 2, seed=2), 2, drop_last=True)
    return train, valid


def _records(log_dir, run_name):
    with open(os.path.join(log_dir, run_name, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """hpcs_tpu.trainer.fit for one epoch of TINY (with a hierarchy list,
    inert on ShapeNet) with checkpoints: (its log dir, its epoch record,
    its last/config.json)."""
    base = tmp_path_factory.mktemp("jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HPCS_TPU_FUSED_EPOCH", "0")  # the per-step loop: one compile less
        jfit(JSystem(JConfig(**TINY, hierarchy_list=HIERARCHY)), *_loaders(port=False),
             epochs=1, log_dir=str(base), run_name="jax", ckpt_dir=str(base / "ckpt"))
    (record,) = _records(str(base), "jax")
    return base, record, load_config(str(base / "ckpt" / "last"))


def test_epoch_record_has_the_jax_packages_names(tmp_path, jax_run):
    system = _system()
    trainer.fit(system, *_loaders(), epochs=1, log_dir=str(tmp_path), run_name="port",
                log=lambda line: None)
    (port,), ref = _records(str(tmp_path), "port"), jax_run[1]
    assert port.keys() == ref.keys()
    assert port["epoch"] == 0 and port["step"] == ref["step"] == 2
    assert np.isfinite([port[k] for k in port if k != "_time"]).all()
    with open(tmp_path / "port" / "metrics.csv") as f:
        assert f.readline().strip().split(",") == sorted(port)


def test_config_json_has_the_jax_packages_keys_and_loads_in_both(tmp_path, jax_run):
    cfg = ModelConfig(**TINY, hierarchy_list=HIERARCHY)
    save_checkpoint(str(tmp_path / "port"), _system(), cfg)
    port, ref = load_config(str(tmp_path / "port")), jax_run[2]
    assert list(port) == list(ref) and port == ref
    for d in (port, ref):
        d["hierarchy_list"] = freeze_hierarchy(d["hierarchy_list"])
        assert ModelConfig(**d) == cfg
    with open(os.path.join(REPO, "benchmarks", "_partnet_bottle_ckpt", "config.json")) as f:
        committed = json.load(f)
    committed["hierarchy_list"] = freeze_hierarchy(committed["hierarchy_list"])
    cfg = ModelConfig(**committed)
    assert (cfg.dataset, cfg.num_class, cfg.use_hierarchical) == ("partnet", 9, True)
    assert hash(cfg) == hash(ModelConfig(**committed))


def test_resume_starts_at_the_stored_epoch(tmp_path):
    ckpt, logs = str(tmp_path / "ckpt"), str(tmp_path / "logs")
    system = _system()
    state, best = trainer.fit(system, *_loaders(), epochs=2, log_dir=logs, ckpt_dir=ckpt,
                              log=lambda line: None)
    assert sorted(os.listdir(ckpt)) == ["best", "last"]
    assert torch.load(os.path.join(ckpt, "last", "model.ckpt"), weights_only=True)["epoch"] == 2
    resumed = _system()
    lines = []
    trainer.fit(resumed, *_loaders(), epochs=3, log_dir=logs, ckpt_dir=ckpt, resume=ckpt + "/last",
                log=lines.append)
    assert len(lines) == 1 and lines[0].startswith("epoch 2:")
    assert [r["epoch"] for r in _records(logs, "run")] == [0, 1, 2]
    assert [r["step"] for r in _records(logs, "run")] == [2, 4, 6]
    assert restore_checkpoint(os.path.join(ckpt, "last"), _system())[0] == 3
    # nothing left to train: the restored state comes back as it was
    again = _system()
    trainer.fit(again, *_loaders(), epochs=3, ckpt_dir=str(tmp_path / "c2"),
                resume=ckpt + "/last", log=lambda line: None)
    _assert_states_equal(again.state_dict(), _restored(ckpt + "/last"))


def _restored(path):
    s = _system()
    restore_checkpoint(path, s)
    return s.state_dict()


def test_test_loop_logs_its_means(tmp_path):
    system = _system()
    logger = MetricLogger(str(tmp_path), "t")
    batches = [synthetic_batch(2, 32, seed=s) for s in range(3)]
    out = trainer.test(system, batches, seed=1, limit_batches=2, logger=logger)
    logger.close()
    (rec,) = _records(str(tmp_path), "t")
    assert sorted(out) == ["score", "test_acc", "test_iou", "test_loss"]
    assert {k: rec[k] for k in out} == out and "step" not in rec


def test_metric_logger_files_as_the_jax_packages(tmp_path, monkeypatch):
    recs = [({"a": 1.0, "b": np.float32(2.5)}, 3), ({"a": 2.0}, None), ({"a": 0.5, "b": 1}, 4)]
    for cls, name in ((MetricLogger, "port"), (JMetricLogger, "jax")):
        logger = cls(str(tmp_path), name)
        for rec, step in recs:
            logger.log(rec, step=step)
        logger.close()
    for fname in ("metrics.csv", "metrics_1.csv"):
        port, ref = ((tmp_path / n / fname).read_text().splitlines() for n in ("port", "jax"))
        assert port[0] == ref[0] and len(port) == len(ref)
    assert not (tmp_path / "port" / "metrics_2.csv").exists()
    strip = [[{k: v for k, v in r.items() if k != "_time"} for r in _records(str(tmp_path), n)]
             for n in ("port", "jax")]
    assert strip[0] == strip[1]
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(RuntimeError, match="wandb"):
        MetricLogger(str(tmp_path), "w", use_wandb=True)
