"""The trained-weights quality protocol (hpcs_torch.trained_readings) on
the CPU at a tiny size: `hpcs_torch.train.main` trains a synthetic model
for 2 epochs, its final checkpoint is loaded in fp32 and in bf16
(`testing.trained_system`), and `testing.fp32_bf16_quality` serves both on
32 held-out objects (seed 123, 4 batches of 8).  chip_smoke.py's trained
phase runs the same protocol on the card at the flagship's widths after
60 epochs."""
import os

import numpy as np
import pytest
import torch

from _torch_port import torch_threads
from hpcs_torch import trained_readings
from hpcs_torch.testing import fp32_bf16_quality, record_test_steps, trained_system

N, BATCH = 128, 8
TINY = (f"--fixed_points {N} --k 10 --eucl_embedding 8 --hyp_embedding 8 --t_per_anchor 10 "
        "--epochs 2 --accelerator cpu").split()
FINAL = os.path.join("logs", "synthetic_vn_dgcnn_partseg", "checkpoints", "final")
PER_SYSTEM = {"score", "purity", "test_acc", "test_iou", "test_loss", "best_k", "objects"}


def _purity(labels, pred):
    """Majority-vote purity of one object, by counting."""
    hits = sum(np.bincount(labels[pred == c]).max() for c in np.unique(pred))
    return hits / len(labels)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("cwd")
    with torch_threads(2), pytest.MonkeyPatch.context() as mp:
        mp.chdir(cwd)
        with record_test_steps() as calls:
            trained, readings = trained_readings.run(seed=0, argv=TINY)
        fp32 = trained_system(FINAL, device="cpu")
        bf16 = trained_system(FINAL, device="cpu", bf16=True)
        batches = trained_readings.held_out_batches(N)
        same = fp32_bf16_quality(fp32, trained_system(FINAL, device="cpu"), batches)
    return dict(trained=trained, readings=readings, fp32=fp32, bf16=bf16, batches=batches,
                calls=calls[-8:], record=readings["quality"], same=same)


def test_the_run_trains_and_reads_its_epochs(served):
    r = served["readings"]
    assert r["seed"] == 0 and r["epochs"] == 2 and r["steps"] == 2 * 64 // BATCH
    assert r["best_step"] == served["trained"].step == 64 // BATCH * (np.argmin(r["val_loss"]) + 1)
    assert len(r["val_loss"]) == len(r["epoch_time_s"]) == 2
    assert all(np.isfinite(r["val_loss"])) and r["train_seconds"] > 0 and r["serve_seconds"] > 0
    assert set(r["test"]) == {"test_loss", "score", "test_acc", "test_iou"}
    assert len(served["batches"]) == 4 and served["batches"][0]["points"].shape == (BATCH, N, 3)


def test_the_checkpoint_is_served_as_trained(served):
    fp32, bf16, trained = served["fp32"], served["bf16"], served["trained"]
    assert not fp32.cfg.bf16 and bf16.cfg.bf16
    assert fp32.cfg == trained.cfg
    for system in (fp32, bf16):
        for k, v in trained.net.state_dict().items():
            assert torch.equal(system.net.state_dict()[k], v), k


def test_every_field_of_the_record(served):
    record, calls, batches = served["record"], served["calls"], served["batches"]
    assert set(record) == {"fp32", "bf16", "purity_delta", "score_delta", "best_k_agreement"}
    C = served["fp32"].cfg.num_class
    for i, name in enumerate(("fp32", "bf16")):
        r = record[name]
        assert set(r) == PER_SYSTEM and r["objects"] == 32 and len(r["best_k"]) == 32
        mine = calls[4 * i: 4 * i + 4]  # the 4 test_steps of this system
        best_k = torch.cat([c["best_k"] for c in mine])
        assert r["best_k"] == best_k.tolist() and all(1 <= k <= C + 4 for k in r["best_k"])
        scores = torch.cat([c["best_score"] for c in mine]).double()
        assert r["score"] == pytest.approx(float(scores.mean()), rel=1e-12)
        for key in ("test_acc", "test_iou", "test_loss"):
            assert r[key] == pytest.approx(np.mean([c["logs"][key] for c in mine]), rel=1e-12)
        purities = [_purity(np.asarray(b["labels"][j]), c["pred"][j].numpy())
                    for b, c in zip(batches, mine) for j in range(BATCH)]
        assert r["purity"] == pytest.approx(np.mean(purities), abs=1e-6)
        assert 0 < r["purity"] <= 1 and 0 < r["score"] <= 1
    assert record["purity_delta"] == abs(record["fp32"]["purity"] - record["bf16"]["purity"])
    assert record["score_delta"] == record["fp32"]["score"] - record["bf16"]["score"]
    agree = np.mean([a == b for a, b in zip(record["fp32"]["best_k"], record["bf16"]["best_k"])])
    assert record["best_k_agreement"] == agree


def test_fp32_against_fp32_gives_no_delta(served):
    same = served["same"]
    assert same["purity_delta"] == 0.0 and same["score_delta"] == 0.0
    assert same["best_k_agreement"] == 1.0
    assert same["fp32"] == same["bf16"] == served["record"]["fp32"]
