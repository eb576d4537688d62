"""The flagship trained to convergence, then served in fp32 and in bf16.

    python -m hpcs_torch.trained_readings [--seeds 0 1 2] [train flags]

For each seed, in the working directory: `python -m hpcs_torch.train` with
FLAGS (the JAX package's 60-epoch synthetic flagship run,
benchmarks/results_round2.json) and --seed, then its checkpoints/final
loaded twice, as its ModelConfig and with bf16, and both served by
test_step on HELD_OUT (32 synthetic objects that no split holds, seed
123, 4 batches of 8) through `testing.fp32_bf16_quality`.  Train flags
given after the seeds are appended to FLAGS (the last wins), e.g. a small
run on the CPU:

    python -m hpcs_torch.trained_readings --seeds 0 --accelerator cpu \\
        --fixed_points 128 --k 10 --eucl_embedding 8 --hyp_embedding 8 --epochs 2

Prints one JSON object per seed: the test means train returns, the
validation loss and time of every epoch, the seconds of training and of
serving, and the quality record.  chip_smoke.py's trained phase runs seed 0.
"""
import argparse
import json
import os
import subprocess
import time

import torch

from . import train
from .data import SyntheticPartDataset
from .testing import fp32_bf16_quality, trained_system

FLAGS = ["--dataset", "synthetic", "--epochs", "60", "--batch", "8", "--fixed_points", "1024",
         "--k", "20", "--eucl_embedding", "32", "--hyp_embedding", "32", "--margin", "0.35",
         "--t_per_anchor", "50", "--temperature", "0.1", "--lr", "0.05", "--trade_off", "0.1"]
HELD_OUT = dict(num_objects=32, num_categories=4, parts_per_object=3, seed=123)
HELD_OUT_BATCH = 8


def held_out_batches(npoints):
    """HELD_OUT's objects of `npoints` points, as 4 batches of 8."""
    data = SyntheticPartDataset(npoints=npoints, **HELD_OUT)
    out = []
    for start in range(0, HELD_OUT["num_objects"], HELD_OUT_BATCH):
        p, c, y = data.batch(start, HELD_OUT_BATCH)
        out.append({"points": p, "category": c, "labels": y})
    return out


def run(seed=0, argv=(), log="logs"):
    """Train (FLAGS, --seed `seed`, --log `log`, then `argv`), then serve
    the final checkpoint (the state after the epoch of the lowest val_loss,
    at step `best_step` of `steps`) in fp32 and bf16.  Returns (the trained
    system, the readings)."""
    t = time.perf_counter()
    system, results = train.main(FLAGS + ["--seed", str(seed), "--log", log, *argv])
    train_s = time.perf_counter() - t
    run_dir = os.path.join(log, f"synthetic_{system.cfg.model_name}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "epoch" in r]
    final = os.path.join(run_dir, "checkpoints", "final")
    t = time.perf_counter()
    fp32 = trained_system(final, device=system.device)
    bf16 = trained_system(final, device=system.device, bf16=True)
    quality = fp32_bf16_quality(fp32, bf16, held_out_batches(system.cfg.fixed_points))
    serve_s = time.perf_counter() - t
    return system, dict(seed=seed, test=results, epochs=len(epochs), steps=epochs[-1]["step"],
                        best_step=system.step,
                        val_loss=[r["val_loss"] for r in epochs],
                        epoch_time_s=[r["epoch_time_s"] for r in epochs],
                        train_seconds=train_s, serve_seconds=serve_s, quality=quality)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0])
    args, train_argv = parser.parse_known_args(argv)
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip(), flush=True)
    for seed in args.seeds:
        _, readings = run(seed, train_argv, log=os.path.join("logs", f"seed{seed}"))
        print(json.dumps(readings), flush=True)


if __name__ == "__main__":
    main()
