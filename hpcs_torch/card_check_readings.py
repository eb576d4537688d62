"""Readings of the card-vs-CPU training-step check over seeds.

    python -m hpcs_torch.card_check_readings

Runs `hpcs_torch.testing.check_train_step_card_vs_cpu` at seeds 0-2 of two
configurations: chip_smoke.py's (B=2, N=256, the flagship's widths) and
tests/test_torch_cuda.py's (B=2, N=128, eucl = hyp = 8).  For each run it
prints the check's result, or the assertion that failed, and per gradient
leaf [card, the CPU's farthest fp32 order] from float64, card and CPU
apart, the CPU's orders apart, and the card's and the CPU's float64 steps
apart, all as shares of the leaf's largest float64 entry.  Needs a CUDA
device; exits 2 without one.
"""
import json
import subprocess
import sys

import torch


def _batch(data, n):
    p, c, seg = data.batch(0, n)
    return {"points": p, "category": c, "labels": seg}


def main():
    if not torch.cuda.is_available():
        print("card_check_readings: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    from .data import SyntheticPartDataset
    from .models import HypHCSystem, ModelConfig
    from .testing import check_train_step_card_vs_cpu

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    configs = {
        "chip_smoke_b2_n256": (
            dict(num_class=50, num_categories=16, eucl_dim=32, hyp_dim=32, k=20,
                 t_per_anchor=50, temperature=0.05),
            SyntheticPartDataset(2, 256, 8, parts_per_object=6, seed=5)),
        "gpu_test_b2_n128": (
            dict(num_class=6, num_categories=2, eucl_dim=8, hyp_dim=8, k=8, t_per_anchor=10,
                 temperature=0.1),
            SyntheticPartDataset(2, 128, 2, seed=0)),
    }
    for tag, (kw, data) in configs.items():
        for seed in (0, 1, 2):
            system = HypHCSystem(ModelConfig(**kw, dropout=0.0, train_rotation="none"),
                                 generator=torch.Generator().manual_seed(seed))
            try:
                out = check_train_step_card_vs_cpu(system, _batch(data, 2), seed=seed)
            except AssertionError as e:
                print(json.dumps({"config": tag, "seed": seed, "failed": str(e)}), flush=True)
                continue
            leaves = out.pop("grad_leaves")
            print(json.dumps({"config": tag, "seed": seed, **out, "grad_leaves": leaves}),
                  flush=True)


if __name__ == "__main__":
    main()
