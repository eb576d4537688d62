#!/usr/bin/env bash
# Time the flagship request from two checkouts in turns (A B B A A B B A)
# on one GPU, one process a run: chip_smoke.py's forward-phase model
# (B=16, N=1024, k=20, eucl = hyp = 32, 16 categories, random weights and
# BatchNorm statistics from its SEED) answers its 8 requests through
# HypHCSystem.embed, then the same 8 through HypHCSystem.test_step (so3
# rotations from a generator seeded with SEED); host clock around each
# request, ending in a synchronize; medians of the last 6. One JSON line
# per run. Each checkout builds its kernels on its first run.
#
#   bash scripts/request_ab.sh <checkout A> <checkout B>
set -u
a=$(realpath "$1")
b=$(realpath "$2")
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
for run in A1 B1 B2 A2 A3 B3 B4 A4; do
  case $run in A*) dir=$a ;; *) dir=$b ;; esac
  (cd "$dir" && python3 - "$run" <<'PY'
import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs
from hpcs_torch.data import SyntheticPartDataset
from hpcs_torch.models import HypHCSystem, ModelConfig, decode_vector_for_batch
from hpcs_torch.ops import _build

_build.build()
gen = torch.Generator().manual_seed(cs.SEED)
cfg = ModelConfig(num_class=50, num_categories=cs.CATEGORIES, eucl_dim=cs.EUCL, hyp_dim=cs.HYP,
                  k=cs.K)
system = HypHCSystem(cfg, generator=gen)
cs.randomize_bn(system.net, gen)
data = SyntheticPartDataset(num_objects=cs.B * cs.REQUESTS, npoints=cs.N,
                            num_categories=cs.CATEGORIES, seed=cs.SEED)
batches = [data.batch(r * cs.B, cs.B) for r in range(cs.REQUESTS)]
requests = [{"points": p, "category": c, "labels": seg} for p, c, seg in batches]
dvs = [decode_vector_for_batch(cfg, r) for r in requests]


def timed(fn):
    ms = []
    for i in range(cs.REQUESTS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return ms


with torch.no_grad():
    forward = timed(lambda i: system.embed(requests[i]["points"], dvs[i]))
    step_gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    test_step = timed(lambda i: system.test_step(requests[i], step_gen))
print(json.dumps({"run": sys.argv[1],
                  "forward_ms_median": float(np.median(forward[cs.WARMUP:])),
                  "test_step_ms_median": float(np.median(test_step[cs.WARMUP:])),
                  "forward_ms_all": forward, "test_step_ms_all": test_step}), flush=True)
PY
  ) || status=1
done
exit $status
