#!/usr/bin/env bash
# Run chip_smoke.py's train phase alone (its own imports, checks and
# timing: the flagship train_step, B=8, N=1024, k=20, eucl = hyp = 32, 50
# classes, t_per_anchor 50, 2 warm-up and 8 timed steps, host clock around
# each step ending in a synchronize; then its profile and trainer.fit)
# from two checkouts in turns (A B B A A B B A) on one GPU, one process a
# run, one JSON line per run: the median step ms and every step's. Each
# checkout builds its kernels on its first run.
#
#   bash scripts/train_step_ab.sh <checkout A> <checkout B>
set -u
a=$(realpath "$1")
b=$(realpath "$2")
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
status=0
for run in A1 B1 B2 A2 A3 B3 B4 A4; do
  case $run in A*) dir=$a ;; *) dir=$b ;; esac
  (cd "$dir" && python3 - "$run" <<'PY'
import contextlib
import io
import json
import sys

sys.path.insert(0, ".")
import chip_smoke as cs
from hpcs_torch.ops import _build

_build.build()
with contextlib.redirect_stdout(io.StringIO()):  # the phase's own JSON line
    out = cs.train_phase("")
print(json.dumps({"run": sys.argv[1], "median_ms": out["train_step_ms_median"],
                  "all_ms": out["train_step_ms_all"]}), flush=True)
PY
  ) || status=1
done
exit $status
