"""Run chip_smoke.py's observe phase alone on one GPU: --profile,
--debug_nans, --plot_inference and the SO(3) probe (observe_phase's
docstring), after building the kernels.  Prints the card, then the
phase's JSON line; with a path, also writes that line there.

    python3 scripts/observe_phase.py [out.json]
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from hpcs_torch.ops import _build  # noqa: E402

if __name__ == "__main__":
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    out = cs.observe_phase(card)
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])), exist_ok=True)
        with open(sys.argv[1], "w") as f:
            json.dump(out, f, indent=1)
