"""Run one phase of chip_smoke.py alone on one GPU, after building the
kernels: `knn` (kernel B1 against knn_plain at the flagship: exactness,
times, selection work, launch geometry, half clouds), `knn_wide` (B1's
wide route at the shapes B1 refuses, N = 65,536 included: exactness,
bf16, times beside the bound, launch geometry, the 4096 / 4097 edge; its
radix route for k > 256 and the 256 / 257 edge), `long_cloud` (the
flagship served at N = 8192 and at k = 40 and 300 through the wide route,
and `python -m hpcs_torch.train --fixed_points 8192`),
`observe` (--profile, --debug_nans, --plot_inference and the SO(3) probe),
`parallel` (hpcs_torch.parallel: data-parallel steps, the sharded
test_step, every configuration point-sharded), `examples`
(examples/api_tour_torch.py and eval_noise_torch.py on an orbax
directory), `notebooks` (mini-ShapeNet-Part written, trained on and
evaluated through examples/shapenet_eval_torch.ipynb; the flagship's
hpcs_tpu checkpoint written by the phase itself) or `partnet` (mini
PartNet written and read without h5py, the entry points with the
hierarchical CosFace, a step against the CPU port, the recipe trained on
and evaluated through examples/partnet_eval_torch.ipynb); see each
phase's docstring.  Prints the card, then the phase's JSON line; with a path,
also writes that line there.

    python3 scripts/chip_phase.py PHASE [out.json]    # PHASE: one of the names above
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from hpcs_torch.ops import _build  # noqa: E402

PHASES = {"knn": cs.knn_phase, "knn_wide": cs.knn_wide_phase, "long_cloud": cs.long_cloud_phase,
          "observe": cs.observe_phase, "parallel": cs.parallel_phase,
          "examples": cs.examples_phase, "notebooks": cs.notebooks_phase,
          "partnet": cs.partnet_phase}

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in PHASES:
        sys.exit(f"usage: python3 scripts/chip_phase.py {'|'.join(PHASES)} [out.json]")
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    out = PHASES[sys.argv[1]](card)
    if len(sys.argv) > 2:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[2])), exist_ok=True)
        with open(sys.argv[2], "w") as f:
            json.dump(out, f, indent=1)
