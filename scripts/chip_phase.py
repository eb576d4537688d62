"""Run one phase of chip_smoke.py alone on one GPU, after building the
kernels: `knn` (kernel B1 against knn_plain at the flagship: exactness,
times, selection work, launch geometry, half clouds), `edgeconv` (kernel
B2 at the flagship's three stages: against its plain version and the
float64 twin on planted near-EPS inputs, times by kernel, ptxas, half
clouds in fp32 and bf16), `bf16` (VN-DGCNN in bf16 on the flagship's
weights: requests, B1 and B2's bf16 routes against their plain versions,
B2's tensor-core HMMA from the SASS and both bounds, a training step, the
entry points with --bf16), `knn_wide` (B1's
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
and evaluated through examples/partnet_eval_torch.ipynb; the libver
"latest" fixtures read) or `parity` (tools/parity_experiment_torch.py: the
decode of hpcs_tpu's stored embeddings, the recipe trained for as many
seeds as fit in 90 s (2 at least), or for all of --seeds, and the report
beside hpcs_tpu's and the reference's seeds); see each phase's docstring.  Prints the card,
then the phase's JSON line; with a path, also writes that line there.

    python3 scripts/chip_phase.py PHASE [out.json]    # PHASE: one of the names above
    python3 scripts/chip_phase.py parity [out.json] --seeds 0 1 2 3 4
"""
import argparse
import functools
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from hpcs_torch.ops import _build  # noqa: E402

PHASES = {"knn": cs.knn_phase, "edgeconv": cs.edgeconv_phase, "bf16": cs.bf16_phase_alone,
          "knn_wide": cs.knn_wide_phase, "long_cloud": cs.long_cloud_phase,
          "observe": cs.observe_phase, "parallel": cs.parallel_phase,
          "examples": cs.examples_phase, "notebooks": cs.notebooks_phase,
          "partnet": cs.partnet_phase, "parity": cs.parity_phase}

if __name__ == "__main__":
    ap = argparse.ArgumentParser(usage="python3 scripts/chip_phase.py PHASE [out.json] "
                                       "[--seeds S ...]")
    ap.add_argument("phase", choices=list(PHASES))
    ap.add_argument("out", nargs="?")
    ap.add_argument("--seeds", type=int, nargs="+", help="parity: the seeds to train")
    args = ap.parse_args()
    phase = PHASES[args.phase]
    if args.seeds is not None:
        if args.phase != "parity":
            sys.exit("--seeds is an option of the parity phase")
        phase = functools.partial(phase, seeds=args.seeds)
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    out = phase(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
