"""Count the CUDA launches whose kernel record a torch.profiler trace lacks.

    python3 scripts/trace_record_loss.py train R    # R traced runs of train --profile
    python3 scripts/trace_record_loss.py bursts N   # N rounds of three traced bursts

`train`: R runs of `hpcs_torch.train.main --profile` at the flagship (as
chip_smoke's observe phase: B=8, N=1024, 2 training steps, 1 validation
and 1 test batch) in one process, three short untraced-to-file profiler
sessions between runs; for each run the launches (CUDA API events), those
without a kernel record, their places in launch order and the ops that made
them, and where the trace's first B1 launches stand.

`bursts`: N rounds of three `utils.profiling.trace` sessions of 300
one-element kernels: A launched as soon as the trace opens, B after a
20 ms host sleep, C after a lead-in of 64 kernels.  For each session the
launches without a kernel record and the least gap from a launch to its
kernel's start on the trace's clock (negative: the kernel placed before its
launch).  One JSON line a session with a loss, then one a way.
"""
import collections
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hpcs_torch.utils import profiling  # noqa: E402


def read_trace(log_dir):
    """The newest trace under log_dir (then removed): its events, its launches
    {correlation: event} in launch order and its kernel records {correlation:
    event}."""
    files = profiling.trace_files(log_dir)
    with open(files[-1]) as f:
        events = json.load(f)["traceEvents"]
    for fn in files:
        os.remove(fn)
    launches, kernels = {}, {}
    for e in events:
        args = e.get("args", {})
        if e.get("cat", "").startswith("cuda_") and "correlation" in args and "aunch" in e["name"]:
            launches[args["correlation"]] = e
        elif e.get("cat") == "kernel":
            kernels[args.get("correlation")] = e
    order = sorted(launches, key=lambda c: launches[c]["ts"])
    return events, {c: launches[c] for c in order}, kernels


def train_runs(runs):
    from torch.profiler import ProfilerActivity, profile

    from hpcs_torch import train
    from hpcs_torch.ops import _build
    from hpcs_torch.testing import write_mini_shapenet

    _build.build()
    root = tempfile.mkdtemp()
    write_mini_shapenet(os.path.join(root, "big", "data", "ShapeNet", "raw"), ("Airplane", "Chair"),
                        cs.OBSERVE_SPLITS, seed=cs.OBSERVE_SEED)
    os.chdir(os.path.join(root, "big"))
    flags = cs.ENTRY_FLAGS + ["--epochs", "1", "--seed", str(cs.OBSERVE_SEED)]
    z = torch.zeros(1, device="cuda")
    for r in range(runs):
        for _ in range(3 if r else 0):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    z.add_(1)
                torch.cuda.synchronize()
            prof.key_averages()
        cs._launch_counts(reset=True)
        train.main(flags + ["--profile", "trace"])
        torch.cuda.synchronize()
        events, launches, kernels = read_trace("trace")
        pos = {c: i for i, c in enumerate(launches)}
        ops = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
               and e.get("ph") == "X"]

        def op_of(c):
            e = launches[c]
            inner = [o for o in ops if o["tid"] == e["tid"]
                     and o["ts"] <= e["ts"] <= o["ts"] + o.get("dur", 0)]
            return min(inner, key=lambda o: o.get("dur", 0))["name"] if inner else None

        lost = [c for c in launches if c not in kernels]
        b1 = [c for c, e in kernels.items() if "knn_kernel" in e["name"]]
        print(json.dumps(dict(
            run=r, counted=cs._launch_counts(), launches=len(launches), lost=len(lost),
            lost_first=[(pos[c], op_of(c)) for c in lost[:6]], b1_records=len(b1),
            b1_launch_places=sorted(pos[c] for c in b1 if c in pos)[:3])), flush=True)


def bursts(rounds):
    z = torch.zeros(1, device="cuda")
    rows = []
    for i in range(rounds):
        for way in "ABC":
            with profiling.trace("trace"):
                if way == "B":
                    time.sleep(0.02)
                if way == "C":
                    for _ in range(64):
                        z.add_(2)
                for _ in range(300):
                    z.add_(1)
            _, launches, kernels = read_trace("trace")
            lost = [i for i, c in enumerate(launches) if c not in kernels]
            gap = min((kernels[c]["ts"] - e["ts"] for c, e in launches.items() if c in kernels),
                      default=None)
            row = dict(round=i, way=way, launches=len(launches), lost=len(lost),
                       last_lost=lost[-1] if lost else None, least_gap_us=gap)
            rows.append(row)
            if lost:
                print(json.dumps(row), flush=True)
    for way in "ABC":
        mine = [r for r in rows if r["way"] == way]
        gaps = [r["least_gap_us"] for r in mine]
        print(json.dumps(dict(way=way, sessions=len(mine),
                              with_loss=sum(r["lost"] > 0 for r in mine),
                              lost=[r["lost"] for r in mine if r["lost"]],
                              negative_gaps=sum(g < 0 for g in gaps), least_gap_us=min(gaps),
                              gaps_us=collections.Counter(round(g) for g in gaps).most_common(3))),
              flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("train", "bursts"):
        sys.exit("usage: python3 scripts/trace_record_loss.py train|bursts COUNT")
    if not torch.cuda.is_available():
        sys.exit("trace_record_loss.py needs a CUDA device")
    (train_runs if sys.argv[1] == "train" else bursts)(int(sys.argv[2]))
