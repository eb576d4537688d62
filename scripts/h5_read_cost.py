"""The host cost of reading PartNet-shaped HDF5 files with
hpcs_torch.utils.hdf5: the median ms of a whole-file read and the peak
bytes numpy and Python allocate during one read (tracemalloc), for the
files the chip_smoke partnet phase times (16 objects of 10,000 points,
written contiguous and chunked one object a chunk, deflated) and the
committed libver="latest" fixtures.

    python3 scripts/h5_read_cost.py [checkout ...] [--reps 9] [--turns 2]

Each checkout (default: this one) is measured in its own process, in
turns A, B, B, A for two checkouts (the order is mirrored on every second
turn), its hpcs_torch and tools imported from it.  One JSON line a run;
a checkout whose reader refuses a file reports the refusal.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OBJECTS = 16  # as chip_smoke.PARTNET_H5_OBJECTS


def measure(root, reps):
    """{file: {"read_ms", "peak_mib", "file_mib"} or {"refused"}} for the
    checkout at `root`."""
    import time
    import tracemalloc

    import numpy as np

    sys.path[:0] = [root, os.path.join(root, "tools")]
    import make_mini_datasets_torch as minidata

    from hpcs_torch.testing import write_h5_deflated
    from hpcs_torch.utils import hdf5

    _, _, arrays = next(minidata.partnet_arrays(per_split=(OBJECTS, 0, 0)))
    tmp = tempfile.TemporaryDirectory()
    files = {"contiguous": os.path.join(tmp.name, "contiguous.h5"),
             "deflated": os.path.join(tmp.name, "deflated.h5")}
    hdf5.write_h5(files["contiguous"], arrays)
    write_h5_deflated(files["deflated"], arrays)
    fixtures = os.path.join(HERE, "tests", "fixtures", "hdf5_latest")
    for name in ("partnet_growable.h5", "dense_group.h5"):
        files[name] = os.path.join(fixtures, name)

    def walk(group, prefix=""):
        for key in group.keys():
            node = group[key]
            if isinstance(node, hdf5.Group):
                yield from walk(node, f"{prefix}{key}/")
            else:
                yield prefix + key, node[...]

    def read(path):
        with hdf5.File(path) as f:
            return dict(walk(f))

    out = {}
    for kind, path in files.items():
        try:
            got = read(path)
        except ValueError as e:
            out[kind] = {"refused": str(e)}
            continue
        if kind in ("contiguous", "deflated"):
            assert all(np.array_equal(got[k], v) for k, v in arrays.items()), kind
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            read(path)
            times.append((time.perf_counter() - t) * 1e3)
        tracemalloc.start()
        read(path)
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        out[kind] = {"read_ms": float(np.median(times)), "peak_mib": peak / 2 ** 20,
                     "array_mib": sum(a.nbytes for a in got.values()) / 2 ** 20,
                     "file_mib": os.path.getsize(path) / 2 ** 20}
    tmp.cleanup()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*", default=[HERE])
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(os.path.realpath(args.child), args.reps)))
        return
    roots = [os.path.realpath(c) for c in args.checkouts]
    for turn in range(args.turns):
        for root in (roots if turn % 2 == 0 else roots[::-1]):
            run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                                  "--reps", str(args.reps)], capture_output=True, text=True,
                                 cwd=root, check=True)
            print(json.dumps({"checkout": root, "turn": turn,
                              **json.loads(run.stdout.strip().splitlines()[-1])}), flush=True)


if __name__ == "__main__":
    main()
