"""The kNN radix route (k > 256) on one GPU: its device time by kernel, and
its time with some of knn.cu's constants changed.

Builds copies of hpcs_torch/ops/csrc/knn.cu, each with one choice of the
radix route replaced (a group's keys GROUP_WORDS, the key sweep's blocks an
SM, the candidate cap, the selection's block for short and long rows and
its blocks an SM, the first digit's counts gathered a warp at a time), and
times
hpcs_torch.ops.knn at k = 300 on Gaussian clouds of (2, 1024, 3), (16,
1024, 63), (1, 65536, 3) and (1, 65536, 63) with each (CUDA events, after a
warm-up), every copy's indices equal to the first's; then the tree's own
build under torch.profiler, device ms by kernel at three of the shapes.
Prints the card, a JSON line per copy and per profiled shape; with a path,
also writes them there.

    python3 scripts/knn_radix_variants.py [out.json]
"""
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hpcs_torch.ops import _build  # noqa: E402
from hpcs_torch.ops import knn as K  # noqa: E402

K_RADIX = 300
SHAPES = [(2, 1024, 3), (16, 1024, 63), (1, 65536, 3), (1, 65536, 63)]
# (name, [(pattern in knn.cu, replacement)]); "tree" is knn.cu as it is
VARIANTS = [
    ("tree", []),
    ("groups_32MiB", [(r"GROUP_WORDS = 1LL << 25", "GROUP_WORDS = 1LL << 23")]),
    ("groups_64MiB", [(r"GROUP_WORDS = 1LL << 25", "GROUP_WORDS = 1LL << 24")]),
    ("key_blocks_2_an_sm", [(r"KEYS_BLOCKS_PER_SM = 4", "KEYS_BLOCKS_PER_SM = 2")]),
    ("key_blocks_8_an_sm", [(r"KEYS_BLOCKS_PER_SM = 4", "KEYS_BLOCKS_PER_SM = 8")]),
    ("candidates_4096", [(r"CAND_CAP = 2048", "CAND_CAP = 4096")]),
    ("long_rows_512_threads", [(r"RADIX_THREADS_LONG = 1024", "RADIX_THREADS_LONG = 512")]),
    ("short_rows_512_threads", [(r"RADIX_THREADS = 256, ", "RADIX_THREADS = 512, ")]),
    ("short_rows_1024_threads", [(r"RADIX_THREADS = 256, ", "RADIX_THREADS = 1024, ")]),
    ("two_long_blocks_an_sm", [(r"__launch_bounds__\(T\)\n",
                                r"__launch_bounds__(T, T == RADIX_THREADS_LONG ? 2 : 1)\n")]),
    # the first digit's counts gathered a warp at a time (one atomic a bin a warp)
    ("aggregated_first_counts", [
        (r"#include <type_traits>\n", "#include <type_traits>\n#include <cooperative_groups.h>\n"),
        (r"  for_row<T>\(row, n, \[&\]\(unsigned key, int\) \{ atomicAdd"
         r"\(&hist\[key >> 21\], 1\); \}\);",
         "  for_row<T>(row, n, [&](unsigned key, int) {\n"
         "    namespace cg = cooperative_groups;\n"
         "    const auto same = cg::labeled_partition(cg::coalesced_threads(), key >> 21);\n"
         "    if (same.thread_rank() == 0) atomicAdd(&hist[key >> 21], (int)same.size());\n"
         "  });")]),
]


def use_source(src):
    """Point the kNN wrapper at a build of `src` (a knn.cu text)."""
    d = Path(tempfile.mkdtemp())
    (d / "knn.cu").write_text(src)
    _build.CSRC = d
    _build._libs.pop("knn", None)
    K._ENTRIES.clear()


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    rng = np.random.default_rng(cs.SEED)
    clouds = {f"{b}x{n}x{d}": torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32))
              .cuda() for b, n, d in SHAPES}
    tree = (Path(_build.CSRC) / "knn.cu").read_text()
    first, lines = {}, []
    for name, subs in VARIANTS:
        src = tree
        for pat, rep in subs:
            src, count = re.subn(pat, rep, src)
            if count != 1:
                raise RuntimeError(f"{name}: {pat!r} matched {count} times in knn.cu")
        use_source(src)
        ms = {}
        for tag, x in clouds.items():
            got = K._knn_wide_cuda(x, K_RADIX)
            if not torch.equal(got, first.setdefault(tag, got)):
                raise RuntimeError(f"{name}: indices at {tag} differ from the first build's")
            ms[tag] = cs.cuda_ms(lambda: K._knn_wide_cuda(x, K_RADIX), 2 if "65536" in tag else 10)
        lines.append(dict(variant=name, k=K_RADIX, ms=ms, card=card))
        print(json.dumps(lines[-1]), flush=True)
    use_source(tree)
    from torch.profiler import ProfilerActivity, profile

    for tag in ("16x1024x63", "1x65536x3", "1x65536x63"):
        x = clouds[tag]
        K._knn_wide_cuda(x, K_RADIX)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            K._knn_wide_cuda(x, K_RADIX)
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.key_averages():
            if e.device_time_total > 0:
                name = e.key.replace("(anonymous namespace)::", "").removeprefix("void ")
                by_kernel[name.split("(")[0]] = dict(launches=e.count,
                                                     device_ms=e.device_time_total / 1e3)
        lines.append(dict(profile=tag, k=K_RADIX, by_kernel=by_kernel, card=card))
        print(json.dumps(lines[-1]), flush=True)
    if len(sys.argv) > 1:
        os.makedirs(os.path.dirname(os.path.abspath(sys.argv[1])), exist_ok=True)
        with open(sys.argv[1], "w") as f:
            json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
