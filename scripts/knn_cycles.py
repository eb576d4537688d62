"""Where kernel B1's time goes inside a block, by clock64 stamps.

Builds an instrumented copy of hpcs_torch/ops/csrc/knn.cu (stamps at the
end of the score sweep, of selection step 1 (the lane maxima and T), of
step 2 (the scan for candidates) and of step 3 (gather, sorts, output),
summed over blocks by atomics) with nvcc for sm_90a, runs it through the
same C entry as B1 on flagship-shaped clouds (B=16, N=1024, k=20) and
prints, per cloud, the launch's CUDA-event ms (prep included), its
indices' equality with B1's own, and the mean SM cycles a block spends in
each phase.  Needs the GPU and nvcc; imports no JAX.

    python3 scripts/knn_cycles.py [out.json]
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hpcs_torch.ops import _build  # noqa: E402
from hpcs_torch.ops import knn as KN  # noqa: E402

SOURCE = _build.CSRC / "knn.cu"
# (text before which a stamp goes, the stamp's name)
STAMPS = [("  // selection: warp w owns rows", "t_scores"),
          ("  // 2. this lane's columns at or above T", "t_step1"),
          ("  // 3. a row's candidates gathered", "t_step2")]
REPORT = """  const long long t_end = clock64();
  if (lane == 0) {
    atomicAdd(&knn_cycles[1], (unsigned long long)(t_step1 - t_scores));
    atomicAdd(&knn_cycles[2], (unsigned long long)(t_step2 - t_step1));
    atomicAdd(&knn_cycles[3], (unsigned long long)(t_end - t_step2));
    atomicAdd(&knn_cycles[5], 1ull);
  }
  if (threadIdx.x == 0) {
    atomicAdd(&knn_cycles[0], (unsigned long long)(t_scores - t_start));
    atomicAdd(&knn_cycles[4], 1ull);
  }
}
"""
READ = """
extern "C" void hpcs_knn_cycles(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, knn_cycles, sizeof(knn_cycles));
  unsigned long long zero[8] = {0};
  cudaMemcpyToSymbol(knn_cycles, zero, sizeof(zero));
}
"""


def instrumented(src):
    """knn.cu with the stamps; raises if an anchor moved."""
    src = src.replace("namespace {\n", "__device__ unsigned long long knn_cycles[8];\nnamespace {\n", 1)
    head = "  extern __shared__ float4 smem4[];\n  const int srow = L::srow(n)"
    if head not in src:
        raise RuntimeError("knn_cycles: knn_kernel's head moved")
    src = src.replace(head, "  const long long t_start = clock64();\n" + head)
    for anchor, name in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"knn_cycles: anchor {anchor!r} not found once")
        src = src.replace(anchor, f"  const long long {name} = clock64();\n" + anchor)
    end = "      idx[((size_t)b * rows + row - row_begin) * k + lane] = q.i < n ? q.i : -1;\n  }\n}\n"
    if src.count(end) != 1:
        raise RuntimeError("knn_cycles: knn_kernel's end moved")
    return src.replace(end, end[:-2] + REPORT) + READ


def main():
    if not torch.cuda.is_available():
        sys.exit("knn_cycles: no CUDA device is available")
    tmp = tempfile.mkdtemp()
    cu, lib_path = os.path.join(tmp, "knn_cycles.cu"), os.path.join(tmp, "libknn_cycles.so")
    with open(cu, "w") as f:
        f.write(instrumented(SOURCE.read_text()))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, cu], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    entry = lib.hpcs_knn
    entry.argtypes, entry.restype = KN._ARGTYPES, ctypes.c_int
    B, N, k = 16, 1024, 20
    rng = np.random.default_rng(0)
    line = torch.zeros(B, N, 3, device="cuda")
    line[:, :, 0] = torch.arange(N, device="cuda", dtype=torch.float32)
    clouds = {"gauss_d3": torch.from_numpy(rng.standard_normal((B, N, 3), np.float32)).cuda(),
              "line_d3": line,
              "gauss_d63": torch.from_numpy(rng.standard_normal((B, N, 63), np.float32)).cuda()}
    out = {}
    for name, x in clouds.items():
        idx = torch.empty((B, N, k), dtype=torch.int32, device="cuda")
        work = torch.empty(B * KN._work_floats(N, x.shape[-1]), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            _build.check(entry(x.data_ptr(), idx.data_ptr(), work.data_ptr(), B, N,
                               x.shape[-1], k, 0, N, stream), "hpcs_knn (instrumented)")

        cycles = (ctypes.c_ulonglong * 8)()
        launch()
        torch.cuda.synchronize()
        lib.hpcs_knn_cycles(cycles)  # reset
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            launch()
        end.record()
        torch.cuda.synchronize()
        lib.hpcs_knn_cycles(cycles)
        c = list(cycles)
        out[name] = dict(ms=start.elapsed_time(end) / 20, equal=bool(torch.equal(idx, KN.knn(x, k))),
                         scores_cycles=c[0] / c[4], step1_cycles=c[1] / c[5],
                         step2_cycles=c[2] / c[5], step3_cycles=c[3] / c[5])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps(out))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(dict(card=card, **out), f, indent=1)


if __name__ == "__main__":
    main()
