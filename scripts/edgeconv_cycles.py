"""Where the bf16 route's two-conv kernel spends a block's time, by clock64 stamps.

Builds an instrumented copy of hpcs_torch/ops/csrc/edgeconv.cu (stamps in
edge_tc_kernel: its set-up, and in each round conv1 up to its barrier,
conv2 and its gates up to theirs, and the mean; thread 0's view of each
block, summed over blocks by atomics) with nvcc for sm_90a, runs it through
the same C entry as B2's bf16 route on the flagship's two-conv stage inputs
(chip_smoke.flagship, request_stages, rounded to bf16: B = 16, N = 1024,
k = 20) and prints, per stage, the launch's CUDA-event ms (the projection
included for C = 21), its output's equality with the route's own, and the
mean SM cycles a block spends in each phase.  Needs the GPU and nvcc;
imports no JAX.

    python3 scripts/edgeconv_cycles.py [out.json]
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hpcs_torch.ops import _build  # noqa: E402
from hpcs_torch.ops import edgeconv as E  # noqa: E402

SOURCE = _build.CSRC / "edgeconv.cu"
# (text in edge_tc_kernel, the text that replaces it)
STAMPS = [
    ("  uint4* s_a = reinterpret_cast<uint4*>(smem4);\n",
     "  uint4* s_a = reinterpret_cast<uint4*>(smem4);\n"
     "  const long long t_start = clock64();\n"
     "  long long t_loop = 0, c_conv1 = 0, c_conv2 = 0, c_mean = 0;\n"),
    ("  for (int r = 0; r < rounds; ++r) {\n",
     "  t_loop = clock64();\n  for (int r = 0; r < rounds; ++r) {\n"
     "    const long long t_round = clock64();\n"),
    ("#pragma unroll 1\n    for (int grp = warp;",
     "    const long long t_conv1 = clock64();\n    c_conv1 += t_conv1 - t_round;\n"
     "#pragma unroll 1\n    for (int grp = warp;"),
    ("    // segmented sum: output (point, f) adds its point's edges in order\n",
     "    const long long t_conv2 = clock64();\n    c_conv2 += t_conv2 - t_conv1;\n"
     "    // segmented sum: output (point, f) adds its point's edges in order\n"),
    ("    if (!last) __syncthreads();\n  }\n}\n",
     "    if (!last) __syncthreads();\n    c_mean += clock64() - t_conv2;\n  }\n"
     "  if (threadIdx.x == 0) {\n"
     "    atomicAdd(&tc_cycles[0], (unsigned long long)(t_loop - t_start));\n"
     "    atomicAdd(&tc_cycles[1], (unsigned long long)c_conv1);\n"
     "    atomicAdd(&tc_cycles[2], (unsigned long long)c_conv2);\n"
     "    atomicAdd(&tc_cycles[3], (unsigned long long)c_mean);\n"
     "    atomicAdd(&tc_cycles[4], 1ull);\n"
     "  }\n}\n"),
]
READ = """
extern "C" void hpcs_tc_cycles(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, tc_cycles, sizeof(tc_cycles));
  unsigned long long zero[8] = {0};
  cudaMemcpyToSymbol(tc_cycles, zero, sizeof(zero));
}
"""


def instrumented(src):
    """edgeconv.cu with the stamps in edge_tc_kernel; raises if an anchor moved."""
    begin = src.index("edge_tc_kernel(const __nv_bfloat16* __restrict__ x")
    end = src.index("int tc_points_per_block(")
    body = src[begin:end]
    for anchor, stamped in STAMPS:
        if body.count(anchor) != 1:
            raise RuntimeError(f"edgeconv_cycles: anchor {anchor!r} not found once")
        body = body.replace(anchor, stamped)
    src = src[:begin] + body + src[end:]
    return src.replace("namespace {\n", "__device__ unsigned long long tc_cycles[8];\nnamespace {\n",
                       1) + READ


def main():
    if not torch.cuda.is_available():
        sys.exit("edgeconv_cycles: no CUDA device is available")
    tmp = tempfile.mkdtemp()
    cu, lib_path = os.path.join(tmp, "edgeconv_cycles.cu"), os.path.join(tmp, "libtc.so")
    with open(cu, "w") as f:
        f.write(instrumented(SOURCE.read_text()))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path, cu], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    entry = lib.hpcs_edgeconv_bf16
    entry.argtypes, entry.restype = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p], ctypes.c_int
    system, _, batches = cs.flagship()
    out = {}
    with torch.no_grad():
        stages = cs.flagship_stages(system, batches[0][0])
        for name in ("stage1_c1", "stage2_c21"):
            x32, idx, w, nc = stages[name]
            x = x32.to(torch.bfloat16)
            b, n, c, _ = x.shape
            got = torch.empty((b, n, 21, 3), dtype=torch.bfloat16, device="cuda")
            work = torch.empty((2, b * n, E.WORKSPACE_ROW), device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                _build.check(entry(x.data_ptr(), idx.data_ptr(), *(t.data_ptr() for t in w),
                                   got.data_ptr(), work.data_ptr(), b, n, c, idx.shape[-1], nc,
                                   0, n, stream), "hpcs_edgeconv_bf16 (instrumented)")

            cycles = (ctypes.c_ulonglong * 8)()
            launch()
            torch.cuda.synchronize()
            lib.hpcs_tc_cycles(cycles)  # reset
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                launch()
            end.record()
            torch.cuda.synchronize()
            lib.hpcs_tc_cycles(cycles)
            cyc = list(cycles)
            out[name] = dict(ms=start.elapsed_time(end) / 20,
                             equal=bool(torch.equal(got, E.edgeconv_infer(x, idx, *w))),
                             blocks=cyc[4] // 20, setup_cycles=cyc[0] / cyc[4],
                             conv1_cycles=cyc[1] / cyc[4], conv2_cycles=cyc[2] / cyc[4],
                             mean_cycles=cyc[3] / cyc[4])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    print(json.dumps(out))
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(dict(card=card, **out), f, indent=1)


if __name__ == "__main__":
    main()
