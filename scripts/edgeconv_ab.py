"""Kernel B2 of two checkouts on one GPU, in turns (A, B, B, A).

    python3 scripts/edgeconv_ab.py <checkout A> <checkout B> <output dir>

Each run is a process of its own that imports checkout X's hpcs_torch and
chip_smoke, builds its kernels, makes the flagship's three EdgeConv stage
inputs (chip_smoke.flagship, request_stages: B = 16, N = 1024, k = 20,
random weights from seed 0) and times each stage as the eval forward calls
it (edgeconv_infer on the stage weights), in fp32 and on the same inputs
rounded to bf16: device ms by kernel under torch.profiler (chip_smoke's
kernel_ms, 20 calls) and the CUDA-event ms of back-to-back calls
(cuda_ms).  Run n of X writes <output dir>/X<n>.json (its stages' outputs
go to a temporary directory).  Prints one JSON line per run (each stage's
and each route's ms), then one comparing the runs: the fp32 outputs equal bit for bit
in all four, the bf16 outputs run to run within a checkout, and the
largest bf16 difference between the checkouts.  Exits 1 if a run failed.
"""
import json
import os
import subprocess
import sys


def worker(checkout, out, tensors):
    sys.path.insert(0, checkout)
    os.chdir(checkout)
    import torch

    import chip_smoke as cs
    from hpcs_torch.ops import _build
    from hpcs_torch.ops import edgeconv as E

    _build.build(["knn", "edgeconv"])
    system, _, batches = cs.flagship()
    with torch.no_grad():
        _, idx1, x0, x1, _, idx2, x2, _, idx3, (w12, w34, w5) = cs.request_stages(
            system, batches[0][0])
        stages = {"stage1_c1": (x0, idx1, w12, 2), "stage2_c21": (x1, idx2, w34, 2),
                  "stage3_c21": (x2, idx3, w5, 1)}
        result, outputs = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            route = str(dtype)[6:]
            for st, (x32, idx, w, nc) in stages.items():
                x = x32.to(dtype)

                def stage(x=x, idx=idx, w=w, nc=nc):
                    return E.edgeconv_infer(x, idx, *w, n_convs=nc)

                outputs[f"{route}_{st}"] = stage().cpu()
                parts = cs.kernel_ms(stage, 20)
                result[f"{route}_{st}"] = dict(ms=sum(parts.values()), by_kernel_ms=parts,
                                               call_ms=cs.cuda_ms(stage, 20))
            result[f"{route}_ms_per_forward"] = sum(
                result[f"{route}_{st}"]["ms"] for st in stages)
            result[f"{route}_call_ms_per_forward"] = sum(
                result[f"{route}_{st}"]["call_ms"] for st in stages)
    torch.save(outputs, tensors)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)


def main(a, b, out_dir):
    import tempfile

    import torch

    here = os.path.abspath(__file__)
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    runs, status = {}, 0
    tmp = tempfile.TemporaryDirectory()
    for run in ("A1", "B1", "B2", "A2"):
        checkout = os.path.abspath(a if run[0] == "A" else b)
        out = os.path.join(os.path.abspath(out_dir), f"{run}.json")
        tensors = os.path.join(tmp.name, f"{run}.pt")
        rc = subprocess.run([sys.executable, here, "--worker", checkout, out, tensors]).returncode
        line = {"run": run, "checkout": checkout, "rc": rc}
        if rc == 0:
            with open(out) as f:
                r = json.load(f)
            line.update({k: v if k.endswith("per_forward") else [v["ms"], v["call_ms"]]
                         for k, v in r.items()})
            runs[run] = torch.load(tensors)
        status |= rc != 0
        print(json.dumps(line), flush=True)
    if len(runs) == 4:
        def equal(route, pairs):
            return all(torch.equal(runs[x][k], runs[y][k]) for k in runs["A1"]
                       if k.startswith(route) for x, y in pairs)

        print(json.dumps({
            "card": card,
            "float32_equal_in_all_runs": equal("float32", (("A1", "B1"), ("B1", "B2"),
                                                           ("A1", "A2"))),
            "bfloat16_equal_run_to_run": equal("bfloat16", (("A1", "A2"), ("B1", "B2"))),
            "bfloat16_max_abs_diff_a_b": {
                k: float((runs["A1"][k].float() - runs["B1"][k].float()).abs().max())
                for k in runs["A1"] if k.startswith("bfloat16")}}),
            flush=True)
    tmp.cleanup()
    return status


if __name__ == "__main__":
    if sys.argv[1] == "--worker":
        worker(*sys.argv[2:5])
    else:
        sys.exit(main(*sys.argv[1:4]))
