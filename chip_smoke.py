"""Drive hpcs_torch's eval forward on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py [--json PATH]

Builds the CUDA kernels from hpcs_torch/ops/csrc, then:

1. prints the card's identity;
2. holds kernel B1 (kNN) against knn_plain on synthetic clouds, on the
   model's stage-2/3 features and on DGCNN's (D = 64, the top of B1's D
   range) at B=16, N=1024, k=20, and, index for index, on clouds whose
   scores are exact: integer points that each appear twice (far apart or
   adjacent; D = 3, 63 and 64), a line of points whose rows' scores rise
   (the selection's worst case) and equal points; and times it on clouds
   whose selection work differs, beside the warp queue's insertions per
   row;
3. holds kernel B2 (EdgeConv stage) against edgeconv_infer_plain at the
   three stage shapes of the model: atol 1e-5 / rtol 1e-4 wherever fp32
   can fix the result, and a bound scaled by the conditioning elsewhere
   (hpcs_torch.testing.check_edgeconv); and, in full, against the plain
   twin in float64 on planted inputs whose pre-BatchNorm vectors are near
   the gate's EPS yet exact in fp32 (testing.check_planted_eps); times each
   stage whole and, by kernel under torch.profiler, its projection and its
   edge kernel apart, beside ptxas's registers and spills of each;
4. answers requests of 16 synthetic clouds of 1024 points with the flagship
   model (eucl = hyp = 32, k = 20, 16 categories, random weights and random
   BatchNorm statistics from a seed), counts the kernels' launches, compares
   the output with the plain forward on the card on the same kNN graphs
   (atol 1e-4 / rtol 1e-3 when run from the kernel's stage-1 output; within
   1e-4 + 1e-3 max|output| in full, see forward_diff) and with the plain
   forward on the CPU on a small input, and times both;
5. holds B1's wide route (knn_wide_kernel, the shapes knn_kernel refuses:
   k = 33 and 40, N = 4097 and 8192, D = 128) against knn_plain, index for
   index on the exact-score clouds and up to near-ties on a random one,
   times it beside its bound, and checks that the forward's requests made
   no wide launch;
6. answers the same requests with HypHCSystem.test_step (so3 rotation from
   a seeded generator, labels from the synthetic parts): counts the
   kernels' launches, checks the card's distance matrices against the CPU
   port's (within 1e-6), the card's linkage, prediction, best k and best
   score against the CPU port's from the same distances (exactly), and
   the linkage's heights and sizes against scipy's complete linkage
   (within 1e-6); times the decode and the whole step;
7. trains (phase train): one HypHCSystem.train_step at B=2, N=256 on the
   card against the CPU port from the same weights, triplets and kNN graphs,
   against the card's own float64 step and the CPU's fp32 step in other
   point orders (hpcs_torch.testing.check_train_step_card_vs_cpu); then the flagship
   training step (B=8, N=1024, k=20, eucl = hyp = 32, 50 classes, t_per_anchor
   50, temperature 0.05, lr 0.005, dropout 0.5, so3 rotations; synthetic
   clouds of 6 parts, seed 5): 2 warm-up and 8 timed steps, B1 launched 3
   times a step and B2 never, every loss and parameter finite; a profile of
   2 steps; and trainer.fit for 1 epoch of 2 training batches and 1
   validation batch, whose validation launches B2 3 times;
8. runs the entry points (phase entry) in a temporary working directory
   holding a ShapeNet-Part tree of 4 categories (Airplane, Chair, Table,
   Lamp; 8 / 2 / 8 objects each, hpcs_torch.testing.write_mini_shapenet):
   `python -m hpcs_torch.train`'s main with the flagship flags (N=1024,
   k=20, eucl = hyp = 32, 16 categories, 50 classes, B=8) for 2 epochs,
   again with --resume from its last/ checkpoint for a third, then
   `python -m hpcs_torch.infer shapenet` on final/ for 2 requests of 16
   clouds; checks the metric records, the checkpoints, the restored state,
   infer against trainer.test on the trained system in memory (prediction,
   best k, best score and linkage exactly, the losses within rtol 1e-5)
   and the kernels' launches of each run; times the epochs, the requests
   and the loader;
9. runs the other backbones (phase backbones): DGCNN, PointNet and
   VN-PointNet (eucl 50 = num_class, hyp 32) and VN-DGCNN with max pooling
   (eucl = hyp = 32), each at full width with random weights and BatchNorm
   statistics: 8 requests of 16 clouds through HypHCSystem.embed (B1 4, 0,
   1 and 3 launches per forward, B2 and the wide route none), held against
   the plain forward on the card on B1's graphs (each graph first against
   knn_plain's) and the CPU port on a small input; a training step at B=2,
   N=256 against the CPU port (testing.check_train_step_card_vs_cpu) and
   the flagship step (B=8, dropout 0.5, so3) 2 warm-up + 3 timed; then
   `python -m hpcs_torch.train --model <name>` for 1 epoch on the entry
   phase's tree and `python -m hpcs_torch.infer` on its final/ checkpoint
   (VN-DGCNN max, which has no flag, from a saved checkpoint), equal to
   trainer.test in memory; and --pretrained: a 50-wide VN-DGCNN backbone
   file grafted into a 32-wide model (conv11 swapped), then 1 epoch;
10. runs VN-DGCNN in bf16 (phase bf16, ModelConfig.bf16 on the forward
   phase's weights): 8 requests through HypHCSystem.embed and 8 through
   test_step (B1 and B2 on bf16 features 3 times each per request, no
   fp32 or wide launch), the output against the plain bf16 forward on the
   card on B1's graphs and the CPU port's on a small input (within 3 % of
   the output's largest entry: bf16 roundings that flip between sums in
   another order); B1 on bf16 index for index against B1 on the upcast
   input at the model's three stage inputs and on tie clouds (and
   knn_plain up to near-ties), B2's bf16 route against its plain version
   at the three stage shapes (check_edgeconv widened by one bf16 ulp),
   each timed beside its bound (bf16 features at 2 bytes); the gap between
   the bf16 and fp32 embeddings, the share of each graph they share and
   the decode's best k and score against fp32; a training step at B=2,
   N=256 against the CPU port and the flagship step (B=8, dropout 0.5,
   so3) 2 warm-up + 3 timed; `python -m hpcs_torch.train --bf16` for 1
   epoch on the entry phase's tree and `python -m hpcs_torch.infer` on its
   final/ (bf16 from its config.json), equal to trainer.test in memory;
   the bf16 times beside the fp32 phases' of the same run, and a profile
   of two bf16 requests;
11. prints one JSON line per kernel summary, the card's name and power
   limit, and last {"ok": true, "device": {...}}.

Every phase prints one JSON line; any failure raises and exits non-zero
without the last line.  --json also writes every phase's results to PATH.
"""
import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
B, N, K = 16, 1024, 20
EUCL = HYP = 32
CATEGORIES = 16
REQUESTS = 8  # batches of B clouds answered on the main path (2 warm-up + 6 timed)
WARMUP = 2
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
HBM_BYTES = 3.35e12  # H100 SXM device memory
# fp32 operations of one folded-BN gate on one channel: |p|^2 5, the norm 3,
# a + b / norm 2, p.d 5 and its scaling 1, |d|^2 + EPS 6, the sign test 1,
# the projection's coefficient 2, the three outputs a p - c d 9
GATE_OPS = 34
RESULTS = {}


def fail(msg):
    raise RuntimeError(msg)


def emit(phase, **fields):
    line = {"phase": phase, **fields}
    RESULTS[phase] = line
    print(json.dumps(line), flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() in ms over `reps` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Median host-clock time of fn() in ms, each run ending in a
    synchronize, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return sorted(times)[reps // 2] * 1e3


def kernel_ms(fn, reps):
    """Device time of fn() in ms per call, by kernel (or copy) name, over
    `reps` calls after one warm-up (torch.profiler, CUPTI).  Where the
    profiler sees no device time (it saw none in one of four chip_smoke
    processes run in turn on one H100), the calls' CUDA-event time, under
    the name "all kernels (CUDA events)"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)):
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3 / reps
    return out or {"all kernels (CUDA events)": cuda_ms(fn, reps)}


def ptxas_summary(log):
    """{kernel: {registers, spill_stores, spill_loads}} from nvcc's -Xptxas -v
    output, names demangled by c++filt where it is installed."""
    rows, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            rows[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            rows[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows[name]["registers"] = int(m[1])
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(rows), capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except OSError:
        plain = []
    if len(plain) != len(rows):
        plain = list(rows)
    names = [p.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
             for p in plain]
    return dict(zip(names, rows.values()))


def bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def knn_work(b, n, d, k, feature_bytes=4):
    """The least fp32 operations and the bytes of one kNN launch.

    Per score, D FMAs: the chain starts from -|x_j|^2 and takes 2 x_i, both
    made once per point (3 D operations each).  Selecting the k best takes
    one compare per score against the row's running k-th best.  Bytes: the
    cloud in (feature_bytes a value: 2 for bf16), the indices out.
    """
    return (2 * b * n * n * d + b * n * n + 3 * b * n * d,
            feature_bytes * b * n * d + 4 * b * n * k)


def edgeconv_work(b, n, c, k, n_convs, cout=21, feature_bytes=4):
    """The least fp32 operations and the bytes of one EdgeConv launch.

    conv1 is linear in the edge feature [x_j - x_i || x_i], so W1 e =
    Wa x_j + (Wb - Wa) x_i: both products (and those of Wd1) are made once
    per point, and each edge adds two of them for p and two for d.  Per
    edge then: those adds, the gates, conv2 and its gates, the mean's adds.
    Bytes: the features, indices and weights in, the output out; features
    and output at feature_bytes a value (2 for bf16), the rest 4.
    """
    per_edge = 2 * cout * 3 + cout * GATE_OPS + cout * 3
    if n_convs == 2:
        per_edge += 2 * cout * cout * 3 * 2 + cout * GATE_OPS
    ops = b * n * (k * per_edge + 4 * c * cout * 3 * 2 + cout * 3)
    weights = 2 * cout * 2 * c + 2 * cout + (2 * cout * cout + 2 * cout) * (n_convs == 2)
    nbytes = feature_bytes * (b * n * c * 3 + b * n * cout * 3) + 4 * (b * n * k + weights)
    return ops, nbytes


def knn_check(x, got, want, ties_exact):
    """Equal indices, except entries whose two candidates' exact scores
    differ by at most 1e-6 * the row's max |score|, or by no more than the
    two scores' fp32 rounding can (the bound of a D-term sum; DGCNN's D = 64
    features are positive and large, where that is the wider).  Returns
    (near-tie entries, max |score difference| over mismatches)."""
    mism = got != want
    n_mis = int(mism.sum())
    if n_mis == 0:
        return 0, 0.0
    if ties_exact:
        fail(f"knn: {n_mis} indices differ on the tie cloud")
    b, i, _ = mism.nonzero(as_tuple=True)
    xd = x.double()
    xi = xd[b, i]

    def score(j):
        xj = xd[b, j.long()]
        return 2 * (xi * xj).sum(-1) - (xj * xj).sum(-1)

    def magnitude(j):  # the sum of |terms| of the score's fp32 sums
        xj = xd[b, j.long()]
        return 2 * (xi * xj).abs().sum(-1) + (xj * xj).sum(-1)

    diff = (score(got[mism]) - score(want[mism])).abs()
    rows = 2 * torch.einsum("md,mnd->mn", xi, xd[b]) - (xd[b] ** 2).sum(-1)
    scale = rows.abs().amax(-1)
    # or within the two scores' fp32 rounding: (D + 2) 2^-23 of their
    # terms' magnitudes, for the kernel's order of sums and the plain one's
    rounding = (x.shape[-1] + 2) * 2.0 ** -23 * (magnitude(got[mism]) + magnitude(want[mism]))
    bad = int(((diff > 1e-6 * scale) & (diff > rounding)).sum())
    if bad:
        fail(f"knn: {bad} of {n_mis} differing indices are not near-ties "
             f"(max score gap {float(diff.max()):.3e})")
    return n_mis, float(diff.max())


def forward_diff(got, want, scale_tol=False):
    """(max abs err, count beyond atol 1e-4 / rtol 1e-3) over the pair
    (x_euclidean, x_poincare).  With scale_tol the count is only reported:
    the check is then max |got - want| <= 1e-4 + 1e-3 max |want| per
    tensor, because a forward that includes the ill-conditioned stage-1
    outputs (edgeconv phase) may move a small output by more than its own
    rtol."""
    err, bad = 0.0, 0
    for g, w in zip(got, want):
        d = (g - w).abs()
        err = max(err, float(d.max()))
        bad += int((d > 1e-4 + 1e-3 * w.abs()).sum())
        if scale_tol and float(d.max()) > 1e-4 + 1e-3 * float(w.abs().max()):
            fail(f"forward differs from its reference by {float(d.max()):.3e}, beyond "
                 f"1e-4 + 1e-3 max|ref| = {1e-4 + 1e-3 * float(w.abs().max()):.3e}")
    return err, bad


def profile_calls(fn, calls):
    """Device time by kernel over `calls` calls of fn(i) (torch.profiler,
    CUPTI): the busy share of the wall time and the top kernels by self
    time, per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []  # device-side kernels only: the ops that launch them, and the ranges
    # of user annotations (Optimizer.step) on the device, would count twice
    for e in prof.key_averages():
        ms = e.self_device_time_total / 1e3
        if (e.device_type == torch.autograd.DeviceType.CUDA and ms > 0
                and not getattr(e, "is_user_annotation", False)):
            rows.append((ms, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    return dict(calls=calls, wall_ms_per_call=wall_ms / calls,
                device_ms_per_call=device_ms / calls,
                device_busy_share=device_ms / wall_ms if wall_ms else None,
                kernels_per_call=sum(r[2] for r in rows) / calls,
                top=[dict(name=k[:90], ms_per_call=ms / calls, calls_per_call=c / calls)
                     for ms, k, c in rows[:12]])


def randomize_bn(net, gen):
    """Random BatchNorm affines and running statistics from `gen`."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.2 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))


# the other backbones at full width: ModelConfig fields, B1 launches per forward
BACKBONES = {
    "dgcnn_partseg": (dict(model_name="dgcnn_partseg", eucl_dim=50), 4),
    "pointnet_partseg": (dict(model_name="pointnet_partseg", eucl_dim=50), 0),
    "vn_pointnet_partseg": (dict(model_name="vn_pointnet_partseg", eucl_dim=50), 1),
    "vn_dgcnn_partseg_max": (dict(model_name="vn_dgcnn_partseg", pooling="max", eucl_dim=EUCL), 3),
}
BACKBONE_TRAIN_TIMED = 3


def backbone_system(fields, **train_fields):
    """A system on the card at full width (50 classes, 16 categories, hyp
    32, k 20), random weights and BatchNorm statistics from SEED."""
    from hpcs_torch.models import HypHCSystem, ModelConfig

    gen = torch.Generator().manual_seed(SEED)
    cfg = ModelConfig(num_class=50, num_categories=CATEGORIES, hyp_dim=HYP, k=K, **fields,
                      **train_fields)
    system = HypHCSystem(cfg, generator=gen)
    randomize_bn(system.net, gen)
    return system


class recorded_knn:
    """Within the block every backbone's kNN graph (`vn_dgcnn.knn`, where
    all of them build it) is B1's and is recorded as (input, graph)."""

    def __init__(self):
        from hpcs_torch.nn.backbones import vn_dgcnn

        self.module, self.pairs = vn_dgcnn, []

    def __enter__(self):
        real = self.real = self.module.knn

        def knn(x, k):
            self.pairs.append((x, real(x, k)))
            return self.pairs[-1][1]

        self.module.knn = knn
        return self.pairs

    def __exit__(self, *exc):
        self.module.knn = self.real


def knn_wide_phase(KN, rng, card):
    """B1's wide route at the shapes knn_kernel refuses, against knn_plain.

    Exact-score clouds (integer points each there twice, far apart or
    adjacent; all-equal points; the line x_j = (j, 0, ...) where N <= 2048
    keeps its scores exact) must match index for index; a Gaussian cloud
    may differ at near-ties only.  Times the kernel on the Gaussian cloud.
    """
    shapes = [(B, 1024, 3, 33), (B, 1024, 3, 40), (4, 4097, 3, 20), (4, 4097, 63, 20),
              (4, 8192, 3, 20), (4, 8192, 63, 20), (B, 1024, 128, 20)]
    rows, gap = [], 0.0
    for b, n, d, k in shapes:
        r = 2 if d > 3 else 8

        def lattice(adjacent):
            half = rng.integers(-r, r + 1, size=(b, (n + 1) // 2, d)).astype(np.float32)
            x = np.repeat(half, 2, axis=1) if adjacent else np.concatenate([half, half], 1)
            return torch.from_numpy(np.ascontiguousarray(x[:, :n])).cuda()

        clouds = {"ties": (lattice(False), True), "adjacent": (lattice(True), True),
                  "equal": (torch.full((b, n, d), 0.5, device="cuda"), True),
                  "gauss": (torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32))
                            .cuda(), False)}
        if n <= 2048:
            line = torch.zeros(b, n, d, device="cuda")
            line[:, :, 0] = torch.arange(n, device="cuda", dtype=torch.float32)
            clouds["line"] = (line, True)
        cases = {}
        for name, (x, exact) in clouds.items():
            before = (KN.knn.launches, KN.knn.wide_launches)
            got = KN.knn(x, k)
            torch.cuda.synchronize()
            if (KN.knn.launches - before[0], KN.knn.wide_launches - before[1]) != (1, 1):
                fail(f"knn_wide: {(b, n, d, k)} did not make one wide launch")
            near, err = knn_check(x, got, KN.knn_plain(x, k), exact)
            gap = max(gap, err)
            cases[name] = dict(differing_near_ties=near, max_score_gap=err)
        x = clouds["gauss"][0]
        ms = cuda_ms(lambda: KN._knn_wide_cuda(x, k), 5)
        plain = cuda_ms(lambda: KN.knn_plain(x, k), 2)
        bound, by = bound_ms(*knn_work(b, n, d, k))
        rows.append(dict(B=b, N=n, D=d, k=k, ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                         roofline_share=bound / ms, cases=cases))
    out = dict(shapes=rows, max_score_gap=gap, ms=sum(r["ms"] for r in rows),
               plain_ms=sum(r["plain_ms"] for r in rows),
               bound_ms=sum(r["bound_ms"] for r in rows), card=card)
    out["bound_by"] = ("operations" if all(r["bound_by"] == "operations" for r in rows)
                       else "bytes")
    emit("knn_wide", **out)
    return out


@torch.no_grad()
def decode_phase(system, cfg, batches, card):
    """HypHCSystem.test_step on the forward phase's requests, then its decode
    held against the CPU port and scipy."""
    from scipy.cluster.hierarchy import linkage as scipy_linkage
    from scipy.spatial.distance import squareform

    from hpcs_torch.decode import (cosine_distance_matrix, decode_leaves, get_optimal_k,
                                   linkage_from_distances_mnn)
    from hpcs_torch.models.base import decode_batch
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN

    requests = [{"points": p, "category": c, "labels": seg} for p, c, seg in batches]
    gen = torch.Generator(device=system.device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    KN.knn.launches = KN.knn.wide_launches = 0
    E.edgeconv_infer.launches = 0
    outs, step_s = [], []
    for req in requests:
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs, ext = system.test_step(req, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        outs.append((logs, ext))
    launches = {"knn": KN.knn.launches, "knn_wide": KN.knn.wide_launches,
                "edgeconv": E.edgeconv_infer.launches}
    if launches != {"knn": 3 * REQUESTS, "knn_wide": 0, "edgeconv": 3 * REQUESTS}:
        fail(f"decode: launch counts {launches}, expected 3 B1 and 3 B2 per request")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

    scale = system.net.scale[0]
    decode_s = []
    for (_, ext), req in zip(outs, requests):
        labels = torch.as_tensor(req["labels"], device=system.device).long()
        torch.cuda.synchronize()
        t = time.perf_counter()
        decode_batch(ext["x_poincare"], labels, scale, cfg.num_class)
        torch.cuda.synchronize()
        decode_s.append(time.perf_counter() - t)
    for logs, ext in outs:
        if ext["linkage"].shape != (B, N - 1, 4) or ext["pred"].shape != (B, N):
            fail("decode: output shapes")
        score = float(logs["score"])
        if not 0.0 <= score <= 1.0:
            fail(f"decode: score {score} outside [0, 1]")
        if not all(bool(torch.isfinite(v)) for v in logs.values()):
            fail(f"decode: non-finite test_step logs {logs}")

    # request 0: the card's distances against the CPU port's, then the card's
    # linkage and sweep against the CPU port's on the card's distances
    ext, labels = outs[0][1], torch.as_tensor(requests[0]["labels"]).long()
    x_p = ext["x_poincare"]
    D = cosine_distance_matrix(decode_leaves(x_p, scale))
    D_cpu = cosine_distance_matrix(decode_leaves(x_p.cpu(), scale.cpu()))
    d_err = float((D.cpu() - D_cpu).abs().max())
    if d_err > 1e-6:
        fail(f"decode: card and CPU distances differ by {d_err:.3e} > 1e-6")
    Z, lockstep, rounds = linkage_from_distances_mnn(D, "complete", return_rounds=True)
    # the decode's parts on request 0, each the median of 3 host-clock runs
    leaves = decode_leaves(x_p, scale)
    parts = {"distances": lambda: cosine_distance_matrix(leaves),
             "linkage": lambda: linkage_from_distances_mnn(D, "complete"),
             "sweep": lambda: get_optimal_k(labels.to(system.device), Z, cfg.num_class)}
    parts_ms = {name: host_ms(fn, 3) for name, fn in parts.items()}
    # the linkage's device time against its wall time, and its kernel count
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        parts["linkage"]()
        torch.cuda.synchronize()
        link_wall = (time.perf_counter() - t) * 1e3
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    link_profile = dict(wall_ms=link_wall,
                        device_ms=sum(e.self_device_time_total for e in dev) / 1e3,
                        kernels=sum(e.count for e in dev))
    # why the norms take their square root in float64: float32 sqrt on the card
    q = torch.rand(1 << 20, generator=torch.Generator().manual_seed(SEED)) + 0.5
    sqrt_mismatch = int((torch.sqrt(q.to(system.device)).cpu() != torch.sqrt(q)).sum())
    Z_cpu = linkage_from_distances_mnn(D.cpu(), "complete")
    if not torch.equal(Z.cpu(), Z_cpu):
        bad = int((Z.cpu() != Z_cpu).any(-1).any(-1).sum())
        fail(f"decode: the card's linkage differs from the CPU port's in {bad} objects")
    if not torch.equal(Z, ext["linkage"]):
        fail("decode: test_step's linkage differs from the decode of its own embeddings")
    sweep = get_optimal_k(labels.to(system.device), Z, cfg.num_class)
    sweep_cpu = get_optimal_k(labels, Z_cpu, cfg.num_class)
    for name, g, c, t in zip(("pred", "best_k", "best_score"), sweep, sweep_cpu,
                             (ext["pred"], ext["best_k"], ext["best_score"])):
        if not (torch.equal(g.cpu(), c) and torch.equal(g, t)):
            fail(f"decode: {name} differs between the card, the CPU port and test_step")
    scipy_h, scipy_sizes = 0.0, True
    for b in range(B):
        D64 = D_cpu[b].double().numpy()
        np.fill_diagonal(D64, 0.0)
        Zs = scipy_linkage(squareform(D64, checks=False), method="complete")
        scipy_h = max(scipy_h, float(np.abs(np.sort(Z_cpu[b, :, 2].double().numpy())
                                            - np.sort(Zs[:, 2])).max()))
        scipy_sizes &= bool(np.array_equal(np.sort(Z_cpu[b, :, 3].numpy()), np.sort(Zs[:, 3])))
    if scipy_h > 1e-6 or not scipy_sizes:
        fail(f"decode: heights differ from scipy's by {scipy_h:.3e} or sizes differ")

    dec = sorted(decode_s[WARMUP:])[len(decode_s[WARMUP:]) // 2]
    step = sorted(step_s[WARMUP:])[len(step_s[WARMUP:]) // 2]
    out = dict(B=B, N=N, requests=REQUESTS, test_rotation=cfg.test_rotation, launches=launches,
               decode_ms_median=dec * 1e3, decode_ms_all=[t * 1e3 for t in decode_s],
               objects_per_s=B / dec, test_step_ms_median=step * 1e3,
               test_step_ms_all=[t * 1e3 for t in step_s],
               decode_parts_ms=parts_ms, linkage_profile=link_profile,
               float32_sqrt_values_differing_from_cpu_of_2_20=sqrt_mismatch,
               mnn_rounds_lockstep=lockstep, mnn_rounds_per_object=rounds.tolist(),
               scores=[float(logs["score"]) for logs, _ in outs],
               test_losses=[float(logs["test_loss"]) for logs, _ in outs],
               best_k=ext["best_k"].tolist(), max_abs_err_d_vs_cpu=d_err,
               max_height_err_vs_scipy=scipy_h, peak_memory_mb=peak_mb, card=card)
    emit("decode", **out)
    return out


TRAIN_B, TRAIN_WARMUP, TRAIN_TIMED = 8, 2, 8


def train_phase(card):
    """The training path on the card: a small step against the CPU port, the
    flagship step timed, a profile of two steps, and trainer.fit."""
    from hpcs_torch import trainer
    from hpcs_torch.data import SyntheticPartDataset
    from hpcs_torch.models import HypHCSystem, ModelConfig
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN
    from hpcs_torch.testing import check_train_step_card_vs_cpu

    def batch_of(data, start, size):
        p, c, seg = data.batch(start, size)
        return {"points": p, "category": c, "labels": seg}

    def counts():
        return {"knn": KN.knn.launches, "knn_wide": KN.knn.wide_launches,
                "edgeconv": E.edgeconv_infer.launches}

    def zero_counts():
        KN.knn.launches = KN.knn.wide_launches = 0
        E.edgeconv_infer.launches = 0

    widths = dict(num_class=50, num_categories=CATEGORIES, eucl_dim=EUCL, hyp_dim=HYP, k=K)
    # 1. one step on the card against the CPU port, B=2, N=256 (8 categories
    # of 6 parts: labels < 48 < 50 classes)
    small = HypHCSystem(ModelConfig(**widths, dropout=0.0, train_rotation="none",
                                    t_per_anchor=50, temperature=0.05),
                        generator=torch.Generator().manual_seed(SEED))
    t = time.perf_counter()
    vs_cpu = check_train_step_card_vs_cpu(
        small, batch_of(SyntheticPartDataset(2, 256, 8, parts_per_object=6, seed=5), 0, 2))
    vs_cpu["seconds"] = time.perf_counter() - t

    # 2. the flagship step, as bench.py's train_step_ms_b8_n1024 configures it
    cfg = ModelConfig(**widths, t_per_anchor=50, temperature=0.05, lr=0.005)
    system = HypHCSystem(cfg, generator=torch.Generator().manual_seed(SEED))
    batch = batch_of(SyntheticPartDataset(TRAIN_B, N, CATEGORIES, parts_per_object=6, seed=5),
                     0, TRAIN_B)
    gen = torch.Generator(device=system.device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    step_s, logs_trace = [], []
    for _ in range(TRAIN_WARMUP + TRAIN_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs = system.train_step(batch, gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        logs_trace.append({k: float(v) for k, v in logs.items()})
    steps = TRAIN_WARMUP + TRAIN_TIMED
    launches = counts()
    if launches != {"knn": 3 * steps, "knn_wide": 0, "edgeconv": 0}:
        fail(f"train: launch counts {launches} over {steps} steps, expected 3 B1 launches a "
             f"step and no B2 or wide kNN launch")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if not all(np.isfinite(v) for logs in logs_trace for v in logs.values()):
        fail("train: non-finite losses")
    if not all(bool(torch.isfinite(p).all()) for p in system.net.parameters()):
        fail("train: non-finite parameters")
    timed = sorted(step_s[TRAIN_WARMUP:])

    # 3. a profile of two steps, and of their parts: the gradients, the
    # optimizer, and the three plain EdgeConv stages forward and backward
    profile = profile_calls(lambda i: system.train_step(batch, gen), 2)
    net = system.net.nn_feat
    pts = torch.as_tensor(batch["points"], device=system.device)
    with torch.no_grad():
        graphs = [KN.knn(pts.contiguous(), K)]
        x1 = net._edge_stage(pts[:, :, None, :], graphs[0], net.conv1, net.conv2)
        graphs.append(KN.knn(x1.reshape(TRAIN_B, N, -1).contiguous(), K))
        x2 = net._edge_stage(x1, graphs[1], net.conv3, net.conv4)
        graphs.append(KN.knn(x2.reshape(TRAIN_B, N, -1).contiguous(), K))

    def edge_stages(_):
        x = pts[:, :, None, :]
        y1 = net._edge_stage(x, graphs[0], net.conv1, net.conv2)
        y2 = net._edge_stage(y1, graphs[1], net.conv3, net.conv4)
        y3 = net._edge_stage(y2, graphs[2], net.conv5)
        (y1.sum() + y2.sum() + y3.sum()).backward()

    parts = {"grads_and_logs": profile_calls(lambda i: system.grads_and_logs(batch, gen), 2),
             "optimizer_step": profile_calls(lambda i: system.apply_gradients(), 2),
             "edge_stages_forward_backward": profile_calls(edge_stages, 2)}
    system.optimizer.zero_grad(set_to_none=True)

    # 4. trainer.fit, 1 epoch: 2 training batches, 1 validation batch (8
    # categories: labels < 50)
    data = SyntheticPartDataset(3 * TRAIN_B, N, 8, parts_per_object=6, seed=5)
    train_batches = [batch_of(data, 0, TRAIN_B), batch_of(data, TRAIN_B, TRAIN_B)]
    zero_counts()
    t = time.perf_counter()
    state, best = trainer.fit(system, train_batches, [batch_of(data, 2 * TRAIN_B, TRAIN_B)],
                              epochs=1, seed=SEED, log=lambda line: None)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    fit_launches = counts()
    if fit_launches != {"knn": 3 * 3, "knn_wide": 0, "edgeconv": 3}:
        fail(f"train: fit's launch counts {fit_launches}, expected 3 B1 a batch and 3 B2 for "
             f"the validation batch")
    if not np.isfinite(best) or state["step"] != system.step:
        fail(f"train: fit returned val_loss {best}, step {state['step']}")
    out = dict(vs_cpu_b2_n256=vs_cpu, B=TRAIN_B, N=N, k=K, eucl=EUCL, hyp=HYP,
               t_per_anchor=50, triplets_per_step=50 * TRAIN_B * N, steps=steps,
               launches=launches, launches_per_step={k: v / steps for k, v in launches.items()},
               train_step_ms_median=timed[len(timed) // 2] * 1e3,
               train_step_ms_all=[t * 1e3 for t in step_s], peak_memory_mb=peak_mb,
               loss_trace=[lg["total_loss"] for lg in logs_trace],
               scale_trace=[lg["scale"] for lg in logs_trace],
               optimizer_params=sum(len(g["params"]) for g in system.optimizer.param_groups),
               profile_2_steps=profile, profile_parts=parts, fit_seconds=fit_s,
               fit_launches=fit_launches,
               fit_val_loss=best, card=card)
    emit("train", **out)
    return out


ENTRY_CATEGORIES = ("Airplane", "Chair", "Table", "Lamp")
ENTRY_SPLITS = (8, 2, 8)  # objects per category: train, val, test
ENTRY_FLAGS = ["--dataset", "shapenet", "--model", "vn_dgcnn_partseg", "--fixed_points", str(N),
               "--k", str(K), "--eucl_embedding", str(EUCL), "--hyp_embedding", str(HYP),
               "--margin", "0.35", "--t_per_anchor", "50", "--temperature", "0.05", "--lr",
               "0.05", "--trade_off", "0.1", "--batch", str(TRAIN_B), "--log", "logs"]


def entry_phase(card):
    """The entry points on the card: train 2 epochs, resume for 1, infer."""
    import tempfile

    from hpcs_torch import infer, train, trainer
    from hpcs_torch.cli import freeze_hierarchy
    from hpcs_torch.data import DataLoader, ShapeNetDataset, fast_txt
    from hpcs_torch.data import loader as loader_module
    from hpcs_torch.models import HypHCSystem, ModelConfig
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN
    from hpcs_torch.testing import check_same_test_outputs, record_test_steps, write_mini_shapenet
    from hpcs_torch.utils.checkpoint import load_config, restore_checkpoint

    passes = []  # host seconds of each pass over a DataLoader, in order
    iterate = loader_module.DataLoader.__iter__

    def timed_iter(self):
        it, total = iterate(self), 0.0
        try:
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                finally:
                    total += time.perf_counter() - t
                yield batch
        finally:
            passes.append(total)

    def run(fn, argv):
        """fn(argv) with every launch count at 0 before; (its result, the
        counts after, its loader passes, seconds)."""
        KN.knn.launches = KN.knn.wide_launches = 0
        E.edgeconv_infer.launches = 0
        del passes[:]
        t = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {"knn": KN.knn.launches, "knn_wide": KN.knn.wide_launches,
                    "edgeconv": E.edgeconv_infer.launches}
        return out, launches, list(passes), seconds

    def expect(name, launches, train_steps, eval_batches):
        want = {"knn": 3 * (train_steps + eval_batches), "knn_wide": 0,
                "edgeconv": 3 * eval_batches}
        if launches != want:
            fail(f"entry: {name} launched {launches}, expected {want}")

    cwd = os.getcwd()
    tmp = tempfile.TemporaryDirectory()
    try:
        t = time.perf_counter()
        write_mini_shapenet(os.path.join(tmp.name, "data", "ShapeNet", "raw"), ENTRY_CATEGORIES,
                            ENTRY_SPLITS, seed=SEED)
        write_s = time.perf_counter() - t
        # the C++ txt parser is built with g++ at first use: build it here,
        # so the first epoch's loader time is the reading alone
        t = time.perf_counter()
        cpp_parser = fast_txt.available()
        parser_build_s = time.perf_counter() - t
        os.chdir(tmp.name)
        loader_module.DataLoader.__iter__ = timed_iter
        n_train, n_val, n_test = (len(ENTRY_CATEGORIES) * n for n in ENTRY_SPLITS)
        steps, val_batches = n_train // TRAIN_B, n_val // TRAIN_B
        test_batches = min(10, -(-n_test // TRAIN_B))
        run_dir = os.path.join("logs", "shapenet_vn_dgcnn_partseg")
        ckpt = os.path.join(run_dir, "checkpoints")

        (_, first_results), l1, p1, s1 = run(train.main, ENTRY_FLAGS + ["--epochs", "2"])
        expect("train (2 epochs)", l1, 2 * steps, 2 * val_batches + test_batches)
        (trained, results), l2, p2, s2 = run(
            train.main, ENTRY_FLAGS + ["--epochs", "3", "--resume", os.path.join(ckpt, "last")])
        expect("train --resume (1 epoch)", l2, steps, val_batches + test_batches)
        with record_test_steps() as served:
            (restored, served_results), l3, p3, s3 = run(infer.main, [
                "shapenet", "--model_path", os.path.join(ckpt, "final"), "--fixed_points",
                str(N), "--batch", str(B), "--test_batches", "2"])
        expect("infer (2 requests)", l3, 0, 2)
        loader_module.DataLoader.__iter__ = iterate

        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        epochs = [r for r in records if "epoch" in r]
        tests = [r for r in records if "epoch" not in r]
        if [r["epoch"] for r in epochs] != [0, 1, 2] or len(tests) != 2:
            fail(f"entry: records of epochs {[r['epoch'] for r in epochs]} and {len(tests)} "
                 f"test records, expected epochs 0, 1, 2 and 2 test records")
        names = {"epoch", "train_total_loss", "loss_metric", "loss_hyp", "train_acc",
                 "train_iou", "scale", "val_loss", "acc", "iou", "lr", "temperature",
                 "epoch_time_s", "step", "_time"}
        for r in epochs:
            if set(r) != names:
                fail(f"entry: epoch record keys {sorted(r)}")
            if not all(np.isfinite(r[k]) for k in ("train_total_loss", "loss_metric", "loss_hyp",
                                                    "val_loss")) or r["scale"] == 1e-3:
                fail(f"entry: epoch record {r}")
        if [r["step"] for r in epochs] != [steps, 2 * steps, 3 * steps]:
            fail(f"entry: steps {[r['step'] for r in epochs]}")
        for r, want in zip(tests, (first_results, results)):
            if set(r) != {"test_loss", "score", "test_acc", "test_iou", "_time"} or any(
                    r[k] != v for k, v in want.items()) or not np.isfinite(r["test_loss"]):
                fail(f"entry: test record {r} against {want}")
        for name in ("best", "last", "final"):
            if sorted(os.listdir(os.path.join(ckpt, name))) != ["config.json", "model.ckpt"]:
                fail(f"entry: checkpoint {name} holds {os.listdir(os.path.join(ckpt, name))}")

        # final/ restored into a fresh system equals the trained one
        cfg_dict = load_config(os.path.join(ckpt, "final"))
        cfg_dict["hierarchy_list"] = freeze_hierarchy(cfg_dict["hierarchy_list"])
        fresh = HypHCSystem(ModelConfig(**cfg_dict), generator=torch.Generator().manual_seed(7))
        restore_checkpoint(os.path.join(ckpt, "final"), fresh)
        for label, sd in (("restored", fresh.state_dict()), ("infer", restored.state_dict())):
            want = trained.state_dict()
            for k, v in want["net"].items():
                if not torch.equal(sd["net"][k], v):
                    fail(f"entry: {label} state differs from the trained one at {k}")
            for p, st in want["optimizer"]["state"].items():
                if not all(torch.equal(sd["optimizer"]["state"][p][k], v)
                           for k, v in st.items() if torch.is_tensor(v)):
                    fail(f"entry: {label} optimizer state differs at parameter {p}")
            if sd["step"] != want["step"]:
                fail(f"entry: {label} step {sd['step']} against {want['step']}")

        # infer against trainer.test on the trained system, same batches and seed
        test_loader = DataLoader(ShapeNetDataset("data/ShapeNet/raw", N, "test"), B,
                                 shuffle=True, seed=SEED)
        with record_test_steps() as in_memory:
            in_memory_results = trainer.test(trained, test_loader, seed=SEED, limit_batches=2)
        try:
            logs_rel = check_same_test_outputs(served, in_memory)
        except AssertionError as e:
            fail(f"entry: infer differs from trainer.test in memory: {e}")
        for c in served:
            if c["linkage"].shape != (B, N - 1, 4) or not 0 <= c["logs"]["score"] <= 1:
                fail("entry: infer's output shapes or score")
    finally:
        loader_module.DataLoader.__iter__ = iterate
        os.chdir(cwd)
        tmp.cleanup()

    epoch_s = [r["epoch_time_s"] for r in epochs]
    # loader passes per run: train and validation per epoch, then the test
    loader_s = [p1[0] + p1[1], p1[2] + p1[3], p2[0] + p2[1]]
    out = dict(categories=list(ENTRY_CATEGORIES), objects_per_split=[n_train, n_val, n_test],
               B_train=TRAIN_B, B_infer=B, N=N, k=K, eucl=EUCL, hyp=HYP,
               train_steps_per_epoch=steps, val_batches=val_batches, test_batches=test_batches,
               launches={"train": l1, "resume": l2, "infer": l3},
               epoch_seconds=epoch_s, loader_seconds_per_epoch=loader_s,
               loader_share_of_epoch=[a / b for a, b in zip(loader_s, epoch_s)],
               txt_parser="C++ (hpcs_torch/data/csrc/fast_txt.cpp)" if cpp_parser
               else "numpy.loadtxt", txt_parser_build_seconds=parser_build_s,
               test_loader_seconds=[p1[4], p2[2]], infer_loader_seconds=p3,
               infer_seconds_per_request=[c["seconds"] for c in served],
               infer_call_seconds=s3, train_call_seconds=[s1, s2],
               write_tree_seconds=write_s, scale=[r["scale"] for r in epochs],
               train_total_loss=[r["train_total_loss"] for r in epochs],
               val_loss=[r["val_loss"] for r in epochs], test_results=[first_results, results],
               infer_results=served_results, in_memory_results=in_memory_results,
               infer_vs_in_memory_max_rel_log_diff=logs_rel, card=card)
    emit("entry", **out)
    return out


BACKBONE_FLAGS = ["--dataset", "shapenet", "--fixed_points", str(N), "--k", str(K),
                  "--hyp_embedding", str(HYP), "--margin", "0.35", "--t_per_anchor", "50",
                  "--temperature", "0.05", "--lr", "0.05", "--trade_off", "0.1", "--batch",
                  str(TRAIN_B), "--epochs", "1", "--log", "logs"]


def backbones_phase(batches, card):
    """The other backbones and VN-DGCNN with max pooling on the card, at
    full width: requests through HypHCSystem.embed against the plain
    forward on the card and the CPU port, a training step against the CPU
    port and the flagship step timed, and the entry points; then the
    pretrained graft.  One line per configuration, then a summary."""
    import contextlib
    import io
    import tempfile

    from hpcs_torch import infer, train, trainer
    from hpcs_torch.cli import add_train_args, configure
    from hpcs_torch.data import DataLoader, ShapeNetDataset, SyntheticPartDataset
    from hpcs_torch.models import HypHCSystem, decode_vector_for_batch
    from hpcs_torch.models.base import init_parameters
    from hpcs_torch.nn.backbones import VNDGCNNPartSeg
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN
    from hpcs_torch.testing import (check_same_test_outputs, check_train_step_card_vs_cpu,
                                    record_test_steps, write_mini_shapenet)
    from hpcs_torch.utils.checkpoint import save_checkpoint

    def zero():
        KN.knn.launches = KN.knn.wide_launches = 0
        E.edgeconv_infer.launches = 0

    def counts():
        return {"knn": KN.knn.launches, "knn_wide": KN.knn.wide_launches,
                "edgeconv": E.edgeconv_infer.launches}

    totals = {"knn": 0, "knn_wide": 0, "edgeconv": 0}

    def expect(what, launches, knn, edgeconv=0):
        want = {"knn": knn, "knn_wide": 0, "edgeconv": edgeconv}
        if launches != want:
            fail(f"backbones: {what} launched {launches}, expected {want}")
        for key in totals:
            totals[key] += launches[key]

    def batch_of(data, start, size):
        p, c, seg = data.batch(start, size)
        return {"points": p, "category": c, "labels": seg}

    rows = {}
    cwd = os.getcwd()
    tmp = tempfile.TemporaryDirectory()
    try:
        write_mini_shapenet(os.path.join(tmp.name, "data", "ShapeNet", "raw"), ENTRY_CATEGORIES,
                            ENTRY_SPLITS, seed=SEED)
        os.chdir(tmp.name)
        n_train, n_val, n_test = (len(ENTRY_CATEGORIES) * n for n in ENTRY_SPLITS)
        steps, val_batches = n_train // TRAIN_B, n_val // TRAIN_B
        test_batches = min(10, -(-n_test // TRAIN_B))
        for name, (fields, per_forward) in BACKBONES.items():
            t_config = time.perf_counter()
            # 1. requests of B clouds through HypHCSystem.embed
            system = backbone_system(fields)
            cfg = system.cfg
            dvs = [decode_vector_for_batch(cfg, {"points": p, "category": c})
                   for p, c, _ in batches]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero()
            outputs, times = [], []
            for (p, _, _), dv in zip(batches, dvs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                outputs.append(system.embed(p, dv))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t)
            launches = counts()
            expect(f"{name}: {REQUESTS} forwards", launches, per_forward * REQUESTS)
            forward_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
            for x_e, x_p in outputs:
                if x_e.shape != (B, N, cfg.eucl_dim) or x_p.shape != (B, N, HYP):
                    fail(f"backbones: {name} output shapes {tuple(x_e.shape)}, {tuple(x_p.shape)}")
                # the log-probability features of PointNet and VN-PointNet
                # saturate expmap0's tanh: their points lie on the ball's
                # edge, up to fp32's rounding of the norm
                if not (torch.isfinite(x_e).all() and torch.isfinite(x_p).all()
                        and (x_p.norm(dim=-1) <= 1 + 1e-6).all()):
                    fail(f"backbones: {name} non-finite embeddings or outside the ball")

            # the plain forward on the card on B1's graphs (each graph held
            # against knn_plain's first), and the CPU port on a small input
            p0, dv0 = batches[0][0], dvs[0]
            with recorded_knn() as pairs:
                system.embed(p0, dv0)
            graph_gap = 0.0
            for x, g in pairs:
                graph_gap = max(graph_gap, knn_check(x, g, KN.knn_plain(x, K), False)[1])
            ref = system.embed(p0, dv0, idx_override=[g for _, g in pairs])
            plain_err, plain_bad = forward_diff(outputs[0], ref)
            if plain_bad:
                fail(f"backbones: {name} differs from the plain forward on B1's graphs: "
                     f"{plain_bad} outputs beyond atol 1e-4 / rtol 1e-3, max {plain_err:.3e}")
            cpu = HypHCSystem(cfg, device="cpu")
            cpu.net.load_state_dict({k: v.cpu() for k, v in system.net.state_dict().items()})
            ps = np.ascontiguousarray(batches[1][0][:2, :256])
            with recorded_knn() as small_pairs:
                gpu_small = system.embed(ps, dvs[1][:2])
            cpu_small = cpu.embed(ps, dvs[1][:2].cpu(),
                                  idx_override=[g.cpu() for _, g in small_pairs])
            cpu_err, cpu_bad = forward_diff([t.cpu() for t in gpu_small], cpu_small,
                                            scale_tol=True)

            # 2. training: one step at B=2, N=256 against the CPU port, then
            # the flagship step (B=8, N=1024, dropout 0.5, so3) timed
            small = backbone_system(fields, dropout=0.0, train_rotation="none",
                                    t_per_anchor=50, temperature=0.05)
            zero()
            t = time.perf_counter()
            vs_cpu = check_train_step_card_vs_cpu(
                small, batch_of(SyntheticPartDataset(2, 256, 8, parts_per_object=6, seed=5),
                                0, 2))
            vs_cpu["seconds"] = time.perf_counter() - t
            expect(f"{name}: the small training step", counts(), per_forward)
            tsys = backbone_system(fields, t_per_anchor=50, temperature=0.05, lr=0.005)
            tbatch = batch_of(SyntheticPartDataset(TRAIN_B, N, CATEGORIES, parts_per_object=6,
                                                   seed=5), 0, TRAIN_B)
            gen = torch.Generator(device=tsys.device).manual_seed(SEED)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero()
            step_s, losses = [], []
            for _ in range(TRAIN_WARMUP + BACKBONE_TRAIN_TIMED):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logs = tsys.train_step(tbatch, gen)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                losses.append({k: float(v) for k, v in logs.items()})
            n_steps = TRAIN_WARMUP + BACKBONE_TRAIN_TIMED
            expect(f"{name}: {n_steps} training steps", counts(), per_forward * n_steps)
            train_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
            if not all(np.isfinite(v) for lg in losses for v in lg.values()):
                fail(f"backbones: {name} non-finite training losses")
            if not all(bool(torch.isfinite(q).all()) for q in tsys.net.parameters()):
                fail(f"backbones: {name} non-finite parameters after training")

            # 3. the entry points: train 1 epoch with --model, then infer
            # from its final/ checkpoint (pooling='max' has no flag: the
            # trained flagship-step system is saved and served)
            if fields.get("pooling") == "max":
                final = os.path.join("ckpt", name)
                save_checkpoint(final, tsys, tsys.cfg)
                trained, train_launches, train_s = tsys, None, None
            else:
                zero()
                t = time.perf_counter()
                trained, _ = train.main(BACKBONE_FLAGS + ["--model", cfg.model_name,
                                                          "--eucl_embedding", "50"])
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t
                train_launches = counts()
                expect(f"{name}: train.main (1 epoch)", train_launches,
                       per_forward * (steps + val_batches + test_batches))
                final = os.path.join("logs", f"shapenet_{cfg.model_name}", "checkpoints",
                                     "final")
            zero()
            with record_test_steps() as served:
                restored, _ = infer.main(["shapenet", "--model_path", final, "--fixed_points",
                                          str(N), "--batch", str(B), "--test_batches", "1"])
            infer_launches = counts()
            expect(f"{name}: infer.main (1 request)", infer_launches, per_forward)
            if type(restored.net.nn_feat) is not type(trained.net.nn_feat) or \
                    restored.cfg.pooling != trained.cfg.pooling:
                fail(f"backbones: {name} restored as {type(restored.net.nn_feat).__name__}")
            loader = DataLoader(ShapeNetDataset("data/ShapeNet/raw", N, "test"), B, shuffle=True,
                                seed=SEED)
            with record_test_steps() as in_memory:
                trainer.test(trained, loader, seed=SEED, limit_batches=1)
            try:
                logs_rel = check_same_test_outputs(served, in_memory)
            except AssertionError as e:
                fail(f"backbones: {name} infer differs from trainer.test in memory: {e}")

            timed = sorted(times[WARMUP:])
            train_timed = sorted(step_s[TRAIN_WARMUP:])
            rows[name] = dict(
                model_name=cfg.model_name, pooling=cfg.pooling, eucl=cfg.eucl_dim, hyp=HYP,
                B=B, N=N, k=K, b1_launches_per_forward=per_forward,
                launches_requests=launches, forward_ms_median=timed[len(timed) // 2] * 1e3,
                forward_ms_all=[t * 1e3 for t in times], clouds_per_s=B / timed[len(timed) // 2],
                forward_peak_memory_mb=forward_peak_mb, graphs_max_score_gap=graph_gap,
                max_ball_norm=max(float(x_p.norm(dim=-1).max()) for _, x_p in outputs),
                max_abs_err_vs_plain_gpu=plain_err, max_abs_err_vs_cpu_small=cpu_err,
                outputs_beyond_elementwise_tol_vs_cpu_small=cpu_bad, train_vs_cpu_b2_n256=vs_cpu,
                train_B=TRAIN_B, train_step_ms_median=train_timed[len(train_timed) // 2] * 1e3,
                train_step_ms_all=[t * 1e3 for t in step_s], train_peak_memory_mb=train_peak_mb,
                loss_trace=[lg["total_loss"] for lg in losses],
                entry_train_launches=train_launches, entry_train_seconds=train_s,
                entry_infer_launches=infer_launches,
                infer_seconds_per_request=[c["seconds"] for c in served],
                infer_vs_in_memory_max_rel_log_diff=logs_rel,
                seconds=time.perf_counter() - t_config, card=card)
            emit(f"backbone_{name}", **rows[name])

        # 4. --pretrained: a 50-wide VN-DGCNN backbone file into a 32-wide model
        gen = torch.Generator().manual_seed(SEED + 1)
        ref = VNDGCNNPartSeg(50, k=K, num_categories=CATEGORIES)
        init_parameters(ref, gen)
        randomize_bn(ref, gen)
        torch.save({f"module.{k}": v for k, v in ref.state_dict().items()}, "backbone.t7")
        flags = BACKBONE_FLAGS + ["--eucl_embedding", str(EUCL), "--pretrained",
                                  "--pretrained_path", "backbone.t7"]
        system, *_ = configure(add_train_args(argparse.ArgumentParser()).parse_args(flags))
        fresh = {k: v.clone() for k, v in system.net.nn_feat.state_dict().items()}
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            train.graft_pretrained(system, "backbone.t7")
        if "(conv11 head re-initialized: width mismatch)" not in out.getvalue():
            fail(f"backbones: --pretrained printed {out.getvalue()!r}")
        grafted = 0
        for k, v in system.net.nn_feat.state_dict().items():
            want = fresh[k] if k.startswith("conv11.") or k.endswith("num_batches_tracked") \
                else ref.state_dict()[k].to(v.device)
            if not torch.equal(v, want):
                fail(f"backbones: --pretrained left {k} unequal to the file's or the model's")
            grafted += not k.startswith("conv11.") and not k.endswith("num_batches_tracked")
        zero()
        t = time.perf_counter()
        _, pretrained_results = train.main(flags)
        torch.cuda.synchronize()
        pretrained_s = time.perf_counter() - t
        pretrained_launches = counts()
        expect("train.main --pretrained (1 epoch)", pretrained_launches,
               3 * (steps + val_batches + test_batches), 3 * (val_batches + test_batches))
    finally:
        os.chdir(cwd)
        tmp.cleanup()
    out = dict(configs=list(rows), launches=totals, pretrained=dict(
        tensors_grafted=grafted, conv11_swapped=True, train_launches=pretrained_launches,
        train_seconds=pretrained_s, test_results=pretrained_results), card=card)
    emit("backbones", **out)
    return out


BF16_SHARE = 0.03  # bf16 outputs against a bf16 reference that rounds elsewhere
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative: two roundings of one fp32 value


def bf16_phase(system, batches, card, fp32):
    """VN-DGCNN in bf16 (ModelConfig.bf16) on the card at the flagship width,
    on the fp32 system's weights: requests through embed and test_step
    (B1 and B2 on bf16 three times each), the output against the plain
    bf16 forward on the card and the CPU port, the kernels' bf16 routes
    against their fp32 routes and plain versions, the readings against
    fp32, a training step against the CPU port and the flagship step
    timed, and the entry points with --bf16."""
    import tempfile

    from hpcs_torch import infer, train, trainer
    from hpcs_torch.data import DataLoader, ShapeNetDataset, SyntheticPartDataset
    from hpcs_torch.models import HypHCSystem, decode_vector_for_batch
    from hpcs_torch.nn.backbones import vn_dgcnn
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN
    from hpcs_torch.testing import (check_edgeconv, check_same_test_outputs,
                                    check_train_step_card_vs_cpu, record_test_steps,
                                    write_mini_shapenet)
    from hpcs_torch.utils.checkpoint import load_config

    bf16 = torch.bfloat16

    def zero():
        KN.knn.launches = KN.knn.wide_launches = KN.knn.bf16_launches = 0
        E.edgeconv_infer.launches = E.edgeconv_infer.bf16_launches = 0

    def counts():
        return {"knn": KN.knn.launches, "knn_bf16": KN.knn.bf16_launches,
                "knn_wide": KN.knn.wide_launches, "edgeconv": E.edgeconv_infer.launches,
                "edgeconv_bf16": E.edgeconv_infer.bf16_launches}

    totals = {"knn_bf16": 0, "edgeconv_bf16": 0}

    def expect(what, launches, knn, edgeconv):
        want = {"knn": knn, "knn_bf16": knn, "knn_wide": 0, "edgeconv": edgeconv,
                "edgeconv_bf16": edgeconv}
        if launches != want:
            fail(f"bf16: {what} launched {launches}, expected {want} (every launch on bf16)")
        for key in totals:
            totals[key] += launches[key]

    def batch_of(data, start, size):
        p, c, seg = data.batch(start, size)
        return {"points": p, "category": c, "labels": seg}

    def share(got, want):
        """max |got - want| over the pair of outputs, as a share of max |want|."""
        return max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
                   for g, w in zip(got, want))

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(system.cfg, bf16=True)
    sys16 = HypHCSystem(cfg)
    sys16.net.load_state_dict(system.net.state_dict())
    dvs = [decode_vector_for_batch(cfg, {"points": p, "category": c}) for p, c, _ in batches]
    requests = [{"points": p, "category": c, "labels": seg} for p, c, seg in batches]

    # 1. the main path: requests through embed, then through test_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    outputs, times = [], []
    for (p, _, _), dv in zip(batches, dvs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outputs.append(sys16.embed(p, dv))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    launches = counts()
    expect(f"{REQUESTS} forwards", launches, 3 * REQUESTS, 3 * REQUESTS)
    forward_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for x_e, x_p in outputs:
        if x_e.shape != (B, N, EUCL) or x_p.shape != (B, N, HYP) or x_e.dtype != torch.float32:
            fail(f"bf16: output {tuple(x_e.shape)} {x_e.dtype}, {tuple(x_p.shape)}")
        if not (torch.isfinite(x_e).all() and torch.isfinite(x_p).all()
                and (x_p.norm(dim=-1) < 1).all()):
            fail("bf16: non-finite embeddings or outside the ball")
    gen = torch.Generator(device=sys16.device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    steps16, step_s = [], []
    for req in requests:
        torch.cuda.synchronize()
        t = time.perf_counter()
        steps16.append(sys16.test_step(req, gen))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    test_launches = counts()
    expect(f"{REQUESTS} test_steps", test_launches, 3 * REQUESTS, 3 * REQUESTS)
    test_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    for logs, ext in steps16:
        if not all(bool(torch.isfinite(v)) for v in logs.values()) or \
                not 0 <= float(logs["score"]) <= 1:
            fail(f"bf16: test_step logs {logs}")
    profile = profile_calls(lambda i: sys16.embed(batches[i][0], dvs[i]), 2)

    # 2. the output against the plain bf16 forward on the card on B1's
    # graphs, and against the CPU port's bf16 forward on a small input
    p0, dv0 = batches[0][0], dvs[0]
    with torch.no_grad(), recorded_knn() as pairs:
        sys16.embed(p0, dv0)
    graphs = [g for _, g in pairs]
    try:
        vn_dgcnn.edgeconv_infer = E.edgeconv_infer_plain
        ref = sys16.embed(p0, dv0, idx_override=graphs)
    finally:
        vn_dgcnn.edgeconv_infer = E.edgeconv_infer
    plain_share = share(outputs[0], ref)
    if plain_share > BF16_SHARE:
        fail(f"bf16: {plain_share:.3e} of the output's largest entry from the plain bf16 "
             f"forward on B1's graphs, beyond {BF16_SHARE}")
    cpu = HypHCSystem(cfg, device="cpu")
    cpu.net.load_state_dict({k: v.cpu() for k, v in system.net.state_dict().items()})
    ps = np.ascontiguousarray(batches[1][0][:2, :256])
    with torch.no_grad(), recorded_knn() as small_pairs:
        gpu_small = sys16.embed(ps, dvs[1][:2])
    cpu_small = cpu.embed(ps, dvs[1][:2].cpu(), idx_override=[g.cpu() for _, g in small_pairs])
    cpu_share = share([t.cpu() for t in gpu_small], cpu_small)
    if cpu_share > BF16_SHARE:
        fail(f"bf16: {cpu_share:.3e} of the output's largest entry from the CPU port's bf16 "
             f"forward, beyond {BF16_SHARE}")

    # 3. the kernels' bf16 routes: B1 index for index its fp32 route on the
    # upcast input (and knn_plain up to near-ties, exactly on the tie
    # clouds); B2 against its plain version at the three stage shapes
    rng = np.random.default_rng(SEED + 16)

    def tie_cloud(d, r):  # integers: exact in bf16 and in every score
        half = rng.integers(-r, r + 1, size=(B, N // 2, d)).astype(np.float32)
        return torch.from_numpy(np.concatenate([half, half], 1)).cuda().to(bf16)

    def adjacent_cloud(d, r):
        half = rng.integers(-r, r + 1, size=(B, N // 2, d)).astype(np.float32)
        return torch.from_numpy(np.repeat(half, 2, axis=1)).cuda().to(bf16)

    knn_cases = {"points_d3": (pairs[0][0], False), "stage2_d63": (pairs[1][0], False),
                 "stage3_d63": (pairs[2][0], False), "ties_d3": (tie_cloud(3, 8), True),
                 "ties_d63": (tie_cloud(63, 2), True), "adjacent_d3": (adjacent_cloud(3, 8), True),
                 "adjacent_d63": (adjacent_cloud(63, 2), True)}
    knn_rows, knn_err = {}, 0.0
    with torch.no_grad():
        for case, (x, ties) in knn_cases.items():
            if x.dtype != bf16:
                fail(f"bf16: the stage input of {case} is {x.dtype}")
            got = KN.knn(x, K)
            if not torch.equal(got, KN.knn(x.float(), K)):
                fail(f"bf16: B1 on bf16 differs from B1 on the upcast input ({case})")
            near, err = knn_check(x.float(), got, KN.knn_plain(x, K), ties)
            knn_err = max(knn_err, err)
            knn_rows[case] = dict(D=x.shape[-1], differing_near_ties_vs_plain=near,
                                  max_score_gap=err)
        knn_ms = {d: cuda_ms(lambda x=x: KN.knn(x, K), 20)
                  for d, x in (("d3", pairs[0][0]), ("d63", pairs[1][0]))}
        knn_plain_ms = {d: cuda_ms(lambda x=x: KN.knn_plain(x, K), 5)
                        for d, x in (("d3", pairs[0][0]), ("d63", pairs[1][0]))}
        net = sys16.net.nn_feat
        weights = [[t.detach() for t in vn_dgcnn.stage_weights(*convs)]
                   for convs in ((net.conv1, net.conv2), (net.conv3, net.conv4), (net.conv5,))]
        stage_in = [pairs[0][0][:, :, None, :].contiguous(),
                    pairs[1][0].reshape(B, N, 21, 3), pairs[2][0].reshape(B, N, 21, 3)]
        ec_rows, ec_err = {}, 0.0
        for st, x, idx, w, nc in zip(("stage1_c1", "stage2_c21", "stage3_c21"), stage_in, graphs,
                                     weights, (2, 2, 1)):
            got = E.edgeconv_infer(x, idx, *w, n_convs=nc)
            want = E.edgeconv_infer_plain(x, idx, *w, n_convs=nc)
            if got.dtype != bf16 or want.dtype != bf16:
                fail(f"bf16: B2 {st} gave {got.dtype}, its plain version {want.dtype}")
            try:
                checked = check_edgeconv(got, want, x, idx, w, nc, rounding=BF16_ULP)
            except AssertionError as e:
                fail(f"bf16: B2 {st}: {e}")
            ec_err = max(ec_err, checked["max_abs_err"])
            ops, nbytes = edgeconv_work(B, N, x.shape[2], K, nc, feature_bytes=2)
            bound, by = bound_ms(ops, nbytes)

            def stage(x=x, idx=idx, w=w, nc=nc):
                return E.edgeconv_infer(x, idx, *w, n_convs=nc)

            parts = kernel_ms(stage, 20)
            ms = sum(parts.values())
            ec_rows[st] = dict(C=x.shape[2], n_convs=nc, **checked, ms=ms,
                               call_ms=cuda_ms(stage, 20), by_kernel_ms=parts,
                               plain_ms=cuda_ms(lambda x=x, idx=idx, w=w, nc=nc:
                                                E.edgeconv_infer_plain(x, idx, *w, n_convs=nc), 5),
                               bound_ms=bound, bound_by=by)

    # 4. readings: bf16 against fp32 on the same weights (request 0)
    with torch.no_grad(), recorded_knn() as pairs32:
        out32 = system.embed(p0, dv0)
    embed_gap = {name: dict(max_share=float((a - b).abs().max() / b.abs().max()),
                            mean_share=float((a - b).abs().mean() / b.abs().mean()))
                 for name, a, b in zip(("x_euclidean", "x_poincare"), outputs[0], out32)}
    graph_agreement = [float(np.mean([len(np.intersect1d(a, b)) / K for a, b in zip(
        g16.cpu().numpy().reshape(-1, K), g32.cpu().numpy().reshape(-1, K))]))
        for g16, (_, g32) in zip(graphs, pairs32)]
    gen32, gen16 = (torch.Generator(device=system.device).manual_seed(SEED + 1) for _ in range(2))
    decode_cmp = []
    for req in requests[:2]:
        l32, e32 = system.test_step(req, gen32)
        l16, e16 = sys16.test_step(req, gen16)
        decode_cmp.append(dict(
            best_k_equal_share=float((e16["best_k"] == e32["best_k"]).float().mean()),
            best_score_mean_abs_delta=float((e16["best_score"] - e32["best_score"]).abs().mean()),
            score_fp32=float(l32["score"]), score_bf16=float(l16["score"])))

    # 5. training: a step at B=2, N=256 against the CPU port, then the
    # flagship step (B=8, N=1024, dropout 0.5, so3) timed
    small = backbone_system(dict(eucl_dim=EUCL, bf16=True), dropout=0.0, train_rotation="none",
                            t_per_anchor=50, temperature=0.05)
    zero()
    t = time.perf_counter()
    vs_cpu = check_train_step_card_vs_cpu(
        small, batch_of(SyntheticPartDataset(2, 256, 8, parts_per_object=6, seed=5), 0, 2))
    vs_cpu["seconds"] = time.perf_counter() - t
    expect("the small training step", counts(), 3, 0)
    tsys = backbone_system(dict(eucl_dim=EUCL, bf16=True), t_per_anchor=50, temperature=0.05,
                           lr=0.005)
    tbatch = batch_of(SyntheticPartDataset(TRAIN_B, N, CATEGORIES, parts_per_object=6, seed=5),
                      0, TRAIN_B)
    tgen = torch.Generator(device=tsys.device).manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero()
    train_s, losses = [], []
    for _ in range(TRAIN_WARMUP + BACKBONE_TRAIN_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs = tsys.train_step(tbatch, tgen)
        torch.cuda.synchronize()
        train_s.append(time.perf_counter() - t)
        losses.append({k: float(v) for k, v in logs.items()})
    n_steps = TRAIN_WARMUP + BACKBONE_TRAIN_TIMED
    expect(f"{n_steps} training steps", counts(), 3 * n_steps, 0)
    train_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if not all(np.isfinite(v) for lg in losses for v in lg.values()) or not all(
            bool(torch.isfinite(q).all()) for q in tsys.net.parameters()):
        fail("bf16: non-finite training losses or parameters")

    # 6. the entry points: train --bf16 for 1 epoch, then infer on its
    # final/ checkpoint (bf16 from its config.json), against trainer.test
    cwd = os.getcwd()
    tmp = tempfile.TemporaryDirectory()
    try:
        write_mini_shapenet(os.path.join(tmp.name, "data", "ShapeNet", "raw"), ENTRY_CATEGORIES,
                            ENTRY_SPLITS, seed=SEED)
        os.chdir(tmp.name)
        n_train, n_val, n_test = (len(ENTRY_CATEGORIES) * n for n in ENTRY_SPLITS)
        steps, val_batches = n_train // TRAIN_B, n_val // TRAIN_B
        test_batches = min(10, -(-n_test // TRAIN_B))
        zero()
        t = time.perf_counter()
        trained, _ = train.main(BACKBONE_FLAGS + ["--eucl_embedding", str(EUCL), "--bf16"])
        torch.cuda.synchronize()
        entry_train_s = time.perf_counter() - t
        entry_train_launches = counts()
        expect("train.main --bf16 (1 epoch)", entry_train_launches,
               3 * (steps + val_batches + test_batches), 3 * (val_batches + test_batches))
        final = os.path.join("logs", "shapenet_vn_dgcnn_partseg", "checkpoints", "final")
        if load_config(final)["bf16"] is not True:
            fail("bf16: final/config.json does not say bf16")
        zero()
        with record_test_steps() as served:
            restored, _ = infer.main(["shapenet", "--model_path", final, "--fixed_points",
                                      str(N), "--batch", str(B), "--test_batches", "1"])
        entry_infer_launches = counts()
        expect("infer.main (1 request)", entry_infer_launches, 3, 3)
        if not (restored.cfg.bf16 and restored.net.nn_feat.compute_dtype == bf16):
            fail("bf16: infer restored an fp32 system")
        loader = DataLoader(ShapeNetDataset("data/ShapeNet/raw", N, "test"), B, shuffle=True,
                            seed=SEED)
        with record_test_steps() as in_memory:
            trainer.test(trained, loader, seed=SEED, limit_batches=1)
        try:
            entry_logs_rel = check_same_test_outputs(served, in_memory)
        except AssertionError as e:
            fail(f"bf16: infer differs from trainer.test in memory: {e}")
    finally:
        os.chdir(cwd)
        tmp.cleanup()

    timed = sorted(times[WARMUP:])
    tst = sorted(step_s[WARMUP:])
    trn = sorted(train_s[TRAIN_WARMUP:])
    w3, w63 = knn_work(B, N, 3, K, feature_bytes=2), knn_work(B, N, 63, K, feature_bytes=2)
    knn_bound = bound_ms(w3[0] + 2 * w63[0], w3[1] + 2 * w63[1])
    ec_ops = sum(edgeconv_work(B, N, r["C"], K, r["n_convs"], feature_bytes=2)[0]
                 for r in ec_rows.values())
    ec_bytes = sum(edgeconv_work(B, N, r["C"], K, r["n_convs"], feature_bytes=2)[1]
                   for r in ec_rows.values())
    out = dict(
        B=B, N=N, k=K, eucl=EUCL, hyp=HYP, requests=REQUESTS, launches=launches,
        test_step_launches=test_launches, launches_main_path=dict(totals),
        forward_ms_median=timed[len(timed) // 2] * 1e3, forward_ms_all=[t * 1e3 for t in times],
        clouds_per_s=B / timed[len(timed) // 2], forward_peak_memory_mb=forward_peak_mb,
        test_step_ms_median=tst[len(tst) // 2] * 1e3, test_step_ms_all=[t * 1e3 for t in step_s],
        test_step_peak_memory_mb=test_peak_mb,
        train_B=TRAIN_B, train_step_ms_median=trn[len(trn) // 2] * 1e3,
        train_step_ms_all=[t * 1e3 for t in train_s], train_peak_memory_mb=train_peak_mb,
        loss_trace=[lg["total_loss"] for lg in losses], fp32_same_call=fp32,
        profile_2_requests=profile,
        share_vs_plain_gpu=plain_share, share_vs_cpu_small=cpu_share, share_limit=BF16_SHARE,
        knn_cases=knn_rows, knn_ms=knn_ms, knn_plain_ms=knn_plain_ms,
        knn_ms_per_forward=knn_ms["d3"] + 2 * knn_ms["d63"],
        knn_plain_ms_per_forward=knn_plain_ms["d3"] + 2 * knn_plain_ms["d63"],
        knn_bound_ms_per_forward=knn_bound[0], knn_bound_by=knn_bound[1],
        knn_max_score_gap=knn_err, edgeconv_stages=ec_rows,
        edgeconv_ms_per_forward=sum(r["ms"] for r in ec_rows.values()),
        edgeconv_plain_ms_per_forward=sum(r["plain_ms"] for r in ec_rows.values()),
        edgeconv_bound_ms_per_forward=bound_ms(ec_ops, ec_bytes)[0],
        edgeconv_bound_by=bound_ms(ec_ops, ec_bytes)[1], edgeconv_max_abs_err=ec_err,
        edgeconv_rounding=BF16_ULP, embed_gap_vs_fp32=embed_gap,
        graph_agreement_vs_fp32=graph_agreement, decode_vs_fp32=decode_cmp,
        train_vs_cpu_b2_n256=vs_cpu, entry_train_launches=entry_train_launches,
        entry_train_seconds=entry_train_s, entry_infer_launches=entry_infer_launches,
        infer_seconds_per_request=[c["seconds"] for c in served],
        infer_vs_in_memory_max_rel_log_diff=entry_logs_rel,
        seconds=time.perf_counter() - t_phase, card=card)
    emit("bf16", **out)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="also write every phase's results to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)

    from hpcs_torch.data import SyntheticPartDataset
    from hpcs_torch.models import HypHCSystem, ModelConfig, decode_vector_for_batch
    from hpcs_torch.nn.backbones import vn_dgcnn
    from hpcs_torch.ops import _build
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN
    from hpcs_torch.testing import check_edgeconv, check_planted_eps, knn_queue_insertions

    t0 = time.time()
    _build.build()
    ptxas = {name: ptxas_summary(_build.build_log(name)) for name in _build.SOURCES}
    emit("build", seconds=round(time.time() - t0, 3), ptxas=ptxas)

    # 1. card identity
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    name = torch.cuda.get_device_name(0)
    emit("card", name=name, nvidia_smi=card, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # the flagship model, random weights and BatchNorm statistics from SEED
    gen = torch.Generator().manual_seed(SEED)
    cfg = ModelConfig(num_class=50, num_categories=CATEGORIES, eucl_dim=EUCL, hyp_dim=HYP, k=K)
    system = HypHCSystem(cfg, generator=gen)
    randomize_bn(system.net, gen)
    data = SyntheticPartDataset(num_objects=B * REQUESTS, npoints=N,
                                num_categories=CATEGORIES, seed=SEED)
    batches = [data.batch(r * B, B) for r in range(REQUESTS)]
    net = system.net.nn_feat
    w12 = [t.detach() for t in vn_dgcnn.stage_weights(net.conv1, net.conv2)]
    w34 = [t.detach() for t in vn_dgcnn.stage_weights(net.conv3, net.conv4)]
    w5 = [t.detach() for t in vn_dgcnn.stage_weights(net.conv5)]

    with torch.no_grad():
        pts = torch.from_numpy(batches[0][0]).to(device).contiguous()
        # stage inputs of the main path for request 0 (kernel graphs)
        idx1 = KN.knn(pts, K)
        x0 = pts[:, :, None, :].contiguous()
        x1 = E.edgeconv_infer(x0, idx1, *w12)
        f1 = x1.reshape(B, N, -1).contiguous()
        idx2 = KN.knn(f1, K)
        x2 = E.edgeconv_infer(x1, idx2, *w34)
        f2 = x2.reshape(B, N, -1).contiguous()
        idx3 = KN.knn(f2, K)

        # 2. kernel B1 against knn_plain.  The tie clouds hold every point
        # twice and lie on an integer lattice, so all their scores are exact
        # in fp32 whatever the order of the sums: indices must be equal.
        rng = np.random.default_rng(SEED)

        def tie_cloud(d, r):
            half = rng.integers(-r, r + 1, size=(B, N // 2, d)).astype(np.float32)
            return torch.from_numpy(np.concatenate([half, half], 1)).to(device)

        def adjacent_cloud(d, r):  # x[2m] == x[2m+1]: ties inside one 32-column group
            half = rng.integers(-r, r + 1, size=(B, N // 2, d)).astype(np.float32)
            return torch.from_numpy(np.repeat(half, 2, axis=1)).to(device)

        # x_j = (j, 0, 0): exact scores 2 i j - j^2 that rise with j up to the
        # row's own column, so the last rows insert nearly every column
        line = torch.zeros(B, N, 3, device=device)
        line[:, :, 0] = torch.arange(N, device=device, dtype=torch.float32)
        # DGCNN's stage-2 and stage-3 inputs: D = 64, the top of B1's D range
        with recorded_knn() as dgcnn_pairs:
            dgcnn = backbone_system(BACKBONES["dgcnn_partseg"][0])
            dgcnn.embed(batches[0][0], decode_vector_for_batch(
                dgcnn.cfg, {"points": batches[0][0], "category": batches[0][1]}))
        d64_2, d64_3 = dgcnn_pairs[2][0], dgcnn_pairs[3][0]
        del dgcnn
        equal = torch.full((B, N, 3), 0.5, device=device)  # all ties: only k columns go in
        gauss = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32)).to(device)
        cases = {"points_d3": (pts, False), "stage2_d63": (f1, False), "stage3_d63": (f2, False),
                 "gauss_d3": (gauss, False), "ties_d3": (tie_cloud(3, 8), True),
                 "ties_d63": (tie_cloud(63, 2), True), "line_d3": (line, True),
                 "adjacent_d3": (adjacent_cloud(3, 8), True),
                 "adjacent_d63": (adjacent_cloud(63, 2), True), "equal_d3": (equal, True),
                 "dgcnn_stage2_d64": (d64_2, False), "dgcnn_stage3_d64": (d64_3, False),
                 "ties_d64": (tie_cloud(64, 2), True), "adjacent_d64": (adjacent_cloud(64, 2), True)}
        knn_rows, knn_err = {}, 0.0
        for case, (x, ties) in cases.items():
            got, want = KN.knn(x, K), KN.knn_plain(x, K)
            near, err = knn_check(x, got, want, ties)
            knn_err = max(knn_err, err)
            knn_rows[case] = dict(D=x.shape[-1], differing_near_ties=near, max_score_gap=err)
        # the kernel's time against the selection's data-dependent work: the
        # warp queue's mean insertions per row (every 16th row)
        selection = {case: dict(ms=cuda_ms(lambda x=x: KN.knn(x, K), 20),
                                insertions_per_row=knn_queue_insertions(x, K, row_step=16))
                     for case, x in (("equal_d3", equal), ("gauss_d3", gauss), ("points_d3", pts),
                                     ("line_d3", line), ("stage2_d63", f1), ("stage3_d63", f2),
                                     ("dgcnn_stage2_d64", d64_2))}
        knn_ms = {"d3": selection["points_d3"]["ms"], "d63": selection["stage2_d63"]["ms"],
                  "d64": selection["dgcnn_stage2_d64"]["ms"]}
        plain_ms = {d: cuda_ms(lambda x=x: KN.knn_plain(x, K), 5)
                    for d, x in (("d3", pts), ("d63", f1), ("d64", d64_2))}
        w3, w63 = knn_work(B, N, 3, K), knn_work(B, N, 63, K)
        knn_b = {d: bound_ms(*w) for d, w in (("d3", w3), ("d63", w63),
                                               ("d64", knn_work(B, N, 64, K)))}
        emit("knn", cases=knn_rows, B=B, N=N, k=K, ms=knn_ms, plain_ms=plain_ms,
             bound_ms={d: v[0] for d, v in knn_b.items()}, selection=selection, card=card)

        # 3. kernel B2 against edgeconv_infer_plain at the three stage shapes
        stages = {"stage1_c1": (x0, idx1, w12, 2), "stage2_c21": (x1, idx2, w34, 2),
                  "stage3_c21": (x2, idx3, w5, 1)}
        ec_rows, ec_err = {}, 0.0
        for st, (x, idx, w, nc) in stages.items():
            got = E.edgeconv_infer(x, idx, *w, n_convs=nc)
            want = E.edgeconv_infer_plain(x, idx, *w, n_convs=nc)
            checked = check_edgeconv(got, want, x, idx, w, nc)
            # planted near-EPS inputs at this stage's shape, against float64
            planted = {v: check_planted_eps(E.edgeconv_infer, B, N, K, x.shape[2], nc, v, device)
                       for v in (("conv1", "conv2") if nc == 2 else ("conv1",))}
            ec_err = max(ec_err, checked["max_abs_err"], *planted.values())
            ops, nbytes = edgeconv_work(B, N, x.shape[2], K, nc)
            bound, by = bound_ms(ops, nbytes)

            def stage():
                return E.edgeconv_infer(x, idx, *w, n_convs=nc)

            # the stage's device time by kernel: the projection (C=21), the
            # edge kernel and conv2's weights' copies to constant memory; ms
            # is their sum, call_ms the CUDA-event time of back-to-back calls,
            # which includes the host's time to launch them
            parts = kernel_ms(stage, 20)
            ms = sum(parts.values())
            ec_rows[st] = dict(C=x.shape[2], n_convs=nc, **checked,
                               max_abs_err_planted_eps_vs_float64=planted, ms=ms,
                               call_ms=cuda_ms(stage, 20),
                               projection_ms=sum(v for k, v in parts.items() if "project" in k),
                               edge_kernel_ms=sum(v for k, v in parts.items() if "edge" in k),
                               by_kernel_ms=parts,
                               plain_ms=cuda_ms(lambda: E.edgeconv_infer_plain(
                                   x, idx, *w, n_convs=nc), 5),
                               bound_ms=bound, bound_by=by, roofline_share=bound / ms)
        ec_ms = sum(r["ms"] for r in ec_rows.values())
        ec_bound = sum(r["bound_ms"] for r in ec_rows.values())
        emit("edgeconv", stages=ec_rows, ms_per_forward=ec_ms, bound_ms_per_forward=ec_bound,
             roofline_share=ec_bound / ec_ms, ptxas=ptxas["edgeconv"], atol=1e-5, rtol=1e-4,
             ill_conditioned_below=1e-4, ill_conditioned_limit="1e-5 + 2^-23 max|b| / |p|",
             card=card)

        # 4. the main path: requests through HypHCSystem.embed
        dvs = [decode_vector_for_batch(cfg, {"points": p, "category": cat})
               for p, cat, _ in batches]
        KN.knn.launches = KN.knn.wide_launches = 0
        E.edgeconv_infer.launches = 0
        outputs, times = [], []
        for (p, _, _), dv in zip(batches, dvs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = system.embed(p, dv)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            outputs.append(out)
        launches = {"knn": KN.knn.launches, "knn_wide": KN.knn.wide_launches,
                    "edgeconv": E.edgeconv_infer.launches}
        if launches != {"knn": 3 * REQUESTS, "knn_wide": 0, "edgeconv": 3 * REQUESTS}:
            fail(f"launch counts {launches}, expected 3 B1 and 3 B2 per forward x {REQUESTS} "
                 f"and no wide kNN launch")
        for x_e, x_p in outputs:
            if x_e.shape != (B, N, EUCL) or x_p.shape != (B, N, HYP):
                fail(f"output shapes {tuple(x_e.shape)}, {tuple(x_p.shape)}")
            if not (torch.isfinite(x_e).all() and torch.isfinite(x_p).all()):
                fail("non-finite embeddings")
            if not (x_p.norm(dim=-1) < 1).all():
                fail("Poincare embeddings outside the unit ball")

        # the plain forward on the card, on the kernel's graphs: once in full
        # and once from the kernel's stage-1 output, which isolates the
        # stage-1 outputs that are ill-conditioned in fp32 (edgeconv phase)
        p0, dv0, graphs = batches[0][0], dvs[0], (idx1, idx2, idx3)

        def after_stage1(x, idx, *w, n_convs=2):
            return x1 if x.shape[2] == 1 else E.edgeconv_infer_plain(x, idx, *w, n_convs=n_convs)

        try:
            vn_dgcnn.knn, vn_dgcnn.edgeconv_infer = KN.knn_plain, E.edgeconv_infer_plain
            ref_full = system.embed(p0, dv0, idx_override=graphs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            system.embed(p0, dv0)
            torch.cuda.synchronize()
            plain_forward_s = time.perf_counter() - t
            vn_dgcnn.edgeconv_infer = after_stage1
            ref_after1 = system.embed(p0, dv0, idx_override=graphs)
        finally:
            vn_dgcnn.knn, vn_dgcnn.edgeconv_infer = KN.knn, E.edgeconv_infer
        after1_err, after1_bad = forward_diff(outputs[0], ref_after1)
        if after1_bad:
            fail(f"forward differs from the plain forward run from the kernel's stage-1 "
                 f"output: {after1_bad} outputs beyond atol 1e-4 / rtol 1e-3, max {after1_err:.3e}")
        full_err, full_bad = forward_diff(outputs[0], ref_full, scale_tol=True)

        # the plain forward on the CPU, small input, same weights and graphs
        cpu = HypHCSystem(cfg, device="cpu")
        cpu.net.load_state_dict({k: v.cpu() for k, v in system.net.state_dict().items()})
        small = slice(0, 2), slice(0, 256)
        ps = torch.from_numpy(batches[1][0][small]).to(device).contiguous()
        dvs_small = dvs[1][:2]
        gpu_small = system.embed(ps, dvs_small)
        g1 = KN.knn(ps, K)
        s1 = E.edgeconv_infer(ps[:, :, None, :].contiguous(), g1, *w12)
        g2 = KN.knn(s1.reshape(2, 256, -1).contiguous(), K)
        s2 = E.edgeconv_infer(s1, g2, *w34)
        g3 = KN.knn(s2.reshape(2, 256, -1).contiguous(), K)
        cpu_small = cpu.embed(ps.cpu(), dvs_small, idx_override=(g1.cpu(), g2.cpu(), g3.cpu()))
        cpu_err, cpu_bad = forward_diff([t.cpu() for t in gpu_small], cpu_small, scale_tol=True)

    profile = profile_calls(lambda i: system.embed(batches[i][0], dvs[i]), 2)
    timed = sorted(times[WARMUP:])
    fwd_s = timed[len(timed) // 2]
    emit("forward", B=B, N=N, k=K, eucl=EUCL, hyp=HYP, requests=REQUESTS, launches=launches,
         forward_ms_median=fwd_s * 1e3, forward_ms_all=[t * 1e3 for t in times],
         clouds_per_s=B / fwd_s, plain_forward_ms=plain_forward_s * 1e3,
         max_abs_err_vs_plain_gpu_from_stage1=after1_err, max_abs_err_vs_plain_gpu=full_err,
         outputs_beyond_elementwise_tol_vs_plain_gpu=full_bad,
         max_abs_err_vs_cpu_small=cpu_err, outputs_beyond_elementwise_tol_vs_cpu_small=cpu_bad,
         peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20, card=card)
    emit("profile", **profile, card=card)

    with torch.no_grad():
        wide = knn_wide_phase(KN, rng, card)
    decode = decode_phase(system, cfg, batches, card)
    train = train_phase(card)
    entry = entry_phase(card)
    entry_launches = {k: sum(run[k] for run in entry["launches"].values())
                      for k in ("knn", "knn_wide", "edgeconv")}
    backbones = backbones_phase(batches, card)
    bf16 = bf16_phase(system, batches, card, fp32=dict(
        forward_ms_median=RESULTS["forward"]["forward_ms_median"],
        forward_peak_memory_mb=RESULTS["forward"]["peak_memory_mb"],
        forward_device_ms_per_request=RESULTS["profile"]["device_ms_per_call"],
        forward_kernels_per_request=RESULTS["profile"]["kernels_per_call"],
        test_step_ms_median=decode["test_step_ms_median"],
        test_step_peak_memory_mb=decode["peak_memory_mb"],
        train_step_ms_median=train["train_step_ms_median"],
        train_peak_memory_mb=train["peak_memory_mb"]))

    # 10. summary lines
    knn_total_ms = knn_ms["d3"] + 2 * knn_ms["d63"]
    knn_plain_total = plain_ms["d3"] + 2 * plain_ms["d63"]
    knn_ops = w3[0] + 2 * w63[0]
    knn_bytes = w3[1] + 2 * w63[1]
    ec_ops = ec_bytes = 0
    for st in ec_rows.values():
        o, b_ = edgeconv_work(B, N, st["C"], K, st["n_convs"])
        ec_ops, ec_bytes = ec_ops + o, ec_bytes + b_
    kernels = [
        dict(name="knn", route="cuda", source="hpcs_torch/ops/csrc/knn.cu",
             replaces="hpcs_tpu/ops/pallas/knn_pallas.py:49",
             launches=launches["knn"] + decode["launches"]["knn"] + train["launches"]["knn"]
             + train["fit_launches"]["knn"] + entry_launches["knn"]
             + backbones["launches"]["knn"],
             max_abs_err=knn_err, ms=knn_total_ms, plain_ms=knn_plain_total,
             bound_ms=bound_ms(knn_ops, knn_bytes)[0], bound_by=bound_ms(knn_ops, knn_bytes)[1],
             library_ms=None),
        dict(name="knn_wide", route="cuda", source="hpcs_torch/ops/csrc/knn.cu",
             replaces="hpcs_tpu/ops/pallas/knn_pallas.py:49",
             launches=launches["knn_wide"] + decode["launches"]["knn_wide"]
             + train["launches"]["knn_wide"] + train["fit_launches"]["knn_wide"]
             + entry_launches["knn_wide"] + backbones["launches"]["knn_wide"],
             max_abs_err=wide["max_score_gap"], ms=wide["ms"], plain_ms=wide["plain_ms"],
             bound_ms=wide["bound_ms"], bound_by=wide["bound_by"], library_ms=None),
        dict(name="edgeconv", route="cuda", source="hpcs_torch/ops/csrc/edgeconv.cu",
             replaces="hpcs_tpu/ops/pallas/edgeconv_pallas.py:67",
             launches=launches["edgeconv"] + decode["launches"]["edgeconv"]
             + train["launches"]["edgeconv"] + train["fit_launches"]["edgeconv"]
             + entry_launches["edgeconv"] + backbones["launches"]["edgeconv"],
             max_abs_err=ec_err,
             ms=sum(s["ms"] for s in ec_rows.values()),
             plain_ms=sum(s["plain_ms"] for s in ec_rows.values()),
             bound_ms=bound_ms(ec_ops, ec_bytes)[0], bound_by=bound_ms(ec_ops, ec_bytes)[1],
             library_ms=None),
        dict(name="knn_bf16", route="cuda", source="hpcs_torch/ops/csrc/knn.cu",
             replaces="hpcs_tpu/ops/pallas/knn_pallas.py:49",
             launches=bf16["launches_main_path"]["knn_bf16"],
             max_abs_err=bf16["knn_max_score_gap"], ms=bf16["knn_ms_per_forward"],
             plain_ms=bf16["knn_plain_ms_per_forward"], bound_ms=bf16["knn_bound_ms_per_forward"],
             bound_by=bf16["knn_bound_by"], library_ms=None),
        dict(name="edgeconv_bf16", route="cuda", source="hpcs_torch/ops/csrc/edgeconv.cu",
             replaces="hpcs_tpu/ops/pallas/edgeconv_pallas.py:67",
             launches=bf16["launches_main_path"]["edgeconv_bf16"],
             max_abs_err=bf16["edgeconv_max_abs_err"], ms=bf16["edgeconv_ms_per_forward"],
             plain_ms=bf16["edgeconv_plain_ms_per_forward"],
             bound_ms=bf16["edgeconv_bound_ms_per_forward"], bound_by=bf16["edgeconv_bound_by"],
             library_ms=None),
    ]
    RESULTS["kernels"] = kernels
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(RESULTS, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
