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
   2 steps; the packed optimizer (FusedRiemannianAdam, what the system
   trains with) against the per-parameter one (RiemannianAdam) on copies
   of the same card gradients and state, within testing.UPDATE_ATOL /
   UPDATE_RTOL, and each one's step alone: kernels and device ms under the
   profiler, and wall ms; and trainer.fit for 1 epoch of 2 training
   batches and 1 validation batch, whose validation launches B2 3 times;
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
11. serves and resumes what hpcs_tpu's users hold (phase import): the
   forward phase's weights after 2 training steps (B=2) and a halved rate,
   written in hpcs_tpu's msgpack format (hpcs_torch.testing.
   write_flax_checkpoint, stored epoch 4), read and timed, served by
   `python -m hpcs_torch.infer synthetic` for 2 requests of 16 clouds
   (equal to trainer.test in memory, as the entry phase holds infer) and
   resumed by `python -m hpcs_torch.train --resume` on a ShapeNet-Part tree
   as the entry phase's (it must start at epoch 5 from the written step,
   moments and rate); a reference Lightning checkpoint of the same weights,
   its backbone class unimportable, through `python -m
   hpcs_torch.import_checkpoint` and infer, equal likewise; and the rest of
   the decode API on 4 flagship objects: linkage in both metrics and
   algorithms, the sequential linkage (complete, single, average) against
   the CPU port exactly and scipy within 1e-6, cut_maxclust,
   cut_maxclust_many and cut_maxclust_fcluster at k = 2..20 (the last equal
   to scipy's fcluster - 1) and eval_clustering in both modes, each against
   the CPU port exactly and timed per object;
12. trains the flagship to convergence (phase trained,
   hpcs_torch.trained_readings): `python -m hpcs_torch.train`'s main with
   the flags of hpcs_tpu's 60-epoch synthetic run
   (benchmarks/results_round2.json) and seed 0 in a temporary working
   directory, then its final/ checkpoint loaded in fp32 and in bf16 and
   served by test_step on 32 held-out synthetic objects (seed 123, 4
   batches of 8): the test score (at least 0.98), test_acc and test_iou,
   the validation loss of every epoch, and each serving's mean best score,
   purity of the best-k cut and best k, with the purity delta (at most
   0.005) and the best-k agreement, beside hpcs_tpu's readings
   (benchmarks/results_round2.json, benchmarks/bf16_quality.json); B1 and
   B2 counted on every batch, in fp32 and bf16; times the epochs and the
   phase;
13. runs hpcs_torch.parallel (phase parallel) at the flagship width: (a)
   the data-parallel step at world size 1 over NCCL (B=8, N=1024, 2
   warm-up + 5 timed steps) against the single-device step from the same
   state and generator: the mean all-reduce the identity bit for bit on
   the first (warm-up) step, the first step's logs equal where the forward
   repeats run to run, and the state within 4 times S, the largest entry
   by which two single-device runs differ (the card's backward is not
   ordered run to run); the timed steps run the real collective, then 5
   more of each step in parts (gradients, all-reduce, update);
   (b) two gloo ranks sharing the card (NCCL refuses two ranks on one
   device): the 2-rank step at B=2, N=256 against the CPU port's 2-rank
   step (testing.check_train_step_card_vs_cpu with the group), the
   flagship step timed, every loss and parameter finite and the ranks'
   parameters equal bit for bit; (c) the sharded test_step on 2 x 8
   flagship objects, whose per-object linkage, prediction, best k and best
   score equal the single-process decode of its embeddings; (d) the
   point-sharded eval forward at B=2, N=4096 over the 2 ranks against the
   unsharded forward (atol 1e-4 / rtol 1e-3), timed beside it, and the
   point-sharded training step at B=2, N=256 against the unsharded step:
   in fp32 the loss within rtol 2e-5 and the ranks equal, in float64
   (knn_plain's graphs) logs and gradients within testing.FLOAT64_WITNESS
   (the fp32 step is ill-conditioned: another order of its sums moves a
   weight by 1.4e-4 where two runs of one order agree); --data_parallel beyond
   the visible GPUs must raise.  Prints the step ms at world sizes 1 and 2,
   the world-size-1 step's parts beside the single-device step's, the
   all-reduce ms per step, each backend and the phase's B1 and B2
   launches, which the kernels line counts;
14. observes (phase observe): (a) `python -m hpcs_torch.train`'s main
   with --profile at the flagship (B=8, N=1024, a ShapeNet-Part tree of 2
   categories: 2 training steps, 1 validation and 1 test batch): one
   trace file holding CUDA kernels and a span for every module of
   VNDGCNNPartSeg, for train_step, eval_step, test_step, embed, decode,
   optimizer.step, knn and edgeconv, every B1 kernel launched inside a
   `knn` span and every B2 kernel inside an `edgeconv` span; its size per
   step and the test request's device ms by module; the flagship step's
   and a B=16 request's ms plain, under the trace and under NaN
   debugging; (b) --debug_nans on a healthy B=2, N=256 run (no raise, and
   every check off afterwards), then a NaN planted in stage 2's conv
   weight (an eval forward must raise naming kernel B2) and in conv6's
   (an eval forward and a training step must raise naming conv6);
   (c) --plot_inference: two PNGs where matplotlib imports, else the
   ImportError before any launch; (d) `python -m
   hpcs_torch.check_invariance` at B=16, N=1024, 8 rotations, fp32 and
   bf16 (its verdict must be PASS), with each stage's graph agreement;
15. prints one JSON line per kernel summary, the card's name and power
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
    from hpcs_torch.testing import (UPDATE_ATOL, UPDATE_RTOL, check_packed_update,
                                    check_train_step_card_vs_cpu)

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

    # 4. the packed optimizer against the per-parameter one on the same card
    # gradients (copies of the system's parameters and state), then each
    # one's step alone: kernels and device ms under the profiler, wall ms
    system.grads_and_logs(batch, gen)
    packed, plain, vs_per_parameter = check_packed_update(system.optimizer)
    optimizer_forms = {name: dict(**profile_calls(lambda i, o=opt: o.step(), 2),
                                  wall_ms=host_ms(opt.step, 5))
                       for name, opt in (("packed", packed), ("per_parameter", plain))}
    optimizer_forms["packed"]["packs"] = len({p.shape[g["ball_dim"]] for g in packed.param_groups
                                              for p in g["params"]})
    system.optimizer.zero_grad(set_to_none=True)

    # 5. trainer.fit, 1 epoch: 2 training batches, 1 validation batch (8
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
               optimizer_packed_vs_per_parameter=vs_per_parameter,
               optimizer_forms=optimizer_forms, update_atol=UPDATE_ATOL, update_rtol=UPDATE_RTOL,
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


IMPORT_EPOCH = 4  # the epoch index the hpcs_tpu-format checkpoint stores
DECODE_OBJECTS = 4  # flagship objects the decode API runs on
REFERENCE_STUB = "reference_hpcs_models_stub"  # unimportable when the file is read


def import_phase(system, cfg, batches, card):
    """What hpcs_tpu's users hold, on the card: an hpcs_tpu-format checkpoint
    (testing.write_flax_checkpoint, flax's msgpack layout) of the forward
    phase's weights after 2 training steps, served by infer and resumed by
    train --resume; a reference Lightning checkpoint imported by
    import_checkpoint and served; the rest of the decode API on 4 flagship
    objects against the CPU port and scipy."""
    import contextlib
    import io
    import tempfile
    import types

    from scipy.cluster.hierarchy import fcluster
    from scipy.cluster.hierarchy import linkage as scipy_linkage
    from scipy.spatial.distance import squareform

    from hpcs_torch import decode as T
    from hpcs_torch import import_checkpoint, infer, train, trainer
    from hpcs_torch.data import DataLoader, SyntheticPartDataset
    from hpcs_torch.models import HypHCSystem, decode_vector_for_batch
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN
    from hpcs_torch.testing import (check_same_test_outputs, record_test_steps,
                                    write_flax_checkpoint, write_mini_shapenet)
    from hpcs_torch.utils import flax_msgpack
    from hpcs_torch.utils.checkpoint import load_config, restore_checkpoint

    t_phase = time.perf_counter()
    launches = {"knn": 0, "knn_wide": 0, "edgeconv": 0}

    def run(what, fn, *args, want=None):
        """fn(*args) with every launch count at 0 before; the counts after
        join the phase's, and must equal `want` where given."""
        KN.knn.launches = KN.knn.wide_launches = 0
        E.edgeconv_infer.launches = 0
        out = fn(*args)
        torch.cuda.synchronize()
        got = {"knn": KN.knn.launches, "knn_wide": KN.knn.wide_launches,
               "edgeconv": E.edgeconv_infer.launches}
        if want is not None and got != want:
            fail(f"import: {what} launched {got}, expected {want}")
        for k in launches:
            launches[k] += got[k]
        return out

    def served(n):  # launches of infer on n requests
        return {"knn": 3 * n, "knn_wide": 0, "edgeconv": 3 * n}

    # the state to write: the forward phase's weights, 2 training steps at
    # B=2 (moments and step), then the rate halved as a plateau would
    src = HypHCSystem(cfg, generator=torch.Generator().manual_seed(SEED))
    src.net.load_state_dict(system.net.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for r in range(2):
        p, c, seg = SyntheticPartDataset(2, N, CATEGORIES, seed=SEED + 20 + r).batch(0, 2)
        src.train_step({"points": p, "category": c, "labels": seg}, gen)
    src.set_learning_rate(cfg.lr / 2)
    lr = src.optimizer.param_groups[0]["lr"]

    def same_state(got, what):
        for k, v in src.net.state_dict().items():
            # num_batches_tracked is not in hpcs_tpu's format (flax has none)
            if not k.endswith("num_batches_tracked") and not torch.equal(got.net.state_dict()[k], v):
                fail(f"import: {what}: {k} differs from the written state")
        named = dict(got.net.named_parameters())
        for name, p in src.net.named_parameters():
            want, have = src.optimizer.state[p], got.optimizer.state[named[name]]
            if have["step"] != want["step"] or not all(
                    torch.equal(have[k], want[k]) for k in ("exp_avg", "exp_avg_sq")):
                fail(f"import: {what}: the moments of {name} differ from the written state")
        if got.step != src.step or any(g["lr"] != float(np.float32(lr))
                                       for g in got.optimizer.param_groups):
            fail(f"import: {what}: step {got.step} or rate differs from {src.step}, {lr}")

    cwd = os.getcwd()
    tmp = tempfile.TemporaryDirectory()
    try:
        # 1. an hpcs_tpu-format checkpoint: read, served, resumed
        flax_dir = os.path.join(tmp.name, "hpcs_tpu_ckpt")
        write_flax_checkpoint(flax_dir, src, cfg, epoch=IMPORT_EPOCH)
        ckpt_file = os.path.join(flax_dir, "model.ckpt")
        size_mb = os.path.getsize(ckpt_file) / 2 ** 20
        read_ms = host_ms(lambda: flax_msgpack.read(ckpt_file), 3)
        fresh = HypHCSystem(cfg, generator=torch.Generator().manual_seed(7))
        restore_ms = host_ms(lambda: restore_checkpoint(flax_dir, fresh), 3)
        if restore_checkpoint(flax_dir, fresh)[0] != IMPORT_EPOCH + 1:
            fail("import: an hpcs_tpu checkpoint must resume at its epoch + 1")
        same_state(fresh, "restore_checkpoint")

        infer_argv = ["synthetic", "--fixed_points", str(N), "--batch", str(B),
                      "--test_batches", "2"]
        t = time.perf_counter()
        with record_test_steps() as served_flax:
            flax_sys, flax_results = run("infer (hpcs_tpu checkpoint)", infer.main,
                                         infer_argv + ["--model_path", flax_dir], want=served(2))
        infer_flax_s = time.perf_counter() - t
        same_state(flax_sys, "infer")
        with record_test_steps() as in_memory:
            in_memory_results = trainer.test(
                src, DataLoader(SyntheticPartDataset(num_objects=32, npoints=N, seed=3), B,
                                shuffle=True, seed=0), seed=0, limit_batches=2)
        try:
            flax_rel = check_same_test_outputs(served_flax, in_memory)
        except AssertionError as e:
            fail(f"import: infer of the hpcs_tpu checkpoint differs from trainer.test: {e}")

        write_mini_shapenet(os.path.join(tmp.name, "data", "ShapeNet", "raw"), ENTRY_CATEGORIES,
                            ENTRY_SPLITS, seed=SEED)
        os.chdir(tmp.name)
        first = []
        original = HypHCSystem.train_step

        def recorded(self, batch, generator):
            if not first:
                try:
                    same_state(self, "the first resumed step")
                    first.append(True)
                except RuntimeError as e:
                    first.append(str(e))
            return original(self, batch, generator)

        n_train, n_val, n_test = (len(ENTRY_CATEGORIES) * n for n in ENTRY_SPLITS)
        steps, val_batches = n_train // TRAIN_B, n_val // TRAIN_B
        test_batches = min(10, -(-n_test // TRAIN_B))
        HypHCSystem.train_step = recorded
        try:
            t = time.perf_counter()
            run("train --resume", train.main,
                ENTRY_FLAGS + ["--epochs", str(IMPORT_EPOCH + 2), "--resume", flax_dir],
                want={"knn": 3 * (steps + val_batches + test_batches), "knn_wide": 0,
                      "edgeconv": 3 * (val_batches + test_batches)})
            resume_s = time.perf_counter() - t
        finally:
            HypHCSystem.train_step = original
        if first != [True]:
            fail(f"import: the resumed run did not start from the written state: {first}")
        with open(os.path.join("logs", "shapenet_vn_dgcnn_partseg", "metrics.jsonl")) as f:
            epochs = [r for r in map(json.loads, f) if "epoch" in r]
        if [r["epoch"] for r in epochs] != [IMPORT_EPOCH + 1] or \
                epochs[0]["step"] != src.step + steps:
            fail(f"import: resumed epochs {[(r['epoch'], r['step']) for r in epochs]}, expected "
                 f"epoch {IMPORT_EPOCH + 1} ending at step {src.step + steps}")

        # 2. a reference Lightning checkpoint, its backbone class unimportable
        stub = types.ModuleType(REFERENCE_STUB)
        stub.VN_DGCNN_partseg = type("VN_DGCNN_partseg", (), {
            "__module__": REFERENCE_STUB, "__qualname__": "VN_DGCNN_partseg"})
        feat = stub.VN_DGCNN_partseg()
        feat.k, feat.out_features, feat.num_categories = K, EUCL, CATEGORIES
        feat.dropout, feat.pooling = cfg.dropout, cfg.pooling
        hparams = dict(euclidean_size=EUCL, hyp_size=HYP, num_class=cfg.num_class, lr=cfg.lr,
                       margin=cfg.margin, t_per_anchor=cfg.t_per_anchor, fraction=cfg.fraction,
                       temperature=cfg.temperature, anneal_factor=cfg.anneal_factor,
                       anneal_step=cfg.anneal_step, trade_off=cfg.trade_off, miner=cfg.miner,
                       cosface=cfg.cosface, nn_feat=feat, nn_emb=None)
        lightning = os.path.join(tmp.name, "lightning.ckpt")
        sys.modules[REFERENCE_STUB] = stub
        try:
            torch.save({"state_dict": {k: v.cpu() for k, v in src.net.state_dict().items()},
                        "hyper_parameters": hparams}, lightning)
        finally:
            del sys.modules[REFERENCE_STUB]
        imported_dir = os.path.join(tmp.name, "imported")
        printed = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            run("import_checkpoint", import_checkpoint.main, [lightning, imported_dir],
                want={"knn": 0, "knn_wide": 0, "edgeconv": 0})
        import_s = time.perf_counter() - t
        got_cfg = load_config(imported_dir)
        want_cfg = dict(eucl_dim=EUCL, hyp_dim=HYP, num_class=cfg.num_class, k=K,
                        model_name="vn_dgcnn_partseg", dataset="shapenet",
                        num_categories=CATEGORIES)
        if any(got_cfg[k] != v for k, v in want_cfg.items()):
            fail(f"import: imported config {got_cfg}, expected {want_cfg}")
        with record_test_steps() as served_ref:
            run("infer (imported Lightning checkpoint)", infer.main,
                infer_argv + ["--model_path", imported_dir], want=served(2))
        try:
            ref_rel = check_same_test_outputs(served_ref, in_memory)
        except AssertionError as e:
            fail(f"import: infer of the imported Lightning checkpoint differs: {e}")
    finally:
        os.chdir(cwd)
        tmp.cleanup()

    # 3. the decode API on the card, on 4 flagship objects
    pts, cat, seg = (a[:DECODE_OBJECTS] for a in batches[0])
    _, x_p = run("embed", src.embed, pts, decode_vector_for_batch(
        cfg, {"points": pts, "category": cat}), want=served(1))
    leaves = T.decode_leaves(x_p, src.net.scale[0].detach())
    labels = torch.as_tensor(seg, device="cuda").long()
    per_obj = {}

    def timed(name, fn):
        per_obj[name] = host_ms(fn, 2) / DECODE_OBJECTS
        return fn()

    def equal(what, got, want):
        if not torch.equal(got.cpu(), want):
            fail(f"import: decode API: {what} differs between the card and the CPU port")

    D = {"cosine": timed("cosine_distance_matrix", lambda: T.cosine_distance_matrix(leaves)),
         "euclidean": timed("euclidean_distance_matrix",
                            lambda: T.euclidean_distance_matrix(leaves))}
    equal("cosine distances", D["cosine"], T.cosine_distance_matrix(leaves.cpu()))
    euclid_gap = float((D["euclidean"].cpu() - T.euclidean_distance_matrix(leaves.cpu()))
                       .abs().max())
    for metric in D:
        for alg, fn in (("mnn", T.linkage_from_distances_mnn),
                        ("sequential", T.linkage_from_distances)):
            Z = timed(f"linkage_{metric}_{alg}", lambda m=metric, a=alg: T.linkage(
                leaves, "complete", m, a))
            equal(f"linkage({metric}, {alg})", Z, fn(D[metric].cpu(), "complete"))
    # scipy's linkage on the same D: heights within 1e-6 for every method;
    # the sizes equal for complete linkage wherever D has no tied distances
    # (equal distances leave the merge order, and so the sizes, to each
    # implementation's tie rule; single and average may also order merges
    # whose fp32 and float64 heights tie differently): reported for all
    Zs, scipy_h, scipy_sizes = {}, 0.0, {}
    upper = torch.triu_indices(N, N, 1)
    tied_pairs = [int((torch.sort(d[upper[0], upper[1]]).values.diff() == 0).sum())
                  for d in D["cosine"].cpu()]
    for method in ("complete", "single", "average"):
        Z = timed(f"linkage_from_distances_{method}",
                  lambda m=method: T.linkage_from_distances(D["cosine"], m))
        Z_cpu = T.linkage_from_distances(D["cosine"].cpu(), method)
        equal(f"linkage_from_distances({method})", Z, Z_cpu)
        Zs[method] = Z
        for b in range(DECODE_OBJECTS):
            D64 = D["cosine"][b].cpu().double().numpy()
            D64 = 0.5 * (D64 + D64.T)
            np.fill_diagonal(D64, 0.0)
            ref = scipy_linkage(squareform(D64, checks=False), method=method)
            scipy_h = max(scipy_h, float(np.abs(np.sort(Z_cpu[b, :, 2].double().numpy())
                                                - np.sort(ref[:, 2])).max()))
            scipy_sizes.setdefault(method, []).append(bool(np.array_equal(
                np.sort(Z_cpu[b, :, 3].numpy()), np.sort(ref[:, 3]))))
    if scipy_h > 1e-6 or any(not same and not ties for same, ties in
                             zip(scipy_sizes["complete"], tied_pairs)):
        fail(f"import: decode API: heights {scipy_h:.3e} from scipy's, or complete linkage's "
             f"sizes differ on tie-free D: {scipy_sizes['complete']}, ties {tied_pairs}")
    # the sequential linkage's launches: N - 1 host-driven steps
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        T.linkage_from_distances(D["cosine"], "complete")
        torch.cuda.synchronize()
    seq_kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0)
    seq_device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3

    Z, Z_cpu = Zs["complete"], Zs["complete"].cpu()
    ks = torch.arange(2, 21, device="cuda")
    many = timed("cut_maxclust_many", lambda: T.cut_maxclust_many(Z, ks))
    equal("cut_maxclust_many", many, T.cut_maxclust_many(Z_cpu, ks.cpu()))
    fcluster_equal = True
    for i, k in enumerate(range(2, 21)):
        cut = T.cut_maxclust(Z, k)
        equal(f"cut_maxclust({k})", cut, T.cut_maxclust(Z_cpu, k))
        if not torch.equal(cut, many[:, i]):
            fail(f"import: decode API: cut_maxclust({k}) differs from cut_maxclust_many")
        fc = T.cut_maxclust_fcluster(Z, k)
        equal(f"cut_maxclust_fcluster({k})", fc, T.cut_maxclust_fcluster(Z_cpu, k))
        for b in range(DECODE_OBJECTS):
            ref = fcluster(Z_cpu[b].double().numpy(), k, "maxclust") - 1
            fcluster_equal &= bool(np.array_equal(fc[b].cpu().numpy(), ref))
    if not fcluster_equal:
        fail("import: decode API: cut_maxclust_fcluster differs from scipy's fcluster - 1")
    per_obj["cut_maxclust_k2_to_20"] = host_ms(
        lambda: [T.cut_maxclust(Z, k) for k in range(2, 21)], 2) / DECODE_OBJECTS
    per_obj["cut_maxclust_fcluster_k2_to_20"] = host_ms(
        lambda: [T.cut_maxclust_fcluster(Z, k) for k in range(2, 21)], 2) / DECODE_OBJECTS
    scores = {}
    for fc in (False, True):
        got = timed(f"eval_clustering_fcluster_ids_{fc}",
                    lambda f=fc: T.eval_clustering(labels, Z, cfg.num_class, f))
        want = T.eval_clustering(labels.cpu(), Z_cpu, cfg.num_class, fc)
        for name, g, w in zip(("ari", "weighted_iou", "purity"), got, want):
            equal(f"eval_clustering(fcluster_ids={fc}) {name}", g, w)
        scores[f"fcluster_ids_{fc}"] = [[float(v) for v in t] for t in got]

    out = dict(B_infer=B, N=N, k=K, eucl=EUCL, hyp=HYP, launches=launches,
               checkpoint_mb=size_mb, read_ms=read_ms, read_mb_per_s=size_mb / read_ms * 1e3,
               restore_ms=restore_ms, stored_epoch=IMPORT_EPOCH, resumed_epoch=IMPORT_EPOCH + 1,
               written_step=src.step, written_lr=lr, infer_seconds_per_request=[
                   c["seconds"] for c in served_flax], infer_call_seconds=infer_flax_s,
               infer_results=flax_results, in_memory_results=in_memory_results,
               infer_vs_in_memory_max_rel_log_diff=[flax_rel, ref_rel],
               resume_call_seconds=resume_s, resume_epoch_seconds=epochs[0]["epoch_time_s"],
               import_checkpoint_seconds=import_s, imported_lines=printed.getvalue().splitlines(),
               decode_objects=DECODE_OBJECTS, decode_ms_per_object=per_obj,
               sequential_linkage_steps=N - 1, sequential_linkage_kernels=seq_kernels,
               sequential_linkage_device_ms=seq_device_ms,
               max_abs_err_euclidean_d_vs_cpu=euclid_gap, max_height_err_vs_scipy=scipy_h,
               sizes_equal_scipy=scipy_sizes, tied_distance_pairs=tied_pairs,
               eval_clustering=scores, seconds=time.perf_counter() - t_phase, card=card)
    emit("import", **out)
    return out


TRAINED_SCORE_GUARD = 0.98  # well under the 0.9969 of hpcs_tpu's converged run
TRAINED_PURITY_DELTA = 0.005  # bench.py's bound on the fp32 / bf16 purity delta
SYNTHETIC_BATCHES = (8, 2, 2)  # batches of 8 in cli.py's synthetic train / val / test splits


def trained_phase(card):
    """The flagship trained to convergence and served in fp32 and bf16
    (hpcs_torch.trained_readings at seed 0), beside hpcs_tpu's readings."""
    import tempfile

    from hpcs_torch import trained_readings
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "benchmarks", "results_round2.json")) as f:
        ref_run = json.load(f)["end_to_end_training_flagship_synthetic"]
    with open(os.path.join(here, "benchmarks", "bf16_quality.json")) as f:
        ref_bf16 = json.load(f)
    KN.knn.launches = KN.knn.wide_launches = KN.knn.bf16_launches = 0
    E.edgeconv_infer.launches = E.edgeconv_infer.bf16_launches = 0
    cwd, tmp = os.getcwd(), tempfile.TemporaryDirectory()
    t = time.perf_counter()
    try:
        os.chdir(tmp.name)
        _, r = trained_readings.run(seed=SEED)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        tmp.cleanup()
    seconds = time.perf_counter() - t
    launches = {"knn": KN.knn.launches, "knn_bf16": KN.knn.bf16_launches,
                "knn_wide": KN.knn.wide_launches, "edgeconv": E.edgeconv_infer.launches,
                "edgeconv_bf16": E.edgeconv_infer.bf16_launches}
    # B1 3 a batch: every training, validation and test batch, and the
    # held-out batches served in fp32 and in bf16; B2 3 a batch of all but
    # the training batches; the bf16 serving on the bf16 routes
    steps, val, test = SYNTHETIC_BATCHES
    held_out = len(trained_readings.held_out_batches(N))
    evals = r["epochs"] * val + test + 2 * held_out
    want = {"knn": 3 * (r["epochs"] * steps + evals), "knn_bf16": 3 * held_out, "knn_wide": 0,
            "edgeconv": 3 * evals, "edgeconv_bf16": 3 * held_out}
    q = r["quality"]
    out = dict(**r, seconds=seconds, launches=launches, launches_expected=want,
               launches_fp32={k: launches[k] - launches[f"{k}_bf16"] for k in ("knn", "edgeconv")},
               epoch_s_median=float(np.median(r["epoch_time_s"])),
               score_guard=TRAINED_SCORE_GUARD, purity_delta_limit=TRAINED_PURITY_DELTA,
               hpcs_tpu=dict(test={k: ref_run[k] for k in ("score", "test_acc", "test_iou")},
                             fp32={k: ref_bf16["fp32"][k] for k in ("score", "purity")},
                             bf16={k: ref_bf16["bf16"][k] for k in ("score", "purity")},
                             purity_delta=abs(ref_bf16["fp32"]["purity"]
                                              - ref_bf16["bf16"]["purity"]),
                             best_k_agreement=ref_bf16["best_k_agreement"]),
               card=card)
    emit("trained", **out)
    if launches != want or r["steps"] != r["epochs"] * steps:
        fail(f"trained: launched {launches} in {r['steps']} steps, expected {want}")
    if not all(np.isfinite(r["val_loss"])):
        fail(f"trained: non-finite validation losses {r['val_loss']}")
    if r["test"]["score"] < TRAINED_SCORE_GUARD:
        fail(f"trained: test score {r['test']['score']:.4f} after {r['epochs']} epochs, below "
             f"{TRAINED_SCORE_GUARD}")
    if q["purity_delta"] > TRAINED_PURITY_DELTA:
        fail(f"trained: fp32 / bf16 purity delta {q['purity_delta']:.5f} over "
             f"{TRAINED_PURITY_DELTA}")
    return out


PAR_WARMUP, PAR_TIMED = 2, 5  # flagship data-parallel steps: warm-up, timed
PAR_TEST_B = 8  # flagship objects per rank in the sharded test_step
PAR_LONG_N = 4096  # the point-sharded forward's cloud (B1 takes N <= 4096)
FACTOR = 4.0  # card-vs-card rule: FACTOR times the spread of the reference step's two runs


def _flagship(**over):
    """The train phase's flagship configuration (random weights from SEED)."""
    from hpcs_torch.models import ModelConfig

    return ModelConfig(num_class=50, num_categories=CATEGORIES, eucl_dim=EUCL, hyp_dim=HYP, k=K,
                       t_per_anchor=50, temperature=0.05, lr=0.005, **over)


def _synthetic(b, n, categories=8, seed=5):
    """b synthetic clouds of n points, 6 parts each; 8 categories keep the
    labels (category * 6 + part) under the flagship's 50 classes."""
    from hpcs_torch.data import SyntheticPartDataset

    p, c, seg = SyntheticPartDataset(b, n, categories, parts_per_object=6, seed=seed).batch(0, b)
    return {"points": p, "category": c, "labels": seg}


def _counts(reset=False):
    """The kernels' launch counts in this process (zeroed with reset)."""
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN

    out = {"knn": KN.knn.launches, "knn_wide": KN.knn.wide_launches,
           "edgeconv": E.edgeconv_infer.launches}
    if reset:
        KN.knn.launches = KN.knn.wide_launches = E.edgeconv_infer.launches = 0
    return out


def _timed_steps(step, batch, gen, system, warmup=PAR_WARMUP):
    """warmup + PAR_TIMED calls of step(batch, gen): (logs of each as
    floats, host ms of each, each ending in a synchronize)."""
    logs, ms = [], []
    for _ in range(warmup + PAR_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logs.append({k: float(v) for k, v in step(batch, gen).items()})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    if not all(np.isfinite(v) for lg in logs for v in lg.values()):
        fail("parallel: non-finite losses")
    if not all(bool(torch.isfinite(p).all()) for p in system.net.parameters()):
        fail("parallel: non-finite parameters")
    return logs, ms


def _split_ms(system, batch, gen, reduce):
    """PAR_TIMED training steps of `system` in parts, each part ending in a
    synchronize: the median host ms of the gradients (grads_and_logs), of
    the mean all-reduce (data_parallel.all_reduce_step over the default
    group, with `reduce`: the data-parallel step's) and of the update."""
    from hpcs_torch.parallel.data_parallel import all_reduce_step

    parts = {"grads": [], "all_reduce": [], "update": []}
    for _ in range(PAR_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = system.grads_and_logs(batch, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if reduce:
            all_reduce_step(system, logs)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        system.apply_gradients()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for name, ms in (("grads", t1 - t0), ("all_reduce", t2 - t1), ("update", t3 - t2)):
            parts[name].append(ms * 1e3)
    return {k: float(np.median(v)) for k, v in parts.items() if reduce or k != "all_reduce"}


def _card_vs_card(got, runs):
    """The card-vs-card rule: each float entry of state_dict `got` within
    FACTOR S of the reference step's first run, S the
    largest entry by which its two runs (`runs`, two state_dicts) differ:
    the card's backward is not ordered run to run (cuBLAS's weight
    gradients), so one run of a step lies up to S from another; S is
    taken over the whole state, since any one entry may agree in two runs
    by chance.  Returns the worst entry as [share of its bound, name] and S."""
    ref = runs[0]
    names = [k for k, v in ref.items() if v.is_floating_point()]
    spread = max(float((runs[1][k].double() - ref[k].double()).abs().max()) for k in names)
    worst = [0.0, ""]
    for name in names:
        gap = (got[name].double() - ref[name].double()).abs()
        share = float(gap.max()) / max(FACTOR * spread, 1e-300) if gap.max() > 0 else 0.0
        if share > worst[0]:
            worst = [share, name]
        if share > 1.0:
            fail(f"parallel: {name} {float(gap.max()):.3e} from the reference step, whose two "
                 f"runs differ by up to {spread:.3e}")
    return worst, spread


def _parallel_nccl():
    """(a) The data-parallel step at world size 1 over NCCL against the
    single-device step from the same state and generator, timed whole and
    in parts beside the single-device step's parts."""
    import copy

    import torch.distributed as dist

    from hpcs_torch.models import HypHCSystem
    from hpcs_torch.parallel import collectives, make_data_parallel_train_step
    from hpcs_torch.parallel.data_parallel import all_reduce_step

    batch = _synthetic(TRAIN_B, N)
    initial = HypHCSystem(_flagship(), generator=torch.Generator().manual_seed(SEED))
    runs, single_ms, first_logs = [], [], []
    for _ in range(2):
        single = copy.deepcopy(initial)
        single_gen = torch.Generator(device=single.device).manual_seed(SEED)
        logs, ms = _timed_steps(single.train_step, batch, single_gen, single)
        runs.append({k: v.clone() for k, v in single.net.state_dict().items()})
        single_ms += ms[PAR_WARMUP:]
        first_logs.append(logs[0])
    system = copy.deepcopy(initial)
    step = make_data_parallel_train_step(system)
    gen = torch.Generator(device=system.device).manual_seed(SEED)
    real, identity = collectives.mean_all_reduce_, []

    def checked(tensors, group=None):  # at world size 1 the mean is the identity
        before = [t.clone() for t in tensors]
        real(tensors, group)
        identity.append(all(torch.equal(a, b) for a, b in zip(before, tensors)))
        return tensors

    # the first warm-up step checks the identity (its clones and compares
    # are outside the timed steps); the others run the real collective
    collectives.mean_all_reduce_ = checked
    try:
        _counts(reset=True)
        first = {k: float(v) for k, v in step(batch, gen).items()}
    finally:
        collectives.mean_all_reduce_ = real
    if identity != [True]:
        fail(f"parallel: the mean all-reduce at world size 1 changed a tensor ({identity})")
    logs, ms = _timed_steps(step, batch, gen, system, warmup=PAR_WARMUP - 1)
    launches = _counts()
    logs = [first] + logs
    reproducible = first_logs[0] == first_logs[1]  # the forward, run to run
    if reproducible and logs[0] != first_logs[0]:
        fail(f"parallel: the world-size-1 step's first logs {logs[0]} differ from the "
             f"single-device step's {first_logs[0]}")
    worst, spread = _card_vs_card(system.net.state_dict(), runs)
    reduce_logs = {k: torch.tensor(v, device=system.device) for k, v in logs[-1].items()}
    allreduce = cuda_ms(lambda: all_reduce_step(system, reduce_logs), 20)
    split = {"data_parallel": _split_ms(system, batch, gen, reduce=True),
             "single_device": _split_ms(single, batch, single_gen, reduce=False)}
    return dict(backend=dist.get_backend(), world=dist.get_world_size(), launches=launches,
                step_ms_median=float(np.median(ms[PAR_WARMUP - 1:])), step_ms_all=ms,
                single_device_step_ms_median=float(np.median(single_ms)),
                all_reduce_ms_per_step=allreduce, step_split_ms=split,
                forward_reproducible=reproducible, all_reduce_identity_steps=len(identity),
                first_step_logs_equal=logs[0] == first_logs[0],
                worst_vs_single_device=worst, single_device_spread=spread)


def _parallel_gloo():
    """(b) 2 ranks sharing the card over gloo: the small step against the
    CPU port's 2-rank step, the flagship step timed and replicated; (c) the
    sharded test_step; (d) the point-sharded forward on a long cloud and the
    point-sharded training step."""
    import torch.distributed as dist

    from hpcs_torch.models import HypHCSystem, decode_vector_for_batch
    from hpcs_torch.models.base import decode_batch
    from hpcs_torch.parallel import (collectives, make_data_parallel_test_step,
                                     make_data_parallel_train_step, make_mesh, make_mesh_2d,
                                     make_point_sharded_forward, make_point_sharded_train_step,
                                     shard_batch, shard_points_batch)
    import copy

    from hpcs_torch.nn.backbones import vn_dgcnn
    from hpcs_torch.ops import knn as KN
    from hpcs_torch.parallel.data_parallel import all_reduce_step, shard_seed
    from hpcs_torch.parallel.point_parallel import PointShard
    from hpcs_torch.testing import (FLOAT64_WITNESS, GRAD_FLOOR, check_train_step_card_vs_cpu,
                                    float64_train_step)

    rank, out, launches = dist.get_rank(), {"backend": dist.get_backend()}, {}
    mesh = make_mesh()

    # (b) the small step, B=2, N=256, against the CPU port's 2-rank step
    small = HypHCSystem(_flagship(dropout=0.0, train_rotation="none"),
                        generator=torch.Generator().manual_seed(SEED))
    t = time.perf_counter()
    out["vs_cpu_b2_n256"] = check_train_step_card_vs_cpu(
        small, shard_batch(mesh, _synthetic(2, 256)), seed=SEED + rank,
        group=mesh.get_group())
    out["vs_cpu_seconds"] = time.perf_counter() - t

    # (b) the flagship step, B=8 (4 a rank), N=1024
    system = HypHCSystem(_flagship(), generator=torch.Generator().manual_seed(SEED))
    step = make_data_parallel_train_step(system, mesh=mesh)
    gen = torch.Generator(device=system.device).manual_seed(shard_seed(SEED, rank))
    _counts(reset=True)
    logs, ms = _timed_steps(step, _synthetic(TRAIN_B, N), gen, system)
    launches["train"] = _counts()
    flat = torch.cat([p.detach().reshape(-1) for p in system.net.parameters()])
    copies = collectives.gather_slots(flat).reshape(2, -1)
    if not torch.equal(copies[0], copies[1]):
        fail("parallel: the 2-rank step left the ranks' parameters apart")
    reduce_logs = {k: torch.tensor(v, device=system.device) for k, v in logs[-1].items()}
    out.update(step_ms_median=float(np.median(ms[PAR_WARMUP:])), step_ms_all=ms,
               loss_trace=[lg["total_loss"] for lg in logs], replicated_bit_for_bit=True,
               all_reduce_ms_per_step=cuda_ms(lambda: all_reduce_step(system, reduce_logs), 20))

    # (c) the sharded test_step, 8 flagship objects a rank
    batch = _synthetic(2 * PAR_TEST_B, N, seed=6)
    tester = make_data_parallel_test_step(system, mesh=mesh)
    _counts(reset=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    test_logs, extras = tester(batch, torch.Generator(device=system.device).manual_seed(
        shard_seed(SEED, rank)))
    torch.cuda.synchronize()
    out["test_step_ms"] = (time.perf_counter() - t) * 1e3
    launches["test_step"] = _counts()
    labels = torch.as_tensor(batch["labels"], device=system.device)
    pred, best_k, best_score, Z = decode_batch(extras["x_poincare"], labels, system.net.scale[0],
                                               system.cfg.num_class)
    for name, got, want in (("linkage", extras["linkage"], Z), ("best_k", extras["best_k"], best_k),
                            ("best_score", extras["best_score"], best_score),
                            ("pred", extras["pred"], pred)):
        if not torch.equal(got, want):
            fail(f"parallel: the sharded test_step's {name} differs from the single-process "
                 "decode of its embeddings")
    out["test_score"] = float(test_logs["score"])

    # (d) the point-sharded eval forward, B=2, N=4096, over the 2 ranks
    points_mesh = make_mesh_2d(1, 2)
    long = _synthetic(2, PAR_LONG_N, seed=7)
    part = shard_points_batch(points_mesh, long)
    forward = make_point_sharded_forward(system, points_mesh)
    dv = decode_vector_for_batch(system.cfg, part)
    _counts(reset=True)
    _, x_p = forward(part["points"], dv)
    launches["point_forward"] = _counts()
    gathered = collectives.gather_slots(x_p, 1)
    _, want = system.embed(long["points"], decode_vector_for_batch(system.cfg, long))
    err = (gathered - want).abs()
    if not bool((err <= 1e-4 + 1e-3 * want.abs()).all()):
        fail(f"parallel: the point-sharded forward is {float(err.max()):.3e} from the unsharded")
    out.update(point_forward_max_abs_err=float(err.max()),
               point_forward_ms=host_ms(lambda: forward(part["points"], dv), 5),
               unsharded_forward_ms=host_ms(lambda: system.embed(
                   long["points"], decode_vector_for_batch(system.cfg, long)), 5))

    # (d) the point-sharded training step, B=2, N=256 (one generator seed on
    # every rank): in fp32 its loss against the unsharded step's and its
    # ranks equal; in float64 (dropout 0, no rotation, knn_plain's graphs:
    # B1 takes no float64) its logs and gradients against the unsharded
    # float64 step's, within testing.FLOAT64_WITNESS of each leaf's scale
    plain = HypHCSystem(_flagship(), generator=torch.Generator().manual_seed(SEED))
    small_batch = _synthetic(2, 256)
    ref_logs = copy.deepcopy(plain).train_step(
        small_batch, torch.Generator(device=plain.device).manual_seed(SEED))
    step = make_point_sharded_train_step(plain, points_mesh)
    part = shard_points_batch(points_mesh, small_batch)
    _counts(reset=True)
    sharded_logs = step(part, torch.Generator(device=plain.device).manual_seed(SEED))
    launches["point_train"] = _counts()
    gap = abs(float(sharded_logs["total_loss"]) / float(ref_logs["total_loss"]) - 1)
    if gap > 2e-5:
        fail(f"parallel: the point-sharded step's loss is {gap:.3e} from the unsharded")
    flat = torch.cat([p.detach().reshape(-1) for p in plain.net.parameters()])
    if not torch.equal(*collectives.gather_slots(flat).reshape(2, -1)):
        fail("parallel: the point-sharded step left the ranks' parameters apart")
    plain64 = HypHCSystem(_flagship(dropout=0.0, train_rotation="none"),
                          generator=torch.Generator().manual_seed(SEED))
    real_knn, vn_dgcnn.knn = vn_dgcnn.knn, KN.knn_plain
    try:
        logs64, grads64, _ = float64_train_step(plain64, small_batch, None, plain64.device)
        got_logs, got_grads, _ = float64_train_step(plain64, part, None, plain64.device,
                                                    shard=PointShard(points_mesh))
    finally:
        vn_dgcnn.knn = real_knn
    top = max(float(np.abs(g).max()) for g in grads64.values())
    worst = max(abs(got_logs[k] / v - 1) for k, v in logs64.items())
    worst_grad = max(float(np.abs(got_grads[k] - g).max()) / max(float(np.abs(g).max()),
                                                                 GRAD_FLOOR * top)
                     for k, g in grads64.items())
    if max(worst, worst_grad) > FLOAT64_WITNESS:
        fail(f"parallel: the point-sharded float64 step's logs {worst:.3e} and gradients "
             f"{worst_grad:.3e} from the unsharded float64 step's")
    out.update(point_train_loss_rel_err=gap, point_train_float64_logs_rel_err=worst,
               point_train_float64_grad_share=worst_grad, launches=launches)
    return out


def parallel_phase(card):
    """hpcs_torch.parallel on the card: (a) one NCCL rank, (b)-(d) two gloo
    ranks sharing the card (NCCL refuses two ranks on one device)."""
    import argparse as _argparse

    from hpcs_torch import cli
    from hpcs_torch.parallel.multihost import run_ranks

    t0 = time.time()
    args = cli.add_train_args(_argparse.ArgumentParser()).parse_args(
        ["--data_parallel", str(torch.cuda.device_count() + 1), "--batch", "64"])
    try:
        cli.data_parallel_size(args)
        fail("parallel: --data_parallel beyond the visible GPUs did not raise")
    except ValueError as e:
        refused = str(e)
    one = run_ranks(_parallel_nccl, 1, backend="nccl", device_ids=[0])[0]
    two = run_ranks(_parallel_gloo, 2, backend="gloo", device_ids=[0, 0])
    launches = {k: one["launches"][k] + sum(sum(part[k] for part in r["launches"].values())
                                            for r in two)
                for k in ("knn", "knn_wide", "edgeconv")}
    want = {"train": {"knn": 3 * (PAR_WARMUP + PAR_TIMED), "knn_wide": 0, "edgeconv": 0},
            "test_step": {"knn": 3, "knn_wide": 0, "edgeconv": 3},
            "point_forward": {"knn": 3, "knn_wide": 0, "edgeconv": 3},
            "point_train": {"knn": 3, "knn_wide": 0, "edgeconv": 0}}
    if any(r["launches"] != want for r in two) or one["launches"] != want["train"]:
        fail(f"parallel: launch counts {[r['launches'] for r in two]} (ranks), "
             f"{one['launches']} (world size 1), expected {want} a rank")
    r0 = two[0]
    out = dict(B=TRAIN_B, N=N, k=K, eucl=EUCL, hyp=HYP, launches=launches,
               backends={"world_size_1": one["backend"], "world_size_2": r0["backend"]},
               step_ms={"world_size_1": one["step_ms_median"], "world_size_2": r0["step_ms_median"],
                        "single_device": one["single_device_step_ms_median"]},
               all_reduce_ms_per_step={"world_size_1": one["all_reduce_ms_per_step"],
                                       "world_size_2": r0["all_reduce_ms_per_step"]},
               step_split_ms_world_size_1=one["step_split_ms"],
               point_forward_ms={"sharded_2_ranks": r0["point_forward_ms"],
                                 "unsharded": r0["unsharded_forward_ms"], "B": 2,
                                 "N": PAR_LONG_N},
               world_size_1=one, ranks=two, refused_beyond_visible=refused,
               rule=f"world size 1: every entry within {FACTOR} S, S the largest entry by "
                    "which two single-device runs differ, the all-reduce the identity on the "
                    "first step; "
                    "point-sharded step: loss rtol 2e-5, in float64 logs and gradients within "
                    "FLOAT64_WITNESS; point-sharded forward atol 1e-4 / rtol 1e-3",
               seconds=time.time() - t0, card=card)
    emit("parallel", **out)
    return out



OBSERVE_SEED = 14  # the observe phase's data, weights and rotations
OBSERVE_SPLITS = (8, 4, 4)  # objects per category (Airplane, Chair): 2 + 1 batches of 8, 1 test
OBSERVE_SMALL_SPLITS = (2, 1, 1)  # B=2: 2 training steps, 1 validation and 1 test batch
OBSERVE_TIMED = 3  # steps (and requests) timed with and without the observers
OBSERVE_ROTATIONS = 8


def _launch_counts(reset=False):
    """fp32 and bf16 launches of B1 (wide route included in knn) and B2."""
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN

    out = {"knn": KN.knn.launches - KN.knn.bf16_launches, "knn_bf16": KN.knn.bf16_launches,
           "knn_wide": KN.knn.wide_launches,
           "edgeconv": E.edgeconv_infer.launches - E.edgeconv_infer.bf16_launches,
           "edgeconv_bf16": E.edgeconv_infer.bf16_launches}
    if reset:
        KN.knn.launches = KN.knn.wide_launches = KN.knn.bf16_launches = 0
        E.edgeconv_infer.launches = E.edgeconv_infer.bf16_launches = 0
    return out


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _span_index(events):
    """{(pid, tid): [(start, end, name)]} of the spans (user annotations)
    on the host's timeline."""
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            spans.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    return spans


def _kernel_spans(events):
    """[(kernel name, device us, [names of the spans around its launch,
    outermost first])] for every kernel: the launch (the CUDA API call
    with the kernel's correlation id) placed inside the host-side spans;
    a kernel whose launch the trace lacks, inside the spans that the
    profiler drew on its stream's device timeline."""
    spans = _span_index(events)
    device_spans = {}
    launches = {}
    for e in events:
        if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
        elif e.get("cat") == "gpu_user_annotation" and e.get("ph") == "X":
            device_spans.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))

    def inside(index, key, ts):
        return [name for start, end, name in sorted(index.get(key, []),
                                                    key=lambda s: (s[0], -s[1]))
                if start <= ts <= end]

    out = []
    for e in events:
        if e.get("cat") != "kernel":
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            around = inside(spans, (launch["pid"], launch["tid"]), launch["ts"])
        else:
            around = inside(device_spans, (e["pid"], e["tid"]), e["ts"])
        out.append((e["name"], e.get("dur", 0.0), around))
    return out


def _by_module(kernels, within, under=None, calls=1):
    """Device ms per call (of `calls`) of the kernels launched inside span
    `within` (inside span `under` when given), by the backbone's module
    (the span path's first two parts: nn_feat.conv6) or kernel span (knn,
    edgeconv) they were launched in."""
    out = {}
    for _, us, around in kernels:
        if within not in around or (under is not None and under not in around):
            continue
        inner = around[around.index(within) + 1:]
        kernel_span = [n for n in inner if n in ("knn", "edgeconv")]
        modules = [n for n in inner if n.startswith(("nn_feat", "nn_emb"))]
        group = (kernel_span[-1] if kernel_span else
                 ".".join(modules[-1].split(".")[:2]) if modules else f"{within} (outside modules)")
        out[group] = out.get(group, 0.0) + us / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _expect_raise(fn, words):
    """fn() must raise FloatingPointError whose message holds every word."""
    try:
        fn()
    except FloatingPointError as e:
        if not all(w in str(e) for w in words):
            fail(f"observe: the NaN error names {str(e)[:300]!r}, expected {words}")
        return str(e)[:300]
    fail(f"observe: no FloatingPointError for a planted NaN (expected one naming {words})")


def observe_phase(card):
    """--profile, --debug_nans, --plot_inference and the SO(3) probe on the
    card: (a) train --profile at the flagship, (b) --debug_nans healthy and
    on planted NaNs, (c) --plot_inference, (d) check_invariance."""
    import tempfile

    from torch.utils._python_dispatch import _get_current_dispatch_mode

    from hpcs_torch import check_invariance, train
    from hpcs_torch.models import HypHCSystem, decode_vector_for_batch
    from hpcs_torch.nn.backbones.vn_dgcnn import VNDGCNNPartSeg
    from hpcs_torch.testing import write_mini_shapenet
    from hpcs_torch.utils import profiling

    t0 = time.time()
    launches = dict.fromkeys(("knn", "knn_bf16", "knn_wide", "edgeconv", "edgeconv_bf16"), 0)

    def counted(fn, *args):
        _launch_counts(reset=True)
        out = fn(*args)
        torch.cuda.synchronize()
        got = _launch_counts()
        for k, v in got.items():
            launches[k] += v
        return out, got

    flags = ENTRY_FLAGS + ["--epochs", "1", "--seed", str(OBSERVE_SEED)]
    cwd, tmp = os.getcwd(), tempfile.TemporaryDirectory()
    out = dict(B=TRAIN_B, N=N, k=K, eucl=EUCL, hyp=HYP)
    try:
        os.chdir(tmp.name)
        # (a) train --profile: 2 training steps, 1 validation and 1 test batch
        write_mini_shapenet(os.path.join("big", "data", "ShapeNet", "raw"), ("Airplane", "Chair"),
                            OBSERVE_SPLITS, seed=OBSERVE_SEED)
        os.chdir("big")
        prof_dir = os.path.abspath("trace")
        t = time.perf_counter()
        _, got = counted(train.main, flags + ["--profile", prof_dir])
        profile_run_s = time.perf_counter() - t
        want = {"knn": 3 * (2 + 1 + 1), "knn_bf16": 0, "knn_wide": 0, "edgeconv": 3 * 2,
                "edgeconv_bf16": 0}
        if got != want:
            fail(f"observe: train --profile launched {got}, expected {want}")
        files = profiling.trace_files(prof_dir)
        if len(files) != 1:
            fail(f"observe: --profile wrote {files}, expected one trace")
        trace_bytes = os.path.getsize(files[0])
        events = _trace_events(files[0])
        names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
        modules = {f"nn_feat.{m}" for m, _ in VNDGCNNPartSeg(EUCL, K, CATEGORIES).named_children()}
        needed = modules | {"nn_emb", "HypHCNet", "train_step", "eval_step", "test_step", "embed",
                            "decode", "optimizer.step", "knn", "edgeconv"}
        if needed - names:
            fail(f"observe: the trace has no span {sorted(needed - names)}")
        kernels = _kernel_spans(events)
        if not kernels:
            fail("observe: the trace holds no CUDA kernel event")
        b1 = [around for name, _, around in kernels if "knn_kernel" in name]
        b2 = [around for name, _, around in kernels
              if "edge_kernel" in name or "edge_mean_kernel" in name]
        if len(b1) != want["knn"] or len(b2) != want["edgeconv"]:
            fail(f"observe: the trace holds {len(b1)} B1 and {len(b2)} B2 kernels, expected "
                 f"{want['knn']} and {want['edgeconv']}")
        if not all("knn" in a for a in b1) or not all("edgeconv" in a for a in b2):
            fail("observe: a B1 or B2 kernel was launched outside its span")
        steps = 2 + 1 + 1
        out["profile"] = dict(
            run_seconds=profile_run_s, trace_bytes=trace_bytes,
            trace_bytes_per_step=trace_bytes / steps, steps=steps, events=len(events),
            kernels=len(kernels), spans=len(names), b1_in_knn_span=len(b1),
            b2_in_edgeconv_span=len(b2),
            test_request_device_ms_by_module=_by_module(kernels, "embed", "test_step"),
            train_step_device_ms=sum(us for _, us, a in kernels if "train_step" in a) / 2e3)
        del events, kernels

        # the observers' cost: flagship steps and requests with and without
        gen = torch.Generator().manual_seed(OBSERVE_SEED)
        system = HypHCSystem(_flagship(), generator=gen)
        batch = _synthetic(TRAIN_B, N, seed=OBSERVE_SEED)
        request = _synthetic(B, N, seed=OBSERVE_SEED + 1)
        dv = decode_vector_for_batch(system.cfg, request)
        step_gen = torch.Generator(device="cuda").manual_seed(OBSERVE_SEED)

        def timed(fn, reps=OBSERVE_TIMED):
            ms = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            return float(np.median(ms))

        def cost():
            step = lambda: system.train_step(batch, step_gen)  # noqa: E731
            embed = lambda: system.embed(request["points"], dv)  # noqa: E731
            step(), embed()
            r = {"step_ms": timed(step), "forward_ms": timed(embed)}
            with profiling.trace(os.path.abspath("cost_trace")):
                r["step_ms_profile"] = timed(step)
                r["forward_ms_profile"] = timed(embed)
            with profiling.nan_debugging():
                step(), embed()
                r["step_ms_debug_nans"] = timed(step)
                r["forward_ms_debug_nans"] = timed(embed)
            r["step_ms_after"] = timed(step)
            r["forward_ms_after"] = timed(embed)
            return r

        out["cost"], _ = counted(cost)
        c = out["cost"]
        out["cost"].update(
            profile_ms_per_step=c["step_ms_profile"] - c["step_ms"],
            debug_nans_step_slowdown=c["step_ms_debug_nans"] / c["step_ms"],
            debug_nans_forward_slowdown=c["forward_ms_debug_nans"] / c["forward_ms"],
            cost_trace_bytes=os.path.getsize(profiling.trace_files("cost_trace")[0]))
        # the flagship request (B=16) by module: the traced requests' kernels
        cost_kernels = _kernel_spans(_trace_events(profiling.trace_files("cost_trace")[0]))
        out["forward_device_ms_by_module"] = _by_module(cost_kernels, "embed",
                                                        calls=OBSERVE_TIMED)
        out["forward_device_ms_traced"] = sum(out["forward_device_ms_by_module"].values())
        del cost_kernels
        os.chdir(tmp.name)

        # (b) --debug_nans: a healthy B=2, N=256 run, then planted NaNs
        write_mini_shapenet(os.path.join("small", "data", "ShapeNet", "raw"),
                            ("Airplane", "Chair"), OBSERVE_SMALL_SPLITS, seed=OBSERVE_SEED)
        os.chdir("small")
        small = flags[:]
        small[small.index("--fixed_points") + 1] = "256"
        small[small.index("--batch") + 1] = "2"
        t = time.perf_counter()
        (_, healthy), got = counted(train.main, small + ["--debug_nans"])
        debug_run_s = time.perf_counter() - t
        if got["knn"] != 3 * (2 + 1 + 1) or got["edgeconv"] != 3 * 2:
            fail(f"observe: train --debug_nans launched {got}")
        off = dict(anomaly=torch.is_anomaly_enabled(),
                   dispatch_mode=_get_current_dispatch_mode() is not None,
                   nan_debugging=profiling.nan_debugging_enabled(),
                   open_spans=profiling.open_spans())
        if any(off.values()):
            fail(f"observe: NaN debugging left on after train.main: {off}")
        planted = HypHCSystem(_flagship(), generator=torch.Generator().manual_seed(OBSERVE_SEED))
        tiny = _synthetic(2, 256, seed=OBSERVE_SEED)
        tiny_dv = decode_vector_for_batch(planted.cfg, tiny)
        net = planted.net.nn_feat

        def with_nan(weight, fn):
            keep = weight.detach().clone()
            with torch.no_grad():
                weight[0, 0] = float("nan")
            try:
                with profiling.nan_debugging():
                    fn()
            finally:
                with torch.no_grad():
                    weight.copy_(keep)

        def embed_tiny():
            planted.embed(tiny["points"], tiny_dv)

        def step_tiny():
            planted.train_step(tiny, torch.Generator(device="cuda").manual_seed(0))

        def errors():
            return dict(
                stage2_eval=_expect_raise(lambda: with_nan(net.conv3.map_to_feat.weight,
                                                           embed_tiny),
                                          ["edgeconv (kernel B2)"]),
                conv6_eval=_expect_raise(lambda: with_nan(net.conv6.map_to_feat.weight,
                                                          embed_tiny), ["conv6"]),
                conv6_train=_expect_raise(lambda: with_nan(net.conv6.map_to_feat.weight,
                                                           step_tiny), ["conv6"]))

        out["debug_nans"], _ = counted(errors)
        out["debug_nans"].update(healthy_run_seconds=debug_run_s, healthy_results=healthy,
                                 state_after=off)
        if _get_current_dispatch_mode() is not None or torch.is_anomaly_enabled():
            fail("observe: NaN debugging left on after the planted cases")

        # (c) --plot_inference: figures where matplotlib imports, else the
        # early ImportError before any step
        try:
            import matplotlib  # noqa: F401
            have_mpl = True
        except ImportError:
            have_mpl = False
        plot_flags = small + ["--plot_inference", "--log", "plot_logs"]
        if have_mpl:
            _, got = counted(train.main, plot_flags)
            plots = sorted(os.listdir(os.path.join("plot_logs", "shapenet_vn_dgcnn_partseg",
                                                   "plots")))
            if plots != ["0.png", "1.png"]:
                fail(f"observe: --plot_inference saved {plots}")
            out["plot_inference"] = dict(matplotlib=True, pngs=plots, launches=got)
        else:
            try:
                counted(train.main, plot_flags)
                fail("observe: --plot_inference without matplotlib did not raise")
            except ImportError as e:
                if "matplotlib" not in str(e):
                    fail(f"observe: --plot_inference's ImportError names {e}")
                err = str(e)
            got = _launch_counts()
            if any(got.values()) or os.path.exists("plot_logs"):
                fail(f"observe: --plot_inference raised after work began: {got}")
            out["plot_inference"] = dict(matplotlib=False, import_error=err,
                                         launches_before_the_error=got)
    finally:
        os.chdir(cwd)
        tmp.cleanup()

    # (d) the SO(3) probe at B=16, N=1024, fp32 and bf16
    invariance = {}
    for name, extra in (("fp32", []), ("bf16", ["--bf16"])):
        argv = ["--batch", str(B), "--fixed_points", str(N), "--k", str(K), "--rotations",
                str(OBSERVE_ROTATIONS), "--seed", str(OBSERVE_SEED)] + extra
        t = time.perf_counter()
        with recorded_knn() as pairs:
            r, got = counted(check_invariance.run, argv)
        embeds = OBSERVE_ROTATIONS + 1
        # each stage's graph under each rotation against the unrotated one's:
        # [rotation][stage] share of rows whose neighbour set is unchanged,
        # and the clouds whose rows all kept theirs in all three stages
        graphs = [torch.sort(g, dim=-1).values for _, g in pairs]
        kept = torch.stack([torch.stack([(graphs[3 * (i + 1) + s] == graphs[s]).all(-1)
                                         for s in range(3)]) for i in range(OBSERVE_ROTATIONS)])
        stage_agreement = kept.float().mean(dim=(2, 3)).tolist()
        clean = kept.all(dim=1).all(dim=-1).tolist()  # [rotation][cloud]
        del pairs, graphs
        want = {"knn": 3 * embeds + embeds if name == "fp32" else embeds,
                "knn_bf16": 0 if name == "fp32" else 3 * embeds, "knn_wide": 0,
                "edgeconv": 3 * embeds if name == "fp32" else 0,
                "edgeconv_bf16": 0 if name == "fp32" else 3 * embeds}
        if got != want:
            fail(f"observe: check_invariance {name} launched {got}, expected {want}")
        if r["verdict"] != "PASS":
            fail(f"observe: check_invariance {name}: {r}")
        # per cloud: clouds whose stage-1 graph is unchanged by the rotation
        # apart from those where some row's neighbour set changed
        pairs = [(d, s) for ds, ss in zip(r["cloud_deviations"], r["cloud_graph_same"])
                 for d, s in zip(ds, ss)]
        same = [d for d, s in pairs if s == 1.0]
        moved = [d for d, s in pairs if s < 1.0]
        still = [d for ds, cs in zip(r["cloud_deviations"], clean) for d, c in zip(ds, cs) if c]
        invariance[name] = dict(
            stage_graph_agreement=stage_agreement, clouds_all_graphs_unchanged=len(still),
            max_relative_all_graphs_unchanged=max(still) / r["scale"] if still else None,
            clouds_graph_unchanged=len(same), clouds_graph_changed=len(moved),
            max_relative_graph_unchanged=max(same) / r["scale"] if same else None,
            max_relative_graph_changed=max(moved) / r["scale"] if moved else None,
            scale=r["scale"], max_deviation=r["max_deviation"],
            median_deviation=r["median_deviation"],
            max_relative=r["max_deviation"] / r["scale"],
            median_relative=r["median_deviation"] / r["scale"],
            graph_agreement_min=r["graph_stability"], graph_agreement=r["graph_same"],
            rel_tol=r["rel_tol"], seconds=time.perf_counter() - t, launches=got)
    out.update(invariance=invariance, launches=launches,
               launches_fp32={"knn": launches["knn"], "edgeconv": launches["edgeconv"]},
               seconds=time.time() - t0, card=card)
    emit("observe", **out)
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
    imp = import_phase(system, cfg, batches, card)
    trained = trained_phase(card)
    par = parallel_phase(card)
    obs = observe_phase(card)

    # 15. summary lines
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
             + backbones["launches"]["knn"] + imp["launches"]["knn"]
             + trained["launches_fp32"]["knn"] + par["launches"]["knn"]
             + obs["launches"]["knn"],
             max_abs_err=knn_err, ms=knn_total_ms, plain_ms=knn_plain_total,
             bound_ms=bound_ms(knn_ops, knn_bytes)[0], bound_by=bound_ms(knn_ops, knn_bytes)[1],
             library_ms=None),
        dict(name="knn_wide", route="cuda", source="hpcs_torch/ops/csrc/knn.cu",
             replaces="hpcs_tpu/ops/pallas/knn_pallas.py:49",
             launches=launches["knn_wide"] + decode["launches"]["knn_wide"]
             + train["launches"]["knn_wide"] + train["fit_launches"]["knn_wide"]
             + entry_launches["knn_wide"] + backbones["launches"]["knn_wide"]
             + imp["launches"]["knn_wide"] + trained["launches"]["knn_wide"]
             + par["launches"]["knn_wide"] + obs["launches"]["knn_wide"],
             max_abs_err=wide["max_score_gap"], ms=wide["ms"], plain_ms=wide["plain_ms"],
             bound_ms=wide["bound_ms"], bound_by=wide["bound_by"], library_ms=None),
        dict(name="edgeconv", route="cuda", source="hpcs_torch/ops/csrc/edgeconv.cu",
             replaces="hpcs_tpu/ops/pallas/edgeconv_pallas.py:67",
             launches=launches["edgeconv"] + decode["launches"]["edgeconv"]
             + train["launches"]["edgeconv"] + train["fit_launches"]["edgeconv"]
             + entry_launches["edgeconv"] + backbones["launches"]["edgeconv"]
             + imp["launches"]["edgeconv"] + trained["launches_fp32"]["edgeconv"]
             + par["launches"]["edgeconv"] + obs["launches"]["edgeconv"],
             max_abs_err=ec_err,
             ms=sum(s["ms"] for s in ec_rows.values()),
             plain_ms=sum(s["plain_ms"] for s in ec_rows.values()),
             bound_ms=bound_ms(ec_ops, ec_bytes)[0], bound_by=bound_ms(ec_ops, ec_bytes)[1],
             library_ms=None),
        dict(name="knn_bf16", route="cuda", source="hpcs_torch/ops/csrc/knn.cu",
             replaces="hpcs_tpu/ops/pallas/knn_pallas.py:49",
             launches=bf16["launches_main_path"]["knn_bf16"] + trained["launches"]["knn_bf16"]
             + obs["launches"]["knn_bf16"],
             max_abs_err=bf16["knn_max_score_gap"], ms=bf16["knn_ms_per_forward"],
             plain_ms=bf16["knn_plain_ms_per_forward"], bound_ms=bf16["knn_bound_ms_per_forward"],
             bound_by=bf16["knn_bound_by"], library_ms=None),
        dict(name="edgeconv_bf16", route="cuda", source="hpcs_torch/ops/csrc/edgeconv.cu",
             replaces="hpcs_tpu/ops/pallas/edgeconv_pallas.py:67",
             launches=bf16["launches_main_path"]["edgeconv_bf16"]
             + trained["launches"]["edgeconv_bf16"] + obs["launches"]["edgeconv_bf16"],
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
