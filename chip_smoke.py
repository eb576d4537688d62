"""Drive hpcs_torch's eval forward on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py [--json PATH]

Builds the CUDA kernels from hpcs_torch/ops/csrc, then:

1. prints the card's identity;
2. holds kernel B1 (kNN) against knn_plain on synthetic clouds and on the
   model's stage-2/3 features at B=16, N=1024, k=20, and, index for index,
   on clouds whose scores are exact: integer points that each appear twice
   (far apart or adjacent), a line of points whose rows' scores rise (the
   selection's worst case) and equal points; and times it on clouds whose
   selection work differs, beside the warp queue's insertions per row;
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
8. prints one JSON line per kernel summary, the card's name and power
   limit, and last {"ok": true, "device": {...}}.

Every phase prints one JSON line; any failure raises and exits non-zero
without the last line.  --json also writes every phase's results to PATH.
"""
import argparse
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
    `reps` calls after one warm-up (torch.profiler, CUPTI)."""
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
    return out


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


def knn_work(b, n, d, k):
    """The least fp32 operations and the bytes of one kNN launch.

    Per score, D FMAs: the chain starts from -|x_j|^2 and takes 2 x_i, both
    made once per point (3 D operations each).  Selecting the k best takes
    one compare per score against the row's running k-th best.  Bytes: the
    cloud in, the indices out.
    """
    return 2 * b * n * n * d + b * n * n + 3 * b * n * d, 4 * b * n * d + 4 * b * n * k


def edgeconv_work(b, n, c, k, n_convs, cout=21):
    """The least fp32 operations and the bytes of one EdgeConv launch.

    conv1 is linear in the edge feature [x_j - x_i || x_i], so W1 e =
    Wa x_j + (Wb - Wa) x_i: both products (and those of Wd1) are made once
    per point, and each edge adds two of them for p and two for d.  Per
    edge then: those adds, the gates, conv2 and its gates, the mean's adds.
    Bytes: the features, indices and weights in, the output out.
    """
    per_edge = 2 * cout * 3 + cout * GATE_OPS + cout * 3
    if n_convs == 2:
        per_edge += 2 * cout * cout * 3 * 2 + cout * GATE_OPS
    ops = b * n * (k * per_edge + 4 * c * cout * 3 * 2 + cout * 3)
    weights = 2 * cout * 2 * c + 2 * cout + (2 * cout * cout + 2 * cout) * (n_convs == 2)
    nbytes = 4 * (b * n * c * 3 + b * n * k + weights + b * n * cout * 3)
    return ops, nbytes


def knn_check(x, got, want, ties_exact):
    """Equal indices, except entries whose two candidates' exact scores
    differ by at most 1e-6 * the row's max |score|.  Returns (near-tie
    entries, max |score difference| over mismatches)."""
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

    diff = (score(got[mism]) - score(want[mism])).abs()
    rows = 2 * torch.einsum("md,mnd->mn", xi, xd[b]) - (xd[b] ** 2).sum(-1)
    scale = rows.abs().amax(-1)
    bad = int((diff > 1e-6 * scale).sum())
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
    with torch.no_grad():
        for m in system.net.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen))
                m.bias.copy_(0.2 * torch.randn(c, generator=gen))
                m.running_mean.copy_(0.3 * torch.randn(c, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(c, generator=gen))
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
        equal = torch.full((B, N, 3), 0.5, device=device)  # all ties: only k columns go in
        gauss = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32)).to(device)
        cases = {"points_d3": (pts, False), "stage2_d63": (f1, False), "stage3_d63": (f2, False),
                 "gauss_d3": (gauss, False), "ties_d3": (tie_cloud(3, 8), True),
                 "ties_d63": (tie_cloud(63, 2), True), "line_d3": (line, True),
                 "adjacent_d3": (adjacent_cloud(3, 8), True),
                 "adjacent_d63": (adjacent_cloud(63, 2), True), "equal_d3": (equal, True)}
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
                                     ("line_d3", line), ("stage2_d63", f1), ("stage3_d63", f2))}
        knn_ms = {"d3": selection["points_d3"]["ms"], "d63": selection["stage2_d63"]["ms"]}
        plain_ms = {d: cuda_ms(lambda x=x: KN.knn_plain(x, K), 5) for d, x in (("d3", pts), ("d63", f1))}
        w3, w63 = knn_work(B, N, 3, K), knn_work(B, N, 63, K)
        knn_b = {d: bound_ms(*w) for d, w in (("d3", w3), ("d63", w63))}
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

    # 7. summary lines
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
             + train["fit_launches"]["knn"],
             max_abs_err=knn_err, ms=knn_total_ms, plain_ms=knn_plain_total,
             bound_ms=bound_ms(knn_ops, knn_bytes)[0], bound_by=bound_ms(knn_ops, knn_bytes)[1],
             library_ms=None),
        dict(name="knn_wide", route="cuda", source="hpcs_torch/ops/csrc/knn.cu",
             replaces="hpcs_tpu/ops/pallas/knn_pallas.py:49",
             launches=launches["knn_wide"] + decode["launches"]["knn_wide"]
             + train["launches"]["knn_wide"] + train["fit_launches"]["knn_wide"],
             max_abs_err=wide["max_score_gap"], ms=wide["ms"], plain_ms=wide["plain_ms"],
             bound_ms=wide["bound_ms"], bound_by=wide["bound_by"], library_ms=None),
        dict(name="edgeconv", route="cuda", source="hpcs_torch/ops/csrc/edgeconv.cu",
             replaces="hpcs_tpu/ops/pallas/edgeconv_pallas.py:67",
             launches=launches["edgeconv"] + decode["launches"]["edgeconv"]
             + train["launches"]["edgeconv"] + train["fit_launches"]["edgeconv"],
             max_abs_err=ec_err,
             ms=sum(s["ms"] for s in ec_rows.values()),
             plain_ms=sum(s["plain_ms"] for s in ec_rows.values()),
             bound_ms=bound_ms(ec_ops, ec_bytes)[0], bound_by=bound_ms(ec_ops, ec_bytes)[1],
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
