"""Drive hpcs_torch's eval forward on one NVIDIA GPU and check its kernels.

    python3 chip_smoke.py [--json PATH]

Builds the CUDA kernels from hpcs_torch/ops/csrc, then:

1. prints the card's identity;
2. holds kernel B1 (kNN) against knn_plain on synthetic clouds, on the
   model's stage-2/3 features and on DGCNN's (D = 64, the top of B1's D
   range) at B=16, N=1024, k=20, and, index for index, on clouds whose
   scores are exact: integer points that each appear twice (far apart or
   adjacent; D = 3, 63 and 64), a line of points whose rows' scores rise
   (a running queue's worst case) and equal points; and times it on clouds
   whose selection work differs, beside the selection's candidates per
   row and the insertions a running queue would make, by kernel at the
   flagship shapes, with the launch geometry (grid, shared bytes,
   registers, resident blocks per SM, waves) of each; and launches B1 over
   each half of the points' and stage inputs' rows (a 2-way point-sharded
   rank's launch), in fp32 and on bf16 features, each index for index the
   whole launch's rows, the second half timed beside the whole launch and
   its bound (knn_phase; alone: python3 scripts/chip_phase.py knn);
3. holds kernel B2 (EdgeConv stage) against edgeconv_infer_plain at the
   three stage shapes of the model: atol 1e-5 / rtol 1e-4 wherever fp32
   can fix the result, and a bound scaled by the conditioning elsewhere
   (hpcs_torch.testing.check_edgeconv); and, in full, against the plain
   twin in float64 on planted inputs whose pre-BatchNorm vectors are near
   the gate's EPS yet exact in fp32 (testing.check_planted_eps); times each
   stage whole and, by kernel under torch.profiler, its projection and its
   edge kernel apart, beside ptxas's registers and spills of each; and
   launches B2 over each half of each stage's centres (its projection over
   the whole table), fp32 and bf16, each the whole launch's rows bit for
   bit, the second half timed beside the whole launch and its bound
   (edgeconv_phase; alone: python3 scripts/chip_phase.py edgeconv);
4. answers requests of 16 synthetic clouds of 1024 points with the flagship
   model (eucl = hyp = 32, k = 20, 16 categories, random weights and random
   BatchNorm statistics from a seed), counts the kernels' launches, compares
   the output with the plain forward on the card on the same kNN graphs
   (atol 1e-4 / rtol 1e-3 when run from the kernel's stage-1 output; within
   1e-4 + 1e-3 max|output| in full, see forward_diff) and with the plain
   forward on the CPU on a small input, and times both;
5. holds B1's wide route (knn_wide_kernel, row tiles with a streamed
   selection, for the shapes knn_kernel refuses: k = 33 and 40, N = 4097
   and 8192, D = 128) against knn_plain, index for index on the
   exact-score clouds and up to near-ties on a random one, on bf16 index
   for index its route on x.float(); times it in fp32 and bf16 beside its
   bound, knn_plain and torch.topk(pairwise_neg_sqdist(x), k), with its
   launch geometry (hpcs_knn_wide_geometry) and its selection work per
   row (merges of 32, single insertions); holds
   one cloud of N = 65,536 (D = 3 and 63) on three ranges of rows; times
   B1 at N = 4096 beside the wide route at 4097 (per score pair); holds
   and times its radix route (k > 256: knn_keys_kernel + knn_radix_kernel)
   at k = 300 on N = 1024 clouds and N = 65,536, beside the wide kernel at
   the k = 256 / 257 edge, with its geometry and passes a row; over half
   of the rows
   of three shapes it equals the whole launch's rows, timed beside it
   (knn_wide_phase; alone: python3 scripts/chip_phase.py knn_wide); and
   checks that the forward's requests made no wide launch;
5b. serves the flagship where B1 does not reach (phase long_cloud; alone:
   python3 scripts/chip_phase.py long_cloud): 3 requests of 4 synthetic
   clouds of N = 8192 (k = 20) and 2 in bf16, 3 of 16 clouds of 1024 at
   k = 40 and 3 at k = 300 (3 of them on the radix route), each request 3
   wide launches and 3 B2 launches, its graphs
   against knn_plain and its output against the plain forward on the card
   on those graphs (as step 4 holds the main path; bf16 as step 10), and
   `python -m hpcs_torch.train --dataset synthetic --fixed_points 8192` at
   the flagship's k and widths, B = 4, 1 epoch (16 steps, 4 validation and
   4 test batches), its launches counted;
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
   phase's weights; alone: python3 scripts/chip_phase.py bf16, on the
   flagship's): 8 requests through HypHCSystem.embed and 8 through
   test_step (B1 and B2 on bf16 features 3 times each per request, no
   fp32 or wide launch), the output against the plain bf16 forward on the
   card on B1's graphs and the CPU port's on a small input (within 3 % of
   the output's largest entry: bf16 roundings that flip between sums in
   another order); B1 on bf16 index for index against B1 on the upcast
   input at the model's three stage inputs and on tie clouds (and
   knn_plain up to near-ties), B2's bf16 route against its plain version
   at the three stage shapes (check_edgeconv widened by one bf16 ulp),
   each timed beside its bound (bf16 features at 2 bytes); the two-conv
   stages through edge_tc_kernel alone (no copy to constant memory), its
   HMMA counted in the SASS (cuobjdump) and its bound with conv2's three
   limb products at the tensor cores' 989 TFLOP/s beside the all-fp32
   bound, ptxas's registers and spills of each stage's kernels; the gap between
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
   moments and rate); the same state as hpcs_tpu's multi-process orbax
   directory, as 1 and as 2 processes write it (hpcs_torch.testing.
   write_orbax_checkpoint; the port needs no orbax): restored bit for
   bit, its MiB, read and restore ms printed beside the msgpack's, served
   by infer equal to the msgpack's served requests, resumed likewise; a
   reference Lightning checkpoint of the same weights,
   its backbone class unimportable, through `python -m
   hpcs_torch.import_checkpoint` and infer, equal likewise; and the rest of
   the decode API on 4 flagship objects: linkage in both metrics and
   algorithms, the sequential linkage (complete, single, average) against
   the CPU port exactly and scipy within 1e-6, cut_maxclust,
   cut_maxclust_many and cut_maxclust_fcluster at k = 2..20 (the last equal
   to scipy's fcluster - 1) and eval_clustering in both modes, each against
   the CPU port exactly and timed per object;
12. runs the port's examples (phase examples): examples/api_tour_torch.py
   on the card at its own sizes (80 epochs of 4 batches of 4 clouds of
   128 points, then its decode), its trained system written as hpcs_tpu's
   2-process orbax directory, and examples/eval_noise_torch.py with --ckpt
   that directory on the card and on the CPU: the embeddings within atol
   2e-4 / rtol 1e-3 of each other, every score in [0, 1], B1 3 a training
   step and test_step and B2 3 a test_step;
13. runs the per-category evaluation notebooks' path (phase notebooks):
   (a) mini-ShapeNet-Part written by tools/make_mini_datasets_torch.py
   (Airplane and Cap, 3 / 1 / 2 objects each) and read back through
   ShapeNetDataset and the C++ txt parser; (b) the recipe of
   tools/parity_real_format_torch.py (80 epochs, B=2, N=256, eucl = hyp =
   16, k=10) trained on the card for NOTEBOOK_SEEDS and tested: B1 3 a
   training step and an eval batch, B2 3 an eval batch; the per-seed test
   loss, raw-cosine accuracy, decode score and purity beside hpcs_tpu's 8
   seeds (benchmarks/parity_real_format.json), failing where the mean
   decode score or purity lies more than two combined standard errors
   below hpcs_tpu's; (c) examples/shapenet_eval_torch.ipynb's code cells
   but the precision-recall cell on seed 0's checkpoint, on the card and on
   the CPU port: the embeddings within atol 2e-4 / rtol 1e-3, and on the
   card's embeddings the CPU's rows equal to the card's (best k and true
   parts, scores within 1e-5; the rows of the CPU's own embeddings are
   printed beside them: a decode moves with rounding at near ties); (d) its
   evaluate_category over the mini test split at the flagship's width
   (N=1024, k=20, eucl = hyp = 32, 16 categories, 50 classes) from the
   import phase's hpcs_tpu msgpack checkpoint, ms per category;
14. runs PartNet without h5py (phase partnet; alone: python3
   scripts/chip_phase.py partnet): (a) the mini PartNet tree (Bottle,
   levels 1 and 3, 10,000 points an object) written by
   tools/make_mini_datasets_torch.py through hpcs_torch.utils.hdf5 and
   read back by PartNetDataset, equal to the generator's arrays, and a
   file of 16 such objects written contiguous and chunked-deflated, each
   read timed; (b) `python -m hpcs_torch.train --dataset partnet
   --category Bottle --level 3` at the entry phase's flags (N=1024, k=20,
   eucl = hyp = 32, B=8; the hierarchical CosFace over levels 1 and 3, its
   sum matrices on the card) for 2 epochs on a tree of 8 / 8 / 8 objects,
   --resume for a third and `python -m hpcs_torch.infer partnet` on
   final/ for 2 requests of 4, held as the entry phase holds ShapeNet's;
   (c) one hierarchical train_step at B=2, N=1024 against the CPU port
   (testing.check_train_step_card_vs_cpu), also with class_vector; (d)
   tools/parity_real_format_torch.py's PartNet recipe trained on the card
   for NOTEBOOK_SEEDS at 80 epochs, its mean decode purity and score held
   to hpcs_tpu's 8 seeds (benchmarks/parity_real_format_partnet.json; z >=
   -2); (e) examples/partnet_eval_torch.ipynb's code cells on seed 0's
   checkpoint on the card and on the CPU port, compared as in phase
   notebooks; B1 and B2 counted in every run; and reads the committed
   libver="latest" fixtures (tests/fixtures/hdf5_latest, written by
   tools/make_hdf5_fixtures_torch.py with h5py: a PartNet-shaped file
   growable along its objects, the extensible array chunk index, and a file
   of dense link storage and a v2 B-tree chunk index) through
   hpcs_torch.utils.hdf5 and PartNetDataset, equal to the tool's seeded
   recipe recomputed on the machine;
14b. runs the quality-parity experiment (phase parity,
   tools/parity_experiment_torch.py; alone: python3 scripts/chip_phase.py
   parity [--seeds 0 1 2 3 4]): its data equal to
   benchmarks/_parity_data.npz; its decode on the card of hpcs_tpu's
   stored embeddings of 5 seeds, each seed's mean best-k score within 1e-6
   of hpcs_tpu's stored one and its mean purity equal; its recipe (40
   epochs, B=4, N=256, eucl = hyp = 16, k=10, SO(3)) trained on the card
   from seed 0 while 90 s of phase time last (2 seeds at least), B1 3 a
   step and an eval batch and B2 3 an eval batch; the mean decode purity and score held at z >= -2
   against hpcs_tpu's 5 seeds, tools/parity_experiment.py's verdicts
   against the reference's 5 seeds printed, with each seed's seconds;
15. trains the flagship to convergence (phase trained,
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
16. runs hpcs_torch.parallel (phase parallel) at the flagship width: (a)
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
   unsharded forward (atol 1e-4 / rtol 1e-3), timed beside it, B1 and B2
   over each rank's rows of the gathered cloud only, the same at the long
   cloud's B=4, N=8192 (the wide route over each rank's rows), and the
   point-sharded training step at B=2, N=256 against the unsharded step:
   in fp32 the loss within rtol 2e-5 and the ranks equal, in float64
   (knn_plain's graphs) logs and gradients within testing.FLOAT64_WITNESS
   (the fp32 step is ill-conditioned: another order of its sums moves a
   weight by 1.4e-4 where two runs of one order agree); (e) the same for
   DGCNN, PointNet, VN-PointNet with max pooling, VN-DGCNN with max
   pooling, in bf16 and with class_vector, at full width (POINT_CONFIGS):
   the sharded forward at B=2, N=4096 against the unsharded one (bf16
   within 3 % of the output's largest entry), both timed, the sharded step
   at B=2, N=256 (its loss within rtol 2e-5 of the unsharded step's, 2^-8
   for PointNet and bf16, whose steps are noise at B = 2; the ranks equal
   bit for bit) and in float64 at B=4; every sharded run launches B1 and
   B2 over its rank's rows only (B1 4 / 0 / 1 / 3 / 3 / 3 a forward and a
   step, B2 0 / 0 / 0 / 0 / 3 / 3 a forward); --data_parallel beyond the
   visible GPUs must raise.  Prints the step ms at world sizes 1 and 2,
   the world-size-1 step's parts beside the single-device step's, the
   all-reduce ms per step, each backend, each configuration's readings and
   the phase's B1 and B2 launches and row-range launches, which the
   kernels line counts;
17. observes (phase observe): (a) `python -m hpcs_torch.train`'s main
   with --profile, in a process of its own, at the flagship (B=8,
   N=1024, a ShapeNet-Part tree of 2 categories: 2 training steps, 1
   validation and 1 test batch): one
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
18. prints one JSON line of the kernels (each with its row-range
   launches: B1, the wide route, B2, each on bf16 too, and the wide route's
   radix route), the card's name and power limit, and last {"ok": true,
   "device": {...}}.

Every phase prints one JSON line; any failure raises and exits non-zero
without the last line.  --json also writes every phase's results to PATH.
"""
import argparse
import dataclasses
import json
import os
import re
import shutil
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
BF16_TC_FLOPS = 989e12  # H100 SXM, bf16 on the tensor cores, dense
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
    return dict(zip(_demangled(list(rows)), rows.values()))


def _demangled(names):
    """Kernel names as ptxas_summary gives them (c++filt where it is installed)."""
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, timeout=60).stdout.splitlines()
    except OSError:
        plain = []
    if len(plain) != len(names):
        plain = list(names)
    return [p.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")
            for p in plain]


def sass_mma_counts(name):
    """{kernel: HMMA instructions in its SASS} of the built library `name`
    (cuobjdump -sass on hpcs_torch/_build's lib<name>-*.so), every kernel,
    names as ptxas_summary's."""
    from hpcs_torch.ops import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build._library_path(name)[1])],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"\bHMMA\b", ln):
            counts[fn] += 1
    return dict(zip(_demangled(list(counts)), counts.values()))


def bound_ms(ops, nbytes, tc_ops=0):
    """The least time in ms for `ops` fp32 operations, `tc_ops` bf16
    tensor-core operations and `nbytes` bytes: the largest of the three
    times, and what it is ("operations" for either kind)."""
    t_ops = max(ops / FP32_FLOPS, tc_ops / BF16_TC_FLOPS) * 1e3
    t_bytes = nbytes / HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def knn_work(b, n, d, k, feature_bytes=4, rows=None):
    """The least fp32 operations and the bytes of one kNN launch over
    `rows` query rows of each cloud (None: all n).

    Per score, D FMAs: the chain starts from -|x_j|^2 and takes 2 x_i, both
    made once per point (3 D operations each).  Selecting the k best takes
    one compare per score against the row's running k-th best.  Bytes: the
    cloud in (feature_bytes a value: 2 for bf16), the rows' indices out.
    """
    r = n if rows is None else rows
    return (2 * b * r * n * d + b * r * n + 3 * b * n * d,
            feature_bytes * b * n * d + 4 * b * r * k)


def edgeconv_work(b, n, c, k, n_convs, cout=21, feature_bytes=4, rows=None, tensor_cores=False):
    """The least fp32 operations and the bytes of one EdgeConv launch over
    `rows` centres of each cloud (None: all n); with tensor_cores (the bf16
    route's two-conv stages) also the bf16 tensor-core operations, as
    (fp32 ops, bytes, tensor-core ops): conv2's products then move to the
    tensor cores at three limb products each.

    conv1 is linear in the edge feature [x_j - x_i || x_i], so W1 e =
    Wa x_j + (Wb - Wa) x_i: both products (and those of Wd1) are made once
    per point that an edge reads (every point of the table at most; the
    range's centres at least: counted so), and each edge adds two of them
    for p and two for d.  Per edge then: those adds, the gates, conv2 and
    its gates, the mean's adds.  Bytes: the table's features, the rows'
    indices and the weights in, the rows' output out; features and output
    at feature_bytes a value (2 for bf16), the rest 4.
    """
    r = n if rows is None else rows
    per_edge = 2 * cout * 3 + cout * GATE_OPS + cout * 3
    conv2 = 2 * cout * cout * 3 * 2 if n_convs == 2 else 0
    if n_convs == 2:
        per_edge += cout * GATE_OPS
    fp32_conv2 = 0 if tensor_cores else conv2
    ops = b * r * (k * (per_edge + fp32_conv2) + 4 * c * cout * 3 * 2 + cout * 3)
    weights = 2 * cout * 2 * c + 2 * cout + (2 * cout * cout + 2 * cout) * (n_convs == 2)
    nbytes = feature_bytes * (b * n * c * 3 + b * r * cout * 3) + 4 * (b * r * k + weights)
    return (ops, nbytes, 3 * b * r * k * conv2) if tensor_cores else (ops, nbytes)


def knn_check(x, got, want, ties_exact, row0=0):
    """Equal indices, except entries whose two candidates' exact scores
    differ by at most 1e-6 * the row's max |score|, or by no more than the
    two scores' fp32 rounding can (the bound of a D-term sum; DGCNN's D = 64
    features are positive and large, where that is the wider).  got and
    want hold rows row0.. of x's clouds.  Returns (near-tie entries, max
    |score difference| over mismatches)."""
    mism = got != want
    n_mis = int(mism.sum())
    if n_mis == 0:
        return 0, 0.0
    if ties_exact:
        fail(f"knn: {n_mis} indices differ on the tie cloud")
    b, i, _ = mism.nonzero(as_tuple=True)
    xd = x.double()
    xi = xd[b, i + row0]

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
    32, k 20 unless `fields` says), random weights and BatchNorm statistics
    from SEED."""
    from hpcs_torch.models import HypHCSystem, ModelConfig

    gen = torch.Generator().manual_seed(SEED)
    cfg = ModelConfig(**{"num_class": 50, "num_categories": CATEGORIES, "hyp_dim": HYP, "k": K,
                         **fields, **train_fields})
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


def half_cloud_knn(KN, clouds, k=K):
    """B1 over each half of each cloud's rows (what a rank of a 2-way
    point-sharded forward launches), in fp32 and on bf16 features: each
    half index for index the whole launch's rows; the second half's device
    time (CUDA events, 20 launches) beside the whole launch's and the
    half's bound."""
    out = {}
    for case, x32 in clouds.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype).contiguous()
            b, n, d = x.shape
            whole = KN.knn(x, k)
            halves = ((0, n // 2), (n // 2, n))
            for half in halves:
                if not torch.equal(KN.knn(x, k, rows=half), whole[:, half[0]:half[1]]):
                    fail(f"knn: rows {half} of {case} ({dtype}) differ from the whole launch's")
            ms = cuda_ms(lambda x=x: KN.knn(x, k, rows=halves[1]), 20)
            bound, by = bound_ms(*knn_work(b, n, d, k, x.element_size(), rows=n - n // 2))
            out[f"{case}_{str(dtype)[6:]}"] = dict(
                B=b, N=n, D=d, k=k, rows=list(halves[1]), equal_to_whole=True, ms=ms,
                whole_ms=cuda_ms(lambda x=x: KN.knn(x, k), 20), bound_ms=bound, bound_by=by,
                roofline_share=bound / ms)
    return out


def flagship():
    """The flagship model on the card (eucl = hyp = 32, k = 20, 16
    categories, 50 classes; random weights and BatchNorm statistics from
    SEED), its config and REQUESTS batches of B synthetic clouds of N
    points."""
    from hpcs_torch.data import SyntheticPartDataset
    from hpcs_torch.models import HypHCSystem, ModelConfig

    gen = torch.Generator().manual_seed(SEED)
    cfg = ModelConfig(num_class=50, num_categories=CATEGORIES, eucl_dim=EUCL, hyp_dim=HYP, k=K)
    system = HypHCSystem(cfg, generator=gen)
    randomize_bn(system.net, gen)
    data = SyntheticPartDataset(num_objects=B * REQUESTS, npoints=N,
                                num_categories=CATEGORIES, seed=SEED)
    return system, cfg, [data.batch(r * B, B) for r in range(REQUESTS)]


def request_weights(system):
    """The eval stages' weights (w12, w34, w5) of a VN-DGCNN system."""
    from hpcs_torch.nn.backbones import vn_dgcnn

    net = system.net.nn_feat
    return ([t.detach() for t in vn_dgcnn.stage_weights(net.conv1, net.conv2)],
            [t.detach() for t in vn_dgcnn.stage_weights(net.conv3, net.conv4)],
            [t.detach() for t in vn_dgcnn.stage_weights(net.conv5)])


def request_stages(system, points):
    """The eval forward's kNN graphs and EdgeConv stages for one request
    (numpy points [B, N, 3]) through the kernels: the points on the card,
    idx1, x0, x1, f1 (stage 2's kNN input), idx2, x2, f2, idx3 and the
    stages' weights (w12, w34, w5)."""
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN

    k, (b, n) = system.cfg.k, points.shape[:2]
    w12, w34, w5 = request_weights(system)
    with torch.no_grad():
        pts = torch.from_numpy(points).cuda().contiguous()
        idx1 = KN.knn(pts, k)
        x0 = pts[:, :, None, :].contiguous()
        x1 = E.edgeconv_infer(x0, idx1, *w12)
        f1 = x1.reshape(b, n, -1).contiguous()
        idx2 = KN.knn(f1, k)
        x2 = E.edgeconv_infer(x1, idx2, *w34)
        f2 = x2.reshape(b, n, -1).contiguous()
        idx3 = KN.knn(f2, k)
    return pts, idx1, x0, x1, f1, idx2, x2, f2, idx3, (w12, w34, w5)


def flagship_stages(system, points):
    """The eval forward's three EdgeConv stages of one request (numpy points
    [B, N, 3]) as {name: (x, idx, weights, n_convs)}, their inputs and
    graphs made through the kernels (request_stages)."""
    _, idx1, x0, x1, _, idx2, x2, _, idx3, (w12, w34, w5) = request_stages(system, points)
    return {"stage1_c1": (x0, idx1, w12, 2), "stage2_c21": (x1, idx2, w34, 2),
            "stage3_c21": (x2, idx3, w5, 1)}


def edgeconv_phase(card, stages=None):
    """Kernel B2 against edgeconv_infer_plain at the three stage shapes of
    the flagship (`stages`, flagship_stages of request 0; None: made here),
    on the planted near-EPS inputs, timed by kernel, and over each half of
    each stage's centres in fp32 and bf16 (step 3 of the module's
    docstring; alone: python3 scripts/chip_phase.py edgeconv)."""
    from hpcs_torch.ops import _build
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.testing import check_edgeconv, check_planted_eps

    device = torch.device("cuda")
    if stages is None:
        system, _, batches = flagship()
        stages = flagship_stages(system, batches[0][0])
    with torch.no_grad():
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
        # B2 over each half of the centres (a 2-way point-sharded rank's
        # launch, the projection over the whole table), fp32 and bf16: the
        # whole launch's rows bit for bit, the second half timed
        ec_halves = {}
        for st, (x32, idx, w, nc) in stages.items():
            for dtype in (torch.float32, torch.bfloat16):
                x = x32.to(dtype)
                whole = E.edgeconv_infer(x, idx, *w, n_convs=nc)
                halves = ((0, N // 2), (N // 2, N))
                for half in halves:
                    part = idx[:, half[0]:half[1]].contiguous()
                    if not torch.equal(E.edgeconv_infer(x, part, *w, n_convs=nc, rows=half),
                                       whole[:, half[0]:half[1]]):
                        fail(f"edgeconv: rows {half} of {st} ({dtype}) differ from the whole "
                             "launch's")
                part = idx[:, N // 2:].contiguous()
                ms = cuda_ms(lambda x=x, part=part, w=w, nc=nc: E.edgeconv_infer(
                    x, part, *w, n_convs=nc, rows=halves[1]), 20)
                bound, by = bound_ms(*edgeconv_work(
                    B, N, x.shape[2], K, nc, rows=N - N // 2, feature_bytes=x.element_size(),
                    tensor_cores=dtype == torch.bfloat16 and nc == 2))
                ec_halves[f"{st}_{str(dtype)[6:]}"] = dict(
                    rows=list(halves[1]), equal_to_whole=True, ms=ms,
                    whole_ms=cuda_ms(lambda x=x, idx=idx, w=w, nc=nc: E.edgeconv_infer(
                        x, idx, *w, n_convs=nc), 20), bound_ms=bound, bound_by=by,
                    roofline_share=bound / ms)
    ec_ms = sum(r["ms"] for r in ec_rows.values())
    ec_bound = sum(r["bound_ms"] for r in ec_rows.values())
    out = dict(stages=ec_rows, half_cloud=ec_halves, ms_per_forward=ec_ms,
               bound_ms_per_forward=ec_bound, roofline_share=ec_bound / ec_ms,
               ptxas=ptxas_summary(_build.build_log("edgeconv")), atol=1e-5, rtol=1e-4,
               ill_conditioned_below=1e-4, ill_conditioned_limit="1e-5 + 2^-23 max|b| / |p|",
               max_abs_err=ec_err, card=card)
    emit("edgeconv", **out)
    return out


KNN_GEOMETRY = ("grid_x", "grid_y", "threads", "smem_bytes", "resident_blocks_per_sm",
                "registers", "local_bytes", "tile_rows", "tile_columns", "padded_d",
                "prep_blocks")
WIDE_GEOMETRY = KNN_GEOMETRY + ("stages", "list_slots", "radix", "column_chunks", "group_rows",
                                 "groups", "select_threads", "select_smem_bytes",
                                 "select_resident_blocks_per_sm", "select_registers",
                                 "select_local_bytes")


def knn_geometry(b, n, d, k, rows=None, wide=False):
    """knn_kernel's launch at (b, n, d, k) over `rows` rows (None: n), from
    knn.cu's hpcs_knn_geometry: grid, threads, dynamic shared bytes, resident
    blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers
    and local (spill) bytes a thread, its tile, and the waves of blocks over
    the card's SMs; knn_prep_kernel's blocks (of the same threads).  With
    `wide`, the wide route's (hpcs_knn_wide_geometry), which adds the ring's
    stages, a row list's slots and whether the radix route takes it (k >
    256), and for it: the score sweep's (knn_keys_kernel's) column chunks
    and its rows a group (grid_x is a group's row tiles, blocks and waves a
    group's), the groups, and knn_radix_kernel's threads, shared bytes,
    resident blocks, registers and spills (its grid: a group's rows by the
    clouds)."""
    import ctypes

    from hpcs_torch.ops import _build

    fields = WIDE_GEOMETRY if wide else KNN_GEOMETRY
    symbol = "hpcs_knn_wide_geometry" if wide else "hpcs_knn_geometry"
    fn = _build.function("knn", symbol, [ctypes.c_int] * 5 + [ctypes.c_void_p])
    out = (ctypes.c_int * len(fields))()
    _build.check(fn(b, n, d, k, n if rows is None else rows, out), symbol)
    g = dict(zip(fields, out))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = g["grid_x"] * g["grid_y"] * g.get("column_chunks", 1)
    g.update(sms=sms, blocks=blocks, waves=blocks / (g["resident_blocks_per_sm"] * sms))
    return g


def knn_phase(card, rng=None):
    """Kernel B1 against knn_plain at the flagship (B=16, N=1024, k=20).

    Its inputs, built here from SEED: the flagship's request-0 points and
    stage-2/3 features (through B1 and B2), DGCNN's stage-2/3 inputs (D =
    64, the top of B1's D range), and synthetic clouds from `rng` (default
    numpy's default_rng(SEED)): Gaussian points, integer clouds whose
    points each appear twice (far apart or adjacent; D = 3, 63 and 64), a
    line of points whose rows' scores rise with the column up to the row's
    own, and equal points.  The integer clouds' scores are exact in fp32
    whatever the order of the sums: their indices must be equal; elsewhere
    knn_check allows near-ties.  Times each case (CUDA events, 20 calls:
    the prep and main launch and the wrapper) beside the selection's
    candidates per row (testing.knn_candidates) and the insertions a
    sequential top-k queue would make; the device time by kernel at the
    three flagship shapes; the launch geometry of each flagship shape (D =
    3, 63, 64; fp32 and bf16; whole and half cloud); and each half of the
    rows, equal to the whole launch's.  Emits the `knn` line; returns it
    with the largest score gap over the near-tie mismatches."""
    from hpcs_torch.models import decode_vector_for_batch
    from hpcs_torch.ops import knn as KN
    from hpcs_torch.testing import knn_candidates, knn_queue_insertions

    device = torch.device("cuda")
    rng = np.random.default_rng(SEED) if rng is None else rng
    system, _, batches = flagship()
    pts, _, _, _, f1, _, _, f2, _, _ = request_stages(system, batches[0][0])
    del system
    with torch.no_grad():
        def tie_cloud(d, r):
            half = rng.integers(-r, r + 1, size=(B, N // 2, d)).astype(np.float32)
            return torch.from_numpy(np.concatenate([half, half], 1)).to(device)

        def adjacent_cloud(d, r):  # x[2m] == x[2m+1]: ties inside one 32-column group
            half = rng.integers(-r, r + 1, size=(B, N // 2, d)).astype(np.float32)
            return torch.from_numpy(np.repeat(half, 2, axis=1)).to(device)

        # x_j = (j, 0, 0): exact scores 2 i j - j^2 that rise with j up to the
        # row's own column (a running queue's worst case)
        line = torch.zeros(B, N, 3, device=device)
        line[:, :, 0] = torch.arange(N, device=device, dtype=torch.float32)
        # DGCNN's stage-2 and stage-3 inputs: D = 64, the top of B1's D range
        with recorded_knn() as dgcnn_pairs:
            dgcnn = backbone_system(BACKBONES["dgcnn_partseg"][0])
            dgcnn.embed(batches[0][0], decode_vector_for_batch(
                dgcnn.cfg, {"points": batches[0][0], "category": batches[0][1]}))
        d64_2, d64_3 = dgcnn_pairs[2][0], dgcnn_pairs[3][0]
        del dgcnn
        equal = torch.full((B, N, 3), 0.5, device=device)  # all ties
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
        # the time against the selection's data-dependent work (every 16th
        # row): its candidates per row (ceil(candidates / 32) sorts of 32),
        # and the insertions a top-k queue taking the columns in order makes
        selection = {case: dict(ms=cuda_ms(lambda x=x: KN.knn(x, K), 20),
                                candidates_per_row=knn_candidates(x, K, row_step=16),
                                insertions_per_row=knn_queue_insertions(x, K, row_step=16))
                     for case, x in (("equal_d3", equal), ("gauss_d3", gauss), ("points_d3", pts),
                                     ("line_d3", line), ("stage2_d63", f1), ("stage3_d63", f2),
                                     ("dgcnn_stage2_d64", d64_2))}
        flagship_inputs = (("d3", pts), ("d63", f1), ("d64", d64_2))
        knn_ms = {d: selection[c]["ms"] for d, c in (("d3", "points_d3"), ("d63", "stage2_d63"),
                                                      ("d64", "dgcnn_stage2_d64"))}
        by_kernel = {d: kernel_ms(lambda x=x: KN.knn(x, K), 20) for d, x in flagship_inputs}
        plain_ms = {d: cuda_ms(lambda x=x: KN.knn_plain(x, K), 5) for d, x in flagship_inputs}
        knn_b = {d: bound_ms(*knn_work(B, N, x.shape[-1], K)) for d, x in flagship_inputs}
        geometry = {}
        for d, x in flagship_inputs:
            for dtype in (torch.float32, torch.bfloat16):
                for part, rows in (("whole", None), ("half", N - N // 2)):
                    geometry[f"{d}_{str(dtype)[6:]}_{part}"] = dict(
                        knn_geometry(B, N, x.shape[-1], K, rows),
                        candidates_per_row=knn_candidates(x.to(dtype), K, row_step=16),
                        insertions_per_row=knn_queue_insertions(x.to(dtype), K, row_step=16))
        knn_halves = half_cloud_knn(KN, {"points_d3": pts, "stage2_d63": f1, "stage3_d63": f2})
    emit("knn", cases=knn_rows, B=B, N=N, k=K, ms=knn_ms, by_kernel_ms=by_kernel,
         plain_ms=plain_ms, bound_ms={d: v[0] for d, v in knn_b.items()},
         roofline_share={d: knn_b[d][0] / knn_ms[d] for d in knn_ms}, selection=selection,
         geometry=geometry, half_cloud=knn_halves, max_score_gap=knn_err, card=card)
    return RESULTS["knn"]


# the wide route's seven timed shapes (shapes knn_kernel refuses)
WIDE_SHAPES = [(B, 1024, 3, 33), (B, 1024, 3, 40), (4, 4097, 3, 20), (4, 4097, 63, 20),
               (4, 8192, 3, 20), (4, 8192, 63, 20), (B, 1024, 128, 20)]
# one cloud of 65,536 points, held against knn_plain on these rows
WIDE_LONG = [(1, 65536, 3, 20), (1, 65536, 63, 20)]
WIDE_LONG_ROWS = ((0, 512), (32668, 33180), (65024, 65536))
# k > 256: the radix route (knn_keys_kernel, then knn_radix_kernel), timed
# at WIDE_RADIX and at N = 65,536 (held on WIDE_LONG_ROWS)
WIDE_RADIX = (2, 1024, 3, 300)
WIDE_LONG_RADIX = [(1, 65536, 3, 300), (1, 65536, 63, 300)]


def knn_wide_phase(card, rng=None):
    """B1's wide route (knn_wide_kernel: the shapes knn_kernel refuses)
    against knn_plain.

    At its seven timed shapes (WIDE_SHAPES): exact-score clouds (integer
    points each there twice, far apart or adjacent; all-equal points; the
    line x_j = (j, 0, ...) where N <= 2048 keeps its scores exact) must
    match index for index, a Gaussian cloud (from `rng`, default numpy's
    default_rng(SEED)) may differ at near-ties only, and each on bf16
    features must equal the route on x.float(), index for index.  Times
    the Gaussian cloud in fp32 and bf16 (CUDA events, prep and wrapper
    included) beside the bound, knn_plain, the two-call composition
    torch.topk(pairwise_neg_sqdist(x), k), the launch geometry and the
    selection's merges of 32 and single insertions per row
    (testing.knn_stream_work, its data-dependent work).  At N = 65,536 (WIDE_LONG) a Gaussian and an
    integer cloud, whole, against knn_plain on WIDE_LONG_ROWS, each range
    also launched alone; the cap's edge: B1 at (4, 4096, D, 20) beside the
    wide route at (4, 4097, D, 20), per score pair; and half of the rows of
    three shapes, equal to the whole launch's rows, timed beside it.  For
    k > 256, the radix route (`radix`, its own seconds): at WIDE_RADIX the
    exact-score clouds index for index, the Gaussian one up to near-ties,
    each on bf16 equal to the route on x.float(); the Gaussian cloud timed
    in fp32 and bf16 beside the bound, knn_plain and the topk composition,
    with its geometry and the selection's passes a row over its keys and
    over its copied candidates (testing.knn_radix_work); at N = 65,536
    (WIDE_LONG_RADIX) a Gaussian and an integer cloud as the k = 20 ones
    above, timed; and the k = 256 / 257 edge, the wide kernel beside the
    radix route on one cloud.  Emits the `knn_wide` line.
    """
    from hpcs_torch.ops import knn as KN
    from hpcs_torch.ops.knn import pairwise_neg_sqdist
    from hpcs_torch.testing import knn_radix_work, knn_stream_work

    rng = np.random.default_rng(SEED) if rng is None else rng

    def lattice(b, n, d, adjacent):
        r = 2 if d > 3 else 8
        half = rng.integers(-r, r + 1, size=(b, (n + 1) // 2, d)).astype(np.float32)
        x = np.repeat(half, 2, axis=1) if adjacent else np.concatenate([half, half], 1)
        return torch.from_numpy(np.ascontiguousarray(x[:, :n])).cuda()

    def gauss(b, n, d):
        return torch.from_numpy(rng.standard_normal((b, n, d)).astype(np.float32)).cuda()

    def wide(x, k, rows=None):
        """KN.knn(x, k, rows), which must be one wide launch (on the radix
        route for k > 256)."""
        before = KN.knn.launches, KN.knn.wide_launches, KN.knn.radix_launches
        got = KN.knn(x, k, rows=rows)
        torch.cuda.synchronize()
        if (KN.knn.launches - before[0], KN.knn.wide_launches - before[1],
                KN.knn.radix_launches - before[2]) != (1, 1, int(k > KN.WIDE_MAX_K)):
            fail(f"knn_wide: {tuple(x.shape)}, k={k} did not make one wide launch")
        return got

    def line_cloud(b, n, d):
        line = torch.zeros(b, n, d, device="cuda")
        line[:, :, 0] = torch.arange(n, device="cuda", dtype=torch.float32)
        return line

    def same_bf16(x, k, rows=None):
        xb = x.bfloat16()
        if not torch.equal(wide(xb, k, rows),
                           KN._knn_wide_cuda(xb.float(), k, rows=rows)):
            fail(f"knn_wide: bf16 {tuple(x.shape)}, k={k}, rows {rows} differs from the "
                 "route on x.float()")

    shapes, gap = [], 0.0
    for b, n, d, k in WIDE_SHAPES:
        clouds = {"ties": (lattice(b, n, d, False), True),
                  "adjacent": (lattice(b, n, d, True), True),
                  "equal": (torch.full((b, n, d), 0.5, device="cuda"), True),
                  "gauss": (gauss(b, n, d), False)}
        if n <= 2048:
            clouds["line"] = (line_cloud(b, n, d), True)
        cases = {}
        for name, (x, exact) in clouds.items():
            near, err = knn_check(x, wide(x, k), KN.knn_plain(x, k), exact)
            same_bf16(x, k)
            gap = max(gap, err)
            cases[name] = dict(differing_near_ties=near, max_score_gap=err, bf16_equal=True)
        x = clouds["gauss"][0]
        xb = x.bfloat16()
        ms = cuda_ms(lambda: KN._knn_wide_cuda(x, k), 10)
        ms_bf16 = cuda_ms(lambda: KN._knn_wide_cuda(xb, k), 10)
        bound, by = bound_ms(*knn_work(b, n, d, k))
        shapes.append(dict(
            B=b, N=n, D=d, k=k, ms=ms, ms_bf16=ms_bf16,
            plain_ms=cuda_ms(lambda: KN.knn_plain(x, k), 2),
            topk_ms=cuda_ms(lambda: torch.topk(pairwise_neg_sqdist(x), k), 2),
            bound_ms=bound, bound_by=by, bf16_bound_ms=bound_ms(*knn_work(b, n, d, k, 2))[0],
            roofline_share=bound / ms, geometry=knn_geometry(b, n, d, k, wide=True),
            selection_work_per_row=dict(zip(("merges", "insertions"),
                                            knn_stream_work(x, k, row_step=n // 16))),
            cases=cases))

    # N = 65,536: whole launches, held on row ranges (knn_plain's [rows, N] scores)
    def held_on_rows(shapes):
        nonlocal gap
        long = {}
        for b, n, d, k in shapes:
            x, ties = gauss(b, n, d), lattice(b, n, d, False)
            whole, whole_ties = wide(x, k), wide(ties, k)
            checked = []
            for rows in WIDE_LONG_ROWS:
                got = wide(x, k, rows)
                if not (torch.equal(got, whole[:, rows[0]:rows[1]])
                        and torch.equal(wide(ties, k, rows), whole_ties[:, rows[0]:rows[1]])):
                    fail(f"knn_wide: rows {rows} of {(b, n, d, k)} differ from the whole "
                         "launch's")
                near, err = knn_check(x, got, KN.knn_plain(x, k, rows), False, row0=rows[0])
                knn_check(ties, whole_ties[:, rows[0]:rows[1]], KN.knn_plain(ties, k, rows), True,
                          row0=rows[0])
                gap = max(gap, err)
                checked.append(dict(rows=list(rows), differing_near_ties=near, max_score_gap=err))
            same_bf16(x, k, WIDE_LONG_ROWS[1])
            ms = cuda_ms(lambda: KN._knn_wide_cuda(x, k), 3)
            bound, by = bound_ms(*knn_work(b, n, d, k))
            long[f"{b}x{n}x{d}_k{k}"] = dict(
                ms=ms, ms_bf16=cuda_ms(lambda: KN._knn_wide_cuda(x.bfloat16(), k), 3),
                bound_ms=bound, bound_by=by, roofline_share=bound / ms,
                geometry=knn_geometry(b, n, d, k, wide=True), rows_checked=checked,
                bf16_equal_on_rows=list(WIDE_LONG_ROWS[1]))
            if k > KN.WIDE_MAX_K:
                long[f"{b}x{n}x{d}_k{k}"]["selection_work_per_row"] = dict(zip(
                    ("row_passes", "candidate_passes"), knn_radix_work(x, k, row_step=n // 16)))
        return long

    long = held_on_rows(WIDE_LONG)

    # the cap's edge: B1 at N = 4096 beside the wide route at 4097, per score pair
    edge = {}
    for d in (3, 63):
        x4096, x4097 = gauss(4, 4096, d), gauss(4, 4097, d)
        b1 = cuda_ms(lambda: KN._knn_cuda(x4096, K), 10)
        w = cuda_ms(lambda: KN._knn_wide_cuda(x4097, K), 10)
        edge[f"d{d}"] = dict(b1_4096_ms=b1, wide_4097_ms=w,
                             wide_per_pair_over_b1=(w / 4097 ** 2) / (b1 / 4096 ** 2))

    # k > 256: the radix route
    t_radix = time.perf_counter()
    radix_before, radix_gap = KN.knn.radix_launches, 0.0
    b, n, d, k = WIDE_RADIX
    x = gauss(b, n, d)
    clouds = {"ties": (lattice(b, n, d, False), True), "adjacent": (lattice(b, n, d, True), True),
              "equal": (torch.full((b, n, d), 0.5, device="cuda"), True),
              "line": (line_cloud(b, n, d), True), "gauss": (x, False)}
    cases = {}
    for name, (xc, exact) in clouds.items():
        near, err = knn_check(xc, wide(xc, k), KN.knn_plain(xc, k), exact)
        same_bf16(xc, k)
        radix_gap = max(radix_gap, err)
        cases[name] = dict(differing_near_ties=near, max_score_gap=err, bf16_equal=True)
    ms = cuda_ms(lambda: KN._knn_wide_cuda(x, k), 10)
    bound, by = bound_ms(*knn_work(b, n, d, k))
    radix = dict(B=b, N=n, D=d, k=k, ms=ms,
                 ms_bf16=cuda_ms(lambda: KN._knn_wide_cuda(x.bfloat16(), k), 10),
                 plain_ms=cuda_ms(lambda: KN.knn_plain(x, k), 5),
                 topk_ms=cuda_ms(lambda: torch.topk(pairwise_neg_sqdist(x), k), 5),
                 bound_ms=bound, bound_by=by, roofline_share=bound / ms, cases=cases,
                 geometry=knn_geometry(b, n, d, k, wide=True),
                 selection_work_per_row=dict(zip(("row_passes", "candidate_passes"),
                                                 knn_radix_work(x, k, row_step=n // 16))))
    gap_before, gap = gap, 0.0
    radix["long"] = held_on_rows(WIDE_LONG_RADIX)
    radix_gap, gap = max(radix_gap, gap), gap_before  # (the k <= 256 kernel's gap apart)
    # the k = 256 / 257 edge: the wide kernel beside the radix route, one cloud each D
    radix["edge_256_257"] = {}
    for d in (3, 63):
        x = gauss(2, 1024, d)
        w = cuda_ms(lambda: KN._knn_wide_cuda(x, 256), 10)
        r = cuda_ms(lambda: KN._knn_wide_cuda(x, 257), 10)
        radix["edge_256_257"][f"2x1024x{d}"] = dict(wide_k256_ms=w, radix_k257_ms=r,
                                                     radix_over_wide=r / w)
    radix.update(max_score_gap=radix_gap, seconds=time.perf_counter() - t_radix,
                 # (timed launches included: the kernels line counts the main path's)
                 launches_in_phase=KN.knn.radix_launches - radix_before)

    # half of each cloud's rows, index for index the whole launch's, timed beside it
    halves = {}
    for b, n, d, k in ((4, 8192, 3, 20), (4, 8192, 63, 20), (B, 1024, 128, 20)):
        x = gauss(b, n, d)
        whole = KN._knn_wide_cuda(x, k)
        for half in ((0, n // 2), (n // 2, n)):
            if not torch.equal(KN._knn_wide_cuda(x, k, rows=half), whole[:, half[0]:half[1]]):
                fail(f"knn_wide: rows {half} of {(b, n, d, k)} differ from the whole launch's")
        ms = cuda_ms(lambda: KN._knn_wide_cuda(x, k, rows=(n // 2, n)), 10)
        bound, by = bound_ms(*knn_work(b, n, d, k, rows=n - n // 2))
        halves[f"{b}x{n}x{d}_k{k}"] = dict(rows=[n // 2, n], equal_to_whole=True, ms=ms,
                                          whole_ms=cuda_ms(lambda: KN._knn_wide_cuda(x, k), 10),
                                          bound_ms=bound, bound_by=by)
    out = dict(shapes=shapes, long=long, edge_4096_4097=edge, radix=radix,
               half_cloud=halves, max_score_gap=gap, ms=sum(r["ms"] for r in shapes),
               ms_bf16=sum(r["ms_bf16"] for r in shapes),
               plain_ms=sum(r["plain_ms"] for r in shapes),
               topk_ms=sum(r["topk_ms"] for r in shapes),
               bound_ms=sum(r["bound_ms"] for r in shapes),
               bf16_bound_ms=sum(r["bf16_bound_ms"] for r in shapes), card=card)
    out["bound_by"] = ("operations" if all(r["bound_by"] == "operations" for r in shapes)
                       else "bytes")
    emit("knn_wide", **out)
    return out


LONG_B, LONG_N = 4, 8192  # the long cloud: the flagship served at N = 8192
LONG_REQUESTS = 3  # requests at N = 8192 (and at k = 40): 1 warm-up + 2 timed
LONG_K = 40
LONG_RADIX_K = 300  # the flagship at k > 256: the wide route's radix route
# `python -m hpcs_torch.train` on cli.py's synthetic splits (64 / 16 / 16
# objects) at N = 8192, the flagship's k and widths, batches of 4 (at 16 the
# hyperbolic loss's 6.5 M triplets of 32 wide do not fit the card's 80 GB):
# 16 training steps, 4 validation and 4 test batches
LONG_TRAIN_B = 4
LONG_TRAIN_FLAGS = ["--dataset", "synthetic", "--fixed_points", str(LONG_N), "--k", str(K),
                    "--eucl_embedding", str(EUCL), "--hyp_embedding", str(HYP), "--batch",
                    str(LONG_TRAIN_B), "--epochs", "1", "--log", "logs"]


def _served_and_held(system, batches, bf16=False):
    """The requests through HypHCSystem.embed, counted (_counts) and timed,
    every output of the expected shape, finite and inside the ball; then
    request 0 held: its three graphs (recorded) against knn_plain up to
    near-ties (knn_check), and its output against the plain forward on the
    card on those graphs, as the forward phase holds it (from the kernels'
    stage-1 output elementwise, atol 1e-4 / rtol 1e-3; in full within 1e-4 +
    1e-3 max |ref|), or in bf16 within BF16_FORWARD_SHARE of the output's
    largest entry (the bf16 phase's rule).  Request 0 is the warm-up: the
    median ms is the others'."""
    from hpcs_torch.models import decode_vector_for_batch
    from hpcs_torch.nn.backbones import vn_dgcnn
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN

    k, (b, n) = system.cfg.k, batches[0]["points"].shape[:2]
    dvs = [decode_vector_for_batch(system.cfg, bt) for bt in batches]
    outputs, ms = [], []
    with torch.no_grad():
        _counts(reset=True)
        for r, (bt, dv) in enumerate(zip(batches, dvs)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if r == 0:  # the warm-up request, its graphs recorded
                with recorded_knn() as pairs:
                    outputs.append(system.embed(bt["points"], dv))
            else:
                outputs.append(system.embed(bt["points"], dv))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        launches = _counts()
        for x_e, x_p in outputs:
            if x_e.shape != (b, n, system.cfg.eucl_dim) or x_p.shape != (b, n, HYP):
                fail(f"long_cloud: output shapes {tuple(x_e.shape)}, {tuple(x_p.shape)}")
            if not (torch.isfinite(x_e).all() and torch.isfinite(x_p).all()
                    and (x_p.float().norm(dim=-1) < 1).all()):
                fail("long_cloud: non-finite embeddings or outside the unit ball")
        near = gap = 0
        for x, idx in pairs:
            m, err = knn_check(x, idx, KN.knn_plain(x, k), False)
            near, gap = near + m, max(gap, err)
        graphs = tuple(idx for _, idx in pairs)
        if bf16:
            stage1 = None
        else:
            stage1 = E.edgeconv_infer(pairs[0][0][:, :, None, :].contiguous(), graphs[0],
                                      *request_weights(system)[0])

        def after_stage1(x, idx, *w, n_convs=2):
            return stage1 if x.shape[2] == 1 else E.edgeconv_infer_plain(x, idx, *w,
                                                                         n_convs=n_convs)

        try:
            vn_dgcnn.knn, vn_dgcnn.edgeconv_infer = KN.knn_plain, E.edgeconv_infer_plain
            ref_full = system.embed(batches[0]["points"], dvs[0], idx_override=graphs)
            torch.cuda.synchronize()
            t = time.perf_counter()
            system.embed(batches[0]["points"], dvs[0])
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t) * 1e3
            if not bf16:
                vn_dgcnn.edgeconv_infer = after_stage1
                ref_after1 = system.embed(batches[0]["points"], dvs[0], idx_override=graphs)
        finally:
            vn_dgcnn.knn, vn_dgcnn.edgeconv_infer = KN.knn, E.edgeconv_infer
    out = dict(B=b, N=n, k=k, requests=len(batches), launches=launches, forward_ms_all=ms,
               forward_ms_median=float(np.median(ms[1:])), plain_forward_ms=plain_ms,
               graph_entries_differing_at_near_ties=near, graph_max_score_gap=gap)
    if bf16:
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(outputs[0], ref_full))
        share = err / max(float(w.float().abs().max()) for w in ref_full)
        if not share <= BF16_FORWARD_SHARE:
            fail(f"long_cloud: the bf16 forward is {share:.3e} of its largest entry from the "
                 "plain bf16 forward")
        out.update(max_abs_err_vs_plain_gpu=err, max_abs_err_share_vs_plain_gpu=share)
        return out
    after1_err, after1_bad = forward_diff(outputs[0], ref_after1)
    if after1_bad:
        fail(f"long_cloud: the forward differs from the plain forward run from the kernels' "
             f"stage-1 output: {after1_bad} outputs beyond atol 1e-4 / rtol 1e-3, max "
             f"{after1_err:.3e}")
    full_err, full_bad = forward_diff(outputs[0], ref_full, scale_tol=True)
    out.update(max_abs_err_vs_plain_gpu_from_stage1=after1_err, max_abs_err_vs_plain_gpu=full_err,
               outputs_beyond_elementwise_tol_vs_plain_gpu=full_bad)
    return out


def long_cloud_phase(card):
    """The flagship served where B1 does not reach, through the wide route
    (eucl = hyp = 32, 16 categories, 50 classes, random weights and
    BatchNorm statistics from SEED; backbone_system): (a) LONG_REQUESTS
    requests of LONG_B synthetic clouds of LONG_N = 8192 points (k = 20),
    3 wide and 3 B2 launches each, and two in bf16 (3 wide and 3 B2
    launches on bf16 each); (b) LONG_REQUESTS requests of the flagship's B = 16
    clouds of N = 1024 at k = LONG_K = 40, 3 wide and 3 B2 (at K = 40)
    launches each; (c) the same requests at k = LONG_RADIX_K = 300, 3
    wide launches on the radix route and 3 B2 (at K = 300) each; each held
    by _served_and_held; the wide route's selection work per row on the
    long cloud's stage inputs; (d)
    `python -m hpcs_torch.train --dataset synthetic --fixed_points 8192`
    (LONG_TRAIN_FLAGS) in a temporary working directory: 3 wide launches a
    training step, a validation and a test batch, 3 B2 launches a
    validation and a test batch.  The point-sharded forward at N = 8192 is
    the parallel phase's.  Emits the `long_cloud` line; its `launches` sum
    every run's (_counts)."""
    import tempfile

    from hpcs_torch import train
    from hpcs_torch.data import SyntheticPartDataset
    from hpcs_torch.testing import knn_stream_work

    t0 = time.time()
    long = [_synthetic(LONG_B, LONG_N, seed=7 + r) for r in range(LONG_REQUESTS)]
    system = backbone_system(dict(eucl_dim=EUCL))
    served = _served_and_held(system, long)
    want = _launches(knn=3 * LONG_REQUESTS, edgeconv=3 * LONG_REQUESTS, wide=3 * LONG_REQUESTS)
    if served["launches"] != want:
        fail(f"long_cloud: N = {LONG_N} launched {served['launches']}, expected {want}")
    stages = request_stages(system, long[0]["points"])
    served["selection_work_per_row"] = {
        name: dict(zip(("merges", "insertions"), knn_stream_work(x, K, row_step=LONG_N // 16)))
        for name, x in (("points_d3", stages[0]), ("stage2_d63", stages[4]),
                        ("stage3_d63", stages[7]))}
    del stages, system

    bf16_system = backbone_system(dict(eucl_dim=EUCL, bf16=True))
    bf16 = _served_and_held(bf16_system, long[:2], bf16=True)
    want = _launches(knn=6, edgeconv=6, wide=6, bf16=True)
    if bf16["launches"] != want:
        fail(f"long_cloud: bf16 at N = {LONG_N} launched {bf16['launches']}, expected {want}")
    del bf16_system

    data = SyntheticPartDataset(num_objects=B * LONG_REQUESTS, npoints=N,
                                num_categories=CATEGORIES, seed=SEED)
    wide_k = [dict(zip(("points", "category", "labels"), data.batch(r * B, B)))
              for r in range(LONG_REQUESTS)]
    k40 = _served_and_held(backbone_system(dict(eucl_dim=EUCL, k=LONG_K)), wide_k)
    want = _launches(knn=3 * LONG_REQUESTS, edgeconv=3 * LONG_REQUESTS, wide=3 * LONG_REQUESTS)
    if k40["launches"] != want:
        fail(f"long_cloud: k = {LONG_K} launched {k40['launches']}, expected {want}")
    k300 = _served_and_held(backbone_system(dict(eucl_dim=EUCL, k=LONG_RADIX_K)), wide_k)
    want = _launches(knn=3 * LONG_REQUESTS, edgeconv=3 * LONG_REQUESTS, wide=3 * LONG_REQUESTS,
                     radix=3 * LONG_REQUESTS)
    if k300["launches"] != want:
        fail(f"long_cloud: k = {LONG_RADIX_K} launched {k300['launches']}, expected {want}")

    cwd = os.getcwd()
    tmp = tempfile.TemporaryDirectory()
    try:
        os.chdir(tmp.name)
        _counts(reset=True)
        t = time.perf_counter()
        _, results = train.main(LONG_TRAIN_FLAGS)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        train_launches = _counts()
        with open(os.path.join("logs", "synthetic_vn_dgcnn_partseg", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    finally:
        os.chdir(cwd)
        tmp.cleanup()
    steps, val, test = 64 // LONG_TRAIN_B, 16 // LONG_TRAIN_B, -(-16 // LONG_TRAIN_B)
    want = _launches(knn=3 * (steps + val + test), edgeconv=3 * (val + test),
                     wide=3 * (steps + val + test))
    if train_launches != want:
        fail(f"long_cloud: train --fixed_points {LONG_N} launched {train_launches}, "
             f"expected {want}")
    if not all(np.isfinite(v) for v in results.values() if isinstance(v, float)):
        fail(f"long_cloud: train's test results are not finite: {results}")
    runs = (served["launches"], bf16["launches"], k40["launches"], k300["launches"],
            train_launches)
    out = dict(long_cloud=served, long_cloud_bf16=bf16, k40=k40, k300=k300,
               train=dict(flags=LONG_TRAIN_FLAGS, steps=steps, val_batches=val,
                          test_batches=test, launches=train_launches, seconds=train_s,
                          test_results=results, records=records),
               launches={c: sum(r[c] for r in runs) for c in COUNTERS},
               seconds=time.time() - t0, card=card)
    emit("long_cloud", **out)
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
    from hpcs_torch.data import DataLoader, ShapeNetDataset, fast_txt
    from hpcs_torch.data import loader as loader_module
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN
    from hpcs_torch.testing import check_same_test_outputs, record_test_steps, write_mini_shapenet

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

        epochs = _check_trained_run("entry", run_dir, ckpt, trained, restored,
                                    (first_results, results), steps)

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


def _check_trained_run(tag, run_dir, ckpt, trained, restored, test_results, steps):
    """The records and checkpoints of `python -m hpcs_torch.train` run for
    2 epochs, then resumed for a third: epoch records 0, 1, 2 with every
    field finite, `steps` training steps an epoch, the two runs' test
    records equal to `test_results`, best/, last/ and final/ written, and
    final/ restored into a fresh system (and `restored`, infer's system)
    equal to `trained` in weights, optimizer moments and step.  Returns
    the epoch records."""
    from hpcs_torch.cli import freeze_hierarchy
    from hpcs_torch.models import HypHCSystem, ModelConfig
    from hpcs_torch.utils.checkpoint import load_config, restore_checkpoint

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    epochs = [r for r in records if "epoch" in r]
    tests = [r for r in records if "epoch" not in r]
    if [r["epoch"] for r in epochs] != [0, 1, 2] or len(tests) != 2:
        fail(f"{tag}: records of epochs {[r['epoch'] for r in epochs]} and {len(tests)} "
             f"test records, expected epochs 0, 1, 2 and 2 test records")
    names = {"epoch", "train_total_loss", "loss_metric", "loss_hyp", "train_acc",
             "train_iou", "scale", "val_loss", "acc", "iou", "lr", "temperature",
             "epoch_time_s", "step", "_time"}
    for r in epochs:
        if set(r) != names:
            fail(f"{tag}: epoch record keys {sorted(r)}")
        if not all(np.isfinite(r[k]) for k in ("train_total_loss", "loss_metric", "loss_hyp",
                                                "val_loss")) or r["scale"] == 1e-3:
            fail(f"{tag}: epoch record {r}")
    if [r["step"] for r in epochs] != [steps, 2 * steps, 3 * steps]:
        fail(f"{tag}: steps {[r['step'] for r in epochs]}")
    for r, want in zip(tests, test_results):
        if set(r) != {"test_loss", "score", "test_acc", "test_iou", "_time"} or any(
                r[k] != v for k, v in want.items()) or not np.isfinite(r["test_loss"]):
            fail(f"{tag}: test record {r} against {want}")
    for name in ("best", "last", "final"):
        if sorted(os.listdir(os.path.join(ckpt, name))) != ["config.json", "model.ckpt"]:
            fail(f"{tag}: checkpoint {name} holds {os.listdir(os.path.join(ckpt, name))}")

    # final/ restored into a fresh system equals the trained one
    cfg_dict = load_config(os.path.join(ckpt, "final"))
    cfg_dict["hierarchy_list"] = freeze_hierarchy(cfg_dict["hierarchy_list"])
    fresh = HypHCSystem(ModelConfig(**cfg_dict), generator=torch.Generator().manual_seed(7))
    restore_checkpoint(os.path.join(ckpt, "final"), fresh)
    for label, sd in (("restored", fresh.state_dict()), ("infer", restored.state_dict())):
        want = trained.state_dict()
        for k, v in want["net"].items():
            if not torch.equal(sd["net"][k], v):
                fail(f"{tag}: {label} state differs from the trained one at {k}")
        for p, st in want["optimizer"]["state"].items():
            if not all(torch.equal(sd["optimizer"]["state"][p][k], v)
                       for k, v in st.items() if torch.is_tensor(v)):
                fail(f"{tag}: {label} optimizer state differs at parameter {p}")
        if sd["step"] != want["step"]:
            fail(f"{tag}: {label} step {sd['step']} against {want['step']}")
    return epochs


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
    from hpcs_torch.ops import _build
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
        # the stages' weights as the forward takes them (prepared once:
        # vn_dgcnn.stage_weights); the two-conv stages run edge_tc_kernel,
        # conv2 on the tensor cores: its HMMA read from the SASS, its bound
        # with conv2's three limb products at the tensor-core rate beside
        # the fp32 route's bound (all at 67 TFLOP/s)
        net = sys16.net.nn_feat
        weights = [vn_dgcnn.stage_weights(*convs)
                   for convs in ((net.conv1, net.conv2), (net.conv3, net.conv4), (net.conv5,))]
        stage_in = [pairs[0][0][:, :, None, :].contiguous(),
                    pairs[1][0].reshape(B, N, 21, 3), pairs[2][0].reshape(B, N, 21, 3)]
        ptx = ptxas_summary(_build.build_log("edgeconv"))
        hmma = sass_mma_counts("edgeconv")
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
            work = edgeconv_work(B, N, x.shape[2], K, nc, feature_bytes=2, tensor_cores=nc == 2)
            bound, by = bound_ms(*work[:2], *work[2:])
            fp32_bound = bound_ms(*edgeconv_work(B, N, x.shape[2], K, nc, feature_bytes=2))[0]

            def stage(x=x, idx=idx, w=w, nc=nc):
                return E.edgeconv_infer(x, idx, *w, n_convs=nc)

            parts = kernel_ms(stage, 20)
            ms = sum(parts.values())
            tc = f"edge_tc_kernel<{x.shape[2]}>"
            if nc == 2 and (not any(tc in name for name in parts)
                            or any("memcpy" in name.lower() for name in parts)):
                fail(f"bf16: B2 {st} ran {list(parts)}: not {tc} alone, or a copy")
            if nc == 2 and not hmma.get(tc):
                fail(f"bf16: no HMMA in {tc}'s SASS ({hmma})")
            ec_rows[st] = dict(C=x.shape[2], n_convs=nc, **checked, ms=ms,
                               call_ms=cuda_ms(stage, 20), by_kernel_ms=parts,
                               plain_ms=cuda_ms(lambda x=x, idx=idx, w=w, nc=nc:
                                                E.edgeconv_infer_plain(x, idx, *w, n_convs=nc), 5),
                               bound_ms=bound, bound_by=by, roofline_share=bound / ms,
                               fp32_rate_bound_ms=fp32_bound,
                               fp32_rate_roofline_share=fp32_bound / ms,
                               ptxas={k: v for k, v in ptx.items()
                                      if any(k in name for name in parts)},
                               **({"hmma_in_sass": hmma[tc], "mma_per_edge": hmma[tc] / 8}
                                  if nc == 2 else {}))

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
    ec_work = [edgeconv_work(B, N, r["C"], K, r["n_convs"], feature_bytes=2, tensor_cores=True)
               for r in ec_rows.values()]
    ec_bound = bound_ms(*(sum(w[i] for w in ec_work) for i in range(3)))
    ec_fp32_bound = bound_ms(*(sum(edgeconv_work(B, N, r["C"], K, r["n_convs"],
                                                 feature_bytes=2)[i] for r in ec_rows.values())
                               for i in range(2)))[0]
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
        edgeconv_bound_ms_per_forward=ec_bound[0], edgeconv_bound_by=ec_bound[1],
        edgeconv_fp32_rate_bound_ms_per_forward=ec_fp32_bound, edgeconv_max_abs_err=ec_err,
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


def bf16_phase_alone(card):
    """bf16_phase on the flagship model and requests (scripts/chip_phase.py
    bf16), with no fp32 phase's readings beside it."""
    system, _, batches = flagship()
    return bf16_phase(system, batches, card, fp32=None)


def import_phase(system, cfg, batches, card, keep=None):
    """What hpcs_tpu's users hold, on the card: an hpcs_tpu-format checkpoint
    (testing.write_flax_checkpoint, flax's msgpack layout) of the forward
    phase's weights after 2 training steps, served by infer and resumed by
    train --resume; the same state as hpcs_tpu's multi-process orbax
    directory (testing.write_orbax_checkpoint, 1 and 2 processes), restored
    bit for bit, served as the msgpack and resumed; a reference Lightning
    checkpoint imported by
    import_checkpoint and served; the rest of the decode API on 4 flagship
    objects against the CPU port and scipy.  With `keep`, a copy of the
    hpcs_tpu-format checkpoint is left in that directory."""
    import contextlib
    import io
    import shutil
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
                                    write_flax_checkpoint, write_mini_shapenet,
                                    write_orbax_checkpoint)
    from hpcs_torch.utils import flax_msgpack
    from hpcs_torch.utils.checkpoint import load_config, restore_checkpoint
    from hpcs_torch.utils.orbax_dir import read_orbax_state

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
        if keep:
            shutil.copytree(flax_dir, keep)
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
        n_train, n_val, n_test = (len(ENTRY_CATEGORIES) * n for n in ENTRY_SPLITS)
        steps, val_batches = n_train // TRAIN_B, n_val // TRAIN_B
        test_batches = min(10, -(-n_test // TRAIN_B))

        def resume(what, ckpt, log):
            """train --resume from ckpt for one epoch, logs under `log`: the
            first step must start from the written state, the epoch be the
            stored one + 1.  Returns (call seconds, epoch seconds)."""
            first = []
            original = HypHCSystem.train_step

            def recorded(self, batch, generator):
                if not first:
                    try:
                        same_state(self, f"the first step resumed from {what}")
                        first.append(True)
                    except RuntimeError as e:
                        first.append(str(e))
                return original(self, batch, generator)

            HypHCSystem.train_step = recorded
            try:
                t = time.perf_counter()
                run(f"train --resume ({what})", train.main,
                    ENTRY_FLAGS + ["--epochs", str(IMPORT_EPOCH + 2), "--resume", ckpt,
                                   "--log", log],
                    want={"knn": 3 * (steps + val_batches + test_batches), "knn_wide": 0,
                          "edgeconv": 3 * (val_batches + test_batches)})
                seconds = time.perf_counter() - t
            finally:
                HypHCSystem.train_step = original
            if first != [True]:
                fail(f"import: the run resumed from {what} did not start from the written "
                     f"state: {first}")
            with open(os.path.join(log, "shapenet_vn_dgcnn_partseg", "metrics.jsonl")) as f:
                epochs = [r for r in map(json.loads, f) if "epoch" in r]
            if [r["epoch"] for r in epochs] != [IMPORT_EPOCH + 1] or \
                    epochs[0]["step"] != src.step + steps:
                fail(f"import: epochs resumed from {what} "
                     f"{[(r['epoch'], r['step']) for r in epochs]}, expected epoch "
                     f"{IMPORT_EPOCH + 1} ending at step {src.step + steps}")
            return seconds, epochs[0]["epoch_time_s"]

        resume_s, resume_epoch_s = resume("the msgpack checkpoint", flax_dir, "logs")

        # 1b. the same state as hpcs_tpu's multi-process checkpoint, an orbax
        # directory (testing.write_orbax_checkpoint; the port needs no
        # orbax), written as 1 and as 2 processes save it: read bit for bit,
        # served as the msgpack, resumed
        orbax = {}
        for processes in (1, 2):
            what = f"the orbax directory of {processes} process(es)"
            odir = os.path.join(tmp.name, f"hpcs_tpu_orbax_{processes}")
            write_orbax_checkpoint(odir, src, cfg, epoch=IMPORT_EPOCH, processes=processes)
            mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, files in
                     os.walk(os.path.join(odir, "orbax")) for f in files) / 2 ** 20
            o_read_ms = host_ms(lambda: read_orbax_state(os.path.join(odir, "orbax")), 3)
            fresh = HypHCSystem(cfg, generator=torch.Generator().manual_seed(7))
            o_restore_ms = host_ms(lambda: restore_checkpoint(odir, fresh), 3)
            if restore_checkpoint(odir, fresh)[0] != IMPORT_EPOCH + 1:
                fail(f"import: {what} must resume at its epoch + 1")
            same_state(fresh, f"restore_checkpoint of {what}")
            t = time.perf_counter()
            with record_test_steps() as served_orbax:
                orbax_sys, orbax_results = run(f"infer ({what})", infer.main,
                                               infer_argv + ["--model_path", odir],
                                               want=served(2))
            infer_s = time.perf_counter() - t
            same_state(orbax_sys, f"infer of {what}")
            try:
                rel = check_same_test_outputs(served_orbax, served_flax)
            except AssertionError as e:
                fail(f"import: infer of {what} differs from the msgpack checkpoint's: {e}")
            o_resume_s, o_epoch_s = resume(what, odir, f"logs_orbax_{processes}")
            orbax[f"processes_{processes}"] = dict(
                checkpoint_mb=mb, read_ms=o_read_ms, read_mb_per_s=mb / o_read_ms * 1e3,
                restore_ms=o_restore_ms, infer_call_seconds=infer_s,
                infer_seconds_per_request=[c["seconds"] for c in served_orbax],
                infer_results=orbax_results, infer_vs_msgpack_max_rel_log_diff=rel,
                resume_call_seconds=o_resume_s, resume_epoch_seconds=o_epoch_s)
        print(json.dumps({"import_checkpoint_sizes": {
            "msgpack": dict(mb=size_mb, read_ms=read_ms, restore_ms=restore_ms),
            **{k: dict(mb=v["checkpoint_mb"], read_ms=v["read_ms"], restore_ms=v["restore_ms"])
               for k, v in orbax.items()}}, "card": card}), flush=True)

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
               resume_call_seconds=resume_s, resume_epoch_seconds=resume_epoch_s, orbax=orbax,
               import_checkpoint_seconds=import_s, imported_lines=printed.getvalue().splitlines(),
               decode_objects=DECODE_OBJECTS, decode_ms_per_object=per_obj,
               sequential_linkage_steps=N - 1, sequential_linkage_kernels=seq_kernels,
               sequential_linkage_device_ms=seq_device_ms,
               max_abs_err_euclidean_d_vs_cpu=euclid_gap, max_height_err_vs_scipy=scipy_h,
               sizes_equal_scipy=scipy_sizes, tied_distance_pairs=tied_pairs,
               eval_clustering=scores, seconds=time.perf_counter() - t_phase, card=card)
    emit("import", **out)
    return out


EXAMPLE_EPOCHS = 80  # examples/api_tour_torch.py's default, as the JAX example's
EXAMPLE_NOISES = 5  # examples/eval_noise_torch.py's default jitters


def examples_phase(card):
    """The port's examples on the card: examples/api_tour_torch.py at its
    own sizes (80 epochs of 4 batches of 4 clouds of 128 points), its
    trained system written as hpcs_tpu's 2-process orbax directory
    (testing.write_orbax_checkpoint), and examples/eval_noise_torch.py on
    that directory on the card and on the CPU: the embeddings within atol
    2e-4 / rtol 1e-3, every score in [0, 1], B1 and B2 counted."""
    import contextlib
    import io
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import api_tour_torch
    import eval_noise_torch

    from hpcs_torch.testing import write_orbax_checkpoint

    t_phase = time.perf_counter()
    launches = {}
    printed = io.StringIO()
    _counts(reset=True)
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        tour = api_tour_torch.main(["--device", "cuda", "--epochs", str(EXAMPLE_EPOCHS)])
    torch.cuda.synchronize()
    tour_s = time.perf_counter() - t
    steps = EXAMPLE_EPOCHS * 4
    # VN-DGCNN: B1 3 a training step and a test_step, B2 3 a test_step only
    launches["api_tour"] = _counts(reset=True)
    if launches["api_tour"] != _launches(knn=3 * steps + 3, edgeconv=3):
        fail(f"examples: api_tour launched {launches['api_tour']}, expected B1 3 a step over "
             f"{steps} steps and a test_step, B2 3")
    system, dec = tour["system"], tour["decode"]
    if system.step != steps or not all(np.isfinite(v) for v in tour["train_logs"].values()) \
            or not 0.0 <= dec["score"] <= 1.0 or not 0.0 <= dec["best_score"] <= 1.0:
        fail(f"examples: api_tour ended at step {system.step}, logs {tour['train_logs']}, "
             f"scores {dec['score']}, {dec['best_score']}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "api_tour_orbax")
        write_orbax_checkpoint(ckpt, system, system.cfg, epoch=EXAMPLE_EPOCHS - 1, processes=2)
        flags = ["--ckpt", ckpt, "--out", ""]
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            on_card = eval_noise_torch.main(flags + ["--device", "cuda"])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        launches["eval_noise"] = _counts(reset=True)
        if launches["eval_noise"] != _launches(knn=3 * EXAMPLE_NOISES,
                                               edgeconv=3 * EXAMPLE_NOISES):
            fail(f"examples: eval_noise launched {launches['eval_noise']}, expected B1 and B2 "
                 f"3 times for each of {EXAMPLE_NOISES} noises")
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            on_cpu = eval_noise_torch.main(flags + ["--device", "cpu"])
        eval_cpu_s = time.perf_counter() - t
        if _counts(reset=True) != _launches():
            fail("examples: eval_noise on the CPU launched a kernel")
    gaps = []
    for c, h in zip(on_card, on_cpu):
        for key in ("x_euclidean", "x_poincare"):
            diff = (c[key] - h[key]).abs()
            if not bool((diff <= 2e-4 + 1e-3 * h[key].abs()).all()):
                fail(f"examples: eval_noise's {key} at noise {c['noise']} differs between the "
                     f"card and the CPU by {float(diff.max()):.3e}")
            gaps.append(float(diff.max()))
        if not (0.0 <= c["score"] <= 1.0 and 0.0 <= h["score"] <= 1.0):
            fail(f"examples: eval_noise scores {c['score']}, {h['score']} outside [0, 1]")
    out = dict(api_tour_epochs=EXAMPLE_EPOCHS, api_tour_steps=steps, api_tour_seconds=tour_s,
               api_tour_ms_per_step=tour_s / steps * 1e3, api_tour_train_logs=tour["train_logs"],
               api_tour_score=dec["score"], api_tour_object0=dict(best_k=dec["best_k"],
                                                                 score=dec["best_score"]),
               eval_noise_seconds=dict(card=eval_s, cpu=eval_cpu_s),
               eval_noise=[dict(noise=c["noise"], best_k_card=c["best_k"], best_k_cpu=h["best_k"],
                                score_card=c["score"], score_cpu=h["score"])
                           for c, h in zip(on_card, on_cpu)],
               max_abs_err_embeddings_card_vs_cpu=max(gaps), launches_by_run=launches,
               launches={k: sum(run[k] for run in launches.values()) for k in COUNTERS},
               printed=printed.getvalue().splitlines(), seconds=time.perf_counter() - t_phase,
               card=card)
    emit("examples", **out)
    return out


# hpcs_tpu's converged mini-ShapeNet-Part run, seeds 0-7 at the recipe's 80
# epochs (benchmarks/parity_real_format.json, "hpcs_tpu"): mean, std (ddof 1)
TPU_MINI_SHAPENET = {"decode_score_mean": (0.2499577347189188, 0.014495220601409663),
                     "decode_purity_mean": (0.4326171875, 0.015343445407218215)}
TPU_MINI_SHAPENET_SEEDS = 8
NOTEBOOK_SEEDS = (0, 1, 2, 3)  # the recipe's seeds trained on the card
MINI_SHAPENET_SPLITS = (3, 1, 2)  # train / val / test objects per category
NOTEBOOK_SCORE_ATOL = 1e-5  # the card's notebook scores against the CPU port's


def _run_cells(cells, cwd, npoints=None, record=None, held=None):
    """Run notebook code cells in order in one namespace from the
    directory `cwd`, the setup cell's NPOINTS set to `npoints` where given
    and PLOT set False after it.  With `record` (a list), every embedding
    the notebook's system makes is appended to it (numpy); with `held`
    (such a list), each is replaced by the next of those.  Returns (the
    namespace, the text the cells printed)."""
    import contextlib
    import io

    ns = {"__name__": "__main__"}
    printed, cwd0, path0 = io.StringIO(), os.getcwd(), list(sys.path)
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(printed):
            for i, cell in enumerate(cells):
                if npoints is not None:
                    cell = cell.replace("NPOINTS, BATCH = 256, 2", f"NPOINTS, BATCH = {npoints}, 2")
                exec(compile(cell, f"notebook cell {i}", "exec"), ns)
                if i == 0:
                    ns["PLOT"] = False
                    if record is not None:
                        ns["system"].embed = _recorded_embed(ns["system"], record, held)
    finally:
        os.chdir(cwd0)
        sys.path[:] = path0
    return ns, printed.getvalue()


def _recorded_embed(system, record, held=None):
    """system.embed, its outputs appended to `record` as numpy arrays and,
    with `held`, replaced by the next of those (numpy pairs)."""
    embed = system.embed

    def recorded(points, decode_vector, idx_override=None):
        out = embed(points, decode_vector, idx_override)
        record.append(tuple(t.cpu().numpy() for t in out))
        if held:
            out = tuple(torch.from_numpy(a).to(system.device) for a in held.pop(0))
        return out

    return recorded


def notebooks_phase(card, flagship_ckpt=None):
    """The per-category evaluation notebooks' path on the card: (a)
    mini-ShapeNet-Part written by tools/make_mini_datasets_torch.py and read
    back through ShapeNetDataset and the C++ txt parser; (b) the recipe of
    tools/parity_real_format_torch.py trained on the card for
    NOTEBOOK_SEEDS at 80 epochs and tested, its mean decode score and
    purity held to hpcs_tpu's (z >= -2); (c) examples/shapenet_eval_torch's
    code cells but the precision-recall cell on seed 0's checkpoint, on the
    card and on the CPU port (the embeddings within the eval forward's
    tolerance; on the card's embeddings best k and true parts equal, scores
    within NOTEBOOK_SCORE_ATOL); (d) its evaluate_category at the flagship's width
    (N = 1024, k = 20, eucl = hyp = 32, 16 categories, 50 classes) from an
    hpcs_tpu msgpack checkpoint (`flagship_ckpt`, the import phase's; else
    one written here the same way)."""
    import contextlib
    import io
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tools"))
    import make_eval_notebook_torch as nbgen
    import make_mini_datasets_torch as minidata
    import parity_real_format_torch as prf

    from hpcs_torch.data import SEG_CLASSES, ShapeNetDataset, fast_txt
    from hpcs_torch.decode import cosine_distance_matrix, decode_leaves, linkage_from_distances_mnn
    from hpcs_torch.models import HypHCSystem
    from hpcs_torch.testing import write_flax_checkpoint

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    launches = {}
    try:
        # (a) the mini dataset, read back by the port's reader and parser
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            raw = minidata.make_shapenet(os.path.join(root, "data"))
        write_s = time.perf_counter() - t
        if not fast_txt.available():
            fail("notebooks: the C++ txt parser did not build")
        counts = {}
        for cat in ("Airplane", "Cap"):
            for split, want in zip(("train", "val", "test"), MINI_SHAPENET_SPLITS):
                ds = ShapeNetDataset(raw, npoints=256, split=split, class_choice=cat)
                counts[f"{cat}/{split}"] = len(ds)
                if len(ds) != want:
                    fail(f"notebooks: {cat} {split} holds {len(ds)} objects, expected {want}")
                for i in range(len(ds)):
                    pts, _, seg = ds[i]
                    if pts.shape != (256, 3) or not set(np.unique(seg)) <= set(SEG_CLASSES[cat]):
                        fail(f"notebooks: {cat} {split} item {i} read as {pts.shape}, labels "
                             f"{np.unique(seg)}")
        path = ShapeNetDataset(raw, split="test").datapath[0][1]
        if not np.array_equal(fast_txt.loadtxt(path), np.loadtxt(path).astype(np.float32)):
            fail(f"notebooks: the C++ parser's {path} differs from numpy.loadtxt's")

        # (b) the recipe trained on the card, seed by seed
        c = prf.CFGS["shapenet"]
        n_train, n_val, n_test = (2 * n for n in MINI_SHAPENET_SPLITS)
        steps = c["epochs"] * -(-n_train // c["batch_size"])
        evals = c["epochs"] * -(-n_val // c["batch_size"]) + -(-n_test // c["batch_size"])
        want = _launches(knn=3 * (steps + evals), edgeconv=3 * evals)
        out_dir, runs = os.path.join(root, "logs"), []
        for seed in NOTEBOOK_SEEDS:
            _counts(reset=True)
            r, _ = prf.run_torch("shapenet", seed, device="cuda", out=out_dir,
                                 data=os.path.join(root, "data"), log=lambda line: None)
            launches[f"train_s{seed}"] = _counts(reset=True)
            print(f"notebooks: seed {seed} trained in {r['train_wall_s']:.1f} s; test loss "
                  f"{r['test_loss']:.4f}, no-margin accuracy {r['test_acc_nomargin']:.4f}, "
                  f"decode score {r['decode_score_mean']:.4f}, purity "
                  f"{r['decode_purity_mean']:.4f}", file=sys.stderr, flush=True)
            if launches[f"train_s{seed}"] != want:
                fail(f"notebooks: seed {seed} launched {launches[f'train_s{seed}']}, expected "
                     f"{want} (B1 3 a step and a validation or test batch, B2 3 an eval batch)")
            if not all(np.isfinite(r[k]) for k in prf.RESULT_KEYS + ("test_loss",)):
                fail(f"notebooks: seed {seed}'s results are not finite: {r}")
            runs.append(dict(seed=seed, **{k: r[k] for k in (
                "test_loss", "test_acc_nomargin", "decode_score_mean", "decode_purity_mean",
                "train_wall_s", "n_test_objects")}))
        quality = {}
        for key, (mean, std) in TPU_MINI_SHAPENET.items():
            tpu = dict(mean=mean, std=std, stderr=std / np.sqrt(TPU_MINI_SHAPENET_SEEDS))
            quality[key] = dict(port=prf.aggregate([r[key] for r in runs]), hpcs_tpu=tpu,
                                **prf.compare(prf.aggregate([r[key] for r in runs]), tpu))

        # (c) the notebook's cells on seed 0's checkpoint: on the card, then
        # on the CPU port with its own embeddings and with the card's.  The
        # decode of trained embeddings moves with their rounding at near-tied
        # distances, so the rows are held on one set of embeddings, and the
        # two devices' embeddings within the eval forward's tolerance.
        ckpt = prf.checkpoint_dir(out_dir, "shapenet", NOTEBOOK_SEEDS[0])
        examples = os.path.join(root, "examples")
        os.makedirs(examples)
        tables, rows, cell_s, embedded = {}, {}, {}, {}
        for run, device, held in (("card", "cuda", None), ("cpu", "cpu", None),
                                  ("cpu_on_card_embeddings", "cpu", "card")):
            cells = nbgen.code_cells(nbgen.build(ckpt, device))[:-1]  # not precision-recall
            _counts(reset=True)
            t = time.perf_counter()
            embedded[run] = []
            ns, printed = _run_cells(cells, examples, record=embedded[run],
                                     held=None if held is None else list(embedded[held]))
            torch.cuda.synchronize()
            cell_s[run] = time.perf_counter() - t
            launches[f"notebook_{run}"] = _counts(reset=True)
            rows[run], tables[run] = ns["all_rows"], printed.splitlines()
            if run == "card":
                per_cat, scale = ns["per_cat"], ns["system"].net.scale[0].detach().cpu()
        # B1 and B2 3 times for each category's one test batch
        if launches["notebook_card"] != _launches(knn=6, edgeconv=6) \
                or launches["notebook_cpu"] != _launches() \
                or launches["notebook_cpu_on_card_embeddings"] != _launches():
            fail(f"notebooks: the notebook launched {launches['notebook_card']} on the card "
                 f"(expected B1 and B2 6 each) and {launches['notebook_cpu']} on the CPU")
        if not len(rows["card"]) == len(rows["cpu"]) == len(rows["cpu_on_card_embeddings"]) \
                == 2 * MINI_SHAPENET_SPLITS[2]:
            fail(f"notebooks: {len(rows['card'])} rows on the card, {len(rows['cpu'])} on the "
                 "CPU")
        embedding_gap = 0.0
        for card_out, cpu_out in zip(embedded["card"], embedded["cpu"]):
            for got, want_out in zip(card_out, cpu_out):
                diff = np.abs(got - want_out)
                embedding_gap = max(embedding_gap, float(diff.max()))
                if not (diff <= 2e-4 + 1e-3 * np.abs(want_out)).all():
                    fail(f"notebooks: the card's embeddings differ from the CPU port's by "
                         f"{float(diff.max()):.3e}, beyond atol 2e-4 / rtol 1e-3")
        score_gap = 0.0
        for got, on_cpu in zip(rows["card"], rows["cpu_on_card_embeddings"]):
            score_gap = max(score_gap, abs(got["score"] - on_cpu["score"]))
            if (got["category"], got["best_k"], got["true_parts"]) != (
                    on_cpu["category"], on_cpu["best_k"], on_cpu["true_parts"]) \
                    or abs(got["score"] - on_cpu["score"]) > NOTEBOOK_SCORE_ATOL:
                fail(f"notebooks: the card's row {got} differs from the CPU port's on the "
                     f"card's embeddings, {on_cpu}")
        own_rows_differing = sum(
            (a["best_k"], a["score"]) != (b["best_k"], b["score"])
            for a, b in zip(rows["card"], rows["cpu"]))
        # how near to ties the card's dendrograms are: per object, its
        # merges whose height lies within 1e-6 (relative) of the next one's,
        # and its median height
        near_ties = []
        for _, x_p in embedded["card"]:
            Z = linkage_from_distances_mnn(cosine_distance_matrix(
                decode_leaves(torch.from_numpy(x_p), scale)), method="complete")
            for h in Z[..., 2].double().numpy():
                near_ties.append(dict(merges=len(h), median_height=float(np.median(h)),
                                      near_tied=int(np.sum(np.diff(h) <= 1e-6 * h[1:]))))

        # (d) evaluate_category at the flagship's width, from hpcs_tpu's format
        if flagship_ckpt is None:
            flagship_ckpt = os.path.join(root, "flagship_hpcs_tpu")
            cfg = _flagship(dataset="shapenet")
            src = HypHCSystem(cfg, generator=torch.Generator().manual_seed(SEED))
            randomize_bn(src.net, torch.Generator().manual_seed(SEED))
            write_flax_checkpoint(flagship_ckpt, src, cfg)
        cells = nbgen.code_cells(nbgen.build(flagship_ckpt, "cuda"))[:2]  # setup, helpers
        ns, _ = _run_cells(cells, examples, npoints=N)
        fcfg = ns["cfg"]
        if (fcfg.eucl_dim, fcfg.hyp_dim, fcfg.k, fcfg.num_categories, fcfg.num_class,
                fcfg.pooling, fcfg.model_name) != (EUCL, HYP, K, CATEGORIES, 50, "mean",
                                                   "vn_dgcnn_partseg"):
            fail(f"notebooks: the flagship checkpoint restored as {fcfg}")
        flagship = {}
        for cat in ("Airplane", "Cap"):
            _counts(reset=True)
            torch.cuda.synchronize()
            t = time.perf_counter()
            cat_rows = ns["evaluate_category"](cat, plot=False)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            launched = _counts(reset=True)
            launches[f"flagship_{cat}"] = launched
            if launched != _launches(knn=3, edgeconv=3):
                fail(f"notebooks: the flagship {cat} evaluation launched {launched}, expected "
                     "B1 and B2 3 each (one batch)")
            if not all(0.0 <= r["score"] <= 1.0 and r["best_k"] >= 1 for r in cat_rows):
                fail(f"notebooks: flagship rows {cat_rows}")
            flagship[cat] = dict(ms=ms, rows=cat_rows)
    finally:
        tmp.cleanup()
    out = dict(dataset=dict(seconds_to_write=write_s, objects=counts,
                            txt_parser="C++ (hpcs_torch/data/csrc/fast_txt.cpp)"),
               recipe={k: v for k, v in prf.CFGS["shapenet"].items() if k != "seed"},
               seeds=runs, quality=quality,
               train_s_per_seed=[r["train_wall_s"] for r in runs],
               notebook=dict(rows_card=rows["card"],
                             rows_cpu_on_card_embeddings=rows["cpu_on_card_embeddings"],
                             rows_cpu_own_embeddings=rows["cpu"],
                             max_score_gap_card_vs_cpu=score_gap, score_atol=NOTEBOOK_SCORE_ATOL,
                             own_embedding_rows_differing=own_rows_differing,
                             card_dendrograms=near_ties,
                             max_abs_err_embeddings_card_vs_cpu=embedding_gap,
                             per_category=per_cat, seconds=cell_s, printed_card=tables["card"]),
               flagship=dict(N=N, k=K, eucl=EUCL, hyp=HYP, categories=CATEGORIES, batch=2,
                             ms_per_category={c: v["ms"] for c, v in flagship.items()},
                             rows={c: v["rows"] for c, v in flagship.items()}),
               launches_by_run=launches,
               launches={k: sum(run[k] for run in launches.values()) for k in COUNTERS},
               seconds=time.perf_counter() - t_phase, card=card)
    emit("notebooks", **out)
    for key, q in quality.items():
        if q["z"] < -2:
            fail(f"notebooks: the card-trained {key} {q['port']['mean']:.4f} is below "
                 f"hpcs_tpu's {q['hpcs_tpu']['mean']:.4f} by {-q['z']:.2f} combined standard "
                 "errors (z < -2)")
    return out


# hpcs_tpu's converged mini-PartNet run (Bottle, level 3, hierarchical CosFace
# over levels [1, 3]), seeds 0-7 at the recipe's 80 epochs
# (benchmarks/parity_real_format_partnet.json, "hpcs_tpu"): mean, std (ddof 1)
TPU_MINI_PARTNET = {"decode_score_mean": (0.0997028760612011, 0.015706302039676774),
                    "decode_purity_mean": (0.221435546875, 0.02034942289359577)}
TPU_MINI_PARTNET_NOMARGIN = (0.133056640625, 0.009536228711012486)  # test_acc_nomargin, printed
TPU_MINI_PARTNET_SEEDS = 8
PARTNET_SPLITS = (8, 8, 8)  # Bottle objects: train, val, test; a batch of TRAIN_B each
PARTNET_FLAGS = ["--dataset", "partnet", "--category", "Bottle", "--level", "3"] + ENTRY_FLAGS[2:]
PARTNET_LEVELS = [1, 3]  # the levels the mini tree holds: the hierarchy's
PARTNET_H5_OBJECTS = 16  # 10,000-point objects in the deflated file the reader is timed on
PARTNET_STEP_B, PARTNET_STEP_N = 2, N  # the card-vs-CPU training step
PARTNET_WARMUP, PARTNET_TIMED = 2, 5  # the trained system's steps at B = TRAIN_B, N


def _h5_read_ms(hdf5, path, reps=3):
    """The median ms of reading every dataset of `path` with
    hpcs_torch.utils.hdf5, and the arrays."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        with hdf5.File(path) as f:
            arrays = {k: f[k][...] for k in f.keys()}
        times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times)), arrays


def _read_latest_fixtures(here, hdf5, PartNetDataset):
    """The fixtures of tools/make_hdf5_fixtures_torch.py under
    tests/fixtures/hdf5_latest, read through hpcs_torch.utils.hdf5 (and the
    PartNet-shaped one through PartNetDataset), each array equal to the
    tool's recipe (partnet_arrays, dense_arrays) recomputed here; fails
    otherwise.  Returns the files, their bytes, what they hold and the ms
    of each read."""
    sys.path.insert(0, os.path.join(here, "tools"))
    import make_hdf5_fixtures_torch as fx

    root = os.path.join(here, "tests", "fixtures", "hdf5_latest")
    checks, ms = {fx.PARTNET_FILE: fx.partnet_arrays(), fx.DENSE_FILE: fx.dense_arrays()}, {}
    for name, arrays in checks.items():
        t = time.perf_counter()
        with hdf5.File(os.path.join(root, name)) as f:
            got = {key: f[key][...] for key in arrays}
            groups = {"/": sorted(f.keys())}
            if name == fx.DENSE_FILE:
                groups["objects"] = sorted(f["objects"].keys())
        ms[name] = (time.perf_counter() - t) * 1e3
        for key, want in arrays.items():
            if got[key].dtype != want.dtype or not np.array_equal(got[key], want):
                fail(f"partnet: the fixture {name}'s {key} reads as {got[key].dtype} "
                     f"{got[key].shape}, not the recipe's {want.dtype} {want.shape}")
        tops = sorted({key.split("/")[0] for key in arrays})
        inner = sorted(key[len("objects/"):] for key in arrays if key.startswith("objects/"))
        if groups["/"] != tops or groups.get("objects", inner) != inner:
            fail(f"partnet: the fixture {name}'s groups list {groups}")
    t = time.perf_counter()
    ds = PartNetDataset(os.path.join(root, fx.PARTNET_LIST), fx.PARTNET_POINTS)
    ms["PartNetDataset"] = (time.perf_counter() - t) * 1e3
    want = fx.partnet_arrays()
    if not (np.array_equal(ds.points, want["data"]) and np.array_equal(ds.label_seg,
                                                                      want["label_seg"])
            and np.array_equal(ds.data_num, want["data_num"]) and len(ds) == fx.PARTNET_OBJECTS):
        fail(f"partnet: PartNetDataset reads the fixture {fx.PARTNET_FILE} unequal to the recipe")
    return dict(files={n: os.path.getsize(os.path.join(root, n)) for n in checks},
                objects=fx.PARTNET_OBJECTS, dense_links={"/": fx.DENSE_ROOT + 1,
                                                         "objects": fx.DENSE_OBJECTS + 1},
                equal_to_recipe=True, read_ms=ms)


def partnet_phase(card):
    """PartNet on the card, read and written without h5py: (a)
    the mini PartNet tree (Bottle, levels 1 and 3, 10,000 points an object)
    written by tools/make_mini_datasets_torch.py through
    hpcs_torch.utils.hdf5 and read back through PartNetDataset, equal to the
    generator's arrays, and a 10,000-point file written chunked and deflated
    (testing.write_h5_deflated) read to the same arrays, each read timed;
    (b) `python -m hpcs_torch.train --dataset partnet --category Bottle
    --level 3` at the flagship's width (N = 1024, k = 20, eucl = hyp = 32,
    hierarchical CosFace over levels 1 and 3, B = 8) for 2 epochs on a tree
    of PARTNET_SPLITS objects, --resume for a third and `python -m
    hpcs_torch.infer partnet` on final/ for 2 requests of 4 clouds, held as
    the entry phase holds ShapeNet's (records, checkpoints, the restored
    state, infer equal to trainer.test in memory), the system's level sum
    matrices on the card; (c) one hierarchical train_step at B = 2, N = 1024
    on the card against the CPU port (testing.check_train_step_card_vs_cpu),
    and again with class_vector; (d) the recipe of
    tools/parity_real_format_torch.py --dataset partnet trained on the card
    for NOTEBOOK_SEEDS at 80 epochs and tested, its mean decode purity and
    score held to hpcs_tpu's 8 seeds (z >= -2), the raw-cosine accuracy
    printed beside hpcs_tpu's; (e) examples/partnet_eval_torch's code cells
    on seed 0's checkpoint, on the card and on the CPU port, compared as
    the notebooks phase compares ShapeNet's.  B1 and B2
    counted in every run.  Also reads the committed libver="latest" fixtures
    (tests/fixtures/hdf5_latest: growable datasets, dense link storage)
    equal to their recipe (_read_latest_fixtures).  Prints whether h5py is
    installed: the port never imports it."""
    import contextlib
    import importlib.util
    import io
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "tools"))
    import make_eval_notebook_torch as nbgen
    import make_mini_datasets_torch as minidata
    import parity_real_format_torch as prf

    from hpcs_torch import infer, train, trainer
    from hpcs_torch.cli import freeze_hierarchy
    from hpcs_torch.data import DataLoader, PartNetDataset, get_hierarchy_list
    from hpcs_torch.loss import hierarchy_sum_matrices
    from hpcs_torch.models import HypHCSystem, ModelConfig
    from hpcs_torch.testing import (check_same_test_outputs, check_train_step_card_vs_cpu,
                                    record_test_steps, write_h5_deflated)
    from hpcs_torch.utils import hdf5

    h5py_installed = importlib.util.find_spec("h5py") is not None
    print(f"partnet: h5py is {'installed' if h5py_installed else 'not installed'} on this "
          "machine; the port reads and writes HDF5 without it", file=sys.stderr, flush=True)
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    root, cwd, launches = tmp.name, os.getcwd(), {}
    try:
        # (a) the mini tree, written and read back; a deflated file
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            minidata.make_partnet(os.path.join(root, "data"))
        write_s = time.perf_counter() - t
        h5_root = os.path.join(root, "data", "PartNet", "sem_seg_h5")
        t = time.perf_counter()
        read = {(level, split): PartNetDataset(
            os.path.join(h5_root, f"Bottle-{level}", f"{split}_files.txt"), 256)
            for level in PARTNET_LEVELS for split in ("train", "val", "test")}
        read_s = time.perf_counter() - t
        for level, split, arrays in minidata.partnet_arrays():
            ds = read[(level, split)]
            for key, got in (("data", ds.points), ("data_num", ds.data_num),
                             ("label_seg", ds.label_seg)):
                if got.dtype != arrays[key].dtype or not np.array_equal(got, arrays[key]):
                    fail(f"partnet: level {level} {split} {key} read back as {got.dtype} "
                         f"{got.shape}, not the generator's {arrays[key].dtype} "
                         f"{arrays[key].shape}")
        objects = {f"{lv}/{sp}": len(ds) for (lv, sp), ds in read.items()}
        _, _, arrays = next(minidata.partnet_arrays(per_split=(PARTNET_H5_OBJECTS, 0, 0)))
        files = {"contiguous": os.path.join(root, "contiguous.h5"),
                 "deflated": os.path.join(root, "deflated.h5")}
        t = time.perf_counter()
        hdf5.write_h5(files["contiguous"], arrays)
        write_ms = {"contiguous": (time.perf_counter() - t) * 1e3}
        t = time.perf_counter()
        write_h5_deflated(files["deflated"], arrays)
        write_ms["deflated"] = (time.perf_counter() - t) * 1e3
        read_ms, mib = {}, {}
        for kind, path in files.items():
            read_ms[kind], got = _h5_read_ms(hdf5, path)
            mib[kind] = os.path.getsize(path) / 2 ** 20
            for key, want in arrays.items():
                if got[key].dtype != want.dtype or not np.array_equal(got[key], want):
                    fail(f"partnet: the {kind} file's {key} reads back unequal")

        # (a') the committed libver="latest" fixtures (growable datasets: the
        # extensible array and v2 B-tree chunk indexes; dense link storage),
        # read without h5py, equal to the arrays of the fixture tool's seeded
        # recipe recomputed here
        latest = _read_latest_fixtures(here, hdf5, PartNetDataset)

        # (b) the entry points at the flagship's width, on a tree of PARTNET_SPLITS
        work = os.path.join(root, "work")
        with contextlib.redirect_stdout(io.StringIO()):
            minidata.make_partnet(os.path.join(work, "data"), per_split=PARTNET_SPLITS)
        os.chdir(work)
        n_train, n_val, n_test = PARTNET_SPLITS
        steps, val_batches = n_train // TRAIN_B, n_val // TRAIN_B
        test_batches = -(-n_test // TRAIN_B)
        run_dir = os.path.join("logs", "partnet_vn_dgcnn_partseg")
        ckpt = os.path.join(run_dir, "checkpoints")

        def run(name, fn, argv, train_steps, eval_batches):
            _counts(reset=True)
            t = time.perf_counter()
            out = fn(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            launches[name] = _counts(reset=True)
            want = _launches(knn=3 * (train_steps + eval_batches), edgeconv=3 * eval_batches)
            if launches[name] != want:
                fail(f"partnet: {name} launched {launches[name]}, expected {want}")
            return out, seconds

        (_, first_results), s1 = run("train", train.main, PARTNET_FLAGS + ["--epochs", "2"],
                                     2 * steps, 2 * val_batches + test_batches)
        (trained, results), s2 = run(
            "resume", train.main,
            PARTNET_FLAGS + ["--epochs", "3", "--resume", os.path.join(ckpt, "last")],
            steps, val_batches + test_batches)
        infer_b = 4
        with record_test_steps() as served:
            (restored, served_results), s3 = run("infer", infer.main, [
                "partnet", "--category", "Bottle", "--level", "3", "--model_path",
                os.path.join(ckpt, "final"), "--fixed_points", str(N), "--batch", str(infer_b),
                "--test_batches", "2"], 0, 2)
        records = _check_trained_run("partnet", run_dir, ckpt, trained, restored,
                                     (first_results, results), steps)
        hierarchy = get_hierarchy_list("data/PartNet/after_merging_label_ids", "Bottle",
                                       PARTNET_LEVELS)
        cfg = trained.cfg
        if not (cfg.use_hierarchical and cfg.dataset == "partnet" and cfg.num_class == 9
                and cfg.num_categories == 1 and cfg.hierarchy_list == freeze_hierarchy(hierarchy)
                and restored.cfg.use_hierarchical):
            fail(f"partnet: the trained system's config {cfg}")
        for system in (trained, restored):
            mats = system.hierarchy_matrices
            want = hierarchy_sum_matrices(hierarchy, cfg.num_class)
            if len(mats) != len(PARTNET_LEVELS) or any(
                    m.device.type != "cuda" or not torch.equal(m.cpu(), w)
                    for m, w in zip(mats, want)):
                fail(f"partnet: the level sum matrices {[tuple(m.shape) for m in mats]} on "
                     f"{[m.device.type for m in mats]}")
        test_loader = DataLoader(PartNetDataset(
            "data/PartNet/sem_seg_h5/Bottle-3/test_files.txt", N), infer_b, shuffle=True,
            seed=SEED)
        with record_test_steps() as in_memory:
            in_memory_results = trainer.test(trained, test_loader, seed=SEED, limit_batches=2)
        try:
            logs_rel = check_same_test_outputs(served, in_memory)
        except AssertionError as e:
            fail(f"partnet: infer differs from trainer.test in memory: {e}")
        for c in served:
            if c["linkage"].shape != (infer_b, N - 1, 4) or not 0 <= c["logs"]["score"] <= 1:
                fail("partnet: infer's output shapes or score")
        # the trained system's hierarchical step at the flagship's width, timed
        train_files = "data/PartNet/sem_seg_h5/Bottle-3/train_files.txt"
        step_batch = next(iter(DataLoader(PartNetDataset(train_files, N), TRAIN_B)))
        gen, step_ms = torch.Generator(device="cuda").manual_seed(SEED), []
        _counts(reset=True)
        for _ in range(PARTNET_WARMUP + PARTNET_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logs = trained.train_step(step_batch, gen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            if not all(bool(torch.isfinite(v).all()) for v in logs.values()):
                fail(f"partnet: a hierarchical training step's logs {logs}")
        launches["timed_steps"] = _counts(reset=True)
        if launches["timed_steps"] != _launches(
                knn=3 * (PARTNET_WARMUP + PARTNET_TIMED)):
            fail(f"partnet: the timed steps launched {launches['timed_steps']}")
        entry = dict(objects_per_split=list(PARTNET_SPLITS), B_train=TRAIN_B, B_infer=infer_b,
                     N=N, k=K, eucl=EUCL, hyp=HYP, levels=PARTNET_LEVELS,
                     train_steps_per_epoch=steps, val_batches=val_batches,
                     test_batches=test_batches,
                     epoch_seconds=[r["epoch_time_s"] for r in records],
                     train_step_ms=step_ms[PARTNET_WARMUP:],
                     train_step_ms_median=float(np.median(step_ms[PARTNET_WARMUP:])),
                     train_step_warmup_ms=step_ms[:PARTNET_WARMUP],
                     train_call_seconds=[s1, s2], infer_call_seconds=s3,
                     infer_seconds_per_request=[c["seconds"] for c in served],
                     train_total_loss=[r["train_total_loss"] for r in records],
                     loss_metric=[r["loss_metric"] for r in records],
                     val_loss=[r["val_loss"] for r in records],
                     test_results=[first_results, results], infer_results=served_results,
                     in_memory_results=in_memory_results,
                     infer_vs_in_memory_max_rel_log_diff=logs_rel)

        # (c) one hierarchical training step, card against the CPU port
        batch = next(iter(DataLoader(PartNetDataset(train_files, PARTNET_STEP_N),
                                     PARTNET_STEP_B)))
        step = {}
        for name, over in (("hierarchical", {}), ("class_vector", dict(class_vector=True))):
            scfg = dataclasses.replace(cfg, dropout=0.0, train_rotation="none", **over)
            system = HypHCSystem(scfg, generator=torch.Generator().manual_seed(SEED))
            _counts(reset=True)
            t = time.perf_counter()
            try:
                readings = check_train_step_card_vs_cpu(system, batch, seed=SEED)
            except AssertionError as e:
                fail(f"partnet: the {name} train_step on the card differs from the CPU "
                     f"port's: {e}")
            seconds = time.perf_counter() - t
            launches[f"step_{name}"] = _counts(reset=True)
            if launches[f"step_{name}"] != _launches(knn=3):
                fail(f"partnet: the {name} step launched {launches[f'step_{name}']}, "
                     "expected B1 3 and B2 none")
            step[name] = dict(seconds=seconds, **{k: v for k, v in readings.items()
                                                  if not isinstance(v, dict)})
        os.chdir(cwd)

        # (d) the recipe on the card, seed by seed
        c = prf.CFGS["partnet"]
        n_tr, n_va, n_te = 4, 2, 2  # make_partnet's default split
        r_steps = c["epochs"] * -(-n_tr // c["batch_size"])
        r_evals = c["epochs"] * -(-n_va // c["batch_size"]) + -(-n_te // c["batch_size"])
        want = _launches(knn=3 * (r_steps + r_evals), edgeconv=3 * r_evals)
        out_dir, runs = os.path.join(root, "logs"), []
        for seed in NOTEBOOK_SEEDS:
            _counts(reset=True)
            r, system = prf.run_torch("partnet", seed, device="cuda", out=out_dir,
                                      data=os.path.join(root, "data"), log=lambda line: None)
            launches[f"recipe_s{seed}"] = _counts(reset=True)
            print(f"partnet: seed {seed} trained in {r['train_wall_s']:.1f} s; test loss "
                  f"{r['test_loss']:.4f}, no-margin accuracy {r['test_acc_nomargin']:.4f}, "
                  f"decode score {r['decode_score_mean']:.4f}, purity "
                  f"{r['decode_purity_mean']:.4f}", file=sys.stderr, flush=True)
            if launches[f"recipe_s{seed}"] != want:
                fail(f"partnet: seed {seed} launched {launches[f'recipe_s{seed}']}, expected "
                     f"{want}")
            if not (system.cfg.use_hierarchical and len(system.hierarchy_matrices) == 2):
                fail(f"partnet: seed {seed} trained without the hierarchical loss")
            if not all(np.isfinite(r[k]) for k in prf.RESULT_KEYS + ("test_loss",)):
                fail(f"partnet: seed {seed}'s results are not finite: {r}")
            runs.append(dict(seed=seed, **{k: r[k] for k in (
                "test_loss", "test_acc", "test_acc_nomargin", "decode_score_mean",
                "decode_purity_mean", "train_wall_s", "n_test_objects")}))
        quality = {}
        for key, (mean, std) in TPU_MINI_PARTNET.items():
            tpu = dict(mean=mean, std=std, stderr=std / np.sqrt(TPU_MINI_PARTNET_SEEDS))
            quality[key] = dict(port=prf.aggregate([r[key] for r in runs]), hpcs_tpu=tpu,
                                **prf.compare(prf.aggregate([r[key] for r in runs]), tpu))
        nomargin = dict(port=prf.aggregate([r["test_acc_nomargin"] for r in runs]),
                        hpcs_tpu=dict(mean=TPU_MINI_PARTNET_NOMARGIN[0],
                                      std=TPU_MINI_PARTNET_NOMARGIN[1]))

        # (e) the notebook's cells on seed 0's checkpoint, on the card, on
        # the CPU port, and on the CPU port with the card's embeddings (rows
        # compared on one set of embeddings)
        ckpt0 = prf.checkpoint_dir(out_dir, "partnet", NOTEBOOK_SEEDS[0])
        examples = os.path.join(root, "examples")
        os.makedirs(examples)
        rows, cell_s, embedded, printed = {}, {}, {}, {}
        for run_name, run_device, held in (("card", "cuda", None), ("cpu", "cpu", None),
                                           ("cpu_on_card_embeddings", "cpu", "card")):
            cells = nbgen.code_cells(nbgen.build_partnet(ckpt0, run_device))
            _counts(reset=True)
            t = time.perf_counter()
            embedded[run_name] = []
            ns, text = _run_cells(cells, examples, record=embedded[run_name],
                                  held=None if held is None else list(embedded[held]))
            torch.cuda.synchronize()
            cell_s[run_name] = time.perf_counter() - t
            launches[f"notebook_{run_name}"] = _counts(reset=True)
            rows[run_name], printed[run_name] = ns["all_rows"], text.splitlines()
            if run_name == "card":
                mean_score, ncfg = ns["mean_score"], ns["cfg"]
        if launches["notebook_card"] != _launches(knn=3, edgeconv=3) \
                or launches["notebook_cpu"] != _launches() \
                or launches["notebook_cpu_on_card_embeddings"] != _launches():
            fail(f"partnet: the notebook launched {launches['notebook_card']} on the card "
                 f"(expected B1 and B2 3 each) and {launches['notebook_cpu']} on the CPU")
        if not (ncfg.use_hierarchical and len(ncfg.hierarchy_list) == 2):
            fail(f"partnet: the notebook restored {ncfg}")
        if not len(rows["card"]) == len(rows["cpu"]) == len(rows["cpu_on_card_embeddings"]) \
                == n_te:
            fail(f"partnet: {len(rows['card'])} notebook rows on the card, {len(rows['cpu'])} "
                 "on the CPU")
        embedding_gap = 0.0
        for card_out, cpu_out in zip(embedded["card"], embedded["cpu"]):
            for got, want_out in zip(card_out, cpu_out):
                diff = np.abs(got - want_out)
                embedding_gap = max(embedding_gap, float(diff.max()))
                if not (diff <= 2e-4 + 1e-3 * np.abs(want_out)).all():
                    fail(f"partnet: the card's notebook embeddings differ from the CPU port's "
                         f"by {float(diff.max()):.3e}, beyond atol 2e-4 / rtol 1e-3")
        score_gap = 0.0
        for got, on_cpu in zip(rows["card"], rows["cpu_on_card_embeddings"]):
            score_gap = max(score_gap, abs(got["score"] - on_cpu["score"]))
            if (got["split"], got["best_k"], got["true_parts"]) != (
                    on_cpu["split"], on_cpu["best_k"], on_cpu["true_parts"]) \
                    or abs(got["score"] - on_cpu["score"]) > NOTEBOOK_SCORE_ATOL:
                fail(f"partnet: the card's notebook row {got} differs from the CPU port's on "
                     f"the card's embeddings, {on_cpu}")
    finally:
        os.chdir(cwd)
        tmp.cleanup()
    out = dict(h5py_installed=h5py_installed,
               dataset=dict(seconds_to_write=write_s, seconds_to_read=read_s, objects=objects,
                            points=10000, deflated_file=dict(
                                objects=PARTNET_H5_OBJECTS, points=10000, level=4,
                                write_ms=write_ms, read_ms=read_ms, mib=mib),
                            latest_fixtures=latest),
               entry=entry, train_step=dict(B=PARTNET_STEP_B, N=PARTNET_STEP_N, **step),
               recipe={k: v for k, v in c.items() if k != "seed"},
               seeds=runs, quality=quality, test_acc_nomargin=nomargin,
               train_s_per_seed=[r["train_wall_s"] for r in runs],
               notebook=dict(rows_card=rows["card"],
                             rows_cpu_on_card_embeddings=rows["cpu_on_card_embeddings"],
                             rows_cpu_own_embeddings=rows["cpu"],
                             max_score_gap_card_vs_cpu=score_gap, score_atol=NOTEBOOK_SCORE_ATOL,
                             max_abs_err_embeddings_card_vs_cpu=embedding_gap,
                             mean_score_card=mean_score, seconds=cell_s,
                             printed_card=printed["card"]),
               launches_by_run=launches,
               launches={k: sum(run[k] for run in launches.values()) for k in COUNTERS},
               seconds=time.perf_counter() - t_phase, card=card)
    emit("partnet", **out)
    for key, q in quality.items():
        if q["z"] < -2:
            fail(f"partnet: the card-trained {key} {q['port']['mean']:.4f} is below "
                 f"hpcs_tpu's {q['hpcs_tpu']['mean']:.4f} by {-q['z']:.2f} combined standard "
                 "errors (z < -2)")
    return out


PARITY_BUDGET_S = 90  # the torch stage: seeds trained while this much phase time lasts
PARITY_MIN_SEEDS = 2  # whatever the budget: one seed has no spread, so its z would hold one
#   draw against the standard error of hpcs_tpu's mean of 5 (a collapsed seed 0 fails it)


def parity_phase(card, seeds=None):
    """tools/parity_experiment_torch.py, the quality-parity experiment, on the
    card: (a) its data stage (the split arrays equal to
    benchmarks/_parity_data.npz); (b) its decode stage on hpcs_tpu's stored
    embeddings of seeds 0-4, each seed's mean best-k score within 1e-6 of
    hpcs_tpu's stored one and its mean purity equal; (c) its torch stage
    (40 epochs, B = 4, N = 256, eucl = hyp = 16, k = 10) trained on the card
    from seed 0 on while PARITY_BUDGET_S of phase time lasts, at least
    PARITY_MIN_SEEDS seeds (all of `seeds` when given), B1 3 launches a
    training step and an eval batch and B2 3 an eval batch; (d) its report: the port's mean purity and score held at
    z >= -2 against hpcs_tpu's 5 seeds, tools/parity_experiment.py's
    verdicts beside the reference's 5 seeds printed."""
    import contextlib
    import io
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import parity_experiment_torch as pet

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    out, launches, runs = tmp.name, {}, []
    try:
        # (a) the data
        if pet.check_data(pet.make_data()) is not True:
            fail("parity: benchmarks/_parity_data.npz is missing")

        # (b) the decode on the card, all 5 stored seeds
        _counts(reset=True)
        t = time.perf_counter()
        decode = pet.run_decode(range(5), device="cuda", out=out, log=lambda line: None)
        decode_s = time.perf_counter() - t
        launches["decode"] = _counts(reset=True)
        print(f"parity: decode of 5 seeds' stored embeddings on the card in {decode_s:.1f} s; "
              f"max |score delta| {decode['max_abs_score_delta']:.3e}, max |purity delta| "
              f"{decode['max_abs_purity_delta']}", file=sys.stderr, flush=True)
        if not decode["ok"] or sorted(decode["seeds"]) != list(range(5)):
            fail(f"parity: the decode did not hold every seed: {json.dumps(decode['seeds'])}")

        # (c) the recipe trained on the card, seed by seed
        c, b = pet.CFG, pet.CFG["batch_size"]
        steps = c["epochs"] * (c["n_train"] // b)
        evals = c["epochs"] * (c["n_val"] // b) + c["n_test"] // b
        want = _launches(knn=3 * (steps + evals), edgeconv=3 * evals)
        t_torch = time.perf_counter()
        for seed in (range(5) if seeds is None else seeds):
            if seeds is None and len(runs) >= PARITY_MIN_SEEDS and \
                    time.perf_counter() - t_torch + runs[-1]["seconds"] > PARITY_BUDGET_S:
                break
            _counts(reset=True)
            t = time.perf_counter()
            r = pet.run_torch(seed, device="cuda", out=out, log=lambda line: None)
            seconds = time.perf_counter() - t
            launches[f"torch_s{seed}"] = _counts(reset=True)
            print(f"parity: seed {seed} in {seconds:.1f} s (trained {r['train_wall_s']:.1f} s); "
                  f"test loss {r['test_loss']:.4f}, acc {r['test_acc']:.4f}, decode score "
                  f"{r['decode_score_mean']:.4f}, purity {r['decode_purity_mean']:.4f}",
                  file=sys.stderr, flush=True)
            if launches[f"torch_s{seed}"] != want:
                fail(f"parity: seed {seed} launched {launches[f'torch_s{seed}']}, expected "
                     f"{want} (B1 3 a step and an eval batch, B2 3 an eval batch)")
            if not all(np.isfinite(r[k]) for k in pet.RESULT_KEYS + ("train_wall_s",)):
                fail(f"parity: seed {seed}'s results are not finite: {r}")
            runs.append(dict(seconds=seconds,
                             **{k: v for k, v in r.items() if "curve" not in k}))

        # (d) the report beside hpcs_tpu's and the reference's 5 seeds
        with contextlib.redirect_stdout(io.StringIO()):
            rep = pet.report([r["seed"] for r in runs], out)
    finally:
        tmp.cleanup()
    total = {k: sum(run[k] for run in launches.values()) for k in COUNTERS}
    result = dict(recipe={k: v for k, v in pet.CFG.items() if k != "seed"},
                  decode=dict(seconds=decode_s, **decode), seeds=runs,
                  seconds_per_seed={r["seed"]: r["seconds"] for r in runs},
                  summary=rep["summary"], vs_reference=rep["vs_reference"],
                  vs_hpcs_tpu=rep["vs_hpcs_tpu"], launches_by_run=launches, launches=total,
                  budget_s=None if seeds is not None else PARITY_BUDGET_S,
                  seconds=time.perf_counter() - t_phase, card=card)
    emit("parity", **result)
    print(f"parity: {len(runs)} seeds in {result['seconds']:.1f} s of phase time; B1 "
          f"{total['knn']} and B2 {total['edgeconv']} launches", file=sys.stderr, flush=True)
    for key in ("decode_purity_mean", "decode_score_mean"):
        q = rep["summary"][key]
        if q["vs_hpcs_tpu"]["z"] < -2:
            fail(f"parity: the card-trained {key} {q['hpcs_torch']['mean']:.4f} is below "
                 f"hpcs_tpu's {q['hpcs_tpu']['mean']:.4f} by {-q['vs_hpcs_tpu']['z']:.2f} "
                 "combined standard errors (z < -2)")
    if not (total["knn"] and total["edgeconv"]):
        fail(f"parity: B1 launched {total['knn']} and B2 {total['edgeconv']} times")
    return result



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


COUNTERS = {"knn": ("knn", "launches"), "knn_wide": ("knn", "wide_launches"),
            "knn_radix": ("knn", "radix_launches"),
            "knn_bf16": ("knn", "bf16_launches"), "knn_rows": ("knn", "row_launches"),
            "edgeconv": ("edgeconv_infer", "launches"),
            "edgeconv_bf16": ("edgeconv_infer", "bf16_launches"),
            "edgeconv_rows": ("edgeconv_infer", "row_launches")}


def _counts(reset=False):
    """The kernels' launch counts in this process (COUNTERS: every launch,
    the wide route's, its radix route's (k > 256), those on bf16 features
    and those over a row range; zeroed with reset)."""
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN

    fns = {"knn": KN.knn, "edgeconv_infer": E.edgeconv_infer}
    out = {k: getattr(fns[fn], attr) for k, (fn, attr) in COUNTERS.items()}
    if reset:
        for fn, attr in COUNTERS.values():
            setattr(fns[fn], attr, 0)
    return out


def _launches(knn=0, edgeconv=0, knn_rows=0, edgeconv_rows=0, bf16=False, wide=0, radix=0):
    """A _counts dict: kNN and B2 launches, of which knn_rows and
    edgeconv_rows over a row range and `wide` kNN launches on the wide
    route (`radix` of them on its radix route), all on bf16 features with
    bf16."""
    return {"knn": knn, "knn_wide": wide, "knn_radix": radix, "knn_bf16": knn if bf16 else 0,
            "knn_rows": knn_rows,
            "edgeconv": edgeconv, "edgeconv_bf16": edgeconv if bf16 else 0,
            "edgeconv_rows": edgeconv_rows}


# the configurations the parallel phase also shards over the points, at
# full width (backbone_system): ModelConfig fields, B1 and B2 row-range
# launches per forward (B1's also per training step; B2 none in training),
# and the rtol of the sharded step's loss against the unsharded step's:
# 2e-5 (the flagship's), except where the step is noise at B = 2 (ROADMAP
# §C): PointNet's STN BatchNorms over [B, C] cancel in fp32 (two nearly
# equal global features), and bf16 rounds; both are held to one bf16
# rounding of the loss, 2^-8 (PointNet 9.3e-4 and bf16 7.6e-4 apart on an
# H100; their float64 steps agree within FLOAT64_WITNESS)
LOSS_NOISY = 2.0 ** -8
POINT_CONFIGS = {
    "dgcnn_partseg": (dict(model_name="dgcnn_partseg", eucl_dim=50), 4, 0, 2e-5),
    "pointnet_partseg": (dict(model_name="pointnet_partseg", eucl_dim=50), 0, 0, LOSS_NOISY),
    "vn_pointnet_partseg_max": (dict(model_name="vn_pointnet_partseg", eucl_dim=50,
                                     pooling="max"), 1, 0, 2e-5),
    "vn_dgcnn_partseg_max": (dict(pooling="max", eucl_dim=EUCL), 3, 0, 2e-5),
    "vn_dgcnn_partseg_bf16": (dict(bf16=True, eucl_dim=EUCL), 3, 3, LOSS_NOISY),
    "vn_dgcnn_partseg_class_vector": (dict(class_vector=True, eucl_dim=EUCL), 3, 3, 2e-5),
}
POINT_TIMED = 3  # sharded and unsharded forwards timed per configuration
# clouds of the float64 witness step: at B = 2 PointNet's STN BatchNorms over
# [B, C] cancel even in float64 (two nearly equal global features; the
# sharded and unsharded float64 steps 1.5e-7 of conv1's gradient apart on
# the CPU), at B = 4 they do not (4.2e-9)
FLOAT64_B = 4
BF16_FORWARD_SHARE = 0.03  # the bf16 phase's rule: of the output's largest entry


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


def _point_sharded_configuration(fields, knn_rows, ec_rows, loss_rtol, mesh):
    """(e) One configuration of POINT_CONFIGS sharded over the points of
    `mesh` (1, 2), at full width: the sharded eval forward at B=2, N=4096
    against the unsharded forward (fp32: atol 1e-4 / rtol 1e-3; bf16:
    within BF16_FORWARD_SHARE of the output's largest entry, the bf16
    phase's rule, since a sum over the points in another order may flip a
    bf16 rounding), both timed; the sharded fp32 training step at B=2,
    N=256 against the unsharded step (the loss within loss_rtol) and its
    ranks' parameters equal bit for bit; its float64 step (dropout 0, no
    rotation, knn_plain's graphs, B=FLOAT64_B) against the unsharded
    float64 step's logs and gradients; each run's kernel launches, which
    must be row-range launches only."""
    import copy

    from hpcs_torch.models import decode_vector_for_batch
    from hpcs_torch.nn.backbones import vn_dgcnn
    from hpcs_torch.ops import knn as KN
    from hpcs_torch.parallel import (collectives, make_point_sharded_forward,
                                     make_point_sharded_train_step, shard_points_batch)
    from hpcs_torch.parallel.point_parallel import PointShard, decode_vector
    from hpcs_torch.testing import FLOAT64_WITNESS, GRAD_FLOOR, float64_train_step

    out, launches = {}, {}
    bf16 = bool(fields.get("bf16"))
    system = backbone_system(fields)
    long = _synthetic(2, PAR_LONG_N, seed=7)
    part = shard_points_batch(mesh, long)
    forward = make_point_sharded_forward(system, mesh)
    dv = decode_vector(mesh, system.cfg, part)
    _counts(reset=True)
    got = forward(part["points"], dv)
    launches["forward"] = _counts()
    want_dv = decode_vector_for_batch(system.cfg, long)
    want = system.embed(long["points"], want_dv)
    errs = []
    for g, w in zip(got, want):
        g = collectives.gather_slots(g, 1)
        err = (g - w).abs()
        errs.append(float(err.max()))
        limit = (BF16_FORWARD_SHARE * w.abs().max() if bf16 else 1e-4 + 1e-3 * w.abs())
        if not bool((err <= limit).all()) or not bool(torch.isfinite(g).all()):
            fail(f"parallel: the point-sharded forward of {fields} is {errs[-1]:.3e} from the "
                 "unsharded")
    out.update(forward_max_abs_err=max(errs), forward_max_abs_err_share=max(errs) / max(
        float(w.abs().max()) for w in want),
        forward_ms=host_ms(lambda: forward(part["points"], dv), POINT_TIMED),
        unsharded_forward_ms=host_ms(lambda: system.embed(long["points"], want_dv), POINT_TIMED))

    train = dict(t_per_anchor=50, temperature=0.05, lr=0.005)
    plain = backbone_system(fields, **train)
    small = _synthetic(2, 256)
    ref_logs = copy.deepcopy(plain).train_step(
        small, torch.Generator(device=plain.device).manual_seed(SEED))
    step = make_point_sharded_train_step(plain, mesh)
    _counts(reset=True)
    logs = step(shard_points_batch(mesh, small),
                torch.Generator(device=plain.device).manual_seed(SEED))
    launches["train"] = _counts()
    flat = torch.cat([p.detach().reshape(-1) for p in plain.net.parameters()])
    if not torch.equal(*collectives.gather_slots(flat).reshape(2, -1)):
        fail(f"parallel: the point-sharded step of {fields} left the ranks' parameters apart")
    loss_gap = abs(float(logs["total_loss"]) / float(ref_logs["total_loss"]) - 1)
    if not loss_gap <= loss_rtol:  # a NaN fails too
        fail(f"parallel: the point-sharded step of {fields}: its loss is {loss_gap:.3e} from "
             f"the unsharded step's, beyond {loss_rtol:.3e}")

    sys64 = backbone_system(fields, dropout=0.0, train_rotation="none", **train)
    wider = _synthetic(FLOAT64_B, 256)
    real_knn, vn_dgcnn.knn = vn_dgcnn.knn, KN.knn_plain
    try:
        logs64, grads64, _ = float64_train_step(sys64, wider, None, sys64.device)
        got_logs, got_grads, _ = float64_train_step(sys64, shard_points_batch(mesh, wider), None,
                                                    sys64.device, shard=PointShard(mesh))
    finally:
        vn_dgcnn.knn = real_knn
    top = max(float(np.abs(g).max()) for g in grads64.values())
    worst = max(abs(got_logs[k] / v - 1) for k, v in logs64.items())
    worst_grad, leaf = max((float(np.abs(got_grads[k] - g).max()) / max(
        float(np.abs(g).max()), GRAD_FLOOR * top), k) for k, g in grads64.items())
    if max(worst, worst_grad) > FLOAT64_WITNESS:
        fail(f"parallel: the point-sharded float64 step of {fields}: logs {worst:.3e} and "
             f"gradients {worst_grad:.3e} ({leaf}) from the unsharded float64 step's")
    expect = {"forward": _launches(knn_rows, ec_rows, knn_rows, ec_rows, bf16),
              "train": _launches(knn_rows, 0, knn_rows, 0, bf16)}
    if launches != expect:
        fail(f"parallel: the point-sharded {fields} launched {launches}, expected {expect}")
    out.update(train_loss_rel_err=loss_gap, train_loss=float(logs["total_loss"]),
               unsharded_train_loss=float(ref_logs["total_loss"]),
               float64_logs_rel_err=worst, float64_grad_share=worst_grad, launches=launches)
    return out


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

    # (d) the same at the long-cloud phase's first request, B=4, N=8192: the
    # wide route over each rank's rows
    longer = _synthetic(LONG_B, LONG_N, seed=7)
    part = shard_points_batch(points_mesh, longer)
    dv = decode_vector_for_batch(system.cfg, part)
    _counts(reset=True)
    _, x_p = forward(part["points"], dv)
    launches["point_forward_long"] = _counts()
    gathered = collectives.gather_slots(x_p, 1)
    _, want = system.embed(longer["points"], decode_vector_for_batch(system.cfg, longer))
    err = (gathered - want).abs()
    if not bool((err <= 1e-4 + 1e-3 * want.abs()).all()):
        fail(f"parallel: the point-sharded forward at N = {LONG_N} is {float(err.max()):.3e} "
             "from the unsharded")
    out.update(point_forward_long_max_abs_err=float(err.max()),
               point_forward_long_ms=host_ms(lambda: forward(part["points"], dv), 3),
               unsharded_forward_long_ms=host_ms(lambda: system.embed(
                   longer["points"], decode_vector_for_batch(system.cfg, longer)), 3))

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

    # (e) every other configuration, point-sharded at full width
    out["configurations"] = {name: _point_sharded_configuration(*config, points_mesh)
                             for name, config in POINT_CONFIGS.items()}
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
    runs = [one["launches"]] + [part for r in two for part in (
        list(r["launches"].values())
        + [c for cfg in r["configurations"].values() for c in cfg["launches"].values()])]
    launches = {k: sum(run[k] for run in runs) for k in COUNTERS}
    # row-range launches by route (a run is all bf16 or all fp32, and its
    # kNN launches all B1's or all the wide route's)
    rows = {f"{kernel}{route}": sum(run[f"{kernel}_rows"] for run in runs
                                    if bool(run[f"{kernel}_bf16"]) == (route == "_bf16")
                                    and not (kernel == "knn" and run["knn_wide"]))
            for kernel in ("knn", "edgeconv") for route in ("", "_bf16")}
    rows["knn_wide"] = sum(run["knn_rows"] for run in runs if run["knn_wide"])
    want = {"train": _launches(knn=3 * (PAR_WARMUP + PAR_TIMED)),
            "test_step": _launches(knn=3, edgeconv=3),
            "point_forward": _launches(3, 3, 3, 3), "point_train": _launches(3, 0, 3, 0),
            "point_forward_long": _launches(3, 3, 3, 3, wide=3)}
    if any(r["launches"] != want for r in two) or one["launches"] != want["train"]:
        fail(f"parallel: launch counts {[r['launches'] for r in two]} (ranks), "
             f"{one['launches']} (world size 1), expected {want} a rank")
    r0 = two[0]
    configurations = {name: dict(
        forward_ms={"sharded_2_ranks": c["forward_ms"], "unsharded": c["unsharded_forward_ms"]},
        forward_max_abs_err=max(r["configurations"][name]["forward_max_abs_err"] for r in two),
        forward_max_abs_err_share=max(r["configurations"][name]["forward_max_abs_err_share"]
                                      for r in two),
        train_loss_rel_err=c["train_loss_rel_err"], train_loss_rtol=POINT_CONFIGS[name][3],
        float64_logs_rel_err=max(r["configurations"][name]["float64_logs_rel_err"] for r in two),
        float64_grad_share=max(r["configurations"][name]["float64_grad_share"] for r in two),
        launches_a_rank=c["launches"]) for name, c in r0["configurations"].items()}
    out = dict(B=TRAIN_B, N=N, k=K, eucl=EUCL, hyp=HYP, launches=launches, row_launches=rows,
               backends={"world_size_1": one["backend"], "world_size_2": r0["backend"]},
               step_ms={"world_size_1": one["step_ms_median"], "world_size_2": r0["step_ms_median"],
                        "single_device": one["single_device_step_ms_median"]},
               all_reduce_ms_per_step={"world_size_1": one["all_reduce_ms_per_step"],
                                       "world_size_2": r0["all_reduce_ms_per_step"]},
               step_split_ms_world_size_1=one["step_split_ms"],
               point_forward_ms={"sharded_2_ranks": r0["point_forward_ms"],
                                 "unsharded": r0["unsharded_forward_ms"], "B": 2,
                                 "N": PAR_LONG_N},
               point_forward_long_ms={"sharded_2_ranks": r0["point_forward_long_ms"],
                                      "unsharded": r0["unsharded_forward_long_ms"],
                                      "B": LONG_B, "N": LONG_N},
               point_forward_long_max_abs_err=max(r["point_forward_long_max_abs_err"]
                                                  for r in two),
               point_configurations=configurations,
               world_size_1=one, ranks=two, refused_beyond_visible=refused,
               rule=f"world size 1: every entry within {FACTOR} S, S the largest entry by "
                    "which two single-device runs differ, the all-reduce the identity on the "
                    "first step; "
                    "point-sharded step: loss rtol 2e-5 (PointNet and bf16: 2^-8), in float64 "
                    "logs and gradients within FLOAT64_WITNESS; point-sharded forward atol 1e-4 "
                    f"/ rtol 1e-3 (bf16: {BF16_FORWARD_SHARE} of the largest entry); only "
                    "row-range launches",
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


def _counted_in_child(module, argv, timeout=900):
    """B1 and B2 launches (`_launch_counts`) of `module`.main(argv) run in a
    Python process of its own, as `python -m module` runs for a user.  A
    trace taken late in a process that has traced before can lack the
    kernel records of its first launches (PERF.md §7): observe's trace is a
    fresh process's."""
    code = ("import importlib, json, sys; sys.path.insert(0, sys.argv[1]); import torch; "
            "import chip_smoke as cs; cs._launch_counts(reset=True); "
            "importlib.import_module(sys.argv[2]).main(sys.argv[3:]); torch.cuda.synchronize(); "
            "print(json.dumps(cs._launch_counts()))")
    proc = subprocess.run([sys.executable, "-c", code, os.path.dirname(os.path.abspath(__file__)),
                           module, *argv], capture_output=True, text=True, timeout=timeout)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode:
        fail(f"{module} {' '.join(argv)} exited with {proc.returncode}: {proc.stdout[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


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
    card: (a) train --profile at the flagship in a process of its own (the
    launches counted there), (b) --debug_nans healthy and
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
        got = _counted_in_child("hpcs_torch.train", flags + ["--profile", prof_dir])
        profile_run_s = time.perf_counter() - t
        for k, v in got.items():
            launches[k] += v
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
            calls = {e["args"]["correlation"] for e in events
                     if e.get("cat", "").startswith("cuda_") and "aunch" in e["name"]}
            records = {e.get("args", {}).get("correlation") for e in events
                       if e.get("cat") == "kernel"}
            fail(f"observe: the trace holds {len(b1)} B1 and {len(b2)} B2 kernels, expected "
                 f"{want['knn']} and {want['edgeconv']}; {len(calls - records)} of its "
                 f"{len(calls)} launches have no kernel record")
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

    from hpcs_torch.models import HypHCSystem, decode_vector_for_batch
    from hpcs_torch.nn.backbones import vn_dgcnn
    from hpcs_torch.ops import _build
    from hpcs_torch.ops import edgeconv as E
    from hpcs_torch.ops import knn as KN

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
    system, cfg, batches = flagship()

    with torch.no_grad():
        # stage inputs of the main path for request 0 (kernel graphs)
        pts, idx1, x0, x1, f1, idx2, x2, f2, idx3, (w12, w34, w5) = request_stages(
            system, batches[0][0])

        # 2. kernel B1 against knn_plain (knn_phase); its rng goes on to knn_wide
        rng = np.random.default_rng(SEED)
        knn = knn_phase(card, rng)
        knn_ms, plain_ms, knn_err = knn["ms"], knn["plain_ms"], knn["max_score_gap"]
        w3, w63 = knn_work(B, N, 3, K), knn_work(B, N, 63, K)

        # 3. kernel B2 against edgeconv_infer_plain at the three stage shapes
        ec = edgeconv_phase(card, {"stage1_c1": (x0, idx1, w12, 2),
                                   "stage2_c21": (x1, idx2, w34, 2),
                                   "stage3_c21": (x2, idx3, w5, 1)})
        ec_rows, ec_err = ec["stages"], ec["max_abs_err"]

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
        wide = knn_wide_phase(card, rng)
    long = long_cloud_phase(card)
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
    import tempfile

    kept = tempfile.TemporaryDirectory()  # the import phase's msgpack, for the notebooks phase
    flagship_ckpt = os.path.join(kept.name, "hpcs_tpu_ckpt")
    imp = import_phase(system, cfg, batches, card, keep=flagship_ckpt)
    examples = examples_phase(card)
    notebooks = notebooks_phase(card, flagship_ckpt)
    kept.cleanup()
    partnet = partnet_phase(card)
    parity = parity_phase(card)
    trained = trained_phase(card)
    par = parallel_phase(card)
    obs = observe_phase(card)

    # 18. summary lines (row_launches: the launches over a row range, all
    # in the parallel phase's point-sharded runs)
    par_rows = par["row_launches"]
    wide_bf16 = long["long_cloud_bf16"]["launches"]["knn_wide"]  # the only wide route on bf16
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
             + examples["launches"]["knn"] + notebooks["launches"]["knn"]
             + partnet["launches"]["knn"]
             + parity["launches"]["knn"] + trained["launches_fp32"]["knn"]
             + par["launches"]["knn"] - par["launches"]["knn_bf16"] - par["launches"]["knn_wide"]
             + obs["launches"]["knn"],
             row_launches=par_rows["knn"],
             max_abs_err=knn_err, ms=knn_total_ms, plain_ms=knn_plain_total,
             bound_ms=bound_ms(knn_ops, knn_bytes)[0], bound_by=bound_ms(knn_ops, knn_bytes)[1],
             library_ms=None),
        dict(name="knn_wide", route="cuda", source="hpcs_torch/ops/csrc/knn.cu",
             replaces="hpcs_tpu/ops/pallas/knn_pallas.py:49",
             launches=launches["knn_wide"] + decode["launches"]["knn_wide"]
             + train["launches"]["knn_wide"] + train["fit_launches"]["knn_wide"]
             + entry_launches["knn_wide"] + backbones["launches"]["knn_wide"]
             + imp["launches"]["knn_wide"] + examples["launches"]["knn_wide"]
             + notebooks["launches"]["knn_wide"] + partnet["launches"]["knn_wide"]
             + parity["launches"]["knn_wide"]
             + trained["launches"]["knn_wide"] + long["launches"]["knn_wide"] - wide_bf16
             + par["launches"]["knn_wide"] + obs["launches"]["knn_wide"],
             row_launches=par_rows["knn_wide"],
             max_abs_err=wide["max_score_gap"], ms=wide["ms"], plain_ms=wide["plain_ms"],
             bound_ms=wide["bound_ms"], bound_by=wide["bound_by"], library_ms=None),
        dict(name="knn_wide_bf16", route="cuda", source="hpcs_torch/ops/csrc/knn.cu",
             replaces="hpcs_tpu/ops/pallas/knn_pallas.py:49", launches=wide_bf16,
             row_launches=0, max_abs_err=wide["max_score_gap"], ms=wide["ms_bf16"],
             plain_ms=wide["plain_ms"], bound_ms=wide["bf16_bound_ms"],
             bound_by=wide["bound_by"], library_ms=None),
        dict(name="knn_radix", route="cuda", source="hpcs_torch/ops/csrc/knn.cu",
             replaces="hpcs_tpu/ops/pallas/knn_pallas.py:49",
             launches=long["launches"]["knn_radix"], row_launches=0,
             max_abs_err=wide["radix"]["max_score_gap"], ms=wide["radix"]["ms"],
             plain_ms=wide["radix"]["plain_ms"], bound_ms=wide["radix"]["bound_ms"],
             bound_by=wide["radix"]["bound_by"], library_ms=None),
        dict(name="edgeconv", route="cuda", source="hpcs_torch/ops/csrc/edgeconv.cu",
             replaces="hpcs_tpu/ops/pallas/edgeconv_pallas.py:67",
             kernel_functions=["edge_kernel<float, 1, 2>", "project_kernel<float>",
                               "edge_kernel<float, 21, 2>", "edge_mean_kernel<float>"],
             launches=launches["edgeconv"] + decode["launches"]["edgeconv"]
             + train["launches"]["edgeconv"] + train["fit_launches"]["edgeconv"]
             + entry_launches["edgeconv"] + backbones["launches"]["edgeconv"]
             + imp["launches"]["edgeconv"] + examples["launches"]["edgeconv"]
             + notebooks["launches"]["edgeconv"] + partnet["launches"]["edgeconv"]
             + parity["launches"]["edgeconv"]
             + trained["launches_fp32"]["edgeconv"]
             + par["launches"]["edgeconv"] - par["launches"]["edgeconv_bf16"]
             + long["launches"]["edgeconv"] - long["launches"]["edgeconv_bf16"]
             + obs["launches"]["edgeconv"], row_launches=par_rows["edgeconv"],
             max_abs_err=ec_err,
             ms=sum(s["ms"] for s in ec_rows.values()),
             plain_ms=sum(s["plain_ms"] for s in ec_rows.values()),
             bound_ms=bound_ms(ec_ops, ec_bytes)[0], bound_by=bound_ms(ec_ops, ec_bytes)[1],
             library_ms=None),
        dict(name="knn_bf16", route="cuda", source="hpcs_torch/ops/csrc/knn.cu",
             replaces="hpcs_tpu/ops/pallas/knn_pallas.py:49",
             launches=bf16["launches_main_path"]["knn_bf16"] + trained["launches"]["knn_bf16"]
             + obs["launches"]["knn_bf16"] + par["launches"]["knn_bf16"],
             row_launches=par_rows["knn_bf16"],
             max_abs_err=bf16["knn_max_score_gap"], ms=bf16["knn_ms_per_forward"],
             plain_ms=bf16["knn_plain_ms_per_forward"], bound_ms=bf16["knn_bound_ms_per_forward"],
             bound_by=bf16["knn_bound_by"], library_ms=None),
        dict(name="edgeconv_bf16", route="cuda", source="hpcs_torch/ops/csrc/edgeconv.cu",
             replaces="hpcs_tpu/ops/pallas/edgeconv_pallas.py:67",
             kernel_functions=["edge_tc_kernel<1>", "project_kernel<__nv_bfloat16>",
                               "edge_tc_kernel<21>", "edge_mean_kernel<__nv_bfloat16>"],
             launches=bf16["launches_main_path"]["edgeconv_bf16"]
             + trained["launches"]["edgeconv_bf16"] + obs["launches"]["edgeconv_bf16"]
             + par["launches"]["edgeconv_bf16"] + long["launches"]["edgeconv_bf16"],
             row_launches=par_rows["edgeconv_bf16"],
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
