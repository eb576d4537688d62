"""Checks of the port's kernels against their plain versions, of the
card's training step and of the packed optimizer against the
per-parameter one, a CPU replay of the wide kNN route's selection
(`knn_stream_select`), the test data and probes of the entry points' checks,
the fp32 / bf16 serving of a trained checkpoint (`fp32_bf16_quality`),
writers of the JAX package's two checkpoint formats (`write_flax_checkpoint`,
`write_orbax_checkpoint`), and of chunked, deflated HDF5 files
(`write_h5_deflated`, as h5py's `compression="gzip"` stores them).

Used by chip_smoke.py, `trained_readings` and the tests; nothing on the
forward or training path imports this module.
"""
import contextlib
import copy
import dataclasses
import itertools
import json
import os
import struct
import time
import zlib

import numpy as np
import torch

from .ops.edgeconv import _vn_llr_folded, edgeconv_infer_plain, graph_feature_vn
from .ops.knn import gather_neighbors, knn_scores
from .ops.vn_math import EPS, NEGATIVE_SLOPE, channel_mix
from .utils import hdf5, ocdbt, zstd

ATOL, RTOL = 1e-5, 1e-4
ILL_CONDITIONED = 1e-4  # pre-BatchNorm |p| below which fp32 cannot fix the output


def min_prenorm(x, idx, W1, Wd1, ab1, W2=None, Wd2=None, ab2=None, n_convs=2):
    """Smallest pre-BatchNorm vector norm |p| that each output [B, N, C_out]
    of an EdgeConv stage depends on.

    The folded BatchNorm scales p by (a |p| + b) / |p|, so where |p| is near
    zero the output follows p's direction, which fp32 cannot fix: two fp32
    implementations that sum in another order may differ there by far more
    than rounding.  On the first stage (C=1) the self-edge makes every p of
    a point parallel to x_i, so some |p| are near zero at flagship sizes.
    """
    B, N, K = idx.shape
    e, _ = graph_feature_vn(x, K, idx)
    p1 = channel_mix(e, W1).norm(dim=-1)  # [B, N, K, C_mid]
    if n_convs == 1:
        return p1.amin(dim=2)
    p2 = channel_mix(_vn_llr_folded(e, W1, Wd1, ab1), W2).norm(dim=-1)
    return torch.minimum(p2, p1.amin(dim=-1, keepdim=True)).amin(dim=2)


def check_edgeconv(got, want, x, idx, weights, n_convs, rounding=0.0):
    """Hold an EdgeConv stage's output `got` against the plain twin's `want`.

    weights = [W1, Wd1, ab1, W2, Wd2, ab2].  Outputs whose pre-BatchNorm
    norms |p| are all >= 1e-4 (in float64) must agree within atol 1e-5 /
    rtol 1e-4.  The others are ill-conditioned (see min_prenorm): their
    error may be at most 1e-5 + eps |b| / |p|, what a relative error of one
    fp32 ulp (eps = 2^-23) in p becomes through the folded BatchNorm's
    b / |p|, b the largest shift of the stage.  `rounding` widens both by
    that share of |want|: the bf16 route's outputs (x, weights and got and
    want in bf16; x and the weights are taken as the fp32 stage gets them)
    are rounded once each, so two that agree in fp32 may lie one bf16 ulp,
    2^-7 of |want|, apart.  Raises AssertionError.
    Returns a dict: the ill-conditioned count, the largest error of the
    other outputs and of the ill-conditioned ones, and the largest share of
    its limit that an ill-conditioned error takes.
    """
    assert torch.isfinite(got).all(), "edgeconv: non-finite output"
    got, want = got.float(), want.float()
    w64 = [None if t is None else t.double() for t in weights]
    if x.dtype == torch.bfloat16:
        w64 = [None if t is None else t.to(torch.bfloat16).double() if i % 3 < 2 else t.double()
               for i, t in enumerate(w64)]
    cond = min_prenorm(x.double(), idx, *w64, n_convs=n_convs)
    cond = cond[..., None].expand_as(got)
    shifts = [w64[2][1]] + ([w64[5][1]] if n_convs == 2 else [])
    shift = max(float(s.abs().max()) for s in shifts)
    err = (got - want).abs().double()
    ill = cond < ILL_CONDITIONED
    bad = (err > ATOL + (RTOL + rounding) * want.abs()) & ~ill
    assert not bad.any(), (
        f"edgeconv C={x.shape[2]}: {int(bad.sum())} outputs beyond atol {ATOL} / rtol "
        f"{RTOL + rounding}, max abs err {float(err[~ill].max()):.3e}")
    share = err[ill] / (ATOL + rounding * want.abs()[ill]
                        + torch.finfo(torch.float32).eps * shift / cond[ill])
    assert not (share > 1).any(), (
        f"edgeconv C={x.shape[2]}: {int((share > 1).sum())} ill-conditioned outputs beyond "
        f"1e-5 + eps |b| / |p|")
    return dict(ill_conditioned=int(ill.sum()), max_abs_err=float(err[~ill].max()),
                max_abs_err_ill_conditioned=float(err[ill].max()) if ill.any() else 0.0,
                max_share_of_ill_conditioned_limit=float(share.max()) if ill.any() else 0.0)


def planted_eps_stage(b, n, k, c, n_convs, variant, seed=0):
    """Inputs of one EdgeConv stage whose pre-BatchNorm vectors p and d lie
    near the gate's EPS = 1e-6 and are yet exact in fp32.

    x holds multiples of 2^-21 up to 8 * 2^-21, and W1, Wd1 multiples of 1/4
    up to 1, so every p = W1 e and d = Wd1 e is a short dyadic sum that fp32
    computes exactly in any order; |p| and |d| are of order 1e-6 to 1e-5,
    and some are 0.  The gate's EPS terms (sqrt(|p|^2 + EPS^2) + EPS, and
    |d|^2 + EPS) then move the output at first order, and the plain twin in
    float64 fixes it to the fp32 rounding of the steps after p.

    variant "conv1": random folded BatchNorm on conv1, which tests conv1's
    gate.  "conv2" (n_convs = 2): conv1's BatchNorm is a = a power of two,
    b = 0, so conv1's output, and with it conv2's p and d, stays of order
    1e-5 and conv2's gate is tested too.  Returns (x [b, n, c, 3],
    idx [b, n, k] int32, [W1, Wd1, ab1, W2, Wd2, ab2]) on the CPU.
    """
    if variant not in ("conv1", "conv2") or (variant == "conv2" and n_convs != 2):
        raise ValueError(f"variant {variant!r} with n_convs={n_convs}")
    rng = np.random.default_rng(seed)
    x = rng.integers(-8, 9, size=(b, n, c, 3)) * 2.0 ** -21
    idx = rng.integers(0, n, size=(b, n, k)).astype(np.int32)
    idx[..., 0] = np.arange(n)  # the self-edge, as a kNN graph has it

    def dyadic(o, i):
        return rng.integers(-4, 5, size=(o, i)) / 4.0

    def normal(o, i):
        return 0.3 * rng.standard_normal((o, i))

    def folded_bn():
        return np.stack([1 + 0.2 * rng.standard_normal(21), 0.2 * rng.standard_normal(21)])

    ab1 = folded_bn()
    if variant == "conv2":
        ab1 = np.stack([2.0 ** rng.integers(-1, 2, size=21), np.zeros(21)])
    w = [dyadic(21, 2 * c), dyadic(21, 2 * c), ab1, normal(21, 21), normal(21, 21), folded_bn()]
    f32 = [torch.from_numpy(np.asarray(t, dtype=np.float32)) for t in w]
    return torch.from_numpy(x.astype(np.float32)), torch.from_numpy(idx), f32


def check_planted_eps(fn, b, n, k, c, n_convs, variant, device, seed=0, dtype=torch.float32):
    """Run the EdgeConv stage `fn` (edgeconv_infer or a twin) on `device` on
    planted_eps_stage's inputs and hold every output to the plain twin in
    float64: atol 1e-5 / rtol 1e-4.  With dtype bf16 the features are bf16
    (the planted x is exact in bf16), the twin takes the channel mixes
    rounded to bf16 as the bf16 route does, and rtol widens by one bf16 ulp,
    2^-7, for the output's one rounding (as check_edgeconv's `rounding`).
    Raises AssertionError; returns the largest abs err."""
    x, idx, w = planted_eps_stage(b, n, k, c, n_convs, variant, seed)
    x, idx, w = x.to(device, dtype), idx.to(device), [t.to(device) for t in w]
    bf16 = dtype == torch.bfloat16
    rtol = RTOL + (2.0 ** -7 if bf16 else 0.0)
    got = fn(x, idx, *w, n_convs=n_convs)
    w64 = [t.to(torch.bfloat16).double() if bf16 and i % 3 < 2 else t.double()
           for i, t in enumerate(w)]
    want = edgeconv_infer_plain(x.double(), idx, *w64, n_convs=n_convs)
    assert got.dtype == dtype, f"edgeconv planted {variant} C={c}: {got.dtype} output"
    assert torch.isfinite(got).all(), f"edgeconv planted {variant} C={c}: non-finite output"
    err = (got.double() - want).abs()
    bad = err > ATOL + rtol * want.abs()
    assert not bad.any(), (
        f"edgeconv planted {variant} C={c}: {int(bad.sum())} outputs beyond atol {ATOL} / "
        f"rtol {rtol} of the float64 twin, max abs err {float(err.max()):.3e}")
    return float(err.max())


def split_conv1(x, idx, W1, Wd1):
    """conv1's p and d [B, N, K, 21, 3] on every edge, in kernel B2's order.

    For C = 1 each edge forms Wa (x_j - x_i) + Wb x_i itself.  Otherwise the
    kernel's projection makes U = Wa x, Ud = Wda x, Pc = Wb x and Dc = Wdb x
    once per point, and an edge forms p = (U_j - U_i) + Pc_i and
    d = (Ud_j - Ud_i) + Dc_i, so the self-edge's p is Wb x_i exactly.
    """
    C = x.shape[2]
    if C == 1:
        xi = x[:, :, None]
        diff = gather_neighbors(x, idx) - xi  # [B, N, K, 1, 3]
        return [W[:, :1] * diff + W[:, 1:] * xi for W in (W1, Wd1)]
    out = []
    for W in (W1, Wd1):
        u, centre = channel_mix(x, W[:, :C]), channel_mix(x, W[:, C:])
        out.append((gather_neighbors(u, idx) - u[:, :, None]) + centre[:, :, None])
    return out


def _kernel_gate(p, d, ab):
    """The kernel's gate: the folded BatchNorm as p (a |p| + b) / |p|, then
    the direction-gated leaky ReLU."""
    norm = torch.sqrt((p * p).sum(-1) + EPS * EPS) + EPS
    p = p * ((ab[0] * norm + ab[1]) / norm)[..., None]
    dot, dsq = (p * d).sum(-1, keepdim=True), (d * d).sum(-1, keepdim=True)
    coeff = torch.where(dot < 0, dot / (dsq + EPS), torch.zeros_like(dot))
    return NEGATIVE_SLOPE * p + (1 - NEGATIVE_SLOPE) * (p - coeff * d)


def bf16_limbs(h):
    """The three bf16 limbs of fp32 h, as kernel B2's bf16 route splits
    conv2's input: h0 = bf16(h), h1 = bf16(h - h0), h2 = bf16(h - h0 - h1),
    each as fp32 values.  Every difference is exact in fp32, and
    h0 + h1 + h2 == h for every finite h of magnitude 2^-110 or more, and 0."""
    limbs = []
    for _ in range(3):
        limbs.append(h.to(torch.bfloat16).float())
        h = h - limbs[-1]
    return limbs


TC_K_STEPS = (slice(0, 16), slice(16, 21))  # edge_tc_kernel's K-steps over conv2's 21 inputs


def limb_conv2(h, W):
    """conv2's W h [..., C_out, 3] as kernel B2's bf16 route makes it from
    h [..., 21, 3] (fp32): W rounded to bf16, h in its three bf16 limbs
    (bf16_limbs), each product exact; one MMA a limb and K-step, limb 2
    first, each adding its 16 products (exactly, in float64) to the fp32
    accumulator with one rounding.  The tensor cores align and truncate
    where this rounds: the two differ by a few fp32 ulps of the largest
    product."""
    Wb = W.to(torch.bfloat16).double()
    acc = h.new_zeros(h.shape[:-2] + (W.shape[0], 3))
    for limb in reversed(bf16_limbs(h)):
        for ks in TC_K_STEPS:
            acc = (acc.double() + torch.einsum("oc,...cv->...ov", Wb[:, ks],
                                               limb[..., ks, :].double())).float()
    return acc


def edgeconv_split_model(x, idx, W1, Wd1, ab1, W2=None, Wd2=None, ab2=None, n_convs=2):
    """A plain model of kernel B2's order of operations (not on any forward
    path; `csrc/edgeconv.cu` and this function change together).

    conv1 as split_conv1; the gate per edge; conv2 accumulated one conv1
    channel at a time into all its outputs; the mean over K as a sum in edge
    order times 1/K.  An index outside [0, N) makes its point's output NaN.
    On bf16 x, the bf16 route: x.float(), the mixes rounded to bf16, conv2
    (two convs: edge_tc_kernel) as limb_conv2, the output rounded to bf16
    (its gates' SFU reciprocals are modelled by the IEEE gate: a few fp32
    ulps apart).  Same arguments and result as edgeconv_infer_plain.
    """
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x, W1, Wd1 = x.float(), W1.to(torch.bfloat16).float(), Wd1.to(torch.bfloat16).float()
    B, N, K = idx.shape
    bad = ((idx < 0) | (idx >= N)).any(-1)
    idx = idx.clamp(0, N - 1)
    p, d = split_conv1(x, idx, W1, Wd1)
    h = _kernel_gate(p, d, ab1)
    if n_convs == 2 and bf16:
        h = _kernel_gate(limb_conv2(h, W2), limb_conv2(h, Wd2), ab2)
    elif n_convs == 2:
        p2 = h.new_zeros(h.shape[:-2] + (W2.shape[0], 3))
        d2 = torch.zeros_like(p2)
        for o in range(h.shape[-2]):
            p2 = p2 + W2[:, o, None] * h[..., o:o + 1, :]
            d2 = d2 + Wd2[:, o, None] * h[..., o:o + 1, :]
        h = _kernel_gate(p2, d2, ab2)
    acc = torch.zeros_like(h[:, :, 0])
    for kk in range(K):
        acc = acc + h[:, :, kk]
    out = acc * (1.0 / K)
    out[bad] = float("nan")
    return out.to(torch.bfloat16) if bf16 else out


def knn_candidates(x, k, row_step=1):
    """Mean candidates per row of kernel B1's selection on x [B, N, D], over
    rows 0, row_step, 2 row_step, ... of each cloud: its data-dependent work.

    Lane l's maximum is the best of columns l, l + 32, ... ((s, i) ranks
    above (s', i') if s > s', or s == s' and i < i'; NaN never ranks; a lane
    with no score holds (-inf, INT_MAX)); T is the k-th best of the 32
    maxima; the candidates are the non-NaN columns that rank at or above T.
    They are sorted and merged 32 at a time, so a row costs
    ceil(candidates / 32) sorts of 32.
    """
    s = knn_scores(x)[:, ::row_step]  # [B, R, N]
    n = s.shape[-1]
    cols = torch.arange(n, device=s.device)
    lanes = torch.nn.functional.pad(s, (0, -n % 32), value=float("nan"))
    lanes = lanes.reshape(*s.shape[:2], -1, 32)  # [B, R, G, 32]: column 32 g + l
    real = ~torch.isnan(lanes)
    v = torch.where(real, lanes, -torch.inf)
    best = v.amax(2)
    first = (real & (v == best[:, :, None])).int().argmax(2)  # the earliest of equal maxima
    seen = real.any(2)
    ms = torch.where(seen, best, -torch.inf)
    mi = torch.where(seen, first * 32 + torch.arange(32, device=s.device), 2 ** 31 - 1)
    order = torch.sort(mi, dim=-1, stable=True).indices  # by index, then by score: (s, i) order
    ms, mi = ms.gather(-1, order), mi.gather(-1, order)
    order = torch.sort(ms, dim=-1, descending=True, stable=True).indices
    ts = ms.gather(-1, order)[..., k - 1:k]
    ti = mi.gather(-1, order)[..., k - 1:k]
    cand = (s > ts) | ((s == ts) & (cols <= ti))
    return int(cand.sum()) / (s.shape[0] * s.shape[1])


def knn_queue_insertions(x, k, row_step=1):
    """Mean insertions per row of a running top-k queue that takes the
    columns of x [B, N, D] in index order (a one-compare warp queue), over
    rows 0, row_step, 2 row_step, ... of each cloud: the work that depends on
    the order of the columns, reported beside knn_candidates.

    After column c the queue holds the k best of columns 0..c, so c goes in
    iff fewer than k earlier columns score at least as high (the earlier one
    wins a tie), and a NaN score never does.
    """
    s = knn_scores(x)[:, ::row_step]  # [B, R, N]
    n = s.shape[-1]
    earlier = torch.ones(n, n, dtype=torch.bool, device=s.device).tril(-1)  # [c, j]: j < c
    total = 0
    for sb in s:
        ahead = ((sb[:, None, :] >= sb[:, :, None]) & earlier).sum(-1)  # [R, c]
        total += int(((ahead < k) & ~torch.isnan(sb)).sum())
    return total / (s.shape[0] * s.shape[1])


_WARP = 32
_LANES = np.arange(_WARP)
_INT_MAX = 2 ** 31 - 1
WIDE_TILE_ROWS, WIDE_TILE_COLUMNS = 32, 256  # knn_wide_kernel's row and column tiles


def ranks_above(s, i, s2, i2):
    """knn.cu's `above`: (s, i) ranks above (s2, i2), a higher score or an
    equal score and a smaller index; false whenever s is NaN."""
    return (s > s2) | ((s == s2) & (i < i2))


def warp_sort(s, i):
    """knn.cu's warp_sort: a bitonic network over the 32 lanes, best first."""
    size = 2
    while size <= _WARP:
        stride = size // 2
        while stride:
            os_, oi = s[_LANES ^ stride], i[_LANES ^ stride]
            keep_better = ((_LANES & size) == 0) == ((_LANES & stride) == 0)
            take = np.where(keep_better, ranks_above(os_, oi, s, i), ranks_above(s, i, os_, oi))
            s, i = np.where(take, os_, s), np.where(take, oi, i)
            stride //= 2
        size *= 2
    return s, i


def _half_clean(s, i):
    """A half-cleaner cascade across the warp: a bitonic 32 sorted, best
    first (the lower lane of each pair keeps the better)."""
    stride = _WARP // 2
    while stride:
        os_, oi = s[_LANES ^ stride], i[_LANES ^ stride]
        low = (_LANES & stride) == 0
        take = np.where(low, ranks_above(os_, oi, s, i), ranks_above(s, i, os_, oi))
        s, i = np.where(take, os_, s), np.where(take, oi, i)
        stride //= 2
    return s, i


def _merge_into(ls, li, cs, ci):
    """knn.cu's merge_into: the 32 (cs, ci) sorted across the warp, then
    merged into the row's sorted list (ls, li: [chunks, 32], in place)
    chunk by chunk: the carry reversed against the chunk splits the best 32
    of the two from the worst 32; the best stay, the worst are carried on
    (past the last chunk they drop)."""
    cs, ci = warp_sort(cs, ci)
    for q in range(ls.shape[0]):
        rs, ri = cs[_WARP - 1 - _LANES], ci[_WARP - 1 - _LANES]
        take = ranks_above(rs, ri, ls[q], li[q])
        cs, ci = np.where(take, ls[q], rs), np.where(take, li[q], ri)
        ls[q], li[q] = _half_clean(np.where(take, rs, ls[q]), np.where(take, ri, li[q]))
        if q + 1 < ls.shape[0]:  # the last chunk's worst 32 drop out unsorted
            cs, ci = _half_clean(cs, ci)


def _insert_one(ls, li, v, c):
    """knn.cu's insert_one: (v, c) into the sorted list (ls, li, in place)
    at the count of entries above it, the entries from there moving down
    one slot, the last dropping."""
    fs, fi = ls.reshape(-1), li.reshape(-1)
    p = int(np.count_nonzero(ranks_above(fs, fi, v, c)))
    fs[p + 1:], fi[p + 1:] = fs[p:-1].copy(), fi[p:-1].copy()
    fs[p], fi[p] = v, c


WIDE_INSERT_MAX = 8  # knn.cu's INSERT_MAX


def knn_stream_select(row, k, chunk=WIDE_TILE_COLUMNS, first=0):
    """The wide route's streamed selection (knn_wide_kernel in knn.cu),
    replayed lane by lane on one row of fp32 scores: (indices [k], -1 for a
    slot no score reached; the merges of 32 and the single insertions it
    made).

    The row keeps its best 32 ceil(k / 32), sorted, empty slots (-inf,
    INT_MAX) at first; T is its k-th.  The columns come in chunks of
    `chunk`, starting at chunk `first` and wrapping around (the kernel's
    column tiles, from its row tile's own); a chunk's columns that rank
    above T are kept in column order (the ballot's compaction).  While more
    than WIDE_INSERT_MAX are kept, the first 32 are sorted and merged into
    the list (merge_into) and the rest filtered again against the raised
    T; the last few go in one at a time (insert_one), each that still
    ranks above T.
    """
    row = np.asarray(row, np.float32)
    n = row.shape[0]
    ls = np.full((-(-k // _WARP), _WARP), -np.inf, np.float32)
    li = np.full(ls.shape, _INT_MAX, np.int64)
    chunks, merges, insertions = -(-n // chunk), 0, 0

    def above_t(cols):
        return ranks_above(row[cols], cols, ls.flat[k - 1], li.flat[k - 1])

    for t in range(chunks):
        c0 = (first + t) % chunks * chunk
        kept = np.arange(c0, min(n, c0 + chunk))
        kept = kept[above_t(kept)]
        while len(kept) > WIDE_INSERT_MAX:
            group = kept[:_WARP]
            cs = np.full(_WARP, -np.inf, np.float32)
            ci = np.full(_WARP, _INT_MAX, np.int64)
            cs[:len(group)], ci[:len(group)] = row[group], group
            _merge_into(ls, li, cs, ci)
            merges += 1
            kept = kept[_WARP:][above_t(kept[_WARP:])]
        for c in kept:
            if above_t(np.array([c]))[0]:
                _insert_one(ls, li, row[c], c)
                insertions += 1
    out = li.reshape(-1)[:k]
    return np.where(out < n, out, -1), merges, insertions


def wide_first_chunk(row, n, row_begin=0):
    """The column tile at which knn_wide_kernel starts for query `row` of
    a launch over rows row_begin.. of an n-point cloud: its row tile's."""
    row0 = row_begin + (row - row_begin) // WIDE_TILE_ROWS * WIDE_TILE_ROWS
    return row0 // WIDE_TILE_COLUMNS % -(-n // WIDE_TILE_COLUMNS)


def knn_stream_work(x, k, row_step=1):
    """Mean merges of 32 and single insertions per row of the wide route's
    selection on x [B, N, D] (knn_stream_select from each row's own first
    tile), over rows 0, row_step, 2 row_step, ... of each cloud: its
    data-dependent work."""
    n, merges, insertions, count = x.shape[1], 0, 0, 0
    for b in range(x.shape[0]):
        xb = x[b].float()
        # knn_scores' arithmetic, on the sampled rows only
        scores = 2.0 * (xb[::row_step] @ xb.T) - torch.sum(xb * xb, dim=-1)[None, :]
        for i, s in zip(range(0, n, row_step), scores.cpu().numpy()):
            _, m, ins = knn_stream_select(s, k, first=wide_first_chunk(i, n))
            merges, insertions, count = merges + m, insertions + ins, count + 1
    return merges / count, insertions / count


RADIX_CAND_CAP = 2048  # knn.cu's CAND_CAP: a bucket's columns copied to shared memory


def radix_score_keys(scores):
    """knn.cu's score_key on fp32 scores: uint32 keys, larger exactly when
    the score ranks above; -0.0 the key of +0.0, NaN 0 (below -inf)."""
    s = np.asarray(scores, np.float32)
    u = s.view(np.uint32).copy()
    u[u == 0x80000000] = 0
    keys = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(s), np.uint32(0), keys).astype(np.uint32)


def _radix_bucket(hist, need):
    """knn.cu's find_bucket: the digit d whose bucket holds the need-th
    largest, the count above it and its own count."""
    rev = np.asarray(hist, np.int64)[::-1]
    j = int(np.searchsorted(np.cumsum(rev), need))
    return len(rev) - 1 - j, int(rev[:j].sum()), int(rev[j])


def _radix_sorted(comp):
    """knn.cu's bitonic network over 2^m >= len(comp) slots (the empty ones
    0), largest first, pair by pair as the kernel's threads take them."""
    p2 = 1
    while p2 < len(comp):
        p2 *= 2
    a = np.zeros(p2, np.uint64)
    a[:len(comp)] = comp
    q = np.arange(p2 // 2)
    size = 2
    while size <= p2:
        half = size // 2
        while half:
            i = 2 * q - (q & (half - 1))
            j = i + half
            lo, hi = a[i], a[j]
            swap = (lo < hi) == ((i & size) == 0)
            a[i], a[j] = np.where(swap, hi, lo), np.where(swap, lo, hi)
            half //= 2
        size *= 2
    return a


def knn_radix_select(keys, k, cand_cap=RADIX_CAND_CAP, threads=None):
    """knn_radix_kernel (knn.cu) replayed on one row's uint32 keys
    (radix_score_keys): (indices [k], -1 past the row's non-NaN columns; the
    passes over the row; the passes over its copied candidates).

    The composite (key << 32 | ~column) is distinct for every column and
    larger exactly when the column ranks above (score descending, then
    index ascending).  A radix select on digits of 11, 11 and 10 bits a
    32-bit word, from the top: a pass counts the columns still in play by
    their digit; the bucket of the need-th largest is found; the next pass
    emits the columns of larger digits and counts the bucket's by their next
    digit, until a bucket holds exactly what is still needed (emitted
    whole).  The first bucket of at most cand_cap columns met on a pass over
    the row is copied aside, and later passes read only the copy.  Up to
    `threads` (the kernel's block; None: its choice, 1024 from 8192
    columns, else 256) emitted composites each go to the count of larger
    ones, more through the kernel's bitonic network.
    """
    keys = np.asarray(keys, np.uint32)
    n = keys.shape[0]
    src = (keys.astype(np.uint64) << np.uint64(32)) | (~np.arange(n, dtype=np.uint32)).astype(
        np.uint64)
    hist = np.bincount(keys >> 21, minlength=2048)
    row_passes, cand_passes = 1, 0
    r = min(k, n - int(hist[0]))
    if r == 0:
        return np.full(k, -1, np.int64), row_passes, cand_passes
    d, above, cnt = _radix_bucket(hist, r)
    need, shp, w, pre, from_row, emitted = r, 64, 11, 0, True, []
    while True:
        need_in = need - above
        sh = shp - w
        take_all = cnt == need_in or sh == 0  # (the last digit's bucket: one column)
        wn = 0 if take_all else (10 if sh % 32 == 10 else 11)
        compact = not take_all and from_row and cnt <= cand_cap
        play = src if shp == 64 else src[(src >> np.uint64(shp)) == np.uint64(pre)]
        dig = (play >> np.uint64(sh)) & np.uint64((1 << w) - 1)
        emitted.append(play[(dig > d) | (take_all & (dig == d))])
        row_passes, cand_passes = row_passes + from_row, cand_passes + (not from_row)
        if take_all:
            break
        bucket = play[dig == d]
        hist = np.bincount(((bucket >> np.uint64(sh - wn)) & np.uint64((1 << wn) - 1))
                           .astype(np.int64), minlength=1 << wn)
        if compact:
            src, from_row = bucket, False
        pre = d if shp == 64 else (pre << w) | d
        shp, w, need = sh, wn, need_in
        d, above, cnt = _radix_bucket(hist, need)
    comp = np.concatenate(emitted)
    assert len(comp) == r
    if r <= (threads or (1024 if n >= 8192 else 256)):
        ordered = np.empty_like(comp)
        ordered[(comp[None, :] > comp[:, None]).sum(1)] = comp  # each at its count of larger
    else:
        ordered = _radix_sorted(comp)[:r]
    cols = (~(ordered & np.uint64(0xFFFFFFFF)).astype(np.uint32)).astype(np.int64)
    return np.concatenate([cols, np.full(k - r, -1, np.int64)]), row_passes, cand_passes


def knn_radix_route(scores, k, tile=WIDE_TILE_COLUMNS, group=None, cand_cap=RADIX_CAND_CAP,
                    threads=None):
    """The radix route replayed on the fp32 scores [R, N] of R query rows:
    the rows in groups of `group` (None: one group),
    each group's keys stored tile by tile (`tile` columns, as
    knn_keys_kernel's column tiles) into a scratch [group, N], then each
    row of the group selected (knn_radix_select, with `threads`).  Returns
    (indices [R, k]; the mean passes a row over its keys and over its
    copied candidates)."""
    scores = np.asarray(scores, np.float32)
    R, n = scores.shape
    group = R if group is None else group
    out = np.empty((R, k), np.int64)
    passes = np.zeros(2)
    for g0 in range(0, R, group):
        rows = min(group, R - g0)
        scratch = np.zeros((rows, n), np.uint32)
        for c0 in range(0, n, tile):
            scratch[:, c0:c0 + tile] = radix_score_keys(scores[g0:g0 + rows, c0:c0 + tile])
        for r in range(rows):
            out[g0 + r], *p = knn_radix_select(scratch[r], k, cand_cap, threads)
            passes += p
    return out, *(passes / R)


def knn_radix_work(x, k, row_step=1):
    """Mean passes a row over its keys and over its copied candidates of
    the radix route's selection on x [B, N, D], over rows 0, row_step,
    2 row_step, ... of each cloud: its data-dependent work."""
    passes, count = np.zeros(2), 0
    for b in range(x.shape[0]):
        xb = x[b].float()
        # knn_scores' arithmetic, on the sampled rows only
        scores = 2.0 * (xb[::row_step] @ xb.T) - torch.sum(xb * xb, dim=-1)[None, :]
        for s in scores.cpu().numpy():
            passes += knn_radix_select(radix_score_keys(s), k)[1:]
            count += 1
    return tuple(passes / count)


NEAR_TIE = 1e-3  # |sim(a,p) - sim(a,n)| below which two fp32 'easy' masks may differ


class GivenTriplets:
    """Triplets and an 'easy' mask given from outside (the JAX package's
    draws, say), served in place of the port's sampler and filter by
    `install_given_triplets`.  `set` takes numpy arrays: anchor, positive,
    negative [T] (flat indices), valid [T] (the sampler's mask), mask [T]
    (the filtered mask to serve) and, where the port's own filtered mask
    may differ from `mask` only at near-ties, the margins
    sim(a, p) - sim(a, n) [T] those near-ties are read from (None: no
    check; NEAR_TIE inf: none either).  Each `set` serves until the next."""

    NEAR_TIE = NEAR_TIE

    def set(self, anchor, positive, negative, valid, mask, margins=None):
        from .miner import Triplets

        self.trip = Triplets(*(torch.from_numpy(np.array(a, np.int64))
                               for a in (anchor, positive, negative)),
                             torch.from_numpy(np.array(valid, np.float32)))
        self.mask, self.margins = np.array(mask, np.float32), margins
        return self


def install_given_triplets(given, setattr=setattr):
    """Patch hpcs_torch.loss.joint so that its sampler returns given.trip
    and its 'easy' filter given.mask, after checking (fp32 embeddings, with
    given.margins) that the port's own mask differs from it only where
    |margin| < given.NEAR_TIE.  `setattr` makes the patches: the builtin's for
    good (a rank process of a test), a pytest monkeypatch's for one test."""
    from .loss import joint

    real_filter = joint.margin_filter

    def margin_filter(emb, trip, margin=0.0, type_of_triplets="easy"):
        if emb.dtype == torch.float32 and given.margins is not None:
            got = real_filter(emb, trip, margin, type_of_triplets).mask.cpu().numpy()
            flipped = got != given.mask
            if not (np.abs(given.margins[flipped]) < given.NEAR_TIE).all():
                raise AssertionError("the port's 'easy' mask differs from the given one "
                                     "beyond near-ties")
        return trip._replace(mask=torch.from_numpy(given.mask).to(emb.device))

    setattr(joint, "sample_balanced_triplets",
            lambda generator, labels, *a, **k: type(given.trip)(
                *(t.to(labels.device) for t in given.trip)))
    setattr(joint, "margin_filter", margin_filter)


def grad_array(p):
    """p's gradient as a float64 numpy array, zeros where the loss does not
    reach p (a VNMaxPool's direction map: its argmax has no gradient, where
    JAX's is zero)."""
    return (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu().double().numpy()


def float64_train_step(system, batch, graphs, device="cpu", shard=None, group=None):
    """One training step of a float64 copy of `system` (on `device`, in
    training mode, on the kNN graphs `graphs`, without rotation or
    dropout): its logs {"total_loss", "loss_metric", "loss_hyp"}, its
    gradients by parameter name and its new state_dict, as numpy.  The
    triplets are what the loss's sampler gives.  graphs None: the step's
    own (`knn` on its float64 features).  shard: a point_parallel.PointShard,
    for the point-sharded step on this rank's part of the batch (its own
    graphs).  group: a process group, for the data-parallel step on this
    rank's shard.  Either way the gradients, logs and running statistics
    are the mean over the ranks (data_parallel.all_reduce_step)."""
    from .models import decode_vector_for_batch
    from .parallel.data_parallel import all_reduce_step
    from .nn import point_shard

    sys64 = copy.deepcopy(system)
    sys64.optimizer.zero_grad(set_to_none=True)
    net = sys64.net.to(device).double().train()
    if sys64.hierarchy_matrices is not None:  # the hierarchical CosFace's level sums
        sys64.hierarchy_matrices = [m.to(device).double() for m in sys64.hierarchy_matrices]
    if getattr(net.nn_feat, "compute_dtype", None) is not None:
        net.nn_feat.compute_dtype = None  # a bf16 backbone's step, in float64 throughout
    for st in sys64.optimizer.state.values():
        st.update({k: v.to(device).double() for k, v in st.items() if torch.is_tensor(v)})
    pts = torch.as_tensor(batch["points"]).to(device).double()
    dv = (decode_vector_for_batch(system.cfg, batch) if shard is None
          else shard.decode_vector(system.cfg, batch, device))
    dv = torch.as_tensor(dv).to(device).double()
    labels = torch.as_tensor(batch["labels"]).long().to(device)
    with point_shard.use(shard):
        _, x_p = net(pts, dv, idx_override=None if graphs is None else
                     [g.to(device) for g in graphs])
        if shard is not None:
            x_p, labels = shard.whole_batch(x_p, labels)
    losses, _ = sys64._losses_and_metrics(torch.Generator(device=device), x_p, labels)
    total = losses["loss_metric"] + losses["loss_hyp"]
    total.backward()
    logs = {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}
    if shard is not None or group is not None:
        logs = all_reduce_step(sys64, logs, group)
    logs = {k: float(v) for k, v in logs.items()}
    grads = {name: grad_array(p) for name, p in net.named_parameters()}
    sys64.apply_gradients()
    return logs, grads, {k: v.cpu().numpy() for k, v in net.state_dict().items()}


def permute_step_inputs(batch, graphs, triplets, perm):
    """The inputs of one training step with each cloud's points reordered:
    point perm[b, j] of cloud b becomes its point j (perm [B, N], CPU).

    Returns (batch, graphs, triplets) for the reordered clouds: the graphs
    [B, N, k] and the triplets' flat indices b N + i mapped to the new
    positions.  The step computes the same function of them, and the same
    gradients in exact arithmetic; only the order of its sums changes."""
    B, N = perm.shape
    inv = torch.argsort(perm, dim=1)
    rows = torch.arange(B)[:, None]
    out = {k: (torch.as_tensor(v)[rows, perm] if k in ("points", "labels") else v)
           for k, v in batch.items()}
    new_graphs = []
    for g in graphs:
        old = g.cpu().long()[rows, perm]  # [B, N, k]: the old neighbours of each new point
        new = torch.gather(inv, 1, old.reshape(B, -1)).reshape(old.shape)
        new_graphs.append(new.to(g.dtype))
    flat = (inv + rows * N).reshape(-1)
    t = triplets
    return out, new_graphs, t._replace(anchor=flat[t.anchor.cpu()], positive=flat[t.positive.cpu()],
                                       negative=flat[t.negative.cpu()])


ORDERS = 4  # point orders besides the given one in which the CPU's fp32 step is run
ORDERS_FLOAT64 = 2  # of which the CPU's float64 step is also run in the first ones
FLOAT64_WITNESS = 1e-8  # card vs CPU float64 step: gradients / leaf's largest entry, logs rel.
FACTOR = 4.0  # the card at most FACTOR times as far from float64 as the CPU's farthest fp32 step
GRAD_FLOOR = 1e-6  # a leaf's gradient scale: at least this share of the net's largest entry
UPDATE_ATOL, UPDATE_RTOL = 1e-6, 1e-5  # the card's optimizer step against the CPU's on its gradients


def check_train_step_card_vs_cpu(system, batch, seed=0, group=None):
    """One train_step of `system` (on the card; any backbone) against the
    same step of its copy on the CPU, and both against the CPU copy's step
    in float64.  With `group` (a process group: gloo carries CPU and CUDA
    tensors alike) every step is the data-parallel step on this rank's
    shard `batch`: each one's gradients, logs and running statistics take
    the mean over the group (data_parallel.all_reduce_step) before they are
    compared, on every rank alike; each rank passes its own seed.

    The system's config must have dropout 0 and train_rotation 'none'.  The
    triplets are drawn once on the CPU (from `seed`) and given to both; the
    CPU runs on the card's kNN graphs (kernel B1's, recorded where every
    backbone builds them, `vn_dgcnn.knn_graph`) and takes the card's 'easy'
    mask after checking that its own differs only at near-ties.

    The fp32 training forward is ill-conditioned (VN-DGCNN: stage 1's
    self-edge), so
    two fp32 steps that sum in other orders differ by far more than a
    rounding (on the H100 a gradient entry of the CPU's fp32 step lies up
    to 27 % of its leaf's largest entry from float64, and two orders of the
    CPU's step up to 18 % apart).  Two witnesses tell a fault from it:
    - the card's step in float64 equals the CPU's float64 step: gradients
      within FLOAT64_WITNESS of each leaf's scale (below), logs within it
      relative (H100 readings: up to 4.6e-10 at B=2, N=128, eucl = hyp = 8;
      6.8e-12 at N=256, eucl = hyp = 32), or within FACTOR times the most
      the CPU's float64 step moves in ORDERS_FLOAT64 other point orders,
      where that is more (float64's own noise: PointNet's batch-statistics
      BatchNorms over [B, C] cancel even there, 1.2e-8 on the H100).  The
      card's plain path computes the same function;
    - the noise: the CPU's fp32 step is also run on the clouds with their
      points reordered (`permute_step_inputs`, ORDERS seeded orders), the
      same function with other sums.  The card's fp32 step must be no more
      than FACTOR times as far from float64 as the farthest of these.
    Tolerances, the CPU-vs-JAX test's (tests/test_torch_train_step.py) with
    the CPU's fp32 steps in JAX's place: logs within atol 1e-5 / rtol 1e-3
    (accuracy and IoU atol 0.02); gradients entry by entry at most FACTOR
    times as far from the float64 gradient as the CPU's farthest, plus 1e-4,
    as shares of the leaf's scale: its largest float64 entry, or GRAD_FLOOR
    of the net's largest where that is larger (a bias before a
    batch-statistics BatchNorm has a zero gradient, whose float64 values
    are rounding alone); the card's and the CPU's gradients are not held to
    each other directly: the CPU's own orders differ by up to 18 %, and by
    the triangle inequality the bound above keeps them within FACTOR + 1
    times the CPU's farthest; running statistics within atol 2e-4 / rtol
    1e-3 of the CPU's; logs and statistics at most FACTOR times as far from
    the float64 step's as the CPU's farthest, plus 1e-5 relative for logs
    and 1e-6 for the statistics.  The new parameters equal, within
    UPDATE_ATOL / UPDATE_RTOL, what the CPU's Riemannian Adam makes of the
    card's gradients from the same parameters: the update is held apart
    from the gradients, because its first step moves each ball point by
    ~lr along its gradient whatever the gradient's size, so two fp32
    gradients of an ill-conditioned step (or of a point whose exact
    gradient is zero) move a point differently.  Each direct tolerance
    (logs, statistics, the mask's near-ties) also admits FACTOR times the
    most that the CPU's own fp32 orders move the value (over a leaf's
    entries, as shares of their tolerance): the card's step is one more
    order of the same sums.  That term is small for
    VN-DGCNN; it carries the backbones whose batch-statistics BatchNorms
    over [B, C] global features cancel in fp32 (PointNet's STNkd,
    VN-PointNet's fstn; see tests/test_torch_backbones_train.py), where the
    CPU's orders move a loss by up to 2e-3 relative.
    Raises AssertionError; returns the largest errors and, per gradient,
    [card, CPU's farthest] from float64, card and CPU apart, the CPU's
    orders apart, and the float64 steps apart.
    """
    from .loss import joint
    from .miner import cosine_similarity01, sample_balanced_triplets
    from .models import HypHCSystem
    from .nn.backbones import vn_dgcnn
    from .parallel.data_parallel import all_reduce_step

    def step(sys_, b, generator):
        logs = sys_.grads_and_logs(b, generator)
        return logs if group is None else all_reduce_step(sys_, logs, group)

    cfg = system.cfg
    if cfg.dropout or cfg.train_rotation != "none":
        raise ValueError("the comparison needs dropout 0 and train_rotation 'none'")
    before = copy.deepcopy(system)  # the card's system before its step
    initial = {k: v.cpu() for k, v in before.net.state_dict().items()}
    cpu = HypHCSystem(cfg, device="cpu")
    cpu.net.load_state_dict(initial)
    labels = torch.as_tensor(batch["labels"]).reshape(-1).long()
    trip = sample_balanced_triplets(torch.Generator().manual_seed(seed), labels, cfg.num_class,
                                    cfg.t_per_anchor, cfg.fraction, num_triplets=cfg.num_triplets)
    real_knn, real_filter, real_sampler = vn_dgcnn.knn, joint.margin_filter, \
        joint.sample_balanced_triplets
    graphs, state = [], {"trip": trip}

    def sampler(generator, labels, *args, **kw):
        return type(trip)(*(t.to(labels.device) for t in state["trip"]))

    def card_knn(x, k):
        graphs.append(real_knn(x, k))
        return graphs[-1]

    def given_graphs(gs):
        it = iter(gs)
        return lambda x, k: next(it).to(x.device)

    margins = []  # (the margins of every triplet, where the mask differs) of each CPU fp32 step

    def margin_filter(emb, t, margin=0.0, type_of_triplets="easy"):
        if "mask" not in state:  # the card's step
            state["mask"] = real_filter(emb, t, margin, type_of_triplets).mask.cpu()
        elif emb.dtype == torch.float32:  # the CPU's, in the given order or another
            own = real_filter(emb, t, margin, type_of_triplets).mask
            emb = emb.detach()
            a = emb[t.anchor]
            tm = cosine_similarity01(a, emb[t.positive]) - cosine_similarity01(a, emb[t.negative])
            margins.append((tm, own != state["mask"].to(own.device)))
        return t._replace(mask=state["mask"].to(emb.device))

    reordered, reordered64 = [], []
    try:
        joint.sample_balanced_triplets, joint.margin_filter = sampler, margin_filter
        vn_dgcnn.knn = card_knn
        logs = step(system, batch, torch.Generator(device=system.device))
        ref_logs, ref_grads, ref_sd = float64_train_step(cpu, batch, graphs, group=group)
        card64_logs, card64_grads, _ = float64_train_step(before, batch, graphs, system.device,
                                                          group=group)
        vn_dgcnn.knn = given_graphs(graphs)
        cpu_logs = step(cpu, batch, torch.Generator())
        perm_gen = torch.Generator().manual_seed(seed + 1)
        B, N = torch.as_tensor(batch["labels"]).shape
        for _ in range(ORDERS):
            perm = torch.stack([torch.randperm(N, generator=perm_gen) for _ in range(B)])
            p_batch, p_graphs, state["trip"] = permute_step_inputs(batch, graphs, trip, perm)
            vn_dgcnn.knn = given_graphs(p_graphs)
            other = HypHCSystem(cfg, device="cpu")
            other.net.load_state_dict(initial)
            if len(reordered) < ORDERS_FLOAT64:  # float64's own noise
                reordered64.append(float64_train_step(other, p_batch, p_graphs,
                                                      group=group)[:2])
            other_logs = step(other, p_batch, torch.Generator())
            other_grads = {n: grad_array(p) for n, p in other.net.named_parameters()}
            other.apply_gradients()
            reordered.append((other_logs, other_grads,
                              {n: v.double().numpy() for n, v in other.net.state_dict().items()}))
    finally:
        vn_dgcnn.knn, joint.margin_filter = real_knn, real_filter
        joint.sample_balanced_triplets = real_sampler
    # the card's mask may differ from the CPU's own only at near-ties: where
    # |sim(a,p) - sim(a,n)| < NEAR_TIE plus FACTOR times the most a margin
    # moves between the CPU's orders
    tm_spread = max(float((tm - margins[0][0]).abs().max()) for tm, _ in margins)
    for tm, flipped in margins:
        assert bool((tm[flipped].abs() < NEAR_TIE + FACTOR * tm_spread).all()), \
            "card and CPU masks differ beyond near-ties"
    out = {"filter_flips": max(int(f.sum()) for _, f in margins), "max_rel_err_logs": 0.0,
           "float64_card_vs_cpu": 0.0, "margin_spread_of_cpu_orders": tm_spread,
           "max_ratio_vs_float64": [0.0, ""]}  # card / (the CPU's farthest + slack), and where

    for k, r in ref_logs.items():
        gap = abs(card64_logs[k] - r) / max(abs(r), 1e-30)
        spread = max(abs(lg[k] - r) for lg, _ in reordered64) / max(abs(r), 1e-30)
        assert gap <= max(FLOAT64_WITNESS, FACTOR * spread), \
            f"{k}: the card's float64 step {gap:.3e} from the CPU's, its orders {spread:.3e}"
        out["float64_card_vs_cpu"] = max(out["float64_card_vs_cpu"], gap)

    def near_float64(got, cpu_vals, ref, slack, what):
        d = np.abs(np.asarray(got, np.float64) - ref).max()
        d_cpu = max(np.abs(np.asarray(c, np.float64) - ref).max() for c in cpu_vals)
        ratio = float(d / (d_cpu + slack))
        if ratio > out["max_ratio_vs_float64"][0]:
            out["max_ratio_vs_float64"] = [ratio, what]
        assert d <= FACTOR * d_cpu + slack, f"{what}: card {d:.3e} from float64, CPU {d_cpu:.3e}"

    for k, v in logs.items():
        g, c = float(v), float(cpu_logs[k])
        tol = (0.02, 0.0) if k in ("acc", "iou") else (1e-5, 1e-3)
        spread = max(abs(float(lg[k]) - c) for lg, _, _ in reordered)
        assert abs(g - c) <= tol[0] + tol[1] * abs(c) + FACTOR * spread, \
            f"{k}: card {g}, CPU {c}, the CPU's orders {spread:.3e} apart"
        if k in ref_logs:
            near_float64(g, [c] + [float(lg[k]) for lg, _, _ in reordered], ref_logs[k],
                         1e-5 * abs(ref_logs[k]), k)
        out["max_rel_err_logs"] = max(out["max_rel_err_logs"], abs(g - c) / max(abs(c), 1e-12))
    cpu_grads = {n: grad_array(p) for n, p in cpu.net.named_parameters()}
    grads = {"card_vs_float64": 0.0, "cpu_vs_float64": 0.0, "card_vs_cpu": 0.0,
             "cpu_vs_cpu_reordered": 0.0}
    out["grad_leaves"] = {}
    params = dict(system.net.named_parameters())
    top = max(float(np.abs(r).max()) for r in ref_grads.values())
    for name, p in system.net.named_parameters():
        g, r = grad_array(p), ref_grads[name]
        scale = max(float(np.abs(r).max()), GRAD_FLOOR * top)
        gap64 = float(np.abs(card64_grads[name] - r).max()) / scale
        spread64 = max(float(np.abs(gs[name] - r).max()) for _, gs in reordered64) / scale
        assert gap64 <= max(FLOAT64_WITNESS, FACTOR * spread64), \
            f"gradient of {name}: the card's float64 step {gap64:.3e} from the CPU's, its " \
            f"orders {spread64:.3e}"
        d = float(np.abs(g - r).max()) / scale
        d_cpu = max(float(np.abs(c[name] - r).max()) / scale
                    for c in [cpu_grads] + [gs for _, gs, _ in reordered])
        direct = float(np.abs(g - cpu_grads[name]).max()) / scale
        spread = max(float(np.abs(gs[name] - cpu_grads[name]).max()) / scale
                     for _, gs, _ in reordered)
        out["grad_leaves"][name] = [d, d_cpu, direct, spread, gap64]
        assert d <= FACTOR * d_cpu + 1e-4, \
            f"gradient of {name}: card {d:.3e} from float64, the CPU's fp32 steps {d_cpu:.3e}"
        out["float64_card_vs_cpu"] = max(out["float64_card_vs_cpu"], gap64)
        for key, val in zip(grads, (d, d_cpu, direct, spread)):
            grads[key] = max(grads[key], val)
    out["max_grad_share"] = grads
    # the update: the CPU's Riemannian Adam applied to the card's gradients
    # from the same parameters gives the card's new parameters
    update = HypHCSystem(cfg, device="cpu")
    update.net.load_state_dict(initial)
    for name, p in update.net.named_parameters():
        g = params[name].grad
        p.grad = None if g is None else g.detach().cpu().clone()
    update.apply_gradients()
    system.apply_gradients()
    cpu.apply_gradients()
    cpu_sd, out["max_abs_err_params"], out["max_abs_err_stats"] = cpu.net.state_dict(), 0.0, 0.0
    update_sd = update.net.state_dict()
    for name, v in system.net.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        g = v.cpu().double().numpy()
        if name in params:
            u = update_sd[name].double().numpy()
            err = np.abs(g - u)
            assert (err <= UPDATE_ATOL + UPDATE_RTOL * np.abs(u)).all(), \
                f"{name}: the card's update differs from the CPU's on its gradients by " \
                f"{err.max():.3e}"
            out["max_abs_err_params"] = max(out["max_abs_err_params"], float(err.max()))
            continue
        c = cpu_sd[name].double().numpy()
        others = [sd[name] for _, _, sd in reordered]
        err, tol = np.abs(g - c), 2e-4 + 1e-3 * np.abs(c)
        spread = max(float((np.abs(o - c) / tol).max()) for o in others)
        assert float((err / tol).max()) <= 1 + FACTOR * spread, \
            f"{name}: card and CPU differ by {err.max():.3e}, the CPU's orders by " \
            f"{spread:.3e} of the tolerance"
        near_float64(g, [c] + others, ref_sd[name], 1e-6, name)
        out["max_abs_err_stats"] = max(out["max_abs_err_stats"], float(err.max()))
    return out


def optimizer_twin(optimizer, cls):
    """A copy of `optimizer`'s parameters, their gradients and its state
    under the Riemannian Adam form `cls` (RiemannianAdam or
    FusedRiemannianAdam), with the same groups and hyperparameters."""
    groups, state = [], {}
    for group in optimizer.param_groups:
        params = []
        for p in group["params"]:
            twin = p.detach().clone().requires_grad_(p.requires_grad)
            twin.grad = None if p.grad is None else p.grad.detach().clone()
            state[twin] = {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in optimizer.state[p].items()}
            params.append(twin)
        groups.append({**{k: v for k, v in group.items() if k != "params"}, "params": params})
    out = cls(groups)
    out.state.update(state)
    return out


def check_packed_update(optimizer):
    """One step of `optimizer`'s packed form (FusedRiemannianAdam) against
    its per-parameter form (RiemannianAdam), both on copies of its
    parameters, gradients and state: parameters and moments within
    UPDATE_ATOL / UPDATE_RTOL (on the card the packs' reductions may run in
    another order than each parameter's).  Raises AssertionError; returns
    (packed, per-parameter twins after their step, {"max_abs_err_params",
    "max_abs_err_moments", "parameters"})."""
    from .optim import FusedRiemannianAdam, RiemannianAdam

    packed, plain = optimizer_twin(optimizer, FusedRiemannianAdam), \
        optimizer_twin(optimizer, RiemannianAdam)
    packed.step()
    plain.step()
    out = {"max_abs_err_params": 0.0, "max_abs_err_moments": 0.0, "parameters": 0}
    pairs = zip((p for g in packed.param_groups for p in g["params"]),
                (p for g in plain.param_groups for p in g["params"]))
    for i, (a, b) in enumerate(pairs):
        for key in ("param", "exp_avg", "exp_avg_sq"):
            got, want = (a, b) if key == "param" else (packed.state[a][key], plain.state[b][key])
            got, want = got.detach().double(), want.detach().double()
            err = (got - want).abs()
            assert bool((err <= UPDATE_ATOL + UPDATE_RTOL * want.abs()).all()), \
                f"parameter {i} {key}: packed and per-parameter updates differ by " \
                f"{float(err.max()):.3e}"
            which = "max_abs_err_params" if key == "param" else "max_abs_err_moments"
            out[which] = max(out[which], float(err.max()))
        out["parameters"] += 1
    return packed, plain, out


# ShapeNet-Part's 16 categories and their synset offsets, in the order of the
# dataset's synsetoffset2category.txt (a category's id is its line's position)
SHAPENET_SYNSETS = {
    "Airplane": "02691156", "Bag": "02773838", "Cap": "02954340", "Car": "02958343",
    "Chair": "03001627", "Earphone": "03261776", "Guitar": "03467517", "Knife": "03624134",
    "Lamp": "03636649", "Laptop": "03642001", "Motorbike": "03790512", "Mug": "03797390",
    "Pistol": "03948459", "Rocket": "04099429", "Skateboard": "04225987", "Table": "04379243",
}


def write_mini_shapenet(root, categories=("Airplane", "Chair"), per_split=(4, 2, 4), seed=0,
                        points=2600):
    """Write a ShapeNet-Part tree under `root` (the directory a
    ShapeNetDataset reads) and return root.

    synsetoffset2category.txt lists all 16 categories; `categories` get
    per_split = (train, val, test) objects each, as
    `<synset>/<token>.txt` with rows "x y z nx ny nz seg" of `points`
    points, each part of the category (its labels in SEG_CLASSES) an
    anisotropic Gaussian blob; the split lists
    train_test_split/shuffled_{split}_file_list.json name them.
    """
    from .data.shapenet import SEG_CLASSES

    os.makedirs(os.path.join(root, "train_test_split"), exist_ok=True)
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        f.writelines(f"{name}\t{synset}\n" for name, synset in SHAPENET_SYNSETS.items())
    rng = np.random.default_rng(seed)
    splits = {"train": [], "val": [], "test": []}
    for cat in categories:
        synset = SHAPENET_SYNSETS[cat]
        os.makedirs(os.path.join(root, synset), exist_ok=True)
        parts = SEG_CLASSES[cat]
        per = np.full(len(parts), points // len(parts))
        per[:points - per.sum()] += 1
        idx = 0
        for split, count in zip(("train", "val", "test"), per_split):
            for _ in range(count):
                token = f"{cat.lower()}_{idx:04d}"
                pts = np.concatenate([rng.uniform(-0.6, 0.6, 3)
                                      + rng.standard_normal((n, 3)) * rng.uniform(0.05, 0.35, 3)
                                      for n in per])
                seg = np.repeat(parts, per)
                normals = rng.standard_normal(pts.shape)
                normals /= np.linalg.norm(normals, axis=1, keepdims=True)
                np.savetxt(os.path.join(root, synset, f"{token}.txt"),
                           np.concatenate([pts, normals, seg[:, None]], axis=1), fmt="%.6f")
                splits[split].append(f"shape_data/{synset}/{token}")
                idx += 1
    for split, items in splits.items():
        with open(os.path.join(root, "train_test_split",
                               f"shuffled_{split}_file_list.json"), "w") as f:
            json.dump(items, f)
    return root


CHUNK_BTREE_K = 32  # a chunk B-tree node's K under superblock version 0: 64 chunks a node


def write_h5_deflated(path, arrays, rows=1, level=4, shuffle=False):
    """Write `arrays` ({name: array}) as hdf5.write_h5 does, each dataset
    chunked by `rows` along its first dim (chunks (rows, *shape[1:]); the
    edge chunk stored whole, zero padded), each chunk shuffled where asked
    and deflated at `level`, and indexed by one leaf of a version 1 B-tree:
    h5py's `create_dataset(..., chunks=chunks, compression="gzip",
    compression_opts=level, shuffle=shuffle)` with libver "earliest".  Up
    to 64 chunks a dataset."""

    def messages(image, array):
        array = np.ascontiguousarray(array)
        rank, size = array.ndim, array.dtype.itemsize
        chunks = (rows,) + array.shape[1:]
        entries = []
        for offsets in itertools.product(*(range(0, s, c) for s, c in zip(array.shape, chunks))):
            block = np.zeros(chunks, array.dtype)
            part = array[tuple(slice(o, o + c) for o, c in zip(offsets, chunks))]
            block[tuple(slice(0, n) for n in part.shape)] = part
            raw = block.tobytes()
            if shuffle:
                raw = np.frombuffer(raw, np.uint8).reshape(-1, size).T.tobytes()
            raw = zlib.compress(raw, level)
            addr = image.alloc(len(raw))
            image.put(addr, raw)
            entries.append((offsets, len(raw), addr))
        if len(entries) > 2 * CHUNK_BTREE_K:
            raise ValueError(f"{path}: {len(entries)} chunks; one B-tree leaf holds "
                             f"{2 * CHUNK_BTREE_K}")
        key = struct.Struct(f"<II{rank + 1}Q")
        tree = bytearray(b"TREE" + struct.pack("<BBHQQ", 1, 0, len(entries), hdf5.UNDEFINED,
                                               hdf5.UNDEFINED))
        for offsets, nbytes, addr in entries:
            tree += key.pack(nbytes, 0, *offsets, 0) + struct.pack("<Q", addr)
        # the right key: one chunk past the last in every dim
        last = entries[-1][0] if entries else (0,) * rank
        tree += key.pack(0, 0, *(o + c for o, c in zip(last, chunks)), size)
        btree = image.alloc(8 + 2 * 8 + (2 * CHUNK_BTREE_K + 1) * key.size
                            + 2 * CHUNK_BTREE_K * 8)
        image.put(btree, tree)
        filters = [(hdf5.SHUFFLE, size)] if shuffle else []
        filters.append((hdf5.DEFLATE, level))
        pipeline = struct.pack("<BB6x", 1, len(filters)) + b"".join(
            struct.pack("<HHHHI4x", fid, 0, 1, 1, value) for fid, value in filters)
        layout = struct.pack(f"<BBBQ{rank + 1}I", 3, 2, rank + 1, btree, *chunks, size)
        return [(hdf5.DATASPACE, hdf5.dataspace_message(array.shape)),
                (hdf5.DATATYPE, hdf5.datatype_message(array.dtype)),
                (hdf5.FILL, hdf5.FILL_DEFAULT), (hdf5.PIPELINE, pipeline),
                (hdf5.LAYOUT, layout)]

    hdf5.write_h5(path, arrays, messages)
    return path


@contextlib.contextmanager
def record_test_steps():
    """Record every HypHCSystem.test_step call made inside the block.

    Yields a list that gains one dict per call: its "logs" as floats, its
    "pred", "best_k", "best_score" and "linkage" on the CPU, and its
    "seconds" on the host clock (after a synchronize on a CUDA system).
    """
    from .models import HypHCSystem

    calls, original = [], HypHCSystem.test_step

    def recorded(self, batch, generator):
        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        sync()
        t = time.perf_counter()
        logs, extras = original(self, batch, generator)
        sync()
        seconds = time.perf_counter() - t
        calls.append(dict(logs={k: float(v) for k, v in logs.items()}, seconds=seconds,
                          **{k: extras[k].cpu() for k in ("pred", "best_k", "best_score",
                                                          "linkage")}))
        return logs, extras

    HypHCSystem.test_step = recorded
    try:
        yield calls
    finally:
        HypHCSystem.test_step = original


def check_same_test_outputs(got, want):
    """Two record_test_steps lists of the same batches: prediction, best k,
    best score and linkage equal exactly, the logs within rtol 1e-5 (the
    losses' sums may run in another order on the card).  Raises
    AssertionError; returns the largest relative difference of the logs."""
    assert len(got) == len(want), f"{len(got)} test steps against {len(want)}"
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("pred", "best_k", "best_score", "linkage"):
            assert torch.equal(g[key], w[key]), f"batch {i}: {key} differs"
        for key, v in w["logs"].items():
            rel = abs(g["logs"][key] - v) / max(abs(v), 1e-30)
            assert rel <= 1e-5, f"batch {i}: {key} {g['logs'][key]} against {v}"
            worst = max(worst, rel)
    return worst


def trained_system(path, device=None, **over):
    """A HypHCSystem holding the checkpoint at `path` (a directory), with
    the ModelConfig of its config.json and the fields `over` (bf16=True for
    its bf16 serving)."""
    from .cli import freeze_hierarchy
    from .models import HypHCSystem, ModelConfig
    from .utils.checkpoint import load_config, restore_checkpoint

    cfg = load_config(path)
    cfg["hierarchy_list"] = freeze_hierarchy(cfg.get("hierarchy_list", ()))
    system = HypHCSystem(ModelConfig(**{**cfg, **over}), device=device)
    restore_checkpoint(path, system)
    return system


def fp32_bf16_quality(fp32, bf16, batches, seed=0):
    """The decode's quality of two systems (a trained checkpoint served in
    fp32 and in bf16) on the same batches: each runs test_step on every
    batch, its rotations and triplets drawn from a generator seeded with
    `seed`.

    Per system: "score" (the mean best score), "purity" (the mean purity
    of the best-k cut, `decode.purity`), "test_acc", "test_iou",
    "test_loss" (means over the batches), "best_k" (per object) and
    "objects".  Then "purity_delta" (|fp32 - bf16|), "score_delta"
    (fp32 - bf16) and "best_k_agreement" (the share of objects whose best
    k is the same).
    """
    from .decode import purity

    def serve(system):
        gen = torch.Generator(device=system.device).manual_seed(seed)
        C = system.cfg.num_class
        logs, purities, best_k, scores = [], [], [], []
        for batch in batches:
            lg, extras = system.test_step(batch, gen)
            labels = torch.as_tensor(batch["labels"], device=system.device).long()
            purities.append(purity(labels, extras["pred"], C, C + 4).cpu())
            best_k.append(extras["best_k"].cpu())
            scores.append(extras["best_score"].cpu())
            logs.append({k: float(v) for k, v in lg.items()})
        best_k = torch.cat(best_k)
        return dict(score=float(torch.cat(scores).double().mean()),
                    purity=float(torch.cat(purities).double().mean()),
                    **{k: float(np.mean([lg[k] for lg in logs]))
                       for k in ("test_acc", "test_iou", "test_loss") if k in logs[0]},
                    best_k=best_k.tolist(), objects=len(best_k))

    a, b = serve(fp32), serve(bf16)
    return dict(fp32=a, bf16=b, purity_delta=abs(a["purity"] - b["purity"]),
                score_delta=a["score"] - b["score"],
                best_k_agreement=float(np.mean([x == y for x, y in zip(a["best_k"],
                                                                       b["best_k"])])))


# ------------------------------------------- the JAX package's checkpoints

_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"), "running_var": ("batch_stats", "var")}


def _flax_place(name):
    """Where the port's VN-DGCNN HypHCNet state entry `name` lies in the JAX
    package's trees: (tree "params" or "batch_stats", key path, layout
    "v" as is, "t" transposed, "conv" a Conv1d [out, in, 1] as [in, out]),
    or None for BatchNorm's num_batches_tracked, which flax lacks.  The
    inverse of `utils.jax_params.from_jax_params` for VN-DGCNN."""
    top = {"scale": ("params", ["scale"], "v"),
           "metric_hyp_loss.loss_cosface.W": ("params", ["cosface_W"], "v"),
           "nn_emb.mlp.0.0.weight": ("params", ["embedder", "Dense_0", "kernel"], "t")}
    if name in top:
        return top[name]
    parts = name.split(".")
    if parts[0] != "nn_feat":
        raise ValueError(f"no flax place for {name}")
    p, leaf = ["backbone"] + parts[1:-1], parts[-1]
    if leaf == "num_batches_tracked":
        return None
    if p[-2:] == ["batchnorm", "bn"]:
        tree, flax_leaf = _BN_LEAVES[leaf]
        return tree, p + [flax_leaf], "v"
    if p[-1] == "map_to_feat":
        return "params", p[:-1] + ["linear", "kernel"], "t"
    if p[-1] == "map_to_dir":
        return "params", p[:-1] + ["dir_kernel"], "t"
    if p[1:] == ["std_feature", "vn_lin"]:
        return "params", ["backbone", "std_feature", "frame_kernel"], "t"
    if len(p) == 3 and p[2] == "0":
        return "params", p[:2] + ["Dense_0", "kernel"], "conv"
    if len(p) == 3 and p[2] == "1":
        tree, flax_leaf = _BN_LEAVES[leaf]
        return tree, p[:2] + ["BatchNorm_0", flax_leaf], "v"
    raise ValueError(f"no flax place for {name} (VN-DGCNN only)")


def _to_flax_layout(x, layout):
    x = x.detach().cpu().float().numpy()
    if layout == "conv":
        x = x[..., 0]
    return np.ascontiguousarray(x.T if layout != "v" else x)


def _set_path(tree, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _pack_buckets(tree, pad_with_row):
    """A flax-layout moment tree packed as the JAX package's fused Riemannian
    Adam packs it: leaves in tree-flatten order (keys sorted), each as rows
    [prod(shape[:-1]), d] padded to a multiple of 128 columns (at least
    128), stacked per width.  The padding is 0, or with `pad_with_row` the
    row's own value (exp_avg_sq, equal along the row)."""
    from .utils.jax_params import _lane_round

    buckets = {}

    def walk(node):
        for key in sorted(node):
            x = node[key]
            if isinstance(x, dict):
                walk(x)
                continue
            shape = x.shape or (1,)
            d = shape[-1]
            rows = x.reshape(-1, d)
            db = _lane_round(d)
            fill = np.repeat(rows[:, :1], db - d, axis=1) if pad_with_row else \
                np.zeros((rows.shape[0], db - d), np.float32)
            buckets.setdefault(db, []).append(np.concatenate([rows, fill], axis=1))

    walk(tree)
    return {str(db): np.concatenate(parts) for db, parts in sorted(buckets.items())}


def flax_state_of(system):
    """The JAX package's TrainState, in its state-dict form (string keys,
    numpy leaves), holding `system`'s state: params and batch_stats, the
    inject_hyperparams(riemannian_adam_fused) optimizer state (packed
    moments, the step count, the param groups' learning rate) and the step.
    The inverse of `utils.checkpoint.load_jax_state`, for VN-DGCNN."""
    from .optim.radam import BETAS
    from .optim.radam import EPS as ADAM_EPS

    trees = {"params": {}, "batch_stats": {}}
    m_tree, v_tree, count = {}, {}, 0
    named = dict(system.net.named_parameters())
    for name, x in system.net.state_dict().items():
        place = _flax_place(name)
        if place is None:
            continue
        tree, path, layout = place
        value = _to_flax_layout(x, layout)
        _set_path(trees[tree], path, value)
        if name in named:
            st = system.optimizer.state.get(named[name]) or {}
            m = st.get("exp_avg", torch.zeros_like(x))
            v = st.get("exp_avg_sq", torch.zeros_like(x))
            count = st.get("step", count)
            _set_path(m_tree, path, _to_flax_layout(m, layout))
            _set_path(v_tree, path, np.ascontiguousarray(
                np.broadcast_to(_to_flax_layout(v, layout), value.shape)))
    f32 = np.float32
    inner = {"count": np.array(count, np.int32), "exp_avg": _pack_buckets(m_tree, False),
             "exp_avg_sq": _pack_buckets(v_tree, True)}
    hyper = {"b1": np.array(BETAS[0], f32), "b2": np.array(BETAS[1], f32),
             "eps": np.array(ADAM_EPS, f32), "learning_rate":
             np.array(system.optimizer.param_groups[0]["lr"], f32),
             "weight_decay": np.array(0.0, f32)}
    opt = {"count": np.array(count, np.int32), "hyperparams": hyper, "hyperparams_states": {},
           "inner_state": inner}
    return {**trees, "opt_state": opt, "step": np.array(system.step, np.int32)}


def msgpack_pack(obj):
    """msgpack bytes of obj, as flax.serialization writes its state dicts:
    dicts (string keys), lists, str, bytes, bool, None, int, float, numpy
    arrays as ext 1 [shape, dtype name, C bytes] and numpy scalars as
    ext 3."""
    out = bytearray()

    def header(n, small, small_max, codes):
        if small is not None and n <= small_max:
            out.append(small | n)
            return
        for code, fmt, top in codes:
            if n < top:
                out.append(code)
                out.extend(struct.pack(fmt, n))
                return
        raise ValueError(f"length {n} too large for msgpack")

    sized = {"str": [(0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32)],
             "bin": [(0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32)],
             "array": [(0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32)],
             "map": [(0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32)]}

    def ext(code, payload):
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            out.append(0xd4 + n.bit_length() - 1)
        else:
            header(n, None, 0, [(0xc7, ">B", 1 << 8), (0xc8, ">H", 1 << 16),
                                (0xc9, ">I", 1 << 32)])
        out.extend(struct.pack(">b", code))
        out.extend(payload)

    def array_record(a):
        return msgpack_pack([list(a.shape), a.dtype.name, a.tobytes("C")])

    def pack(x):
        if isinstance(x, np.ndarray):
            ext(1, array_record(x))
        elif isinstance(x, np.generic):  # before int and float: np.float64 is a float
            ext(3, array_record(np.asarray(x)))
        elif x is None:
            out.append(0xc0)
        elif isinstance(x, bool):
            out.append(0xc3 if x else 0xc2)
        elif isinstance(x, int):
            if -32 <= x <= 0x7f:  # positive and negative fixint
                out.extend(struct.pack(">b", x) if x < 0 else bytes([x]))
            elif x >= 1 << 63:
                out.append(0xcf)
                out.extend(struct.pack(">Q", x))
            else:
                out.append(0xd3)
                out.extend(struct.pack(">q", x))
        elif isinstance(x, float):
            out.append(0xcb)
            out.extend(struct.pack(">d", x))
        elif isinstance(x, str):
            raw = x.encode("utf-8")
            header(len(raw), 0xa0, 31, sized["str"])
            out.extend(raw)
        elif isinstance(x, bytes):
            header(len(x), None, 0, sized["bin"])
            out.extend(x)
        elif isinstance(x, (list, tuple)):
            header(len(x), 0x90, 15, sized["array"])
            for v in x:
                pack(v)
        elif isinstance(x, dict):
            header(len(x), 0x80, 15, sized["map"])
            for k, v in x.items():
                pack(k)
                pack(v)
        else:
            raise TypeError(f"cannot pack {type(x).__name__}")

    pack(obj)
    return bytes(out)


def write_flax_checkpoint(path, system, cfg, epoch=0, extra=None):
    """Write `system`'s state as the JAX package's single-file checkpoint
    into the directory `path`: model.ckpt, the msgpack of {"state":
    TrainState, "epoch", "extra"} that its save_checkpoint writes with
    flax (`flax_state_of`, `msgpack_pack`), and config.json.  `epoch` is
    stored as given: the JAX package's index of the epoch it finished."""
    os.makedirs(path, exist_ok=True)
    payload = {"state": flax_state_of(system), "epoch": int(epoch), "extra": extra or {}}
    with open(os.path.join(path, "model.ckpt"), "wb") as f:
        f.write(msgpack_pack(payload))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)


# ------------------------------------ the JAX package's orbax checkpoints

_ZARR_DTYPES = {np.dtype(np.float32): "<f4", np.dtype(np.int32): "<i4",
                np.dtype(np.uint32): "<u4", np.dtype(np.float64): "<f8",
                np.dtype(np.int64): "<i8"}


def _tree_leaves(tree, path=()):
    """(key path, leaf) of a state-dict tree, dicts in sorted key order;
    an empty dict is a leaf."""
    if isinstance(tree, dict) and tree:
        for key in sorted(tree):
            yield from _tree_leaves(tree[key], path + (key,))
    else:
        yield path, tree


def _zstd_chunk(x):
    """A zarr chunk of the array x: its C-order little-endian bytes in one
    zstd frame at level 1, as orbax's zarr arrays hold them."""
    return zstd.compress(np.ascontiguousarray(x).astype(x.dtype.newbyteorder("<")).tobytes(), 1)


def write_orbax_checkpoint(path, system, cfg, epoch=0, extra=None, processes=1):
    """Write `system`'s state as the JAX package's multi-process checkpoint
    into the directory `path`: what its save_checkpoint(use_orbax=True)
    writes for `flax_state_of(system)` in `processes` processes, with no
    orbax or tensorstore.

    - orbax/_METADATA (the tree), _CHECKPOINT_METADATA and
      array_metadatas/process_<i>; not _sharding, the arrays' placement on
      JAX devices, which a restore onto a given TrainState does not read;
    - the arrays as zarr v2 with zstd chunks (level 1) in an OCDBT database
      with zstd nodes.  With `processes` > 1 on 2 devices each, as a
      replicated TrainState is saved, an array whose first dimension
      divisible by the device count exists is cut along it into one chunk
      per device, each written by that device's process; any other array
      is one chunk of process 0;
    - meta.json ({"epoch", "extra"}: `epoch` as the JAX package stores it,
      the index of the epoch it finished) and config.json.

    A test helper: it lets a GPU machine without orbax read such a
    directory at full width."""
    state = flax_state_of(system)
    devices = 2 * processes if processes > 1 else 1
    root = os.path.join(path, "orbax")
    os.makedirs(os.path.join(root, "array_metadatas"), exist_ok=True)
    tree, arrays = {}, []
    per_process = [{} for _ in range(processes)]
    for top in ("params", "batch_stats", "opt_state", "step"):  # TrainState's fields
        for keys, leaf in _tree_leaves(state[top], (top,)):
            key_meta = [{"key": k, "key_type": 2} for k in keys]
            if isinstance(leaf, dict):
                tree[str(keys)] = {"key_metadata": key_meta, "value_metadata": {
                    "value_type": "Dict", "skip_deserialize": True}}
                continue
            name = ".".join(keys)
            x = np.asarray(leaf)  # not ascontiguousarray: it makes a 0-d array 1-d
            axis = next((a for a, n in enumerate(x.shape) if n % devices == 0), None) \
                if devices > 1 and x.size else None
            chunk = list(x.shape)
            if axis is not None:
                chunk[axis] //= devices
            tree[str(keys)] = {"key_metadata": key_meta, "value_metadata": {
                "value_type": "jax.Array", "skip_deserialize": False, "write_shape": chunk}}
            arrays.append({"array_metadata": {"param_name": name, "write_shape": chunk,
                                              "chunk_shape": chunk, "ext_metadata": None}})
            zarray = {"chunks": chunk, "compressor": {"id": "zstd", "level": 1},
                      "dimension_separator": ".", "dtype": _ZARR_DTYPES[x.dtype],
                      "fill_value": None, "filters": None, "order": "C",
                      "shape": list(x.shape), "zarr_format": 2}
            per_process[0][f"{name}/.zarray".encode()] = json.dumps(
                zarray, separators=(",", ":")).encode()
            for d in range(devices if axis is not None else 1):
                index = [0] * x.ndim
                part = x
                if axis is not None:
                    index[axis] = d
                    part = np.take(x, range(d * chunk[axis], (d + 1) * chunk[axis]), axis=axis)
                key = f"{name}/{'.'.join(map(str, index)) or '0'}".encode()
                per_process[d * processes // devices][key] = _zstd_chunk(part)
    ocdbt.write_multi_process(root, per_process)
    now = time.time_ns()
    files = {"_METADATA": {"tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
                           "store_array_data_equal_to_fill_value": True,
                           "custom_metadata": None},
             "_CHECKPOINT_METADATA": {
                 "item_handlers": "orbax.checkpoint._src.handlers.standard_checkpoint_handler."
                                  "StandardCheckpointHandler",
                 "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": now,
                 "commit_timestamp_nsecs": now, "custom_metadata": {}}}
    files.update({f"array_metadatas/process_{i}": {"array_metadatas": arrays}
                  for i in range(processes)})
    for rel, content in files.items():
        with open(os.path.join(root, rel), "w") as f:
            json.dump(content, f)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"epoch": int(epoch), "extra": extra or {}}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)

