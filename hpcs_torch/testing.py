"""Checks of the port's kernels against their plain versions, and the
test data and probes of the entry points' checks.

Used by chip_smoke.py and the tests; nothing on the forward path imports
this module.
"""
import contextlib
import copy
import json
import os
import time

import numpy as np
import torch

from .ops.edgeconv import _vn_llr_folded, edgeconv_infer_plain, graph_feature_vn
from .ops.knn import gather_neighbors, knn_scores
from .ops.vn_math import EPS, NEGATIVE_SLOPE, channel_mix

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


def check_planted_eps(fn, b, n, k, c, n_convs, variant, device, seed=0):
    """Run the EdgeConv stage `fn` (edgeconv_infer or a twin) on `device` on
    planted_eps_stage's inputs and hold every output to the plain twin in
    float64: atol 1e-5 / rtol 1e-4.  Raises AssertionError; returns the
    largest abs err."""
    x, idx, w = planted_eps_stage(b, n, k, c, n_convs, variant, seed)
    x, idx, w = x.to(device), idx.to(device), [t.to(device) for t in w]
    got = fn(x, idx, *w, n_convs=n_convs)
    want = edgeconv_infer_plain(x.double(), idx, *[t.double() for t in w], n_convs=n_convs)
    assert torch.isfinite(got).all(), f"edgeconv planted {variant} C={c}: non-finite output"
    err = (got.double() - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    assert not bad.any(), (
        f"edgeconv planted {variant} C={c}: {int(bad.sum())} outputs beyond atol {ATOL} / "
        f"rtol {RTOL} of the float64 twin, max abs err {float(err.max()):.3e}")
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


def edgeconv_split_model(x, idx, W1, Wd1, ab1, W2=None, Wd2=None, ab2=None, n_convs=2):
    """A plain model of kernel B2's order of operations (not on any forward
    path; `csrc/edgeconv.cu` and this function change together).

    conv1 as split_conv1; the gate per edge; conv2 accumulated one conv1
    channel at a time into all its outputs; the mean over K as a sum in edge
    order times 1/K.  An index outside [0, N) makes its point's output NaN.
    Same arguments and result as edgeconv_infer_plain.
    """
    B, N, K = idx.shape
    bad = ((idx < 0) | (idx >= N)).any(-1)
    idx = idx.clamp(0, N - 1)
    p, d = split_conv1(x, idx, W1, Wd1)
    h = _kernel_gate(p, d, ab1)
    if n_convs == 2:
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
    return out


def knn_queue_insertions(x, k, row_step=1):
    """Mean insertions per row of kernel B1's warp queue on x [B, N, D],
    over rows 0, row_step, 2 row_step, ... of each cloud.

    The queue takes the columns in index order, so after column c it holds
    the k best of columns 0..c: c goes in iff fewer than k earlier columns
    score at least as high (the earlier one wins a tie), and a NaN score
    never does.  This is the selection's data-dependent work.
    """
    s = knn_scores(x)[:, ::row_step]  # [B, R, N]
    n = s.shape[-1]
    earlier = torch.ones(n, n, dtype=torch.bool, device=s.device).tril(-1)  # [c, j]: j < c
    total = 0
    for sb in s:
        ahead = ((sb[:, None, :] >= sb[:, :, None]) & earlier).sum(-1)  # [R, c]
        total += int(((ahead < k) & ~torch.isnan(sb)).sum())
    return total / (s.shape[0] * s.shape[1])


def grad_array(p):
    """p's gradient as a float64 numpy array, zeros where the loss does not
    reach p (a VNMaxPool's direction map: its argmax has no gradient, where
    JAX's is zero)."""
    return (torch.zeros_like(p) if p.grad is None else p.grad).detach().cpu().double().numpy()


def float64_train_step(system, batch, graphs, device="cpu"):
    """One training step of a float64 copy of `system` (on `device`, in
    training mode, on the kNN graphs `graphs`, without rotation or
    dropout): its logs {"total_loss", "loss_metric", "loss_hyp"}, its
    gradients by parameter name and its new state_dict, as numpy.  The
    triplets are what the loss's sampler gives."""
    from .models import decode_vector_for_batch

    sys64 = copy.deepcopy(system)
    sys64.optimizer.zero_grad(set_to_none=True)
    net = sys64.net.to(device).double().train()
    if getattr(net.nn_feat, "compute_dtype", None) is not None:
        net.nn_feat.compute_dtype = None  # a bf16 backbone's step, in float64 throughout
    for st in sys64.optimizer.state.values():
        st.update({k: v.to(device).double() for k, v in st.items() if torch.is_tensor(v)})
    pts = torch.as_tensor(batch["points"]).to(device).double()
    dv = torch.as_tensor(decode_vector_for_batch(system.cfg, batch)).to(device).double()
    _, x_p = net(pts, dv, idx_override=[g.to(device) for g in graphs])
    labels = torch.as_tensor(batch["labels"]).long().to(device)
    losses, _ = sys64._losses_and_metrics(torch.Generator(device=device), x_p, labels)
    total = losses["loss_metric"] + losses["loss_hyp"]
    total.backward()
    logs = {"total_loss": float(total.detach()),
            **{k: float(v.detach()) for k, v in losses.items()}}
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


NEAR_TIE = 1e-3  # |sim(a,p) - sim(a,n)| below which two fp32 'easy' masks may differ
ORDERS = 4  # point orders besides the given one in which the CPU's fp32 step is run
ORDERS_FLOAT64 = 2  # of which the CPU's float64 step is also run in the first ones
FLOAT64_WITNESS = 1e-8  # card vs CPU float64 step: gradients / leaf's largest entry, logs rel.
FACTOR = 4.0  # the card at most FACTOR times as far from float64 as the CPU's farthest fp32 step
GRAD_FLOOR = 1e-6  # a leaf's gradient scale: at least this share of the net's largest entry
UPDATE_ATOL, UPDATE_RTOL = 1e-6, 1e-5  # the card's optimizer step against the CPU's on its gradients


def check_train_step_card_vs_cpu(system, batch, seed=0):
    """One train_step of `system` (on the card; any backbone) against the
    same step of its copy on the CPU, and both against the CPU copy's step
    in float64.

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
        logs = system.grads_and_logs(batch, torch.Generator(device=system.device))
        ref_logs, ref_grads, ref_sd = float64_train_step(cpu, batch, graphs)
        card64_logs, card64_grads, _ = float64_train_step(before, batch, graphs, system.device)
        vn_dgcnn.knn = given_graphs(graphs)
        cpu_logs = cpu.grads_and_logs(batch, torch.Generator())
        perm_gen = torch.Generator().manual_seed(seed + 1)
        B, N = torch.as_tensor(batch["labels"]).shape
        for _ in range(ORDERS):
            perm = torch.stack([torch.randperm(N, generator=perm_gen) for _ in range(B)])
            p_batch, p_graphs, state["trip"] = permute_step_inputs(batch, graphs, trip, perm)
            vn_dgcnn.knn = given_graphs(p_graphs)
            other = HypHCSystem(cfg, device="cpu")
            other.net.load_state_dict(initial)
            if len(reordered) < ORDERS_FLOAT64:  # float64's own noise
                reordered64.append(float64_train_step(other, p_batch, p_graphs)[:2])
            other_logs = other.grads_and_logs(p_batch, torch.Generator())
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
