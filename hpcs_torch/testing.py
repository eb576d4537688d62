"""Checks of the port's kernels against their plain versions.

Used by chip_smoke.py and the tests; nothing on the forward path imports
this module.
"""
import numpy as np
import torch

from .ops.edgeconv import _vn_llr_folded, edgeconv_infer_plain, graph_feature_vn
from .ops.vn_math import channel_mix

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


def check_edgeconv(got, want, x, idx, weights, n_convs):
    """Hold an EdgeConv stage's output `got` against the plain twin's `want`.

    weights = [W1, Wd1, ab1, W2, Wd2, ab2].  Outputs whose pre-BatchNorm
    norms |p| are all >= 1e-4 (in float64) must agree within atol 1e-5 /
    rtol 1e-4.  The others are ill-conditioned (see min_prenorm): their
    error may be at most 1e-5 + eps |b| / |p|, what a relative error of one
    fp32 ulp (eps = 2^-23) in p becomes through the folded BatchNorm's
    b / |p|, b the largest shift of the stage.  Raises AssertionError.
    Returns a dict: the ill-conditioned count, the largest error of the
    other outputs and of the ill-conditioned ones, and the largest share of
    its limit that an ill-conditioned error takes.
    """
    assert torch.isfinite(got).all(), "edgeconv: non-finite output"
    w64 = [None if t is None else t.double() for t in weights]
    cond = min_prenorm(x.double(), idx, *w64, n_convs=n_convs)
    cond = cond[..., None].expand_as(got)
    shifts = [w64[2][1]] + ([w64[5][1]] if n_convs == 2 else [])
    shift = max(float(s.abs().max()) for s in shifts)
    err = (got - want).abs().double()
    ill = cond < ILL_CONDITIONED
    bad = (err > ATOL + RTOL * want.abs()) & ~ill
    assert not bad.any(), (
        f"edgeconv C={x.shape[2]}: {int(bad.sum())} outputs beyond atol {ATOL} / rtol "
        f"{RTOL}, max abs err {float(err[~ill].max()):.3e}")
    share = err[ill] / (ATOL + torch.finfo(torch.float32).eps * shift / cond[ill])
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
