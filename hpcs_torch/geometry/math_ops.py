"""Clamped inverse-hyperbolic functions with boundary-stable gradients.

Each forward clamps its input and each backward differentiates at the
clamped point, so embeddings pinned at the Poincare-ball boundary keep a
gradient (plain autograd through a clamp would give zero there).
The decode's norm (`l2_normalize_rn`) rounds its sum of squares and its
square root exactly, so the card and the CPU give the same bits; the losses
take the plain `l2_normalize`.
"""
import torch

ARTANH_EPS = 1e-5
ARCOSH_EPS = 1e-7
TANH_CLAMP = 15.0


class Artanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        xc = torch.clamp(x, -1.0 + ARTANH_EPS, 1.0 - ARTANH_EPS)
        ctx.save_for_backward(xc)
        return 0.5 * (torch.log1p(xc) - torch.log1p(-xc))

    @staticmethod
    def backward(ctx, grad):
        (xc,) = ctx.saved_tensors
        return grad / (1.0 - xc ** 2)


class Arcosh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        xc = torch.clamp(x, min=1.0 + ARCOSH_EPS)
        ctx.save_for_backward(xc)
        return torch.log(torch.clamp(xc + torch.sqrt(xc ** 2 - 1.0), min=1e-15))

    @staticmethod
    def backward(ctx, grad):
        (xc,) = ctx.saved_tensors
        return grad / torch.sqrt(xc ** 2 - 1.0)


class Arsinh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.log(torch.clamp(x + torch.sqrt(1.0 + x ** 2), min=1e-15))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad / torch.sqrt(1.0 + x ** 2)


def artanh(x):
    return Artanh.apply(x)


def arcosh(x):
    return Arcosh.apply(x)


def arsinh(x):
    return Arsinh.apply(x)


def tanh(x):
    """tanh with a +-15 input clamp."""
    return torch.tanh(torch.clamp(x, -TANH_CLAMP, TANH_CLAMP))


class _FMA(torch.autograd.Function):
    """float32 a * b + c, rounded once; the gradient is that of a * b + c."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.c_shape = c.shape
        p = a.double() * b.double()  # exact
        c = c.double()
        s = c + p
        bb = s - c
        err = (c - (s - bb)) + (p - bb)  # TwoSum: s + err == c + p exactly
        even = (s.view(torch.int64) & 1) == 0
        # toward err's side: a nonzero err of fp32 operands is a multiple of
        # 2^-298, so err * 1e308 lies beyond |s| < 1e78 on err's side; where
        # err == 0 (the branch not taken) it is 0, not err * inf's NaN
        s = torch.where((err != 0) & even, torch.nextafter(s, err * 1e308), s)
        return s.float()  # rounded to odd in float64, then to nearest in float32

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        return ((grad * b).sum_to_size(a.shape), (grad * a).sum_to_size(b.shape),
                grad.sum_to_size(ctx.c_shape))


def fma(a, b, c):
    """a * b + c rounded once, as a fused multiply-add does (broadcasting).

    For float32 the sum is made exactly in float64 (a * b is exact there,
    TwoSum gives the rest), rounded to odd and then to float32, which is
    the one correctly rounded fp32 result.  Other types round twice.
    """
    if torch.result_type(a, c) != torch.float32:
        return a * b + c
    return _FMA.apply(a, b, c)


def sum_of_squares(x, keepdim=False):
    """Sum of x^2 over the last axis as fp32 FMAs in dimension order.

    It is how XLA's fused CPU code sums a row of 32 (hpcs_tpu's norms and
    distances at the flagship's ball width), so there the port's distance
    matrices equal the JAX package's bit for bit.
    """
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for f in range(x.shape[-1]):
        acc = fma(x[..., f], x[..., f], acc)
    return acc[..., None] if keepdim else acc


def sqrt_rn(x):
    """The correctly rounded square root.  For float32 it is taken in
    float64: PyTorch's float32 sqrt on the card is not correctly rounded
    (it differs from the CPU's in ~0.7 % of values)."""
    if x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def l2_normalize(x, dim=-1, eps=1e-12):
    """x / max(|x|, eps) along `dim`."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def l2_normalize_rn(x, eps=1e-12):
    """The decode's l2_normalize over the last axis: |x| from
    `sum_of_squares` and `sqrt_rn`, so its distances are the same bits on
    the card and the CPU."""
    return x / torch.clamp(sqrt_rn(sum_of_squares(x, keepdim=True)), min=eps)
