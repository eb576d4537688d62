"""Clamped inverse-hyperbolic functions with boundary-stable gradients.

Each forward clamps its input and each backward differentiates at the
clamped point, so embeddings pinned at the Poincare-ball boundary keep a
gradient (plain autograd through a clamp would give zero there).
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
