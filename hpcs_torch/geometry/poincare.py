"""Poincare-ball (curvature 1) primitives used by the embedder.

The manifold coordinates live on the last axis; every function broadcasts
over the leading axes.  Denominators are floored at MIN_NORM.
"""
import torch

from .math_ops import artanh, sqrt_rn, sum_of_squares, tanh

MIN_NORM = 1e-15
BALL_EPS_F32 = 4e-3
BALL_EPS_F64 = 1e-5


def _sqnorm(x, keepdim=True):
    return torch.sum(x * x, dim=-1, keepdim=keepdim)


def _norm(x, keepdim=True):
    return torch.sqrt(torch.clamp(_sqnorm(x, keepdim), min=MIN_NORM * MIN_NORM))


def expmap0(u):
    """Exponential map at the origin: tanh(|u|) u / |u|."""
    u_norm = _norm(u)
    return tanh(u_norm) * u / u_norm


def logmap0(x):
    """Log map at the origin (inverse of expmap0)."""
    x_norm = _norm(x)
    return artanh(x_norm) * x / x_norm


def project(x, eps=None):
    """Clamp points to the open ball of radius 1 - eps (the decode's leaves;
    the norm from `sum_of_squares` and `sqrt_rn`)."""
    if eps is None:
        eps = BALL_EPS_F64 if x.dtype == torch.float64 else BALL_EPS_F32
    norm = sqrt_rn(torch.clamp(sum_of_squares(x, keepdim=True), min=MIN_NORM * MIN_NORM))
    maxnorm = 1.0 - eps
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)
