"""Poincare-ball (curvature 1) primitives.

The manifold coordinates live on the last axis; every function broadcasts
over the leading axes.  Denominators are floored at MIN_NORM.  Everything
is differentiable with autograd.  The decode places its leaves with its
own exactly rounded norms (`hpcs_torch.decode.decode_leaves`).
"""
import torch

from .math_ops import arcosh, artanh, tanh

MIN_NORM = 1e-15
BALL_EPS_F32 = 4e-3
BALL_EPS_F64 = 1e-5


def _sqnorm(x, keepdim=True):
    return torch.sum(x * x, dim=-1, keepdim=keepdim)


def _dot(x, y):
    return torch.sum(x * y, dim=-1, keepdim=True)


def _norm(x, keepdim=True):
    return torch.sqrt(torch.clamp(_sqnorm(x, keepdim), min=MIN_NORM * MIN_NORM))


def lambda_(x):
    """Conformal factor lambda_x = 2 / (1 - |x|^2), the denominator floored
    at MIN_NORM (a point on or outside the sphere gets 2 / MIN_NORM)."""
    return 2.0 / torch.clamp(1.0 - _sqnorm(x), min=MIN_NORM)


def egrad2rgrad(p, dp):
    """Euclidean -> Riemannian gradient: divide by lambda(p)^2."""
    return dp / lambda_(p) ** 2


def inner(x, u, v=None):
    """Riemannian inner product of tangent vectors at x (keepdim on the last axis)."""
    if v is None:
        v = u
    return lambda_(x) ** 2 * _dot(u, v)


def gyration(u, v, w):
    """Gyration gyr[u, v]w (the Mobius addition's associativity correction)."""
    u2, v2 = _sqnorm(u), _sqnorm(v)
    uv, uw, vw = _dot(u, v), _dot(u, w), _dot(v, w)
    a = -uw * v2 + vw + 2 * uv * vw
    b = -vw * u2 - uw
    d = 1 + 2 * uv + u2 * v2
    return w + 2 * (a * u + b * v) / torch.clamp(d, min=MIN_NORM)


def ptransp(x, y, u):
    """Parallel transport of the tangent u from x to y."""
    return gyration(y, -x, u) * lambda_(x) / lambda_(y)


def mobius_add(x, y):
    """Mobius addition x (+) y."""
    x2, y2, xy = _sqnorm(x), _sqnorm(y), _dot(x, y)
    num = (1 + 2 * xy + y2) * x + (1 - x2) * y
    denom = 1 + 2 * xy + x2 * y2
    return num / torch.clamp(denom, min=MIN_NORM)


def expmap(u, p):
    """Exponential map of the tangent u at the point p."""
    u_norm = _norm(u)
    return mobius_add(p, tanh(lambda_(p) * u_norm / 2.0) * u / u_norm)


def expmap0(u):
    """Exponential map at the origin: tanh(|u|) u / |u|."""
    u_norm = _norm(u)
    return tanh(u_norm) * u / u_norm


def logmap0(x):
    """Log map at the origin (inverse of expmap0)."""
    x_norm = _norm(x)
    return artanh(x_norm) * x / x_norm


def ball_eps(dtype):
    """The margin inside the sphere that `project` keeps for `dtype`."""
    return BALL_EPS_F64 if dtype == torch.float64 else BALL_EPS_F32


def project(x, eps=None):
    """Clamp points to the open ball of radius 1 - eps."""
    norm = _norm(x)
    maxnorm = 1.0 - (ball_eps(x.dtype) if eps is None else eps)
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def mobius_mul(x, t):
    """Mobius scalar multiplication t (*) x."""
    normx = _norm(x)
    return tanh(t * artanh(normx)) * x / normx


def get_midpoint_o(x):
    """Hyperbolic midpoint between x and the origin."""
    return mobius_mul(x, 0.5)


def hyp_dist_o(x, keepdim=True):
    """Hyperbolic distance of x from the origin, 2 artanh(|x|).

    |x|^2 is floored at MIN_NORM^2 under the square root, so at an exactly
    zero x (the LCA of antipodal leaves) the gradient is 0, not NaN.
    """
    n = torch.sqrt(torch.clamp(_sqnorm(x, keepdim), min=MIN_NORM * MIN_NORM))
    return 2.0 * artanh(n)


def hyp_distance(x, y):
    """The similarity kernel exp(-acosh(d_xy)) of x and y (broadcasting),
    both projected into the ball first."""
    x, y = project(x), project(y)
    xy = torch.sum((x - y) ** 2, dim=-1)
    xx = 1.0 - torch.sum(x * x, dim=-1)
    yy = 1.0 - torch.sum(y * y, dim=-1)
    dxy = 1.0 + 2.0 * xy / torch.clamp(xx * yy, min=MIN_NORM)
    return torch.exp(-arcosh(dxy))


def hyp_distance_mat(x, y=None):
    """Dense [N, M] form of hyp_distance for x [N, F], y [M, F]."""
    if y is None:
        y = x
    x, y = project(x), project(y)
    x2 = torch.sum(x * x, dim=-1)
    y2 = torch.sum(y * y, dim=-1)
    xy = torch.clamp(x2[:, None] + y2[None, :] - 2.0 * x @ y.T, min=0.0)
    denom = torch.clamp((1.0 - x2)[:, None] * (1.0 - y2)[None, :], min=MIN_NORM)
    return torch.exp(-arcosh(1.0 + 2.0 * xy / denom))
