"""Hyperbolic least-common-ancestor (LCA) constructions on the Poincare ball.

`hyp_lca` projects the origin onto the geodesic between a and b, the HypHC
LCA that the training loss uses.  It is built by gyro-translation, not by
circle inversion (which diverges in fp32 when |a| is small): translate a to
the origin with x -> (-a) (+) x, where the geodesic becomes a diameter;
project the translated origin onto it (reflect, then take the hyperbolic
midpoint); translate back with a (+) . .

`hyp_lca_mat` is the midpoint-based pairwise matrix min(d_o(x), d_o(y),
d_o(midpoint(x, y))), in any dimension.
"""
import torch

from .poincare import MIN_NORM, get_midpoint_o, hyp_dist_o, mobius_add, mobius_mul, project


def euc_reflection(x, a):
    """Euclidean (= hyperbolic) reflection of x across the line through a and o."""
    xTa = torch.sum(x * a, dim=-1, keepdim=True)
    norm_a_sq = torch.clamp(torch.sum(a ** 2, dim=-1, keepdim=True), min=MIN_NORM)
    return 2 * (xTa * a / norm_a_sq) - x


def gyro_midpoint(x, y):
    """Hyperbolic midpoint of the geodesic segment [x, y]."""
    return mobius_add(x, mobius_mul(mobius_add(-x, y), 0.5))


def hyp_lca(a, b, return_coord=True):
    """Projection of the origin onto the geodesic between ball points a and b.

    With return_coord=False, its depth d(o, proj) [..., 1] instead, the
    quantity the HypHC loss consumes.  Broadcasts over leading axes.
    """
    c = mobius_add(-a, b)  # the geodesic's direction in the frame where a is o
    p = -a  # the origin in that frame
    proj = mobius_add(a, gyro_midpoint(p, euc_reflection(p, c)))
    if not return_coord:
        return hyp_dist_o(proj)
    return proj


def hyp_lca_midpoint(a, b):
    """Geodesic midpoint of [a, b] by the same frame change."""
    return mobius_add(a, get_midpoint_o(mobius_add(-a, b)))


def hyp_lca_mat(x, y=None):
    """Dense [N, M] matrix min(d_o(x_i), d_o(y_j), d_o(midpoint(x_i, y_j)))."""
    if y is None:
        y = x
    x, y = project(x), project(y)
    dox, doy = hyp_dist_o(x), hyp_dist_o(y)  # [N, 1], [M, 1]
    dom = hyp_dist_o(hyp_lca_midpoint(x[:, None, :], y[None, :, :]))[..., 0]
    return torch.minimum(torch.minimum(dox, doy.T), dom)
