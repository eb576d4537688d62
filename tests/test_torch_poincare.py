"""The port's Poincare-ball and LCA functions (the training loss's and the
optimizer's) against hpcs_tpu.geometry: values and gradients (jax.vjp
against autograd).

Inside the ball (radii 0, an exact zero row, to 0.9), on the sphere and
outside it, the two must agree within atol 1e-5 / rtol 1e-4: the same fp32
formulas, reduced in another order.  The LCA's gradients are held to
atol 1e-4 / rtol 1e-3 there: each is 2-4e-5 from float64 in either package
(five Mobius additions and a reflection).  Near the edge (radii 0.99 and 0.997)
1 - |x|^2 cancels and the LCA's Mobius additions amplify any rounding by up
to 1 / (1 - |x|^2)^2 (~3e4), so there both are held to the same function in
float64 instead: the port's error may be at most 4 times JAX's, plus 1e-6
and 1e-5 of the largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcs_tpu import geometry as G
from hpcs_tpu.geometry.math_ops import l2_normalize as j_l2_normalize
from hpcs_torch import geometry as P
from hpcs_torch.decode import decode_leaves
from hpcs_torch.geometry.math_ops import l2_normalize, l2_normalize_rn
from hpcs_torch.loss import normalize_to_radius

TOL = dict(atol=1e-5, rtol=1e-4)
TOL_LCA = dict(atol=1e-4, rtol=1e-3)
LCA = ("hyp_lca", "hyp_lca_depth", "hyp_lca_mat")
INSIDE = (0.0, 1e-4, 0.1, 0.5, 0.9)
EDGE = (0.99, 0.997)
OUTSIDE = (1.0, 1.5)


def _points(seed, radii, n=60, d=5):
    """n rows of dimension d at the given radii in turn.  Rows of radius 1
    are signed basis vectors, whose |x|^2 = 1 is exact (1 - |x|^2 is pure
    rounding on any other point of the sphere)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    r = np.resize(np.array(radii, np.float64), n)
    x = x / np.linalg.norm(x, axis=-1, keepdims=True) * r[:, None]
    on = np.flatnonzero(r == 1.0)
    x[on] = np.eye(d)[np.arange(len(on)) % d] * rng.choice([-1, 1], len(on))[:, None]
    return x.astype(np.float32)


def _torch_vg(fn, xs, dtype=torch.float32):
    ts = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in xs]
    y = fn(*ts)
    y.backward(torch.ones_like(y))
    return y.detach().double().numpy(), [t.grad.double().numpy() for t in ts]


def _jax_vg(fn, xs):
    def vg(*args):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(jnp.ones_like(y))

    y, gs = jax.jit(vg)(*map(jnp.asarray, xs))
    return np.asarray(y), [np.asarray(g) for g in gs]


def _check(fn_t, fn_j, *xs, tol=TOL, grad_tol=None, rows=slice(None)):
    """Values within `tol`, gradients (of the rows `rows`) within
    `grad_tol` (default `tol`) and finite everywhere."""
    y, gs = _torch_vg(fn_t, xs)
    yj, gjs = _jax_vg(fn_j, xs)
    np.testing.assert_allclose(y, yj, **tol)
    for g, gj in zip(gs, gjs):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g[rows], gj[rows], **(grad_tol or tol))


def _check_vs_float64(fn_t, fn_j, *xs):
    y, gs = _torch_vg(fn_t, xs)
    yj, gjs = _jax_vg(fn_j, xs)
    y64, g64s = _torch_vg(fn_t, xs, torch.float64)
    for got, jax_, ref in zip([y, *gs], [yj, *gjs], [y64, *g64s]):
        assert np.isfinite(got).all()
        assert (np.abs(got - ref).max()
                <= 4 * np.abs(jax_ - ref).max() + 1e-6 + 1e-5 * np.abs(ref).max())


UNARY = ["lambda_", "expmap0", "logmap0", "get_midpoint_o", "hyp_dist_o", "project"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_maps_match_jax(name):
    radii = INSIDE + EDGE + (OUTSIDE if name not in ("logmap0", "get_midpoint_o") else ())
    _check(getattr(P, name), getattr(G, name), _points(1, radii))


def test_hyp_dist_o_has_zero_gradient_at_the_origin():
    t = torch.zeros(3, 4, requires_grad=True)
    P.hyp_dist_o(t).sum().backward()
    assert torch.equal(t.grad, torch.zeros(3, 4))
    _check(P.hyp_dist_o, G.hyp_dist_o, np.zeros((3, 4), np.float32))


def _pair(name):
    if name == "expmap":
        return (lambda u, p: P.expmap(u, p)), (lambda u, p: G.expmap(u, p))
    if name == "hyp_lca_depth":
        return ((lambda a, b: P.hyp_lca(a, b, return_coord=False)),
                (lambda a, b: G.hyp_lca(a, b, return_coord=False)))
    if name == "mobius_mul":
        return (lambda x: P.mobius_mul(x, 0.3)), (lambda x: G.mobius_mul(x, 0.3))
    return getattr(P, name), getattr(G, name)


BINARY = ["mobius_add", "egrad2rgrad", "inner", "expmap", "hyp_distance", "hyp_lca",
          "hyp_lca_depth", "hyp_lca_midpoint", "euc_reflection", "gyro_midpoint"]


def _args(name, radii, seed=2):
    n_args = 3 if name in ("gyration", "ptransp") else 1 if name == "mobius_mul" else 2
    xs = [_points(seed + i, radii) for i in range(n_args)]
    if name == "expmap":
        xs[0] = 0.1 * xs[0]  # a tangent vector at a point of the ball
    if name in ("egrad2rgrad", "inner", "gyration", "ptransp"):
        xs[-1] = _points(seed + 9, (1.0, 0.3, 2.0))  # tangent vectors, any length
    return xs


@pytest.mark.parametrize("name", BINARY + ["gyration", "ptransp", "mobius_mul"])
def test_maps_match_jax_inside_the_ball(name):
    _check(*_pair(name), *_args(name, INSIDE), grad_tol=TOL_LCA if name in LCA else TOL)


@pytest.mark.parametrize("name", BINARY + ["gyration", "ptransp", "mobius_mul"])
def test_maps_near_the_edge_are_as_close_to_float64_as_jax(name):
    _check_vs_float64(*_pair(name), *_args(name, EDGE + INSIDE))


@pytest.mark.parametrize("name", ["hyp_distance_mat", "hyp_lca_mat"])
def test_pairwise_matrices_match_jax(name):
    """Gradients of distinct points only: on the diagonal of x against
    itself the distance is at its singular minimum, and the gradient there
    is whatever the rounding of x_i - x_i makes it."""
    x, y = _points(8, INSIDE, n=12), _points(9, INSIDE, n=9)
    grad_tol = TOL_LCA if name in LCA else TOL
    _check(lambda a, b: getattr(P, name)(a, b), lambda a, b: getattr(G, name)(a, b), x, y,
           grad_tol=grad_tol)
    np.testing.assert_allclose(getattr(P, name)(torch.from_numpy(x)).numpy(),
                               np.asarray(getattr(G, name)(jnp.asarray(x))), **TOL)


def test_hyp_lca_at_the_loss_radii():
    """Leaves on the sphere of the learnable radius (1e-3 at init, up to
    0.996, the projection's radius), 8 antipodal pairs included: the loss's
    depths.  An antipodal pair's depth is 0, the minimum of a cone: its
    gradient is any subgradient, fixed by rounding, so only its finiteness
    is held there.  (A leaf paired with itself is left out: its geodesic is
    a point, and in fp32 both packages' depths are rounding noise.)"""
    rng = np.random.default_rng(10)
    a = rng.standard_normal((96, 32)).astype(np.float32)
    b = rng.standard_normal((96, 32)).astype(np.float32)
    b[:8] = -a[:8]
    for r in (1e-3, 0.3, 0.9, 0.996):
        an = (a / np.linalg.norm(a, axis=-1, keepdims=True) * r).astype(np.float32)
        bn = (b / np.linalg.norm(b, axis=-1, keepdims=True) * r).astype(np.float32)
        if r <= 0.9:
            _check(*_pair("hyp_lca_depth"), an, bn, grad_tol=TOL_LCA, rows=slice(8, None))
        else:
            _check_vs_float64(*_pair("hyp_lca_depth"), an, bn)


@pytest.mark.parametrize("scale", [1e-3, 0.5, 1.0])
def test_decode_leaves_and_plain_forms_agree(scale):
    """The decode's exactly rounded leaves are the losses' plain
    project(normalize_to_radius(x, scale)) up to rounding."""
    x = torch.from_numpy(1.2 * _points(11, INSIDE + EDGE + OUTSIDE, d=32))
    s = torch.tensor(scale)
    torch.testing.assert_close(decode_leaves(x, s), P.project(normalize_to_radius(x, s)),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_plain_l2_normalize_matches_jax(dim):
    x = np.random.default_rng(12).standard_normal((6, 40, 7)).astype(np.float32)
    _check(lambda t: l2_normalize(t, dim=dim), lambda t: j_l2_normalize(t, axis=dim), x)


def test_plain_l2_normalize_of_a_zero_vector():
    """x / eps: zero, with the finite gradient 1 / eps where JAX's is NaN
    (the norm's derivative at 0)."""
    x = np.zeros((2, 5), np.float32)
    x[1] = np.arange(5)
    y, (g,) = _torch_vg(l2_normalize, [x])
    yj, (gj,) = _jax_vg(j_l2_normalize, [x])
    np.testing.assert_allclose(y, yj, **TOL)
    np.testing.assert_allclose(g[1], gj[1], **TOL)
    assert np.isnan(gj[0]).all() and (g[0] == np.float32(1e12)).all()


def test_l2_normalize_rn_and_plain_agree():
    """The decode's l2_normalize_rn (exactly rounded norm, last axis) and
    the plain l2_normalize differ by rounding only; both map 0 to 0."""
    x = np.random.default_rng(13).standard_normal((6, 40, 32)).astype(np.float32)
    x[0, 0] = 0.0
    t = torch.from_numpy(x)
    torch.testing.assert_close(l2_normalize_rn(t), l2_normalize(t), rtol=0, atol=1e-7)
    assert not l2_normalize_rn(t)[0, 0].any()
