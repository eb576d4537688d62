"""Port geometry vs hpcs_tpu.geometry: values and gradients, atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpcs_tpu import geometry as G
from hpcs_torch.geometry import math_ops as M
from hpcs_torch.geometry import poincare as P

ATOL = 1e-6


def _value_and_grad_torch(fn, x):
    t = torch.tensor(x, requires_grad=True)
    y = fn(t)
    y.sum().backward()
    return y.detach().numpy(), t.grad.numpy()


def _value_and_grad_jax(fn, x):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.ones_like(y))[0])


def _check(fn_torch, fn_jax, x, rtol=1e-6):
    y_t, g_t = _value_and_grad_torch(fn_torch, x)
    y_j, g_j = _value_and_grad_jax(fn_jax, x)
    np.testing.assert_allclose(y_t, y_j, atol=ATOL, rtol=rtol)
    np.testing.assert_allclose(g_t, g_j, atol=ATOL, rtol=max(rtol, 1e-5))


# points inside, at and beyond each clamp
SCALARS = {
    "artanh": np.array([-1.5, -1.0, -0.99999, -0.5, 0.0, 0.3, 0.99, 0.999995, 1.0, 2.0], np.float32),
    "arcosh": np.array([0.0, 1.0, 1.0000001, 1.001, 1.5, 3.0, 50.0], np.float32),
    "arsinh": np.array([-30.0, -2.0, -0.1, 0.0, 0.5, 4.0, 100.0], np.float32),
    "tanh": np.array([-20.0, -15.5, -3.0, 0.0, 0.7, 14.0, 16.0], np.float32),
}


@pytest.mark.parametrize("name", sorted(SCALARS))
def test_scalar_functions_match_jax(name):
    _check(getattr(M, name), getattr(G, name), SCALARS[name])


def _ball_points():
    rng = np.random.default_rng(3)
    u = rng.standard_normal((64, 5)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    # radii inside the ball, next to the fp32 boundary eps, on it, outside it
    radii = np.array([0.0, 1e-3, 0.2, 0.9, 0.995, 0.996, 0.997, 0.99999, 1.0, 1.3],
                     np.float32)
    return (u[:len(radii)] * radii[:, None]).astype(np.float32)


@pytest.mark.parametrize("name", ["expmap0", "logmap0", "project"])
def test_ball_maps_match_jax(name):
    x = _ball_points()
    if name == "expmap0":
        x = x * 4.0  # tangent vectors, up to past the tanh saturation
    # next to the boundary artanh and its derivative amplify a last-ulp
    # difference of |x| by 1 / (1 - |x|^2), up to 5e4, so logmap0 is held to
    # rtol 1e-4
    _check(getattr(P, name), getattr(G, name), x, rtol=1e-4 if name == "logmap0" else 1e-6)


def test_expmap0_stays_in_ball_and_inverts():
    u = torch.from_numpy(np.random.default_rng(5).standard_normal((32, 8)).astype(np.float32))
    x = P.expmap0(u * 0.5)
    assert torch.all(torch.linalg.norm(x, dim=-1) < 1.0)
    torch.testing.assert_close(P.logmap0(x), u * 0.5, atol=1e-5, rtol=1e-4)
