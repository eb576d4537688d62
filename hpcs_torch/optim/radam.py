"""Riemannian Adam on the Poincare ball, and the plateau LR schedule.

Every parameter is a set of ball points along its `ball_dim` axis: the
Euclidean gradient becomes the Riemannian one (/ lambda^2), the second
moment takes the Riemannian inner product, the step is
project(expmap(-step_size m / (sqrt(v) + eps), p)), and the first moment is
parallel-transported to the new point.  A parameter outside the ball (a
BatchNorm weight of ones has norm sqrt(C) > 1) sees lambda at its MIN_NORM
floor and is projected in by its first step.

The update runs parameter by parameter.  It gives the numbers of the JAX
package's packed-bucket form: zero-padding the ball axis, which the packing
does, changes no norm or dot product.  The step count is shared: every
parameter is updated every step, one without a gradient as if its gradient
were zero.
"""
from typing import NamedTuple

import torch

from ..geometry import egrad2rgrad, expmap, inner, project, ptransp

BETAS = (0.9, 0.999)
EPS = 1e-8


class RiemannianAdam(torch.optim.Optimizer):
    """params: tensors, or groups {"params": [...], "ball_dim": axis} (the
    axis that holds the ball's coordinates; default the last).

    State per parameter: "step", "exp_avg" (the parameter's shape) and
    "exp_avg_sq" (its shape with the ball axis of size 1).
    """

    def __init__(self, params, lr=1e-3):
        super().__init__(params, dict(lr=lr, ball_dim=-1))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RiemannianAdam takes no closure")
        b1, b2 = BETAS
        for group in self.param_groups:
            dim = group["ball_dim"]
            for p in group["params"]:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p.narrow(dim, 0, 1))
                state["step"] += 1
                count = state["step"]
                step_size = group["lr"] * (1 - b2 ** count) ** 0.5 / (1 - b1 ** count)

                point = p.movedim(dim, -1)
                grad = torch.zeros_like(point) if p.grad is None else p.grad.movedim(dim, -1)
                rgrad = egrad2rgrad(point, grad)
                m = b1 * state["exp_avg"].movedim(dim, -1) + (1 - b1) * rgrad
                v = b2 * state["exp_avg_sq"].movedim(dim, -1) + (1 - b2) * inner(point, rgrad)
                new_point = project(expmap(-step_size * (m / (torch.sqrt(v) + EPS)), point))
                state["exp_avg"].movedim(dim, -1).copy_(ptransp(point, new_point, m))
                state["exp_avg_sq"].movedim(dim, -1).copy_(v)
                point.copy_(new_point)


class PlateauState(NamedTuple):
    """ReduceLROnPlateau bookkeeping, once per epoch: factor 0.5, patience 4,
    min_lr 1e-6 on the validation loss."""

    lr: float
    best: float
    num_bad: int


def plateau_init(lr: float) -> PlateauState:
    return PlateauState(lr=lr, best=float("inf"), num_bad=0)


def plateau_update(state: PlateauState, metric: float, factor=0.5, patience=4,
                   min_lr=1e-6, threshold=1e-4) -> PlateauState:
    """torch's ReduceLROnPlateau in mode 'min' with the relative threshold:
    an epoch improves only when metric < best (1 - threshold)."""
    if metric < state.best * (1.0 - threshold):
        return PlateauState(lr=state.lr, best=metric, num_bad=0)
    num_bad = state.num_bad + 1
    if num_bad > patience:
        return PlateauState(lr=max(state.lr * factor, min_lr), best=state.best, num_bad=0)
    return PlateauState(lr=state.lr, best=state.best, num_bad=num_bad)
