"""Riemannian Adam on the Poincare ball, and the plateau LR schedule.

Every parameter is a set of ball points along its `ball_dim` axis: the
Euclidean gradient (plus weight_decay times the point) becomes the
Riemannian one (/ lambda^2), the second moment takes the Riemannian inner
product, the step is project(expmap(-step_size m / (sqrt(v) + eps), p)), and
the first moment is parallel-transported to the new point.  A parameter
outside the ball (a BatchNorm weight of ones has norm sqrt(C) > 1) sees
lambda at its MIN_NORM floor and is projected in by its first step.

Two forms compute that update.  `RiemannianAdam`, the JAX package's
`riemannian_adam`, runs it parameter by parameter.  `FusedRiemannianAdam`,
its `riemannian_adam_fused` and what HypHCSystem trains with, packs the
rows of every parameter whose ball axis has the same width into one
[rows, D] tensor and runs the update once per width.  Every operation of the
update is row-local, and both forms reduce each row over its own D
contiguous entries, so on the CPU the two give the same bits.  (The JAX
package pads the ball axis to 128 lanes for its TPU; zeros there change no
norm or dot product, so its numbers are the same up to the order of the
sums.)

The step count is shared: every parameter is updated every step, one
without a gradient as if its gradient were zero.  The JAX package's state
tuples (`RAdamState`, `FusedRAdamState`) have no class here: both forms keep
torch's `optimizer.state`, per parameter "step", "exp_avg" (the parameter's
shape) and "exp_avg_sq" (its shape with the ball axis of size 1), and
"max_exp_avg_sq" (as exp_avg_sq) with amsgrad.  The packs live only inside
`step`, so `state_dict`, `load_state_dict` and whatever assigns
`optimizer.state` see the same state in either form.
"""
from typing import NamedTuple

import torch

from ..geometry import egrad2rgrad, expmap, inner, project, ptransp

BETAS = (0.9, 0.999)
EPS = 1e-8


def _rows(t, dim):
    """t with its ball axis `dim` last, as [rows, D] (a view where one can be)."""
    t = t.movedim(dim, -1)
    return t.reshape(-1, t.shape[-1])


def _write(t, dim, rows):
    """Copy rows [rows, D] into t, whose ball axis is `dim`."""
    dest = t.movedim(dim, -1)
    dest.copy_(rows.view(dest.shape))


def _init_state(state, p, dim, amsgrad=False):
    """Zero moments for p on its first step; then count the step."""
    if not state:
        state["step"] = 0
        state["exp_avg"] = torch.zeros_like(p)
        state["exp_avg_sq"] = torch.zeros_like(p.narrow(dim, 0, 1))
        if amsgrad:
            state["max_exp_avg_sq"] = torch.zeros_like(state["exp_avg_sq"])
    state["step"] += 1
    return state


def _step_size(lr, count):
    """lr (a float, or a callable of the step count) with Adam's bias
    corrections at step `count` (1 on the first step)."""
    b1, b2 = BETAS
    lr = lr(count) if callable(lr) else lr
    return lr * (1 - b2 ** count) ** 0.5 / (1 - b1 ** count)


def _update(point, grad, m, v, step_size, weight_decay, vmax=None):
    """The update of ball points point [R, D] (contiguous rows) with
    gradients grad [R, D] and moments m [R, D], v [R, 1] (vmax [R, 1] with
    amsgrad).  Returns (new point, m transported to it, v, vmax)."""
    b1, b2 = BETAS
    if weight_decay:
        grad = grad + weight_decay * point
    rgrad = egrad2rgrad(point, grad)
    m = b1 * m + (1 - b1) * rgrad
    v = b2 * v + (1 - b2) * inner(point, rgrad)
    if vmax is not None:
        vmax = torch.maximum(vmax, v)
    denom = torch.sqrt(v if vmax is None else vmax) + EPS
    new_point = project(expmap(-step_size * (m / denom), point))
    return new_point, ptransp(point, new_point, m), v, vmax


class RiemannianAdam(torch.optim.Optimizer):
    """The update parameter by parameter: the plain form that
    `FusedRiemannianAdam` is held against.

    params: tensors, or groups {"params": [...], "ball_dim": axis} (the
    axis that holds the ball's coordinates; default the last).  lr: a float
    or a callable of the step count (1 on the first step).  weight_decay
    adds weight_decay times the point to the gradient; amsgrad divides by
    the square root of the largest second moment seen.
    """

    def __init__(self, params, lr=1e-3, weight_decay=0.0, amsgrad=False):
        super().__init__(params, dict(lr=lr, ball_dim=-1, weight_decay=weight_decay,
                                      amsgrad=amsgrad))

    def __setstate__(self, state):
        super().__setstate__(state)
        for group in self.param_groups:  # a state_dict saved before these options
            group.setdefault("weight_decay", 0.0)
            group.setdefault("amsgrad", False)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RiemannianAdam takes no closure")
        for group in self.param_groups:
            dim, amsgrad = group["ball_dim"], group["amsgrad"]
            for p in group["params"]:
                state = _init_state(self.state[p], p, dim, amsgrad)
                point = _rows(p, dim).contiguous()
                grad = torch.zeros_like(point) if p.grad is None else _rows(p.grad, dim)
                new_point, m, v, vmax = _update(
                    point, grad.contiguous(), _rows(state["exp_avg"], dim).contiguous(),
                    _rows(state["exp_avg_sq"], dim).contiguous(),
                    _step_size(group["lr"], state["step"]), group["weight_decay"],
                    _rows(state["max_exp_avg_sq"], dim).contiguous() if amsgrad else None)
                _write(p, dim, new_point)
                _write(state["exp_avg"], dim, m)
                _write(state["exp_avg_sq"], dim, v)
                if amsgrad:
                    _write(state["max_exp_avg_sq"], dim, vmax)


class FusedRiemannianAdam(torch.optim.Optimizer):
    """The update once per pack: the rows of every parameter whose ball axis
    has width D (and whose step size and weight decay are the same) are
    concatenated into [rows, D], updated, and copied back.

    params, lr and weight_decay as `RiemannianAdam`'s (no amsgrad, as in
    the JAX package's packed form).  The state between steps is
    `RiemannianAdam`'s, entry for entry.
    """

    def __init__(self, params, lr=1e-3, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, ball_dim=-1, weight_decay=weight_decay))

    def __setstate__(self, state):
        super().__setstate__(state)
        for group in self.param_groups:  # a state_dict saved before weight_decay
            group.setdefault("weight_decay", 0.0)

    def _packs(self):
        """Count this step on every parameter and group them: {(D, dtype,
        device, step size, weight decay): [(p, ball_dim, state), ...]}."""
        packs = {}
        for group in self.param_groups:
            dim = group["ball_dim"]
            for p in group["params"]:
                state = _init_state(self.state[p], p, dim)
                key = (p.shape[dim], p.dtype, p.device, _step_size(group["lr"], state["step"]),
                       group["weight_decay"])
                packs.setdefault(key, []).append((p, dim, state))
        return packs

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FusedRiemannianAdam takes no closure")
        for (D, _, _, step_size, weight_decay), members in self._packs().items():
            points = [_rows(p, dim) for p, dim, _ in members]
            grad = torch.cat([torch.zeros_like(x) if p.grad is None else _rows(p.grad, dim)
                              for x, (p, dim, _) in zip(points, members)])
            new_point, m, v, _ = _update(
                torch.cat(points), grad, torch.cat([_rows(s["exp_avg"], d) for _, d, s in members]),
                torch.cat([_rows(s["exp_avg_sq"], d) for _, d, s in members]),
                step_size, weight_decay)
            sizes = [x.shape[0] for x in points]
            dests, srcs = [], []
            for packed, key in ((new_point, None), (m, "exp_avg"), (v, "exp_avg_sq")):
                for (p, dim, state), rows in zip(members, packed.split(sizes)):
                    dest = (p if key is None else state[key]).movedim(dim, -1)
                    dests.append(dest)
                    srcs.append(rows.view(dest.shape))
            torch._foreach_copy_(dests, srcs)


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
