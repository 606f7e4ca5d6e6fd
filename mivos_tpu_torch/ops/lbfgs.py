"""Bounded L-BFGS with a zoom line search, through autograd
(counterpart of mivos_tpu/ops/lbfgs.py).

The JAX package runs `optax.lbfgs(memory_size)` inside one jitted
while_loop. This is a port of that algorithm as optax 0.2.6 defines it:
`scale_by_lbfgs(memory_size, scale_init_precond=True)` (the two-loop
recursion, transform.py:1497-1755), `scale(-1)`, then
`scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one')` (the zoom line search with cubic and
quadratic interpolation and its fallback to a safe step,
linesearch.py:455-1400), wrapped in the JAX package's outer loop (best
iterate, the gtol exit, `stop_fn`, and the final-iterate check). It is
not `torch.optim.LBFGS`, which is a different algorithm.

Every quantity stays a tensor on x0's device. The loop runs on the host:
it reads one flag per L-BFGS iteration and one per line-search step, so
the early exits are exact; `info` counts those reads and the function
evaluations.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Callable, Optional

import torch

# scale_by_zoom_linesearch defaults (linesearch.py:1331-1345), as
# optax.lbfgs builds it.
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
STEPSIZE_PRECISION, INCREASE_FACTOR, TOL = 1e-5, 2.0, 0.0


class _Evaluator:
    """fun(x) -> (loss, aux) as value, aux and gradient, counted."""

    def __init__(self, fun: Callable):
        self.fun = fun
        self.evals = 0
        self.host_reads = 0

    def __call__(self, x: torch.Tensor):
        self.evals += 1
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, aux = self.fun(x)
            grad, = torch.autograd.grad(loss, x)
        return loss.detach(), aux, grad

    def value(self, x: torch.Tensor) -> torch.Tensor:
        self.evals += 1
        with torch.no_grad():
            return self.fun(x)[0]

    def read(self, *flags: torch.Tensor):
        """One device-to-host read of a few boolean flags."""
        self.host_reads += 1
        return torch.stack(flags).tolist()


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product accumulated in fp64, rounded to a's dtype: optax
    takes its inner products at the highest precision (tree_vdot), and
    these decide the curvature pairs and every line-search test."""
    return torch.dot(a.double(), b.double()).to(a.dtype)


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """linesearch.py `_compute_decrease_error`: Armijo's sufficient
    decrease, or Hager-Zhang's approximate one where the value has
    barely moved."""
    err = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta = value - value_init - APPROX_DEC_RTOL * value_init.abs()
    err = torch.minimum(torch.maximum(approx, delta), err)
    err = torch.maximum(err, torch.zeros_like(err))
    return torch.where(err.isnan(), torch.full_like(err, math.inf), err)


def _curvature_error(slope, slope_init):
    err = slope.abs() - CURV_RTOL * slope_init.abs()
    err = torch.maximum(err, torch.zeros_like(err))
    return torch.where(err.isnan(), torch.full_like(err, math.inf), err)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where there is none (linesearch.py:455-493)."""
    db, dc = b - a, c - a
    dbc = db * dc
    denom = dbc * dbc * (db - dc)
    e1 = fb - fa - fpa * db
    e2 = fc - fa - fpa * dc
    big_a = (dc * dc * e1 + -(db * db) * e2) / denom
    big_b = (-(dc * dc * dc) * e1 + db * db * db * e2) / denom
    radical = big_b * big_b - 3.0 * big_a * fpa
    return a + (-big_b + torch.sqrt(radical)) / (3.0 * big_a)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a (linesearch.py:496-521)."""
    db = b - a
    big_b = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * big_b)


def zoom_linesearch(ev: _Evaluator, params, updates, value, grad):
    """optax's zoom line search along `updates` from `params` (value and
    gradient there given). Returns the stepsize, a 0-d tensor."""
    zero = torch.zeros((), dtype=value.dtype, device=value.device)
    slope_init = _vdot(updates, grad)
    value_init = value
    stepsize, slope = zero, slope_init
    safe_stepsize, safe_value = zero, value
    interval_found = False
    count = 0
    while True:
        if not interval_found:   # _search_interval
            prev_stepsize, prev_value, prev_slope = stepsize, value, slope
            new = (torch.ones_like(zero) if count == 0
                   else INCREASE_FACTOR * prev_stepsize)
            value, _, grad_new = ev(params + new * updates)
            slope = _vdot(grad_new, updates)
            decrease_error = _decrease_error(new, value, slope, value_init,
                                             slope_init)
            error = torch.maximum(decrease_error,
                                  _curvature_error(slope, slope_init))
            safe = decrease_error <= TOL
            safe_stepsize = torch.where(safe, new, safe_stepsize)
            safe_value = torch.where(safe, value, safe_value)
            set_high = (decrease_error > 0.0) | (
                (value >= prev_value) & (count > 0))
            set_low = (slope >= 0.0) & ~set_high
            low = torch.where(set_low, new, prev_stepsize)
            value_low = torch.where(set_low, value, prev_value)
            slope_low = torch.where(set_low, slope, prev_slope)
            high = torch.where(set_low, prev_stepsize, new)
            value_high = torch.where(set_low, prev_value, value)
            slope_high = torch.where(set_low, prev_slope, slope)
            cubic_ref, value_cubic_ref = low, value_low
            found = set_high | set_low | (error <= TOL)
            done = error <= TOL
            failed = ~done & (count + 1 >= MAX_LINESEARCH_STEPS)
            stepsize = new
        else:                    # _zoom_into_interval
            delta = (high - low).abs()
            left, right = torch.minimum(high, low), torch.maximum(high, low)
            cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                              cubic_ref, value_cubic_ref)
            use_cubic = (cubic > left + 0.2 * delta) & (
                cubic < right - 0.2 * delta)
            quad = _quadmin(low, value_low, slope_low, high, value_high)
            use_quad = ~use_cubic & (quad > left + 0.1 * delta) & (
                quad < right - 0.1 * delta)
            use_bisection = ~use_cubic & ~use_quad
            middle = torch.where(use_cubic, cubic, cubic_ref)
            middle = torch.where(use_quad, quad, middle)
            middle = torch.where(use_bisection, (low + high) / 2.0, middle)
            value, _, grad_new = ev(params + middle * updates)
            slope = _vdot(grad_new, updates)
            decrease_error = _decrease_error(middle, value, slope, value_init,
                                             slope_init)
            error = torch.maximum(decrease_error,
                                  _curvature_error(slope, slope_init))
            update_safe = (decrease_error <= TOL) & (value < safe_value)
            safe_stepsize = torch.where(update_safe, middle, safe_stepsize)
            safe_value = torch.where(update_safe, value, safe_value)
            done = error <= TOL
            set_high_to_middle = (decrease_error > 0.0) | (value >= value_low)
            set_high_to_low = ((slope * (high - low) >= 0.0)
                               & ~set_high_to_middle)
            set_low_to_middle = ~set_high_to_middle
            high1 = torch.where(set_high_to_middle, middle, high)
            value_high1 = torch.where(set_high_to_middle, value, value_high)
            slope_high1 = torch.where(set_high_to_middle, slope, slope_high)
            moved = set_high_to_middle | set_high_to_low
            cubic_ref = torch.where(moved, high, low)
            value_cubic_ref = torch.where(moved, value_high, value_low)
            high = torch.where(set_high_to_low, low, high1)
            value_high = torch.where(set_high_to_low, value_low, value_high1)
            slope_high = torch.where(set_high_to_low, slope_low, slope_high1)
            low = torch.where(set_low_to_middle, middle, low)
            value_low = torch.where(set_low_to_middle, value, value_low)
            slope_low = torch.where(set_low_to_middle, slope, slope_low)
            too_small = (delta <= STEPSIZE_PRECISION) & (safe_stepsize > 0.0)
            failed = ~done & (too_small | (count + 1 >= MAX_LINESEARCH_STEPS))
            found = torch.ones_like(done)
            stepsize = middle
        count += 1
        # _try_safe_step: a failed search falls back to the best stepsize
        # with sufficient decrease, or to 0 outside the domain.
        fallback = failed & ((safe_stepsize > 0.0) | decrease_error.isinf())
        stepsize = torch.where(fallback, safe_stepsize, stepsize)
        stop, interval_found = ev.read(done | failed, found)
        if stop:
            return stepsize


def lbfgs_minimize(
    fun: Callable,                       # x -> (loss, aux)
    x0: torch.Tensor,
    maxiter: int = 20,
    memory_size: int = 20,
    gtol: float = 1e-8,
    stop_fn: Optional[Callable] = None,  # (aux, stop_state) -> (stop, state)
    stop_state0=None,
):
    """Minimize fun over a flat fp32 vector x. Returns (best_x, info).

    `fun` returns (scalar loss, aux) and must be differentiable in x;
    `stop_fn` turns the aux of an iterate into a domain-specific early
    exit (the f-BRS clicks-satisfied / IoU-converged rules). info holds
    the best `loss`, `iters` (L-BFGS iterations), `evals` (calls of
    `fun`) and `host_reads` (device-to-host flag reads).
    """
    ev = _Evaluator(fun)
    x = x0.detach()
    memory = deque(maxlen=memory_size)   # (dw, du, rho), oldest first
    prev_x = prev_g = None
    stop_state = stop_state0
    best_x = best_loss = None
    it = 0
    while it < maxiter:
        loss, aux, grad = ev(x)
        if best_loss is None:
            best_x, best_loss = x, loss
        else:
            better = loss < best_loss
            best_x = torch.where(better, x, best_x)
            best_loss = torch.where(better, loss, best_loss)
        done = grad.abs().max() < gtol
        if stop_fn is not None:
            stop, stop_state = stop_fn(aux, stop_state)
            done = done | stop

        # scale_by_lbfgs: record (dw, du) of the last step, then the
        # two-loop recursion from a scaled identity.
        if prev_x is None:
            scale = torch.clamp(1.0 / torch.sqrt((grad * grad).sum()), max=1.0)
        else:
            dw, du = x - prev_x, grad - prev_g
            curv = _vdot(du, dw)
            memory.append((dw, du, torch.where(curv == 0.0, torch.zeros_like(curv),
                                          1.0 / curv)))
            du_sq = (du * du).sum()
            scale = torch.where(du_sq > 0.0, curv / du_sq, torch.ones_like(curv))
        prev_x, prev_g = x, grad
        vec, alphas = grad, []
        for dw_i, du_i, rho_i in reversed(memory):
            alpha = rho_i * _vdot(dw_i, vec)
            vec = vec + (-alpha) * du_i
            alphas.append(alpha)
        vec = scale * vec
        for (dw_i, du_i, rho_i), alpha in zip(memory, reversed(alphas)):
            beta = rho_i * _vdot(du_i, vec)
            vec = vec + (alpha - beta) * dw_i
        updates = -vec

        stepsize = zoom_linesearch(ev, x, updates, loss, grad)
        x = x + stepsize * updates
        it += 1
        if ev.read(done)[0]:
            break
    # The final iterate may beat the best tracked one.
    final_loss = ev.value(x)
    if best_loss is None:   # maxiter 0
        best_x, best_loss = x, final_loss
    better = final_loss < best_loss
    best_x = torch.where(better, x, best_x)
    best_loss = torch.where(better, final_loss, best_loss)
    return best_x, {"loss": best_loss, "iters": it, "evals": ev.evals,
                    "host_reads": ev.host_reads}
