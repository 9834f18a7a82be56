"""L-BFGS with a zoom linesearch in plain torch: the algorithm of optax
0.2.6's ``optax.lbfgs`` (``scale_by_lbfgs`` → ``scale(-1)`` →
``scale_by_zoom_linesearch``), which the JAX package's MLlib classifier
runs, written out over one flat float32 parameter vector.

``torch.optim.LBFGS(line_search_fn="strong_wolfe")`` is a different
algorithm (its own initial step, its own interpolation and stopping
rules) and does not follow the JAX trajectory; this module does,
formula for formula:

- the direction is the two-loop recursion over the last ``memory_size``
  parameter and gradient differences (Nocedal & Wright, Algorithm 7.4),
  with the identity scaled by ``s·y / y·y`` — on the first iteration by
  ``min(1, 1/‖g‖)`` (``scale_init_precond``);
- the step is the zoom linesearch (Algorithms 3.5 and 3.6) with optax's
  defaults: initial guess 1 (``initial_guess_strategy="one"``), growth
  factor 2, sufficient decrease ``slope_rtol=1e-4`` or Hager–Zhang's
  approximate decrease (``approx_dec_rtol=1e-6``), curvature
  ``curv_rtol=0.9``, cubic then quadratic interpolation then bisection,
  an interval threshold of ``stepsize_precision=1e-5``, at most 20 steps,
  and the safeguarded fallback to the best step with sufficient decrease;
- the value and gradient at the accepted step are kept and reused as the
  next iteration's (``optax.value_and_grad_from_state``).

Vectors stay on their device; the linesearch's scalars (values, slopes,
step sizes) are float32 on the host, as the JAX program holds them in
float32, so each linesearch step reads one value and one slope back. Its
exit depends on those values: the run is eager, one host read per
linesearch step.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

F32 = np.float32
ValueAndGrad = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def _host(*scalars: torch.Tensor) -> list[np.float32]:
    """0-d device tensors → float32 host scalars, in one copy."""
    return [F32(v) for v in torch.stack([s.reshape(()) for s in scalars]).cpu().numpy()]


@dataclass
class _Line:
    """The zoom linesearch's state (optax's ``ZoomLinesearchState``):
    host float32 scalars and device gradients."""

    count: int
    stepsize: np.float32
    value: np.float32
    grad: torch.Tensor
    slope: np.float32
    decrease_error: np.float32
    curvature_error: np.float32
    interval_found: bool
    done: bool
    failed: bool
    low: np.float32
    value_low: np.float32
    slope_low: np.float32
    high: np.float32
    value_high: np.float32
    slope_high: np.float32
    cubic_ref: np.float32
    value_cubic_ref: np.float32
    safe_stepsize: np.float32
    safe_value: np.float32
    safe_grad: torch.Tensor


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc)
    with slope fpa at a; NaN where there is none (optax's ``_cubicmin``)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc**2 * r0 + -(db**2) * r1) / denom
    B = (-(dc**3) * r0 + db**3 * r1) / denom
    radical = B * B - F32(3.0) * A * C
    return a + (-B + np.sqrt(radical)) / (F32(3.0) * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a (optax's ``_quadmin``)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db**2)
    return a - C / (F32(2.0) * B)


#: optax 0.2.6's ``lbfgs`` defaults: ``memory_size``, and
#: ``scale_by_zoom_linesearch(max_linesearch_steps=20,
#: initial_guess_strategy="one")``'s arguments (``STEPSIZE_PRECISION`` is
#: its ``interval_threshold``; ``tol`` is 0).
MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = F32(2.0)
SLOPE_RTOL = 1e-4
CURV_RTOL = F32(0.9)
APPROX_DEC_RTOL = F32(1e-6)
STEPSIZE_PRECISION = F32(1e-5)


class ZoomLinesearch:
    """optax's ``zoom_linesearch`` at those settings."""

    def _decrease_error(self, stepsize, value_step, slope_step, value_init, slope_init):
        err = value_step - value_init - F32(SLOPE_RTOL) * stepsize * slope_init
        # or Hager and Zhang's approximate decrease, whichever is smaller
        approx = slope_step - F32(2 * SLOPE_RTOL - 1.0) * slope_init
        delta_values = value_step - value_init - APPROX_DEC_RTOL * abs(value_init)
        err = np.minimum(np.maximum(approx, delta_values), err)
        err = np.maximum(err, F32(0.0))
        return F32(np.inf) if np.isnan(err) else err

    def _curvature_error(self, slope_step, slope_init):
        err = np.maximum(abs(slope_step) - CURV_RTOL * abs(slope_init), F32(0.0))
        return F32(np.inf) if np.isnan(err) else err

    def search(
        self, value_and_grad: ValueAndGrad, params: torch.Tensor,
        updates: torch.Tensor, value: np.float32, grad: torch.Tensor,
    ) -> tuple[np.float32, np.float32, torch.Tensor, int]:
        """The accepted step size along ``updates`` from ``params``, with
        the value and gradient there and the linesearch steps taken."""
        (slope,) = _host(torch.dot(updates, grad))
        zero = F32(0.0)
        st = _Line(
            count=0, stepsize=zero, value=value, grad=grad, slope=slope,
            decrease_error=F32(np.inf), curvature_error=F32(np.inf),
            interval_found=False, done=False, failed=False,
            low=zero, value_low=value, slope_low=slope,
            high=zero, value_high=value, slope_high=slope,
            cubic_ref=zero, value_cubic_ref=value,
            safe_stepsize=zero, safe_value=value, safe_grad=grad,
        )
        line = dict(value_and_grad=value_and_grad, params=params, updates=updates,
                    value_init=value, slope_init=slope)
        with np.errstate(all="ignore"):
            while not (st.done or st.failed):
                st = self._zoom(st, **line) if st.interval_found else self._interval(st, **line)
                if st.failed:
                    st = self._safe_step(st)
        return st.stepsize, st.value, st.grad, st.count

    def _on_line(self, value_and_grad, params, updates, stepsize):
        v, g = value_and_grad(params + float(stepsize) * updates)
        value, slope = _host(v, torch.dot(g, updates))
        return value, g, slope

    def _interval(self, st: _Line, *, value_and_grad, params, updates, value_init, slope_init):
        """Search an interval holding a valid step (Algorithm 3.5)."""
        new = F32(1.0) if st.count == 0 else INCREASE_FACTOR * st.stepsize
        value, grad, slope = self._on_line(value_and_grad, params, updates, new)
        dec = self._decrease_error(new, value, slope, value_init, slope_init)
        curv = self._curvature_error(slope, slope_init)
        error = max(dec, curv)
        safe = (new, value, grad) if dec <= 0.0 else (st.safe_stepsize, st.safe_value, st.safe_grad)
        set_high = bool(dec > 0.0) or bool(value >= st.value and st.count > 0)
        set_low = bool(slope >= 0.0) and not set_high
        if set_low:
            low, value_low, slope_low = new, value, slope
            high, value_high, slope_high = st.stepsize, st.value, st.slope
        else:
            low, value_low, slope_low = st.stepsize, st.value, st.slope
            high, value_high, slope_high = new, value, slope
        done = bool(error <= 0.0)
        return _Line(
            count=st.count + 1, stepsize=new, value=value, grad=grad, slope=slope,
            decrease_error=dec, curvature_error=curv,
            interval_found=set_high or set_low or done, done=done,
            failed=st.count + 1 >= MAX_LINESEARCH_STEPS and not done,
            low=low, value_low=value_low, slope_low=slope_low,
            high=high, value_high=value_high, slope_high=slope_high,
            cubic_ref=low, value_cubic_ref=value_low,
            safe_stepsize=safe[0], safe_value=safe[1], safe_grad=safe[2],
        )

    def _zoom(self, st: _Line, *, value_and_grad, params, updates, value_init, slope_init):
        """Zoom into the interval (Algorithm 3.6)."""
        low, high = st.low, st.high
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        cubic_chk, quad_chk = F32(0.2) * delta, F32(0.1) * delta
        too_small = bool(delta <= STEPSIZE_PRECISION)
        cubic = _cubicmin(low, st.value_low, st.slope_low, high, st.value_high,
                          st.cubic_ref, st.value_cubic_ref)
        use_cubic = bool(cubic > left + cubic_chk) and bool(cubic < right - cubic_chk)
        quad = _quadmin(low, st.value_low, st.slope_low, high, st.value_high)
        use_quad = not use_cubic and bool(quad > left + quad_chk) and bool(quad < right - quad_chk)
        if use_cubic:
            middle = cubic
        elif use_quad:
            middle = quad
        else:
            middle = (low + high) / F32(2.0)
        value, grad, slope = self._on_line(value_and_grad, params, updates, middle)
        dec = self._decrease_error(middle, value, slope, value_init, slope_init)
        curv = self._curvature_error(slope, slope_init)
        error = max(dec, curv)
        if dec <= 0.0 and value < st.safe_value:
            safe = (middle, value, grad)
        else:
            safe = (st.safe_stepsize, st.safe_value, st.safe_grad)
        done = bool(error <= 0.0)
        set_high_to_middle = bool(dec > 0.0) or bool(value >= st.value_low)
        set_high_to_low = bool(slope * (high - low) >= 0.0) and not set_high_to_middle
        new_high = (middle, value, slope) if set_high_to_middle else (high, st.value_high, st.slope_high)
        if set_high_to_low:
            new_high = (low, st.value_low, st.slope_low)
        new_low = (low, st.value_low, st.slope_low) if set_high_to_middle else (middle, value, slope)
        cubic_ref = (high, st.value_high) if set_high_to_middle or set_high_to_low else (low, st.value_low)
        presumably_failed = (st.count + 1 >= MAX_LINESEARCH_STEPS) or (
            too_small and safe[0] > 0.0
        )
        return _Line(
            count=st.count + 1, stepsize=middle, value=value, grad=grad, slope=slope,
            decrease_error=dec, curvature_error=curv,
            interval_found=st.interval_found, done=done,
            failed=bool(presumably_failed) and not done,
            low=new_low[0], value_low=new_low[1], slope_low=new_low[2],
            high=new_high[0], value_high=new_high[1], slope_high=new_high[2],
            cubic_ref=cubic_ref[0], value_cubic_ref=cubic_ref[1],
            safe_stepsize=safe[0], safe_value=safe[1], safe_grad=safe[2],
        )

    @staticmethod
    def _safe_step(st: _Line) -> _Line:
        """After a failure, the best step with sufficient decrease if one
        was seen (or if the last step left the domain)."""
        if st.safe_stepsize > 0.0 or np.isinf(st.decrease_error):
            return replace(st, stepsize=st.safe_stepsize, value=st.safe_value,
                           grad=st.safe_grad)
        return st


@dataclass
class LBFGSState:
    """``optax.lbfgs``'s state: the previous iterate and gradient, the
    difference memories ``[memory_size, n]`` and their weights, and the
    linesearch's last step size, value and gradient (the value and
    gradient at the current iterate, reused by ``value_and_grad``)."""

    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params: torch.Tensor
    diff_updates: torch.Tensor
    weights: torch.Tensor
    learning_rate: np.float32 = F32(1.0)
    value: np.float32 = F32(np.inf)
    grad: torch.Tensor | None = None
    linesearch_steps: int = 0


class LBFGS:
    """``optax.lbfgs()`` (memory 10, a scaled initial preconditioner, the
    zoom linesearch) over a flat float32 vector::

        opt = LBFGS()
        state = opt.init(x)
        value, grad = opt.value_and_grad(fn, x, state)
        updates, state = opt.update(grad, state, x, value=value, value_and_grad=fn)
        x = x + updates

    ``fn(x) -> (value, grad)`` (0-d and ``x``-shaped tensors)."""

    linesearch = ZoomLinesearch()

    @staticmethod
    def init(params: torch.Tensor) -> LBFGSState:
        memory = params.new_zeros(MEMORY_SIZE, params.numel())
        return LBFGSState(
            count=0, params=torch.zeros_like(params), updates=torch.zeros_like(params),
            diff_params=memory, diff_updates=memory.clone(),
            weights=params.new_zeros(MEMORY_SIZE), grad=torch.zeros_like(params),
        )

    @staticmethod
    def value_and_grad(
        fn: ValueAndGrad, params: torch.Tensor, state: LBFGSState
    ) -> tuple[np.float32, torch.Tensor]:
        """The value and gradient the state holds for ``params`` (the
        linesearch's at the accepted step), or ``fn``'s where the held
        value is not finite (the first iteration)."""
        if np.isfinite(state.value):
            return state.value, state.grad
        v, g = fn(params)
        return _host(v)[0], g

    @staticmethod
    def _precondition(grad, state: LBFGSState, memory_idx: int, scale) -> torch.Tensor:
        """The two-loop recursion: the inverse-Hessian approximation times
        ``grad``, newest memory entry first, then oldest first."""
        m = MEMORY_SIZE
        order = [(memory_idx + i) % m for i in range(m)]
        rhos, dws, dus = state.weights, state.diff_params, state.diff_updates
        vec, alphas = grad, {}
        for idx in reversed(order):
            alphas[idx] = rhos[idx] * torch.dot(dws[idx], vec)
            vec = vec - alphas[idx] * dus[idx]
        vec = scale * vec
        for idx in order:
            beta = rhos[idx] * torch.dot(dus[idx], vec)
            vec = vec + (alphas[idx] - beta) * dws[idx]
        return vec

    def update(
        self, grad: torch.Tensor, state: LBFGSState, params: torch.Tensor, *,
        value: np.float32, value_and_grad: ValueAndGrad,
    ) -> tuple[torch.Tensor, LBFGSState]:
        """One L-BFGS iteration from ``params`` (``value``, ``grad`` there):
        returns the update (``-stepsize · P g``) and the new state."""
        m = MEMORY_SIZE
        memory_idx, prev_idx = state.count % m, (state.count - 1) % m
        diff_params = state.diff_params.clone()
        diff_updates = state.diff_updates.clone()
        weights = state.weights.clone()
        if state.count > 0:
            dp, du = params - state.params, grad - state.updates
            vdot = torch.dot(du, dp)
            diff_params[prev_idx] = dp
            diff_updates[prev_idx] = du
            weights[prev_idx] = torch.where(vdot == 0.0, 0.0, 1.0 / vdot)
        if state.count > 0:
            num, den = torch.dot(du, dp), torch.dot(du, du)
            scale = torch.where(den > 0.0, num / den, 1.0)
        else:
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        direction = -self._precondition(
            grad, replace(state, diff_params=diff_params, diff_updates=diff_updates,
                          weights=weights),
            memory_idx, scale,
        )
        stepsize, new_value, new_grad, steps = self.linesearch.search(
            value_and_grad, params, direction, value, grad
        )
        return float(stepsize) * direction, LBFGSState(
            count=state.count + 1, params=params, updates=grad,
            diff_params=diff_params, diff_updates=diff_updates, weights=weights,
            learning_rate=stepsize, value=new_value, grad=new_grad,
            linesearch_steps=steps,
        )
