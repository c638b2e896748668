"""L-BFGS with the zoom line search: optax 0.2.6's ``optax.lbfgs()``.

tpuwave's ``FwiProblem.invert(optimizer="lbfgs")`` runs
``optax.lbfgs()``, the chain of

1. ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``: the
   memory of parameter and gradient differences, written at slot
   ``(count - 1) % 10`` before the two-loop recursion; the identity scale
   is ``<dg, dw> / <dg, dg>``, and on the first step
   ``min(1, 1 / ||g||)``;
2. ``scale(-1)``;
3. ``scale_by_zoom_linesearch(max_linesearch_steps=20,
   initial_guess_strategy="one")``: Nocedal and Wright's algorithms 3.5
   (interval search, step 1 then doubling) and 3.6 (zoom: cubic, then
   quadratic interpolation, then bisection) with the Armijo test relaxed
   to Hager and Zhang's approximate decrease near a minimum, a 0.9
   curvature test, and the best sufficient-decrease step kept as the
   fallback;

with ``value_and_grad_from_state``: an iteration's value and gradient are
the line search's last ones (those of the accepted trial point), and are
computed only on the first iteration. :class:`Lbfgs` does the same
arithmetic in the same order. Its scalars are numpy scalars of the
parameters' precision (float64 for float64 parameters, as tpuwave's
runs with x64 on, else float32), so every branch of the line search
takes the same turn as optax's; the vectors stay torch tensors on their
device.

:meth:`Lbfgs.leaves` lists the state as ``jax.tree_util.tree_leaves`` of
the chained optax state lists it, and :meth:`Lbfgs.load_leaves` reads
such a list back, so one checkpoint resumes in either package.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Lbfgs"]

#: ``(value, [gradient per parameter])`` of a list of parameters
ValueAndGrad = Callable[[List[torch.Tensor]], Tuple[float, List[torch.Tensor]]]


def _vdot(xs: Sequence[torch.Tensor], ys: Sequence[torch.Tensor]) -> float:
    """optax.tree.vdot: the sum over the leaves of their inner products."""
    total = 0.0
    for x, y in zip(xs, ys):
        total = total + float(torch.dot(x.reshape(-1), y.reshape(-1)))
    return total


def _add_scale(xs, scalar, ys) -> list:
    """optax.tree.add_scale: x + scalar * y per leaf."""
    return [x + float(scalar) * y for x, y in zip(xs, ys)]


def _cubicmin(f, a, fa, fpa, b, fb, c, fc):
    """optax's _cubicmin: the critical point of the cubic through (a, fa),
    (b, fb), (c, fc) with slope fpa at a (nan where there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    with np.errstate(all="ignore"):
        A = (dc ** 2 * r0 + -(db ** 2) * r1) / denom
        B = (-(dc ** 3) * r0 + db ** 3 * r1) / denom
        radical = B * B - f(3.0) * A * C
        return a + (-B + np.sqrt(radical)) / (f(3.0) * A)


def _quadmin(f, a, fa, fpa, b, fb):
    """optax's _quadmin: the critical point of the parabola through
    (a, fa), (b, fb) with slope fpa at a."""
    D = fa
    C = fpa
    db = b - a
    with np.errstate(all="ignore"):
        B = (fb - D - C * db) / (db ** 2)
        return a - C / (f(2.0) * B)


class _Zoom:
    """The zoom line search's state (optax's ZoomLinesearchState)."""

    def __init__(self, f, params, updates, value, grad, slope):
        self.f = f
        zero = f(0.0)
        self.count = 0
        self.params, self.updates = params, updates
        self.stepsize_guess = f(1.0)
        self.stepsize, self.value, self.grad, self.slope = (
            zero, value, grad, slope)
        self.value_init, self.slope_init = value, slope
        self.decrease_error = self.curvature_error = self.error = f(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = zero, value, slope
        self.high, self.value_high, self.slope_high = zero, value, slope
        self.cubic_ref, self.value_cubic_ref = zero, value
        self.safe_stepsize, self.safe_value, self.safe_grad = (
            zero, value, grad)


class Lbfgs:
    """``optax.lbfgs()`` over a list of parameter tensors.

    One iteration is ``value, grad = opt.value_and_grad(params, vg)``,
    then ``updates = opt.update(grad, params, value, vg)`` and
    ``params[i] + updates[i]``; ``vg(params)`` returns the objective and
    its gradient list.
    """

    MEMORY_SIZE = 10
    MAX_LINESEARCH_STEPS = 20
    # scale_by_zoom_linesearch's defaults
    SLOPE_RTOL, CURV_RTOL = 1e-4, 0.9
    APPROX_DEC_RTOL, INTERVAL_THRESHOLD = 1e-6, 1e-5
    INCREASE_FACTOR, TOL = 2.0, 0.0

    def __init__(self, params: Sequence[torch.Tensor]):
        m = self.MEMORY_SIZE
        self.f = np.float64 if params[0].dtype == torch.float64 \
            else np.float32
        # scale_by_lbfgs
        self.count = 0
        self.params = [torch.zeros_like(p) for p in params]
        self.updates = [torch.zeros_like(p) for p in params]
        self.dparams = [p.new_zeros((m,) + tuple(p.shape)) for p in params]
        self.dupdates = [p.new_zeros((m,) + tuple(p.shape)) for p in params]
        self.weights = np.zeros(m, self.f)
        # scale_by_zoom_linesearch
        self.learning_rate = self.f(1.0)
        self.value = self.f(np.inf)
        self.grad = [torch.zeros_like(p) for p in params]
        self.info = (0, self.f(np.inf), self.f(np.inf))

    # -- value_and_grad_from_state -------------------------------------------
    def value_and_grad(self, params, vg: ValueAndGrad):
        """The line search's last value and gradient where the value is
        finite, else ``vg(params)``."""
        if np.isfinite(self.value):
            return self.value, self.grad
        value, grad = vg(params)
        return self.f(value), grad

    # -- one update --------------------------------------------------------
    def update(self, grad, params, value, vg: ValueAndGrad) -> list:
        """The chained transform's updates (to add to ``params``)."""
        direction = self._scale_by_lbfgs(grad, params)
        direction = [-1.0 * d for d in direction]
        return self._zoom_linesearch(direction, params, self.f(value), grad,
                                     vg)

    def _scale_by_lbfgs(self, updates, params) -> list:
        f, m = self.f, self.MEMORY_SIZE
        memory_idx = self.count % m
        prev_memory_idx = (self.count - 1) % m
        diff_params = [p - q for p, q in zip(params, self.params)]
        diff_updates = [u - v for u, v in zip(updates, self.updates)]
        vd = f(_vdot(diff_updates, diff_params))
        with np.errstate(divide="ignore"):
            weight = f(0.0) if vd == 0.0 else f(1.0) / vd
        if self.count == 0:
            diff_params = [torch.zeros_like(x) for x in diff_params]
            diff_updates = [torch.zeros_like(x) for x in diff_updates]
            weight = f(0.0)
        for mem, x in zip(self.dparams, diff_params):
            mem[prev_memory_idx] = x
        for mem, x in zip(self.dupdates, diff_updates):
            mem[prev_memory_idx] = x
        self.weights[prev_memory_idx] = weight

        numerator = f(_vdot(diff_updates, diff_params))
        denominator = f(_vdot(diff_updates, diff_updates))
        identity_scale = numerator / denominator if denominator > 0.0 \
            else f(1.0)
        if self.count == 0:
            update_norm = np.sqrt(f(_vdot(updates, updates)))
            with np.errstate(divide="ignore"):
                identity_scale = np.minimum(f(1.0), f(1.0) / update_norm)

        # two-loop recursion (optax's _precondition_by_lbfgs)
        rhos = self.weights
        indices = [(memory_idx + i) % m for i in range(m)]
        vec, alphas = list(updates), [None] * m
        for pos in reversed(range(m)):
            idx = indices[pos]
            dwi = [x[idx] for x in self.dparams]
            dui = [x[idx] for x in self.dupdates]
            alpha = rhos[idx] * f(_vdot(dwi, vec))
            vec = _add_scale(vec, -alpha, dui)
            alphas[pos] = alpha
        vec = [float(identity_scale) * v for v in vec]
        for pos in range(m):
            idx = indices[pos]
            dwi = [x[idx] for x in self.dparams]
            dui = [x[idx] for x in self.dupdates]
            beta = rhos[idx] * f(_vdot(dui, vec))
            vec = _add_scale(vec, alphas[pos] - beta, dwi)

        self.count += 1
        self.params = list(params)
        self.updates = list(updates)
        return vec

    # -- scale_by_zoom_linesearch ---------------------------------------
    def _on_line(self, st, stepsize, vg):
        step = _add_scale(st.params, stepsize, st.updates)
        value, grad = vg(step)
        value = self.f(value)
        slope = self.f(_vdot(grad, st.updates))
        return value, grad, slope

    def _decrease_error(self, stepsize, value_step, slope_step, value_init,
                        slope_init):
        f = self.f
        err = value_step - value_init - self.SLOPE_RTOL * stepsize \
            * slope_init
        approx = slope_step - (2 * self.SLOPE_RTOL - 1.0) * slope_init
        delta_values = value_step - value_init \
            - self.APPROX_DEC_RTOL * np.abs(value_init)
        approx = np.maximum(approx, delta_values)
        err = np.minimum(approx, err)
        err = np.maximum(err, f(0.0))
        return f(np.inf) if np.isnan(err) else f(err)

    def _curvature_error(self, slope_step, slope_init):
        f = self.f
        err = np.abs(slope_step) - self.CURV_RTOL * np.abs(slope_init)
        err = np.maximum(err, f(0.0))
        return f(np.inf) if np.isnan(err) else f(err)

    def _search_interval(self, st, vg):
        """Algorithm 3.5 of Nocedal and Wright."""
        prev_stepsize, prev_value, prev_slope = st.stepsize, st.value, \
            st.slope
        new_stepsize = (st.stepsize_guess if st.count == 0
                        else self.f(self.INCREASE_FACTOR * prev_stepsize))
        value, grad, slope = self._on_line(st, new_stepsize, vg)
        dec = self._decrease_error(new_stepsize, value, slope, st.value_init,
                                   st.slope_init)
        curv = self._curvature_error(slope, st.slope_init)
        err = max(dec, curv)
        if dec <= self.TOL:
            st.safe_stepsize, st.safe_value, st.safe_grad = (
                new_stepsize, value, grad)
        set_high_to_new = (dec > 0.0) or (value >= prev_value
                                          and st.count > 0)
        set_low_to_new = (slope >= 0.0) and not set_high_to_new
        if set_low_to_new:
            st.low, st.value_low, st.slope_low = new_stepsize, value, slope
            st.high, st.value_high, st.slope_high = (
                prev_stepsize, prev_value, prev_slope)
        else:
            st.low, st.value_low, st.slope_low = (
                prev_stepsize, prev_value, prev_slope)
            st.high, st.value_high, st.slope_high = new_stepsize, value, \
                slope
        st.interval_found = bool(set_high_to_new or set_low_to_new
                                 or err <= self.TOL)
        st.done = bool(err <= self.TOL)
        st.failed = (st.count + 1 >= self.MAX_LINESEARCH_STEPS) and \
            not st.done
        st.count += 1
        st.stepsize, st.value, st.grad, st.slope = (new_stepsize, value,
                                                    grad, slope)
        st.decrease_error, st.curvature_error, st.error = dec, curv, err
        st.cubic_ref, st.value_cubic_ref = st.low, st.value_low

    def _zoom_into_interval(self, st, vg):
        """Algorithm 3.6 of Nocedal and Wright."""
        f = self.f
        low, value_low, slope_low = st.low, st.value_low, st.slope_low
        high, value_high, slope_high = st.high, st.value_high, st.slope_high
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic_chk, quad_chk = f(0.2) * delta, f(0.1) * delta
        too_small_int = delta <= self.INTERVAL_THRESHOLD
        middle_cubic = _cubicmin(f, low, value_low, slope_low, high,
                                 value_high, st.cubic_ref,
                                 st.value_cubic_ref)
        use_cubic = bool((middle_cubic > left + cubic_chk)
                         & (middle_cubic < right - cubic_chk))
        middle_quad = _quadmin(f, low, value_low, slope_low, high,
                               value_high)
        use_quad = (not use_cubic) and bool(
            (middle_quad > left + quad_chk)
            & (middle_quad < right - quad_chk))
        if use_cubic:
            middle = f(middle_cubic)
        elif use_quad:
            middle = f(middle_quad)
        else:
            middle = f((low + high) / f(2.0))
        value, grad, slope = self._on_line(st, middle, vg)
        dec = self._decrease_error(middle, value, slope, st.value_init,
                                   st.slope_init)
        curv = self._curvature_error(slope, st.slope_init)
        err = max(dec, curv)
        if dec <= self.TOL and value < st.safe_value:
            st.safe_stepsize, st.safe_value, st.safe_grad = (middle, value,
                                                             grad)
        done = bool(err <= self.TOL)
        set_high_to_middle = (dec > 0.0) or (value >= value_low)
        set_high_to_low = (slope * (high - low) >= 0.0) and \
            not set_high_to_middle
        set_low_to_middle = not set_high_to_middle
        if set_high_to_middle:
            new_high = (middle, value, slope)
        elif set_high_to_low:
            new_high = (low, value_low, slope_low)
        else:
            new_high = (high, value_high, slope_high)
        new_low = ((middle, value, slope) if set_low_to_middle
                   else (low, value_low, slope_low))
        if set_high_to_middle or set_high_to_low:
            st.cubic_ref, st.value_cubic_ref = high, value_high
        else:
            st.cubic_ref, st.value_cubic_ref = low, value_low
        presumably_failed = (st.count + 1 >= self.MAX_LINESEARCH_STEPS) or (
            too_small_int and st.safe_stepsize > 0.0)
        st.failed = bool(presumably_failed and not done)
        st.done = done
        st.count += 1
        st.stepsize, st.value, st.grad, st.slope = middle, value, grad, slope
        st.decrease_error, st.curvature_error, st.error = dec, curv, err
        st.low, st.value_low, st.slope_low = new_low
        st.high, st.value_high, st.slope_high = new_high

    def _zoom_linesearch(self, updates, params, value, grad, vg) -> list:
        slope = self.f(_vdot(updates, grad))
        st = _Zoom(self.f, list(params), updates, value, grad, slope)
        while not (st.done or st.failed):
            if st.interval_found:
                self._zoom_into_interval(st, vg)
            else:
                self._search_interval(st, vg)
            if st.failed and (st.safe_stepsize > 0.0
                              or np.isinf(st.decrease_error)):
                # _try_safe_step: fall back on the best sufficient decrease
                st.stepsize, st.value, st.grad = (
                    st.safe_stepsize, st.safe_value, st.safe_grad)
        self.learning_rate = st.stepsize
        self.value, self.grad = st.value, st.grad
        self.info = (st.count, st.decrease_error, st.curvature_error)
        return [float(st.stepsize) * u for u in updates]

    # -- optax's leaves ------------------------------------------------------
    def leaves(self) -> list:
        """The state as ``jax.tree_util.tree_leaves(optax.lbfgs() state)``:
        count (int32), params, updates, the two memories, the weights;
        the line search's learning rate, value, grad, and its info (the
        number of line-search steps, int64 with float64 parameters as in
        jax's x64 mode, else int32; the two errors)."""
        f = self.f
        n_int = np.int64 if f is np.float64 else np.int32
        return ([np.asarray(self.count, np.int32)] + list(self.params)
                + list(self.updates) + list(self.dparams)
                + list(self.dupdates) + [self.weights.copy(),
                                         np.asarray(self.learning_rate, f),
                                         np.asarray(self.value, f)]
                + list(self.grad)
                + [np.asarray(self.info[0], n_int),
                   np.asarray(self.info[1], f), np.asarray(self.info[2], f)])

    def n_leaves(self) -> int:
        return 7 + 5 * len(self.params)

    def load_leaves(self, leaves: Sequence) -> None:
        """Restore the state from :meth:`leaves`' list (or optax's)."""
        n, f = len(self.params), self.f
        if len(leaves) != self.n_leaves():
            raise ValueError(f"an L-BFGS state over {n} parameter(s) has "
                             f"{self.n_leaves()} leaves, got {len(leaves)}")
        like = self.params[0]

        def t(a):
            return torch.as_tensor(np.asarray(a)).to(like)

        it = iter(leaves)
        self.count = int(np.asarray(next(it)))
        self.params = [t(next(it)) for _ in range(n)]
        self.updates = [t(next(it)) for _ in range(n)]
        self.dparams = [t(next(it)) for _ in range(n)]
        self.dupdates = [t(next(it)) for _ in range(n)]
        self.weights = np.asarray(next(it), f).copy()
        self.learning_rate = f(np.asarray(next(it)))
        self.value = f(np.asarray(next(it)))
        self.grad = [t(next(it)) for _ in range(n)]
        self.info = (int(np.asarray(next(it))), f(np.asarray(next(it))),
                     f(np.asarray(next(it))))
