"""Line-search minimizer: steepest descent / nonlinear CG / L-BFGS.

JAX counterpart of the reference lineage's line-search layer
(``internal/ceres/line_search_minimizer.cc``, ``line_search.cc``,
``line_search_direction.cc``, ``low_rank_inverse_hessian.cc``): the descent
direction and the L-BFGS two-loop recursion run on host numpy over the
(small) tangent vector while every cost/gradient evaluation is one jitted
device program — the same host-control/device-compute split as the
trust-region minimizer.

Used directly for ``MinimizerType.LINE_SEARCH`` problems and for the
GradientProblem solver façade.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from skeres.core.options import SolverOptions
from skeres.core.summary import IterationSummary, Summary
from skeres.core.types import (
    CallbackReturnType,
    LineSearchDirectionType,
    LineSearchType,
    TerminationType,
)

__all__ = ["LineSearchMinimizer", "wolfe_line_search", "armijo_line_search"]


def _interpolate_step(lo, f_lo, g_lo, hi, f_hi, trial_frac=0.5):
    """Minimize the cubic (or quadratic) model on [lo, hi] given value and
    derivative at lo and value at hi (reference: ``polynomial.cc``
    MinimizeInterpolatingPolynomial, bisection-safeguarded)."""
    d = hi - lo
    if d == 0.0:
        return lo
    # quadratic through (lo, f_lo, g_lo) and (hi, f_hi)
    denom = 2.0 * (f_hi - f_lo - g_lo * d)
    if denom != 0.0:
        t = -g_lo * d * d / denom
        cand = lo + t
        lo_b, hi_b = (lo, hi) if lo < hi else (hi, lo)
        span = hi_b - lo_b
        # safeguard: keep strictly inside the bracket
        if lo_b + 0.05 * span <= cand <= hi_b - 0.05 * span and np.isfinite(cand):
            return cand
    return lo + trial_frac * d


def armijo_line_search(
    phi: Callable[[float], float],
    f0: float,
    g0: float,
    initial_step: float,
    sufficient_decrease: float,
    max_iterations: int,
    min_step: float,
):
    """Backtracking Armijo search with polynomial interpolation.

    Returns (step, f_step, num_evals) or (None, f0, num_evals) on failure.
    """
    s = initial_step
    prev_s, prev_f = None, None
    for k in range(max_iterations):
        f = phi(s)
        if np.isfinite(f) and f <= f0 + sufficient_decrease * g0 * s:
            return s, f, k + 1
        if prev_s is not None and np.isfinite(f):
            s_new = _interpolate_step(0.0, f0, g0, s, f)
        else:
            s_new = 0.5 * s
        prev_s, prev_f = s, f
        s = max(min(s_new, 0.9 * s), 0.1 * s)  # Ceres-style safeguard window
        if s < min_step:
            break
    return None, f0, max_iterations


def wolfe_line_search(
    phi_dphi: Callable[[float], tuple],
    f0: float,
    g0: float,
    initial_step: float,
    sufficient_decrease: float,
    curvature: float,
    max_iterations: int,
    min_step: float,
    step_expansion: float = 10.0,
):
    """Strong-Wolfe search: bracketing phase + zoom phase
    (reference: ``line_search.cc`` WolfeLineSearch; Nocedal & Wright alg 3.5/3.6).

    ``step_expansion`` bounds the bracketing-phase step growth (reference:
    ``max_line_search_step_expansion``, default 10).

    phi_dphi(s) -> (phi(s), phi'(s)). Returns (step, f, num_evals) or
    (None, f0, evals).
    """
    evals = 0
    s_prev, f_prev, g_prev = 0.0, f0, g0
    s = initial_step
    max_step = 1e16

    def zoom(lo, f_lo, g_lo, hi, f_hi):
        nonlocal evals
        for _ in range(max_iterations):
            sj = _interpolate_step(lo, f_lo, g_lo, hi, f_hi)
            if abs(hi - lo) < min_step:
                return (lo, f_lo) if f_lo < f0 else (None, f0)
            fj, gj = phi_dphi(sj)
            evals += 1
            if not np.isfinite(fj) or fj > f0 + sufficient_decrease * g0 * sj or fj >= f_lo:
                hi, f_hi = sj, fj
            else:
                if abs(gj) <= -curvature * g0:
                    return sj, fj
                if gj * (hi - lo) >= 0:
                    hi, f_hi = lo, f_lo
                lo, f_lo, g_lo = sj, fj, gj
        return (lo, f_lo) if f_lo < f0 else (None, f0)

    for i in range(max_iterations):
        f, g = phi_dphi(s)
        evals += 1
        if not np.isfinite(f) or f > f0 + sufficient_decrease * g0 * s or (
            i > 0 and f >= f_prev
        ):
            out = zoom(s_prev, f_prev, g_prev, s, f)
            return out[0], out[1], evals
        if abs(g) <= -curvature * g0:
            return s, f, evals
        if g >= 0:
            out = zoom(s, f, g, s_prev, f_prev)
            return out[0], out[1], evals
        s_prev, f_prev, g_prev = s, f, g
        s = min(step_expansion * s, max_step)
    return None, f0, evals


class _LowRankInverseHessian:
    """L-BFGS memory + two-loop recursion (reference:
    ``low_rank_inverse_hessian.cc``), host-side numpy."""

    def __init__(self, max_rank: int, use_scaling: bool = True):
        self.max_rank = max_rank
        self.use_scaling = use_scaling
        self.s = deque(maxlen=max_rank)
        self.y = deque(maxlen=max_rank)
        self.rho = deque(maxlen=max_rank)

    def update(self, delta_x, delta_g):
        sy = float(np.dot(delta_x, delta_g))
        if sy <= 1e-14:
            return False
        self.s.append(delta_x)
        self.y.append(delta_g)
        self.rho.append(1.0 / sy)
        return True

    def apply(self, g):
        q = g.copy()
        alphas = []
        for s_i, y_i, rho_i in zip(
            reversed(self.s), reversed(self.y), reversed(self.rho)
        ):
            a = rho_i * np.dot(s_i, q)
            alphas.append(a)
            q -= a * y_i
        if self.use_scaling and self.y:
            y_last = self.y[-1]
            q *= 1.0 / (self.rho[-1] * np.dot(y_last, y_last))
        for (s_i, y_i, rho_i), a in zip(
            zip(self.s, self.y, self.rho), reversed(alphas)
        ):
            b = rho_i * np.dot(y_i, q)
            q += (a - b) * s_i
        return q


class _DenseInverseHessian:
    """Full-rank BFGS inverse-Hessian approximation (reference:
    ``line_search_direction.cc`` BFGS path), host-side numpy. Maintains
    H_k with the standard BFGS inverse update

        H <- (I - rho s y^T) H (I - rho y s^T) + rho s s^T,

    with the Oren-Luenberger scaling of the initial H applied at the first
    update (same as the reference's use_approximate_eigenvalue_scaling
    default behavior for BFGS: H0 = (s^T y / y^T y) I)."""

    def __init__(self, n: int, use_scaling: bool = True):
        self.h = np.eye(n)
        self.use_scaling = use_scaling
        self.initialized = False
        # non-empty marker so the initial-step heuristic treats an updated
        # BFGS like an updated LBFGS (see minimize(): unit initial step)
        self.s = []

    def update(self, delta_x, delta_g):
        sy = float(np.dot(delta_x, delta_g))
        if sy <= 1e-14:
            return False
        if not self.initialized and self.use_scaling:
            yy = float(np.dot(delta_g, delta_g))
            if yy > 0.0:
                self.h *= sy / yy
        self.initialized = True
        self.s.append(None)  # rank marker only
        rho = 1.0 / sy
        hy = self.h @ delta_g
        yhy = float(np.dot(delta_g, hy))
        # expanded form of the sandwich update (one rank-2 correction):
        # H += rho^2 (y'Hy) s s' + rho s s' - rho (s (Hy)' + (Hy) s')
        self.h += (rho * rho * yhy + rho) * np.outer(delta_x, delta_x)
        self.h -= rho * (np.outer(delta_x, hy) + np.outer(hy, delta_x))
        return True

    def apply(self, g):
        return self.h @ g


class LineSearchMinimizer:
    """Host loop over jitted cost/gradient programs
    (reference: ``line_search_minimizer.cc``)."""

    def __init__(self, evaluator, options: SolverOptions, summary: Summary):
        self.ev = evaluator
        self.options = options
        self.summary = summary

        ev = evaluator

        def cost_and_grad(state):
            cost, blocks = ev.blocks(state)
            g, _ = ev.gradient_and_diag(blocks)
            return cost, g

        def try_step(state, direction, step):
            new_state = ev.plus(state, direction * step)
            cost, blocks = ev.blocks(new_state)
            g, _ = ev.gradient_and_diag(blocks)
            return new_state, cost, g

        def try_cost(state, direction, step):
            new_state = ev.plus(state, direction * step)
            return ev.cost(new_state)

        self._cost_and_grad = jax.jit(cost_and_grad)
        self._try_step = jax.jit(try_step)
        self._try_cost = jax.jit(try_cost)

    def minimize(self, state):
        o = self.options
        s = self.summary
        start = time.time()
        dtype = self.ev.dtype

        cost_d, g_d = self._cost_and_grad(state)
        cost = float(jax.block_until_ready(cost_d))
        g = np.asarray(g_d, dtype=np.float64)
        s.num_jacobian_evaluations += 1
        if not np.isfinite(cost):
            s.termination_type = TerminationType.FAILURE
            s.message = "Initial cost evaluation produced non-finite values."
            return state
        s.initial_cost = cost + s.fixed_cost

        direction_type = o.line_search_direction_type

        def make_inverse_hessian():
            scaling = o.use_approximate_eigenvalue_bfgs_scaling
            if direction_type == LineSearchDirectionType.LBFGS:
                return _LowRankInverseHessian(
                    o.max_lbfgs_rank, use_scaling=scaling
                )
            if direction_type == LineSearchDirectionType.BFGS:
                return _DenseInverseHessian(int(g.size), use_scaling=scaling)
            return None

        lbfgs = make_inverse_hessian()
        prev_g = None
        prev_direction = None
        restarts = 0

        it = IterationSummary(
            iteration=0,
            cost=cost + s.fixed_cost,
            gradient_max_norm=float(np.max(np.abs(g))) if g.size else 0.0,
            gradient_norm=float(np.linalg.norm(g)),
            iteration_time_in_seconds=time.time() - start,
            cumulative_time_in_seconds=time.time() - start,
            step_is_valid=True,
            step_is_successful=True,
        )
        s.iterations.append(it)
        if it.gradient_max_norm <= o.gradient_tolerance:
            s.termination_type = TerminationType.CONVERGENCE
            s.message = "Gradient tolerance reached."
            return state

        for iteration in range(1, o.max_num_iterations + 1):
            iter_start = time.time()
            if time.time() - start > o.max_solver_time_in_seconds:
                s.termination_type = TerminationType.NO_CONVERGENCE
                s.message = "Maximum solver time reached."
                return state

            # -- direction ----------------------------------------------------
            if direction_type == LineSearchDirectionType.STEEPEST_DESCENT:
                direction = -g
            elif direction_type == LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT:
                if prev_g is None:
                    direction = -g
                else:
                    # Polak-Ribiere+ (reference default)
                    beta = max(
                        0.0,
                        float(np.dot(g, g - prev_g) / max(np.dot(prev_g, prev_g), 1e-300)),
                    )
                    direction = -g + beta * prev_direction
            else:  # LBFGS (two-loop) or BFGS (dense inverse Hessian)
                direction = -lbfgs.apply(g)

            dg = float(np.dot(direction, g))
            if not np.isfinite(dg) or dg >= 0.0:
                # not a descent direction: restart from steepest descent
                restarts += 1
                if restarts > o.max_num_line_search_direction_restarts:
                    s.termination_type = TerminationType.FAILURE
                    s.message = (
                        "Line search direction failure: exceeded "
                        "max_num_line_search_direction_restarts."
                    )
                    return state
                if lbfgs is not None:
                    lbfgs = make_inverse_hessian()
                prev_g = None
                direction = -g
                dg = float(np.dot(direction, g))

            direction_dev = jnp.asarray(direction, dtype=dtype)

            # initial step: reference uses min(1, 2(f - f_prev)/dg) heuristics;
            # 1.0 for quasi-Newton, scaled for first iteration
            if lbfgs is not None and lbfgs.s:
                initial_step = 1.0
            else:
                initial_step = min(1.0, 1.0 / max(float(np.max(np.abs(g))), 1e-12))

            # -- line search --------------------------------------------------
            cached = {}

            def phi_dphi(step):
                new_state, c, gd = self._try_step(state, direction_dev, step)
                c = float(jax.block_until_ready(c))
                gnew = np.asarray(gd, dtype=np.float64)
                cached[step] = (new_state, c, gnew)
                return c, float(np.dot(gnew, direction))

            def phi(step):
                new_state, c, gd = self._try_step(state, direction_dev, step)
                c = float(jax.block_until_ready(c))
                cached[step] = (new_state, c, np.asarray(gd, dtype=np.float64))
                return c

            if o.line_search_type == LineSearchType.WOLFE:
                step, new_cost, evals = wolfe_line_search(
                    phi_dphi,
                    cost,
                    dg,
                    initial_step,
                    o.line_search_sufficient_function_decrease,
                    o.line_search_sufficient_curvature_decrease,
                    o.max_num_line_search_step_size_iterations,
                    o.min_line_search_step_size,
                    o.max_line_search_step_expansion,
                )
            else:
                step, new_cost, evals = armijo_line_search(
                    phi,
                    cost,
                    dg,
                    initial_step,
                    o.line_search_sufficient_function_decrease,
                    o.max_num_line_search_step_size_iterations,
                    o.min_line_search_step_size,
                )
            s.num_residual_evaluations += evals
            s.num_jacobian_evaluations += evals

            if step is None:
                s.termination_type = TerminationType.NO_CONVERGENCE
                s.message = (
                    f"Line search failed to find a valid step at iteration "
                    f"{iteration}."
                )
                return state

            new_state, new_cost, new_g = cached[step]
            step_vec = step * direction
            step_norm = float(np.linalg.norm(step_vec))

            if lbfgs is not None:
                lbfgs.update(step_vec, new_g - g)
            prev_g, prev_direction = g, direction

            cost_change = cost - new_cost
            accepted = new_cost < cost
            if accepted:
                state = new_state
            x_norm = float(self.ev.x_norm(state))

            it = IterationSummary(
                iteration=iteration,
                cost=new_cost + s.fixed_cost,
                cost_change=cost_change,
                gradient_max_norm=float(np.max(np.abs(new_g))),
                gradient_norm=float(np.linalg.norm(new_g)),
                step_norm=step_norm,
                step_is_valid=True,
                step_is_successful=accepted,
                line_search_function_evaluations=evals,
                iteration_time_in_seconds=time.time() - iter_start,
                cumulative_time_in_seconds=time.time() - start,
            )
            s.iterations.append(it)
            if accepted:
                s.num_successful_steps += 1
            else:
                s.num_unsuccessful_steps += 1

            for cb in o.callbacks:
                ret = cb(it)
                if ret == CallbackReturnType.SOLVER_ABORT:
                    s.termination_type = TerminationType.USER_FAILURE
                    s.message = "User callback returned SOLVER_ABORT."
                    return state
                if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                    s.termination_type = TerminationType.USER_SUCCESS
                    s.message = "User callback terminated the solver."
                    return state

            # -- convergence --------------------------------------------------
            if it.gradient_max_norm <= o.gradient_tolerance:
                s.termination_type = TerminationType.CONVERGENCE
                s.message = "Gradient tolerance reached."
                cost, g = new_cost, new_g
                return state
            if abs(cost_change) <= o.function_tolerance * abs(cost):
                s.termination_type = TerminationType.CONVERGENCE
                s.message = "Function tolerance reached."
                return state
            if step_norm <= o.parameter_tolerance * (x_norm + o.parameter_tolerance):
                s.termination_type = TerminationType.CONVERGENCE
                s.message = "Parameter tolerance reached."
                return state
            cost, g = new_cost, new_g

        s.termination_type = TerminationType.NO_CONVERGENCE
        s.message = "Maximum number of iterations reached."
        return state
