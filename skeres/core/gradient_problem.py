"""General unconstrained minimization: the GradientProblem façade.

JAX counterpart of the reference lineage's gradient-problem layer
(``include/ceres/gradient_problem.h``, ``gradient_problem_solver.h``,
``internal/ceres/gradient_problem_solver.cc``): minimize a smooth scalar
function f(x) — not a sum of squares — with the line-search minimizer.
Where the reference requires the user to hand-code f and its gradient
(``FirstOrderFunction::Evaluate``), here f is a pure JAX function and the
gradient is ``jax.grad``; an optional manifold makes the search run in
tangent space.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from skeres.core.line_search import LineSearchMinimizer
from skeres.core.options import SolverOptions
from skeres.core.summary import Summary
from skeres.core.types import MinimizerType, TerminationType
from skeres.models.manifolds import EuclideanManifold, Manifold

__all__ = ["GradientProblem", "GradientProblemSolver", "solve_gradient_problem"]


class GradientProblem:
    """f: (n,) -> scalar, with an optional manifold on x."""

    def __init__(self, f: Callable, size: int, manifold: Optional[Manifold] = None):
        self.f = f
        self.size = int(size)
        self.manifold = manifold or EuclideanManifold(size)
        if self.manifold.ambient_size != self.size:
            raise ValueError("manifold ambient size != problem size")


class _GradientEvaluator:
    """Duck-typed evaluator for LineSearchMinimizer over a GradientProblem.

    The tangent-space gradient is d f(plus(x, delta)) / d delta at 0 —
    identical to how the NLLS evaluator defines Jacobians."""

    def __init__(self, problem: GradientProblem, dtype=None):
        from skeres.core.evaluator import default_dtype

        self.p = problem
        self.dtype = dtype or default_dtype()
        self.num_tangent = problem.manifold.tangent_size

    def blocks(self, state):
        (x,) = state
        m = self.p.manifold

        def f_tangent(delta):
            return self.p.f(m.plus(x, delta))

        zero = jnp.zeros((self.num_tangent,), dtype=self.dtype)
        cost, g = jax.value_and_grad(f_tangent)(zero)
        return cost, g

    def gradient_and_diag(self, g):
        return g, jnp.ones_like(g)

    def cost(self, state):
        (x,) = state
        return self.p.f(x)

    def plus(self, state, step):
        (x,) = state
        return (self.p.manifold.plus(x, step.astype(x.dtype)),)

    def x_norm(self, state):
        (x,) = state
        return jnp.sqrt(jnp.sum(x.astype(self.dtype) ** 2))


def solve_gradient_problem(
    options: SolverOptions, problem: GradientProblem, x0
) -> tuple:
    """Returns (x_solution (np.ndarray), Summary)."""
    summary = Summary()
    summary.minimizer_type = MinimizerType.LINE_SEARCH
    start = time.time()

    ev = _GradientEvaluator(problem, dtype=options.dtype)
    minimizer = LineSearchMinimizer(ev, options, summary)
    state = (jnp.asarray(np.asarray(x0, dtype=np.float64), dtype=ev.dtype),)

    t0 = time.time()
    state = minimizer.minimize(state)
    summary.minimizer_time_in_seconds = time.time() - t0

    if summary.iterations:
        summary.final_cost = min(it.cost for it in summary.iterations)
    summary.total_time_in_seconds = time.time() - start
    return np.asarray(state[0], dtype=np.float64), summary


class GradientProblemSolver:
    """Class-style façade mirroring ``ceres::GradientProblemSolver``."""

    @staticmethod
    def solve(options: SolverOptions, problem: GradientProblem, x0):
        return solve_gradient_problem(options, problem, x0)
