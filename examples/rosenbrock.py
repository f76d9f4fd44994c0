#!/usr/bin/env python
"""Rosenbrock minimization with the GradientProblem solver.

Counterpart of the reference lineage's ``examples/rosenbrock.cc``: the
general unconstrained-minimization facade (cost + gradient, no residual
structure), solved with the line-search minimizer. The gradient comes from
``jax.grad`` instead of the reference's hand-derived expressions — the
autodiff IS the framework here.

    python -m examples.rosenbrock [--x -1.2] [--y 1.0]
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from skeres.core.gradient_problem import (
    GradientProblem,
    solve_gradient_problem,
)
from skeres.core.options import SolverOptions
from skeres.core.types import MinimizerType


def rosenbrock(p):
    x, y = p[0], p[1]
    return (1.0 - x) ** 2 + 100.0 * (y - x * x) ** 2


def main(x0=-1.2, y0=1.0):
    problem = GradientProblem(rosenbrock, size=2)
    options = SolverOptions(
        minimizer_type=MinimizerType.LINE_SEARCH,
        max_num_iterations=200,
    )
    params = np.array([x0, y0])
    solution, summary = solve_gradient_problem(options, problem, params)
    print(summary.full_report())
    print(f"initial: x={x0} y={y0}")
    print(f"final:   x={solution[0]:.6f} y={solution[1]:.6f} "
          f"f={summary.final_cost:.3e}")
    return summary, solution


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--x", type=float, default=-1.2)
    ap.add_argument("--y", type=float, default=1.0)
    args = ap.parse_args()
    main(args.x, args.y)
