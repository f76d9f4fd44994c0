#!/usr/bin/env python
"""Powell's singular function (reference: ``examples/powell.cc``).

    f1 = x1 + 10 x2;  f2 = sqrt(5) (x3 - x4)
    f3 = (x2 - 2 x3)^2;  f4 = sqrt(10) (x1 - x4)^2

Converges to x = 0, cost -> 0 (BASELINE.md config 1 oracle).
"""

import argparse

import jax.numpy as jnp

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--linear_solver", default="DENSE_QR")
    ap.add_argument("--max_iterations", type=int, default=100)
    args = ap.parse_args()

    problem = st.Problem()
    x1 = problem.add_parameter_block([3.0])
    x2 = problem.add_parameter_block([-1.0])
    x3 = problem.add_parameter_block([0.0])
    x4 = problem.add_parameter_block([1.0])

    def f1(p, _):
        a, b = p
        return a + 10.0 * b

    def f2(p, _):
        a, b = p
        return jnp.sqrt(5.0) * (a - b)

    def f3(p, _):
        a, b = p
        return (a - 2.0 * b) ** 2

    def f4(p, _):
        a, b = p
        return jnp.sqrt(10.0) * (a - b) ** 2

    problem.add_residual_block(f1, None, [x1, x2])
    problem.add_residual_block(f2, None, [x3, x4])
    problem.add_residual_block(f3, None, [x2, x3])
    problem.add_residual_block(f4, None, [x1, x4])

    options = SolverOptions(
        linear_solver_type=LinearSolverType[args.linear_solver],
        max_num_iterations=args.max_iterations,
        minimizer_progress_to_stdout=True,
    )
    summary = st.solve(options, problem)
    print(summary.full_report())
    print(
        "Final x1 = {:.3e}, x2 = {:.3e}, x3 = {:.3e}, x4 = {:.3e}".format(
            float(x1.value[0]),
            float(x2.value[0]),
            float(x3.value[0]),
            float(x4.value[0]),
        )
    )


if __name__ == "__main__":
    main()
