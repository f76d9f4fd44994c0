#!/usr/bin/env python
"""More-Garbow-Hillstrom test-set scoreboard.

Counterpart of the reference lineage's ``examples/more_garbow_hillstrom.cc``
binary: solves every function of the MGH (TOMS 1981) test set from the
paper's standard starting point and prints the reached vs certified
minimum (sum-of-squares F convention). Documented local minima reachable
from the standard start count as certified, exactly like the reference's
expected-value tables.

    python -m examples.more_garbow_hillstrom           # all 35
    python -m examples.more_garbow_hillstrom --problem 14
"""

import argparse

import numpy as np

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType
from skeres.models.mgh import PROBLEMS


def solve(prob):
    problem = st.Problem()
    x = problem.add_parameter_block(np.asarray(prob.x0, dtype=np.float64))

    def fn(params, data):
        (p,) = params
        return prob.residual(p)

    problem.add_residual_block(fn, None, [x])
    options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_QR,
        max_num_iterations=prob.max_iterations,
        use_nonmonotonic_steps=True,
        function_tolerance=1e-16,
        gradient_tolerance=1e-16,
        parameter_tolerance=1e-16,
    )
    summary = st.solve(options, problem)
    return 2.0 * summary.final_cost


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", type=int, default=None,
                    help="registry key (1-35 + size variants); default all")
    args = ap.parse_args()

    keys = [args.problem] if args.problem else sorted(PROBLEMS)
    ok = 0
    print(f"{'#':>4} {'name':<28}{'reached F':>14}{'certified F*':>16}  status")
    for k in keys:
        prob = PROBLEMS[k]
        f = solve(prob)
        good = prob.certified(f)
        ok += good
        cert = ", ".join(f"{v:.6g}" for v in prob.fstars)
        print(f"{k:>4} {prob.name:<28}{f:>14.6e}{cert:>16}  "
              f"{'ok' if good else 'FAILED'}")
    print(f"\n{ok}/{len(keys)} certified")
    return ok, len(keys)


if __name__ == "__main__":
    main()
