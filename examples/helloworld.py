#!/usr/bin/env python
"""Hello world: minimize 0.5 (10 - x)^2.

Counterpart of the reference lineage's ``examples/helloworld.cc`` /
``helloworld_autodiff.cc`` — but there is no Jet or CostFunction class:
the residual is a pure JAX function and the Jacobian comes from jvp.
"""

import skeres as st
from skeres.core.options import SolverOptions


def main():
    problem = st.Problem()
    x = problem.add_parameter_block([0.5])

    def f(params, data):
        (xv,) = params
        return 10.0 - xv

    problem.add_residual_block(f, None, [x])

    options = SolverOptions(minimizer_progress_to_stdout=True)
    summary = st.solve(options, problem)
    print(summary.brief_report())
    print(f"x : 0.5 -> {float(x.value[0]):.6f}")


if __name__ == "__main__":
    main()
