#!/usr/bin/env python
"""Minimize an interpolated sampled function (counterpart of the reference
lineage's ``examples/sampled_function/sampled_function.cc``): the cost is
known only at integer samples of f(x) = (x - 4.5)^2; a differentiable
Catmull-Rom interpolant (ops/interpolation.py CubicInterpolator) makes it
usable as a residual, and the solver finds the minimum between samples.

    python -m examples.sampled_function
"""

import jax.numpy as jnp
import numpy as np

import skeres as st
from skeres.core.options import SolverOptions
from skeres.ops.interpolation import CubicInterpolator


def main():
    values = np.array([(i - 4.5) ** 2 for i in range(10)])
    interpolator = CubicInterpolator(jnp.asarray(values))

    problem = st.Problem()
    x = problem.add_parameter_block([1.0])

    def resid(params, data):
        (xv,) = params
        return jnp.reshape(interpolator.evaluate(xv[0]), (1,))

    problem.add_residual_block(resid, None, [x])
    summary = st.solve(
        SolverOptions(max_num_iterations=100, minimizer_progress_to_stdout=True),
        problem,
    )
    print(summary.brief_report())
    print(f"expected x: 4.5, actual x: {float(np.asarray(x.value)[0]):.6f}")
    return float(np.asarray(x.value)[0])


if __name__ == "__main__":
    main()
