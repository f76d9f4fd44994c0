"""More-Garbow-Hillstrom convergence certification — the complete
35-function set (42 parametrized cases including the Watson/Penalty/
Chebyquad size variants).

Counterpart of the reference lineage's ``examples/more_garbow_hillstrom.cc``
and the NIST-style certification in ``system_test.cc``: every test problem
must reach a certified minimum from the paper's standard starting point.
The function registry (starts, certified F* values including documented
local minima, per-problem tolerances) lives in ``skeres/models/mgh.py``
and is shared with the ``examples/more_garbow_hillstrom.py`` scoreboard.
"""

import numpy as np
import pytest

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType
from skeres.models.mgh import PROBLEMS


def _solve(prob):
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
        # certification-grade convergence: Watson-12's certified 4.72238e-10
        # and Penalty2's 2.93660e-4 are only reached with tight tolerances
        function_tolerance=1e-16,
        gradient_tolerance=1e-16,
        parameter_tolerance=1e-16,
    )
    summary = st.solve(options, problem)
    return summary, np.asarray(x.value)


@pytest.mark.parametrize(
    "num", sorted(PROBLEMS), ids=[PROBLEMS[n].name for n in sorted(PROBLEMS)]
)
def test_mgh(num):
    prob = PROBLEMS[num]
    summary, x = _solve(prob)
    f = 2.0 * summary.final_cost
    assert prob.certified(f), (
        f"{prob.name}: reached F={f:.6e}, certified {prob.fstars}"
    )
    has_zero = 0.0 in prob.fstars
    at_global = f <= prob.zero_atol if has_zero else True
    if prob.expected_x is not None and at_global:
        np.testing.assert_allclose(x, prob.expected_x, atol=prob.x_atol)
