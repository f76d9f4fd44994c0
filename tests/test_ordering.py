"""Automatic Schur elimination-ordering discovery (reference:
``reorder_program.cc`` ComputeStableSchurOrdering,
``parameter_block_ordering.cc`` IndependentSetOrdering)."""

import numpy as np

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.ordering import compute_schur_ordering, independent_groups
from skeres.core.types import LinearSolverType, TerminationType
from skeres.io.bal import build_bal_problem, synthetic_bal


def test_bal_points_discovered_as_independent():
    bal = synthetic_bal(num_cameras=5, num_points=40, observations_per_point=3)
    # build WITHOUT declaring the schur ordering
    problem, cams, pts = build_bal_problem(bal, use_schur_ordering=False)
    program = problem.compile()
    # points (group of pts) are independent (one point slot per residual);
    # cameras are too at the group level (one camera slot per residual) —
    # the ordering must pick the LARGER group: points
    indep = independent_groups(program)
    assert pts.group_index in indep
    assert compute_schur_ordering(program) == pts.group_index


def test_schur_solver_works_without_declared_ordering():
    """SCHUR solvers with no declared groups must auto-discover the
    elimination group instead of downgrading (reference preprocessor)."""
    bal = synthetic_bal(num_cameras=5, num_points=40, observations_per_point=3)
    problem, _, _ = build_bal_problem(bal, use_schur_ordering=False)
    summary = st.solve(
        SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            max_num_iterations=40,
        ),
        problem,
    )
    assert summary.linear_solver_type_used == LinearSolverType.ITERATIVE_SCHUR
    assert summary.termination_type == TerminationType.CONVERGENCE


def test_coupled_group_not_independent():
    """A residual touching two blocks of the same group disqualifies it."""
    import jax.numpy as jnp

    problem = st.Problem()
    xs = problem.add_parameter_block_array(np.zeros((6, 2)))

    def pair(params, data):
        a, b = params
        return a - b + 1.0

    problem.add_residual_blocks(
        pair, None,
        [(xs, np.arange(5, dtype=np.int32)),
         (xs, np.arange(1, 6, dtype=np.int32))],
    )
    program = problem.compile()
    assert independent_groups(program) == []
    assert compute_schur_ordering(program) is None
    # SCHUR request downgrades to dense normal cholesky
    summary = st.solve(
        SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR,
            max_num_iterations=20,
        ),
        problem,
    )
    assert (
        summary.linear_solver_type_used
        == LinearSolverType.DENSE_NORMAL_CHOLESKY
    )
