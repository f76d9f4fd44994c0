"""SUBSET preconditioner (reference: subset_preconditioner.cc):
M = J_sub^T J_sub + D over user-tagged residual blocks, dense-factored,
CGNR only."""

import jax.numpy as jnp
import numpy as np
import pytest

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import (
    LinearSolverType,
    PreconditionerType,
    TerminationType,
)


def _build_chain(n=24, seed=0):
    """Anchored odometry chain (the well-conditioned bulk — tagged for
    the subset) + a few long-range closures (left out)."""
    rng = np.random.default_rng(seed)
    truth = np.cumsum(rng.normal(size=(n, 2)), axis=0)
    problem = st.Problem()
    blocks = [
        problem.add_parameter_block(truth[i] + rng.normal(size=2))
        for i in range(n)
    ]

    def prior(params, data):
        (x,) = params
        return 10.0 * (x - data)

    def odo(params, data):
        a, b = params
        return 5.0 * (b - a - data)

    subset_ids = [
        problem.add_residual_block(prior, None, [blocks[0]], data=truth[0])
    ]
    for i in range(n - 1):
        subset_ids.append(
            problem.add_residual_block(
                odo, None, [blocks[i], blocks[i + 1]],
                data=truth[i + 1] - truth[i],
            )
        )
    for i, j in [(0, n - 1), (2, n // 2), (1, n - 3)]:
        problem.add_residual_block(
            odo, None, [blocks[i], blocks[j]], data=truth[j] - truth[i]
        )
    return problem, blocks, truth, subset_ids


def _solve(precond, subset_ids=None, n=24):
    problem, blocks, truth, ids = _build_chain(n)
    options = SolverOptions(
        linear_solver_type=LinearSolverType.CGNR,
        preconditioner_type=precond,
        residual_blocks_for_subset_preconditioner=(
            ids if subset_ids is None else subset_ids
        )
        if precond == PreconditionerType.SUBSET
        else None,
        max_num_iterations=50,
    )
    s = st.solve(options, problem)
    x = np.stack([np.asarray(b.value) for b in blocks])
    return s, x, truth


def test_subset_preconditioner_converges_and_beats_jacobi():
    s_sub, x_sub, truth = _solve(PreconditionerType.SUBSET)
    s_jac, x_jac, _ = _solve(PreconditionerType.JACOBI)
    assert s_sub.termination_type == TerminationType.CONVERGENCE, s_sub.message
    np.testing.assert_allclose(x_sub, truth, atol=1e-4)
    np.testing.assert_allclose(x_sub, x_jac, atol=1e-4)
    # the subset normal matrix is nearly the full one: PCG should need
    # far fewer iterations than diagonal scaling
    it_sub = sum(it.linear_solver_iterations for it in s_sub.iterations)
    it_jac = sum(it.linear_solver_iterations for it in s_jac.iterations)
    assert it_sub < 0.5 * it_jac, (it_sub, it_jac)


def test_subset_requires_tagged_blocks():
    problem, blocks, truth, ids = _build_chain(8)
    options = SolverOptions(
        linear_solver_type=LinearSolverType.CGNR,
        preconditioner_type=PreconditionerType.SUBSET,
    )
    s = st.solve(options, problem)
    assert s.termination_type == TerminationType.FAILURE
    assert "residual_blocks_for_subset_preconditioner" in s.message


def test_subset_downgrades_when_too_many_parameters():
    problem, blocks, truth, ids = _build_chain(8)
    options = SolverOptions(
        linear_solver_type=LinearSolverType.CGNR,
        preconditioner_type=PreconditionerType.SUBSET,
        residual_blocks_for_subset_preconditioner=ids,
        subset_preconditioner_max_parameters=3,
    )
    s = st.solve(options, problem)
    assert s.termination_type == TerminationType.CONVERGENCE, s.message
    assert s.preconditioner_type_used == PreconditionerType.JACOBI
