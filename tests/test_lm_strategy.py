"""LM strategy sequence tests (reference:
``internal/ceres/levenberg_marquardt_strategy_test.cc``): pin the exact D
clamping and the radius/decrease-factor recurrence over a recorded
accept/reject trajectory, independent of end-to-end convergence."""

import jax.numpy as jnp
import numpy as np

import skeres as st
from skeres.core.linear_solvers import lm_diagonal
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType


def test_lm_diagonal_clamping():
    """D^2 = clamp(diag(J^T J), min, max) / radius — exact formula."""
    diag = jnp.asarray([0.0, 1e-20, 0.5, 7.0, 1e40])
    out = np.asarray(lm_diagonal(diag, mu=0.25, min_diagonal=1e-6, max_diagonal=1e32))
    want = np.clip(np.asarray(diag), 1e-6, 1e32) * 0.25
    np.testing.assert_allclose(out, want, rtol=0, atol=0)


def _replay_radius(summary, options):
    """Re-run the reference radius recurrence over the recorded
    accept/reject + relative-decrease trajectory and check that each
    iteration's trust_region_radius matches what the minimizer used."""
    radius = options.initial_trust_region_radius
    decrease_factor = 2.0
    rows = summary.iterations[1:]  # iteration 0 takes no step
    assert rows, "no iterations recorded"
    for it in rows:
        np.testing.assert_allclose(
            it.trust_region_radius, radius, rtol=1e-12,
            err_msg=f"iteration {it.iteration}",
        )
        if not it.step_is_valid:
            radius = max(
                radius / decrease_factor, options.min_trust_region_radius
            )
            decrease_factor *= 2.0
            continue
        if it.step_is_successful:
            q = it.relative_decrease
            radius = radius / max(1.0 / 3.0, 1.0 - (2.0 * q - 1.0) ** 3)
            radius = min(radius, options.max_trust_region_radius)
            decrease_factor = 2.0
        else:
            radius = radius / decrease_factor
            decrease_factor *= 2.0


def _rosenbrock_problem():
    problem = st.Problem()
    xy = problem.add_parameter_block([-1.2, 1.0])

    def r(params, data):
        (p,) = params
        return jnp.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])

    problem.add_residual_block(r, None, [xy])
    return problem


def test_radius_sequence_accepted_and_rejected_steps():
    """Rosenbrock from the classic start generates a mix of accepted and
    rejected LM steps; the recorded radius sequence must follow the
    reference recurrence exactly (radius /= max(1/3, 1-(2q-1)^3) on accept
    with decrease-factor reset, radius /= 2,4,8,... on consecutive
    rejects)."""
    options = SolverOptions(
        max_num_iterations=50,
        # monotonic: relative_decrease is then the plain (pre-history)
        # quality measure the recurrence sees
        use_nonmonotonic_steps=False,
        initial_trust_region_radius=1e4,
    )
    problem = _rosenbrock_problem()
    summary = st.solve(options, problem)
    assert summary.num_unsuccessful_steps > 0, "want at least one rejection"
    assert summary.num_successful_steps > 0
    _replay_radius(summary, options)


def test_radius_sequence_pure_descent():
    """A linear problem accepts every step with q ~= 1: radius must grow by
    exactly 3x per iteration (1 - (2q-1)^3 -> 1/3 branch) up to the cap."""
    options = SolverOptions(
        max_num_iterations=6,
        initial_trust_region_radius=1e4,
        max_trust_region_radius=1e16,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
    )
    problem = st.Problem()
    x = problem.add_parameter_block([3.0])

    def r(params, data):
        (v,) = params
        return 2.0 * v - 10.0

    problem.add_residual_block(r, None, [x])
    summary = st.solve(options, problem)
    _replay_radius(summary, options)
    radii = [it.trust_region_radius for it in summary.iterations[1:]]
    for a, b in zip(radii, radii[1:]):
        np.testing.assert_allclose(b / a, 3.0, rtol=1e-9)


def test_min_max_lm_diagonal_affect_step():
    """Degenerate clamp bounds must change the damped step (proves the
    clamp is live in the solve path, as in the reference strategy test)."""
    def solve_with(min_d, max_d):
        problem = _rosenbrock_problem()
        options = SolverOptions(
            max_num_iterations=1,
            min_lm_diagonal=min_d,
            max_lm_diagonal=max_d,
            initial_trust_region_radius=1.0,
            linear_solver_type=LinearSolverType.DENSE_NORMAL_CHOLESKY,
            function_tolerance=0.0,
            gradient_tolerance=0.0,
            parameter_tolerance=0.0,
        )
        summary = st.solve(options, problem)
        return summary.iterations[1].step_norm

    default = solve_with(1e-6, 1e32)
    heavy = solve_with(1e6, 1e32)  # min clamp dominates -> tiny step
    assert heavy < default * 0.1, (heavy, default)
