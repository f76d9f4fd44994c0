"""Canned linear-least-squares fixture (reference:
``internal/ceres/linear_least_squares_problems.cc`` — "the backbone of
solver correctness" per SURVEY.md §5.2): small block-structured problems
with solutions known in closed form (numpy f64 lstsq / damped normal
equations), fed to EVERY linear solver, plus pairwise cross-checks.

The fixtures are built here (not copied): a BA-structured problem (two
"cameras" x four "points", one observation block per pair) and a mixed
problem with a parameter prior — enough structure to exercise the Schur
elimination, CGNR, and the dense paths on the same ground truth.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType, TerminationType

SOLVERS = [
    LinearSolverType.DENSE_NORMAL_CHOLESKY,
    LinearSolverType.DENSE_QR,
    LinearSolverType.CGNR,
    LinearSolverType.DENSE_SCHUR,
    LinearSolverType.ITERATIVE_SCHUR,
]


def _ba_structured_problem():
    """Linear BA-like fixture: cams (2 blocks x 2 params), pts (4 blocks x
    2 params), residual per (cam, pt) pair:  r = A@cam + B@pt - b with
    fixed per-pair A, B. Returns (problem, cams, pts, dense_target)."""
    rng = np.random.default_rng(42)
    n_cams, n_pts = 2, 4
    cam0 = rng.standard_normal((n_cams, 2))
    pt0 = rng.standard_normal((n_pts, 2))

    pairs = [(c, p) for c in range(n_cams) for p in range(n_pts)]
    A = rng.standard_normal((len(pairs), 2, 2))
    B = rng.standard_normal((len(pairs), 2, 2))
    b = rng.standard_normal((len(pairs), 2))

    problem = st.Problem()
    cams = problem.add_parameter_block_array(cam0.copy(), name="cams")
    pts = problem.add_parameter_block_array(pt0.copy(), name="pts")
    problem.set_schur_elimination_group(pts, 0)
    problem.set_schur_elimination_group(cams, 1)

    def resid(params, data):
        cam, pt = params
        a_, b_, rhs = data
        return a_ @ cam + b_ @ pt - rhs

    cam_idx = np.asarray([c for c, _ in pairs], dtype=np.int32)
    pt_idx = np.asarray([p for _, p in pairs], dtype=np.int32)
    problem.add_residual_blocks(
        resid, None, [(cams, cam_idx), (pts, pt_idx)],
        data=(jnp.asarray(A), jnp.asarray(B), jnp.asarray(b)),
    )

    # dense ground truth: J x = rhs in f64
    n = 2 * n_cams + 2 * n_pts
    J = np.zeros((2 * len(pairs), n))
    rhs = np.zeros(2 * len(pairs))
    for i, (c, p) in enumerate(pairs):
        J[2 * i : 2 * i + 2, 2 * c : 2 * c + 2] = A[i]
        J[2 * i : 2 * i + 2, 2 * n_cams + 2 * p : 2 * n_cams + 2 * p + 2] = B[i]
        rhs[2 * i : 2 * i + 2] = b[i]
    x_star, *_ = np.linalg.lstsq(J, rhs, rcond=None)
    cost_star = 0.5 * float(np.sum((J @ x_star - rhs) ** 2))
    return problem, cams, pts, (x_star, cost_star)


@pytest.mark.parametrize("solver", SOLVERS)
def test_linear_problem_every_solver_reaches_closed_form(solver):
    problem, cams, pts, (x_star, cost_star) = _ba_structured_problem()
    options = SolverOptions(
        linear_solver_type=solver,
        max_num_iterations=5,
        eta=1e-12,  # tight inner CG so the iterative paths match too
    )
    summary = st.solve(options, problem)
    assert summary.termination_type == TerminationType.CONVERGENCE
    got = np.concatenate(
        [np.asarray(cams.values).ravel(), np.asarray(pts.values).ravel()]
    )
    # cost converges quadratically; parameters lag at the function-tolerance
    # stop (same acceptance the reference uses: solutions agree on cost)
    np.testing.assert_allclose(got, x_star, rtol=0, atol=1e-5)
    np.testing.assert_allclose(summary.final_cost, cost_star, rtol=1e-10, atol=1e-12)


def test_pairwise_solver_agreement_nonlinear():
    """All solvers on the same small NONLINEAR problem must agree on the
    final cost within tolerance (the reference's system-test acceptance:
    solutions agree with each other, not with a golden number)."""
    finals = {}
    for solver in SOLVERS:
        problem, cams, pts, _ = _ba_structured_problem()

        def resid(params, data):
            cam, pt = params
            a_, b_, rhs = data
            lin = a_ @ cam + b_ @ pt - rhs
            return lin + 0.05 * lin**2  # mild nonlinearity

        # rebuild with the nonlinear residual over the same structure
        p2 = st.Problem()
        c2 = p2.add_parameter_block_array(np.asarray(cams.values).copy())
        q2 = p2.add_parameter_block_array(np.asarray(pts.values).copy())
        p2.set_schur_elimination_group(q2, 0)
        p2.set_schur_elimination_group(c2, 1)
        rng = np.random.default_rng(42)
        n_cams, n_pts = 2, 4
        rng.standard_normal((n_cams, 2)); rng.standard_normal((n_pts, 2))
        pairs = [(c, p) for c in range(n_cams) for p in range(n_pts)]
        A = rng.standard_normal((len(pairs), 2, 2))
        B = rng.standard_normal((len(pairs), 2, 2))
        b = rng.standard_normal((len(pairs), 2))
        p2.add_residual_blocks(
            resid, None,
            [(c2, np.asarray([c for c, _ in pairs], np.int32)),
             (q2, np.asarray([p for _, p in pairs], np.int32))],
            data=(jnp.asarray(A), jnp.asarray(B), jnp.asarray(b)),
        )
        s = st.solve(
            SolverOptions(linear_solver_type=solver, max_num_iterations=60,
                          eta=1e-10),
            p2,
        )
        assert s.termination_type == TerminationType.CONVERGENCE, solver
        finals[solver] = s.final_cost
    vals = list(finals.values())
    for v in vals[1:]:
        np.testing.assert_allclose(v, vals[0], rtol=1e-7)


def test_damped_step_matches_normal_equations():
    """One damped solve (fixed radius) must equal the f64 closed form
    (J_s^T J_s + clamp(diag_s)/radius) y = -g_s in the Jacobi-scaled space,
    for every solver (the per-solver unit check the reference runs against
    its canned problems)."""
    radius = 7.5
    for solver in SOLVERS:
        problem, cams, pts, _ = _ba_structured_problem()
        from skeres.core.evaluator import Evaluator
        from skeres.core.minimizer import TrustRegionMinimizer
        from skeres.core.schur import SchurSolver
        from skeres.core.summary import Summary

        program = problem.compile()
        ev = Evaluator(program)
        schur = None
        if solver in (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR):
            schur = SchurSolver(
                ev,
                iterative=solver == LinearSolverType.ITERATIVE_SCHUR,
                eta=1e-14,
                max_cg_iterations=500,
            )
        options = SolverOptions(eta=1e-14, max_linear_solver_iterations=500)
        minimizer = TrustRegionMinimizer(
            ev, options, Summary(), solver, schur_solver=schur
        )
        state = program.initial_state(ev.dtype)
        cost, g, diag, data, scale, _, _ = minimizer.linearize(state)

        g64 = np.asarray(g, np.float64)
        diag64 = np.asarray(diag, np.float64)
        scale64 = np.asarray(scale, np.float64)

        # dense J from the evaluator for the ground truth
        _, blocks = ev.blocks(state)
        jd, rd = ev.jacobian_dense(blocks)
        J = np.asarray(jd, np.float64) * scale64[None, :]
        lhs = J.T @ J + np.diag(np.clip(diag64 * scale64**2, 1e-6, 1e32) / radius)
        y_star = np.linalg.solve(lhs, -(g64 * scale64))

        gs = jnp.asarray(g) * scale
        diag_s = diag * scale * scale
        # linearize() returns pre-scaled Schur prep (or raw data for the
        # dense solvers); _solve_scaled dispatches correctly for both
        y, _, _ = minimizer._solve_scaled(
            data, gs, diag_s, jnp.asarray(radius, ev.dtype), scale
        )
        np.testing.assert_allclose(
            np.asarray(y), y_star, rtol=0, atol=1e-8,
            err_msg=str(solver),
        )
