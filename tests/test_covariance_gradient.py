"""Covariance (dense SVD) and GradientProblem tests.

Counterpart of the reference lineage's ``covariance_test.cc`` (analytic
small-system oracle) and ``gradient_problem_solver_test.cc`` (Rosenbrock).
"""

import jax.numpy as jnp
import numpy as np

import skeres as st
from skeres.core.covariance import Covariance, CovarianceOptions
from skeres.core.gradient_problem import (
    GradientProblem,
    solve_gradient_problem,
)
from skeres.core.options import SolverOptions
from skeres.core.types import TerminationType


def test_covariance_linear_system_oracle():
    """Linear residuals r = A x - b: covariance must equal (A^T A)^{-1}."""
    rng = np.random.default_rng(5)
    a_mat = rng.normal(size=(6, 3))
    b_vec = rng.normal(size=(6,))

    problem = st.Problem()
    x = problem.add_parameter_block(np.zeros(3))

    def resid(params, data):
        (p,) = params
        return jnp.asarray(a_mat) @ p - jnp.asarray(b_vec)

    problem.add_residual_block(resid, None, [x])
    st.solve(SolverOptions(max_num_iterations=50), problem)

    cov = Covariance()
    assert cov.compute(problem)
    block = cov.get_covariance_block(x, x)
    expected = np.linalg.inv(a_mat.T @ a_mat)
    np.testing.assert_allclose(block, expected, rtol=1e-6, atol=1e-10)


def test_covariance_rank_deficient_detection():
    """A rank-deficient J^T J must fail compute() unless null space allowed."""
    problem = st.Problem()
    x = problem.add_parameter_block([1.0, 1.0])

    def resid(params, data):
        (p,) = params
        return (p[0] + p[1] - 2.0)[None]  # only the sum is observable

    problem.add_residual_block(resid, None, [x])
    cov = Covariance()
    assert not cov.compute(problem)
    cov2 = Covariance(CovarianceOptions(null_space_rank=1))
    assert cov2.compute(problem)
    blk = cov2.get_covariance_block(x, x)
    assert np.isfinite(blk).all()


def test_gradient_problem_rosenbrock():
    """Reference: examples/rosenbrock.cc — LBFGS line search to (1, 1)."""

    def rosenbrock(x):
        return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2

    gp = GradientProblem(rosenbrock, 2)
    x_sol, summary = solve_gradient_problem(
        SolverOptions(max_num_iterations=300), gp, np.array([-1.2, 1.0])
    )
    assert summary.termination_type == TerminationType.CONVERGENCE, summary.message
    np.testing.assert_allclose(x_sol, [1.0, 1.0], atol=1e-5)


def test_gradient_problem_on_sphere_manifold():
    """Minimize a linear function on the unit sphere: the optimum is the
    (negative) coefficient direction; exercises manifold line search."""
    c = np.array([1.0, 2.0, 2.0]) / 3.0

    def f(x):
        return -jnp.dot(jnp.asarray(c), x)

    gp = GradientProblem(f, 3, manifold=st.SphereManifold(3))
    x0 = np.array([1.0, 0.0, 0.0])
    x_sol, summary = solve_gradient_problem(
        SolverOptions(max_num_iterations=200), gp, x0
    )
    np.testing.assert_allclose(np.linalg.norm(x_sol), 1.0, atol=1e-8)
    np.testing.assert_allclose(x_sol, c / np.linalg.norm(c), atol=1e-5)


def test_covariance_schur_complement_matches_dense_svd():
    """SCHUR_COMPLEMENT covariance (block inverse through the reduced
    camera system, never forming the full J^T J — the batched
    counterpart of [ceres: covariance_impl.cc] SPARSE_QR on BA structure)
    must reproduce the DENSE_SVD path on every block-pair type:
    camera-camera, camera-point, point-point (same and distinct points)."""
    from skeres.core.types import CovarianceAlgorithmType, LinearSolverType
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=5, num_points=30, observations_per_point=4)
    problem, cameras, points = build_bal_problem(bal)
    # anchor the gauge so J^T J is full rank on the free coordinates
    # (2 constant cameras = 18 fixed dof > the 7 gauge dof)
    problem.set_parameter_block_constant(cameras[0])
    problem.set_parameter_block_constant(cameras[1])

    st.solve(
        SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR,
            max_num_iterations=25,
        ),
        problem,
    )

    dense = Covariance()
    assert dense.compute(problem)
    schur = Covariance(
        CovarianceOptions(
            algorithm_type=CovarianceAlgorithmType.SCHUR_COMPLEMENT
        )
    )
    assert schur.compute(problem)

    pairs = [
        (cameras[2], cameras[2]),
        (cameras[2], cameras[4]),
        (cameras[3], points[7]),
        (points[11], cameras[2]),
        (points[3], points[3]),
        (points[3], points[19]),
        # constant camera: covariance must be zero in both paths
        (cameras[0], cameras[2]),
    ]
    for b1, b2 in pairs:
        want = dense.get_covariance_block_in_tangent_space(b1, b2)
        got = schur.get_covariance_block_in_tangent_space(b1, b2)
        np.testing.assert_allclose(
            got, want, rtol=1e-5, atol=1e-9,
            err_msg=f"block pair {(b1.group_index, b1.row)} x "
                    f"{(b2.group_index, b2.row)}",
        )
    # ambient-space lift agrees too (manifold plus-Jacobians)
    want = dense.get_covariance_block(cameras[2], points[7])
    got = schur.get_covariance_block(cameras[2], points[7])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_covariance_schur_singular_point_block_returns_false():
    """A point with a single 2D observation makes its C_p = E_p^T E_p
    (3x3) rank-2; the closed-form cofactor inverse is then non-finite and
    SCHUR_COMPLEMENT compute() must return False cleanly (reference:
    Covariance::Compute returning false on rank deficiency), not crash in
    the SVD or hand back garbage point blocks."""
    from skeres.core.types import CovarianceAlgorithmType
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=4, num_points=12, observations_per_point=1)
    problem, cameras, points = build_bal_problem(bal)
    problem.set_parameter_block_constant(cameras[0])
    problem.set_parameter_block_constant(cameras[1])

    schur = Covariance(
        CovarianceOptions(
            algorithm_type=CovarianceAlgorithmType.SCHUR_COMPLEMENT
        )
    )
    assert schur.compute(problem) is False


def test_covariance_apply_loss_function_false():
    """apply_loss_function=False (reference: covariance.h) must evaluate
    the covariance from the UNWEIGHTED Jacobians: with a robust loss on
    the problem, it equals the covariance of the identical loss-free
    problem; with the default True it differs."""
    from skeres.ops.loss import CauchyLoss

    rng = np.random.default_rng(7)
    a_mat = rng.normal(size=(8, 3))
    b_vec = rng.normal(size=(8,))

    def make(loss):
        problem = st.Problem()
        x = problem.add_parameter_block(np.full(3, 0.5))

        def resid(params, data):
            (p,) = params
            return jnp.asarray(a_mat) @ p - jnp.asarray(b_vec)

        problem.add_residual_block(resid, loss, [x])
        return problem, x

    p_robust, x_r = make(CauchyLoss(0.3))
    p_plain, x_p = make(None)

    cov_no_loss = Covariance(CovarianceOptions(apply_loss_function=False))
    assert cov_no_loss.compute(p_robust)
    cov_plain = Covariance()
    assert cov_plain.compute(p_plain)
    np.testing.assert_allclose(
        cov_no_loss.get_covariance_block(x_r, x_r),
        cov_plain.get_covariance_block(x_p, x_p),
        rtol=1e-10,
    )

    cov_with_loss = Covariance()
    assert cov_with_loss.compute(p_robust)
    assert not np.allclose(
        cov_with_loss.get_covariance_block(x_r, x_r),
        cov_plain.get_covariance_block(x_p, x_p),
        rtol=1e-3,
    )
