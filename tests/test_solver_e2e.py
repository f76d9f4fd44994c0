"""End-to-end solver tests: the config-1 acceptance workloads
(reference lineage: ``examples/powell.cc``, ``examples/curve_fitting.cc``,
``examples/robust_curve_fitting.cc``, ``internal/ceres/system_test.cc``).

Oracle values (SURVEY.md §7): Powell converges to cost -> 0 (x -> 0);
curve fitting is checked against a scipy.optimize.least_squares oracle run
on identical data (no memorized numbers).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType, TerminationType


def _solve_powell(linear_solver, **kw):
    problem = st.Problem()
    x1 = problem.add_parameter_block([3.0])
    x2 = problem.add_parameter_block([-1.0])
    x3 = problem.add_parameter_block([0.0])
    x4 = problem.add_parameter_block([1.0])

    def f1(params, data):
        (a, b) = params
        return a + 10.0 * b

    def f2(params, data):
        (a, b) = params
        return jnp.sqrt(5.0) * (a - b)

    def f3(params, data):
        (a, b) = params
        return (a - 2.0 * b) ** 2

    def f4(params, data):
        (a, b) = params
        return jnp.sqrt(10.0) * (a - b) ** 2

    problem.add_residual_block(f1, None, [x1, x2])
    problem.add_residual_block(f2, None, [x3, x4])
    problem.add_residual_block(f3, None, [x2, x3])
    problem.add_residual_block(f4, None, [x1, x4])

    options = SolverOptions(
        linear_solver_type=linear_solver,
        max_num_iterations=100,
        **kw,
    )
    summary = st.solve(options, problem)
    return problem, summary, (x1, x2, x3, x4)


@pytest.mark.parametrize(
    "linear_solver",
    [
        LinearSolverType.DENSE_QR,
        LinearSolverType.DENSE_NORMAL_CHOLESKY,
        LinearSolverType.CGNR,
    ],
)
def test_powell(linear_solver):
    problem, summary, xs = _solve_powell(linear_solver)
    assert summary.termination_type == TerminationType.CONVERGENCE, summary.message
    assert summary.final_cost < 1e-10
    for x in xs:
        assert abs(float(x.value[0])) < 2e-2


def test_powell_report():
    problem, summary, xs = _solve_powell(LinearSolverType.DENSE_QR)
    report = summary.full_report()
    assert "Parameter blocks" in report
    assert "CONVERGENCE" in report
    assert "Final cost" in summary.brief_report()


def _curve_data(outliers=False):
    rng = np.random.default_rng(1234)
    x = np.linspace(0.0, 5.0, 67)
    y = np.exp(0.3 * x + 0.1) + rng.normal(0.0, 0.2, size=x.shape)
    if outliers:
        y = y.copy()
        y[::9] += 10.0
    return x, y


def exponential_residual(params, data):
    (p,) = params
    return data[1:2] - jnp.exp(p[0] * data[0] + p[1])


def _build_curve_problem(x, y, loss=None):
    problem = st.Problem()
    mc = problem.add_parameter_block([0.0, 0.0])
    problem.add_residual_blocks(
        exponential_residual,
        loss,
        [(mc.array, np.zeros(len(x), dtype=np.int32))],
        data=np.stack([x, y], axis=1),
        name="expfit",
    )
    return problem, mc


def test_curve_fitting_matches_scipy_oracle():
    from scipy.optimize import least_squares

    x, y = _curve_data()
    problem, mc = _build_curve_problem(x, y)
    options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_QR, max_num_iterations=100
    )
    summary = st.solve(options, problem)
    assert summary.termination_type == TerminationType.CONVERGENCE, summary.message

    oracle = least_squares(
        lambda p: y - np.exp(p[0] * x + p[1]),
        x0=[0.0, 0.0],
        xtol=1e-12,
        ftol=1e-12,
        gtol=1e-12,
    )
    m, c = mc.value
    np.testing.assert_allclose([m, c], oracle.x, atol=1e-5)
    np.testing.assert_allclose(summary.final_cost, oracle.cost, rtol=1e-8)
    # standard Ceres tutorial ballpark: m ~ 0.2916, c ~ 0.1314 with their seed
    assert abs(m - 0.3) < 0.1 and abs(c - 0.1) < 0.2


def test_robust_curve_fitting_cauchy():
    x, y = _curve_data(outliers=True)
    problem, mc = _build_curve_problem(x, y, loss=st.CauchyLoss(0.5))
    options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_QR, max_num_iterations=200
    )
    summary = st.solve(options, problem)
    assert summary.termination_type == TerminationType.CONVERGENCE, summary.message
    m, c = mc.value
    # robust fit should stay near the ground truth despite outliers
    assert abs(m - 0.3) < 0.1
    assert abs(c - 0.1) < 0.35


def test_constant_parameter_block():
    """Holding a block constant keeps it fixed and still converges."""
    problem = st.Problem()
    a = problem.add_parameter_block([2.0])
    b = problem.add_parameter_block([5.0])
    problem.set_parameter_block_constant(a)

    def resid(params, data):
        (pa, pb) = params
        return jnp.concatenate([pa - 1.0, pb - 3.0])

    problem.add_residual_block(resid, None, [a, b])
    summary = st.solve(SolverOptions(max_num_iterations=50), problem)
    assert summary.termination_type == TerminationType.CONVERGENCE
    assert float(a.value[0]) == 2.0  # untouched
    np.testing.assert_allclose(float(b.value[0]), 3.0, atol=1e-8)
    # fixed residual (a - 1) = 1 remains: final cost = 0.5
    np.testing.assert_allclose(summary.final_cost, 0.5, atol=1e-8)


def test_bounds_projection():
    """Upper/lower bounds clamp the iterates (projected steps)."""
    problem = st.Problem()
    p = problem.add_parameter_block([5.0])
    problem.set_parameter_lower_bound(p, 0, 2.0)

    def resid(params, data):
        (x,) = params
        return x  # pulls x toward 0, bound stops it at 2

    problem.add_residual_block(resid, None, [p])
    summary = st.solve(SolverOptions(max_num_iterations=60), problem)
    assert float(p.value[0]) >= 2.0 - 1e-12
    np.testing.assert_allclose(float(p.value[0]), 2.0, atol=1e-6)


def test_callbacks_and_abort():
    from skeres.core.types import CallbackReturnType

    problem, mc = _build_curve_problem(*_curve_data())
    seen = []

    def cb(it):
        seen.append(it.iteration)
        if it.iteration >= 2:
            return CallbackReturnType.SOLVER_ABORT
        return CallbackReturnType.SOLVER_CONTINUE

    summary = st.solve(
        SolverOptions(max_num_iterations=100, callbacks=[cb]), problem
    )
    assert summary.termination_type == TerminationType.USER_FAILURE
    assert max(seen) == 2


def test_powell_dogleg():
    from skeres.core.types import TrustRegionStrategyType

    problem, summary, xs = _solve_powell(
        LinearSolverType.DENSE_NORMAL_CHOLESKY,
        trust_region_strategy_type=TrustRegionStrategyType.DOGLEG,
    )
    assert summary.termination_type == TerminationType.CONVERGENCE, summary.message
    assert summary.final_cost < 1e-10


def test_powell_subspace_dogleg():
    """2-D subspace dogleg (reference: dogleg_strategy.cc
    ComputeSubspaceDoglegStep) must converge on Powell and, on a
    rejected-step trajectory (Rosenbrock), do no worse than traditional
    dogleg in iterations-to-converge class."""
    from skeres.core.types import DoglegType, TrustRegionStrategyType

    problem, summary, xs = _solve_powell(
        LinearSolverType.DENSE_NORMAL_CHOLESKY,
        trust_region_strategy_type=TrustRegionStrategyType.DOGLEG,
        dogleg_type=DoglegType.SUBSPACE_DOGLEG,
    )
    assert summary.termination_type == TerminationType.CONVERGENCE, summary.message
    assert summary.final_cost < 1e-10


def test_subspace_dogleg_rosenbrock_converges():
    from skeres.core.types import DoglegType, TrustRegionStrategyType

    problem = st.Problem()
    xy = problem.add_parameter_block([-1.2, 1.0])

    def r(params, data):
        (p,) = params
        return jnp.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])

    problem.add_residual_block(r, None, [xy])
    summary = st.solve(
        SolverOptions(
            max_num_iterations=200,
            trust_region_strategy_type=TrustRegionStrategyType.DOGLEG,
            dogleg_type=DoglegType.SUBSPACE_DOGLEG,
        ),
        problem,
    )
    assert summary.termination_type == TerminationType.CONVERGENCE, summary.message
    x = np.asarray(xy.value)
    np.testing.assert_allclose(x, [1.0, 1.0], atol=1e-6)


def test_loss_function_wrapper_reset():
    """LossFunctionWrapper: swapping the wrapped loss between solves
    changes the NEXT solve (reference: loss_function.h; jit semantics
    documented on the class)."""
    from skeres.ops.loss import HuberLoss, LossFunctionWrapper

    wrapper = LossFunctionWrapper(HuberLoss(0.1))

    def run():
        x, y = _curve_data()
        problem = st.Problem()
        mc = problem.add_parameter_block([0.0, 0.0])

        def resid(params, data):
            (m_c,) = params
            xx, yy = data
            return jnp.reshape(yy - jnp.exp(m_c[0] * xx + m_c[1]), (1,))

        problem.add_residual_blocks(
            resid, wrapper, [(mc, np.zeros(len(x), dtype=np.int32))],
            data=(jnp.asarray(x), jnp.asarray(y)),
        )
        return st.solve(SolverOptions(max_num_iterations=60), problem)

    s_huber = run()
    wrapper.reset(None)  # trivial loss on the next solve
    s_trivial = run()
    # robustified and trivial final costs must differ (the swap took effect)
    assert abs(s_huber.final_cost - s_trivial.final_cost) > 1e-6


def test_curve_fitting_line_search_lbfgs():
    from skeres.core.types import MinimizerType

    x, y = _curve_data()
    problem, mc = _build_curve_problem(x, y)
    options = SolverOptions(
        minimizer_type=MinimizerType.LINE_SEARCH,
        max_num_iterations=200,
    )
    summary = st.solve(options, problem)
    assert summary.termination_type in (
        TerminationType.CONVERGENCE,
        TerminationType.NO_CONVERGENCE,
    ), summary.message
    m, c = mc.value
    assert abs(m - 0.3) < 0.1 and abs(c - 0.1) < 0.2


def test_bounds_active_at_coupled_optimum():
    """Constrained optimum strictly ON a bound of a coupled 2-parameter
    problem (reference: trust_region_minimizer.cc bounds semantics).
    min (x0+x1-4)^2 + (x0-x1)^2 s.t. x0 <= 1: the unconstrained optimum is
    (2, 2); the constrained one is x0 = 1, x1 = 2, cost = 1. Requires
    model_cost_change to see the PROJECTED step — with the naive
    (unprojected) model the step quality is corrupted whenever the bound
    is active and the solve stalls short of the boundary optimum."""
    problem = st.Problem()
    p = problem.add_parameter_block([0.0, 0.0])
    problem.set_parameter_upper_bound(p, 0, 1.0)

    def r1(params, data):
        (x,) = params
        return jnp.reshape(x[0] + x[1] - 4.0, (1,))

    def r2(params, data):
        (x,) = params
        return jnp.reshape(x[0] - x[1], (1,))

    problem.add_residual_block(r1, None, [p])
    problem.add_residual_block(r2, None, [p])
    summary = st.solve(SolverOptions(max_num_iterations=200), problem)
    x = np.asarray(p.value)
    assert x[0] <= 1.0 + 1e-12
    np.testing.assert_allclose(x[0], 1.0, atol=1e-5)
    np.testing.assert_allclose(x[1], 2.0, atol=1e-5)
    np.testing.assert_allclose(summary.final_cost, 1.0, atol=1e-5)


def test_bounds_projected_line_search():
    """Projected line search on bounds-active steps (reference:
    trust_region_minimizer.cc DoLineSearch): bounded Rosenbrock whose
    optimum sits on the y <= 0.5 face. The solve must reach the
    constrained optimum, and disabling the search
    (max_num_line_search_step_size_iterations=0) must never do BETTER —
    the search only ever improves the step length along the clipped
    direction."""
    from scipy.optimize import minimize as scipy_minimize

    def build():
        problem = st.Problem()
        p = problem.add_parameter_block([-1.2, 1.0])
        problem.set_parameter_upper_bound(p, 1, 0.5)

        def r(params, data):
            (x,) = params
            return jnp.stack([1.0 - x[0], 10.0 * (x[1] - x[0] ** 2)])

        problem.add_residual_block(r, None, [p])
        return problem, p

    # scipy oracle for the box-constrained optimum
    oracle = scipy_minimize(
        lambda v: (1 - v[0]) ** 2 + 100.0 * (v[1] - v[0] ** 2) ** 2,
        [-1.2, 1.0],
        bounds=[(None, None), (None, 0.5)],
        method="L-BFGS-B",
    )

    for ls_iters in (20, 0):
        problem, p = build()
        s = st.solve(
            SolverOptions(
                max_num_iterations=300,
                max_num_line_search_step_size_iterations=ls_iters,
                dtype=np.float64,
            ),
            problem,
        )
        x = np.asarray(p.value)
        assert x[1] <= 0.5 + 1e-12
        if ls_iters:
            assert s.termination_type == TerminationType.CONVERGENCE, s.message
            final_with_ls = s.final_cost
            np.testing.assert_allclose(x, oracle.x, atol=1e-3)
            np.testing.assert_allclose(
                s.final_cost, 0.5 * oracle.fun, rtol=1e-3, atol=1e-7
            )
    # cost parity: the search must not lose to plain projection
    assert final_with_ls <= s.final_cost * (1 + 1e-6) + 1e-9


def test_curve_fitting_line_search_dense_bfgs():
    """Dense BFGS direction (not the LBFGS alias) converges on curve
    fitting (reference: line_search_direction.cc BFGS)."""
    from skeres.core.types import LineSearchDirectionType, MinimizerType

    x, y = _curve_data()
    problem, mc = _build_curve_problem(x, y)
    options = SolverOptions(
        minimizer_type=MinimizerType.LINE_SEARCH,
        line_search_direction_type=LineSearchDirectionType.BFGS,
        max_num_iterations=200,
    )
    summary = st.solve(options, problem)
    assert summary.termination_type in (
        TerminationType.CONVERGENCE,
        TerminationType.NO_CONVERGENCE,
    ), summary.message
    m, c = mc.value
    assert abs(m - 0.3) < 0.1 and abs(c - 0.1) < 0.2


def test_residual_eval_time_populated():
    """full_report's time split must show nonzero residual-eval time when
    steps ran (reference: solver.cc timing fields)."""
    problem, summary, _ = _solve_powell(LinearSolverType.DENSE_QR)
    assert summary.num_residual_evaluations > 0
    assert summary.residual_evaluation_time_in_seconds > 0.0


def test_nonmonotonic_steps_return_best_iterate():
    """With use_nonmonotonic_steps the loop may accept cost-increasing
    steps, but the returned parameters must correspond to the minimum cost
    seen and final_cost must be the cost of those returned parameters
    (reference: trust_region_minimizer.cc / solver.h
    use_nonmonotonic_steps)."""
    import jax.numpy as jnp

    problem = st.Problem()
    xy = problem.add_parameter_block([-1.2, 1.0])

    def resid(params, data):
        (p,) = params
        return jnp.stack([10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]])

    problem.add_residual_block(resid, None, [xy])
    costs = []

    def cb(it):
        costs.append((it.cost, it.step_is_successful))

    summary = st.solve(
        SolverOptions(
            use_nonmonotonic_steps=True,
            initial_trust_region_radius=1e8,
            max_num_iterations=12,
            callbacks=[cb],
        ),
        problem,
    )
    accepted = [c for c, ok in costs if ok]
    # the crafted radius makes the accepted trajectory genuinely
    # non-monotonic (it ends on a worse iterate than it found); if a future
    # change makes this monotonic the test is vacuous — fail loudly so the
    # fixture gets re-tuned instead of silently passing
    assert any(b > a for a, b in zip(accepted, accepted[1:])), accepted
    # returned parameters == best accepted iterate
    np.testing.assert_allclose(summary.final_cost, min(accepted), rtol=1e-6)
    # final_cost == cost of the parameters actually written back
    np.testing.assert_allclose(
        problem.evaluate(), summary.final_cost, rtol=1e-6
    )


def test_final_cost_is_cost_of_returned_parameters():
    """final_cost must never report a rejected candidate's cost: after any
    solve, evaluating the problem at the written-back parameters must
    reproduce final_cost exactly."""
    problem, summary, _ = _solve_powell(LinearSolverType.DENSE_QR)
    np.testing.assert_allclose(
        problem.evaluate(), summary.final_cost, rtol=1e-6, atol=1e-18
    )


def test_pinned_and_disabled_jacobi_scaling():
    """refresh_jacobi_scaling=False pins the iteration-zero column scaling
    (the reference's exact behavior); jacobi_scaling=False disables scaling
    entirely. Both must stay consistent with the Schur solver's pre-scaled
    prep (regression: the host kept a stale scale while the prep used a
    fresh one) and converge to the same solution as the default."""
    from skeres.io.bal import build_bal_problem, synthetic_bal

    finals = {}
    for name, kw in [
        ("default", {}),
        ("pinned", dict(refresh_jacobi_scaling=False)),
        ("unscaled", dict(jacobi_scaling=False)),
    ]:
        bal = synthetic_bal(
            num_cameras=4, num_points=40, observations_per_point=4
        )
        problem, _, _ = build_bal_problem(bal)
        s = st.solve(
            SolverOptions(
                linear_solver_type=LinearSolverType.DENSE_SCHUR,
                max_num_iterations=30,
                **kw,
            ),
            problem,
        )
        assert s.termination_type == TerminationType.CONVERGENCE, (
            name,
            s.message,
        )
        finals[name] = s.final_cost
        np.testing.assert_allclose(
            problem.evaluate(), s.final_cost, rtol=1e-5,
            err_msg=name,
        )
    base = finals["default"]
    for name, v in finals.items():
        np.testing.assert_allclose(
            v, base, rtol=1e-3, atol=1e-8, err_msg=name
        )


def test_detailed_step_timings_off_same_result():
    """detailed_step_timings=False lets the solve/try dispatches pipeline
    (throughput mode); the trajectory must be
    identical to the default."""
    finals = []
    for flag in (True, False):
        problem, summary, _ = _solve_powell(
            LinearSolverType.DENSE_QR, detailed_step_timings=flag
        )
        finals.append(summary.final_cost)
        assert summary.termination_type == TerminationType.CONVERGENCE
    np.testing.assert_allclose(finals[1], finals[0], rtol=1e-12, atol=1e-18)
