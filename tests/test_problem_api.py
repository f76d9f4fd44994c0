"""Problem mutation & callback APIs (reference: problem_test.cc,
evaluation_callback_test.cc in the Ceres lineage's test layout —
SURVEY.md §5.4)."""

import jax.numpy as jnp
import numpy as np

from skeres.core.callbacks import EvaluationCallback, StateUpdatingCallback
from skeres.core.options import SolverOptions
from skeres.core.problem import Problem
from skeres.core.solver import solve


def _quad(params, data):
    (x,) = params
    return x - data


def _build(n=4):
    p = Problem()
    blocks = [p.add_parameter_block(np.array([float(i + 5)])) for i in range(n)]
    ids = [
        p.add_residual_block(_quad, None, [b], data=jnp.array([float(i)]))
        for i, b in enumerate(blocks)
    ]
    return p, blocks, ids


def test_remove_residual_block():
    p, blocks, ids = _build()
    assert p._num_residual_blocks == 4
    p.remove_residual_block(ids[1])
    assert p._num_residual_blocks == 3
    # removing twice raises
    try:
        p.remove_residual_block(ids[1])
        assert False, "expected KeyError"
    except KeyError:
        pass
    prog = p.compile()
    assert prog.num_residual_blocks == 3


def test_remove_parameter_block_drops_its_residuals():
    p, blocks, ids = _build()
    p.remove_parameter_block(blocks[2])
    assert p._num_residual_blocks == 3
    assert p.is_parameter_block_constant(blocks[2])
    # solve still works and drives the remaining blocks to their data
    options = SolverOptions(max_num_iterations=10)
    summary = solve(options, p)
    assert summary.final_cost < 1e-10
    np.testing.assert_allclose(blocks[0].value, [0.0], atol=1e-5)
    # removed block untouched
    np.testing.assert_allclose(blocks[2].value, [7.0], atol=1e-12)


def test_remove_all_blocks_of_a_batch():
    p, blocks, ids = _build(2)
    p.remove_residual_block(ids[0])
    p.remove_residual_block(ids[1])
    assert p._num_residual_blocks == 0
    assert not p._batches


def test_state_updating_and_update_state_every_iteration():
    p, blocks, ids = _build(2)
    options = SolverOptions(max_num_iterations=5, update_state_every_iteration=True)
    seen = []

    def spy(it, state):
        # state must be live device arrays matching the group layout
        seen.append(float(jnp.sum(state[0])))

    options.callbacks = [spy]
    solve(options, p)
    assert len(seen) >= 1


def test_evaluation_callback_fires():
    p, blocks, ids = _build(2)

    class Spy(EvaluationCallback):
        def __init__(self):
            self.calls = []

        def prepare_for_evaluation(self, evaluate_jacobians, new_point):
            self.calls.append((evaluate_jacobians, new_point))

    spy = Spy()
    options = SolverOptions(max_num_iterations=3, evaluation_callback=spy)
    solve(options, p)
    assert spy.calls, "EvaluationCallback never fired"
    # first dispatch is the initial full linearization: jacobians at a new point
    assert spy.calls[0] == (True, True)


def test_numeric_diff_residual_blocks():
    """numeric_diff=True (reference: NumericDiffCostFunction) must solve
    with central-difference Jacobians. Fixture: a residual whose AD
    derivative is deliberately WRONG (stop_gradient hides half the
    product rule), so the analytic path stalls at the wrong point while
    the numeric path reaches the true minimum."""
    import jax

    def broken_ad(params, data):
        (p,) = params
        # r = x^2 - 4, but AD sees only x*dx (not 2x*dx)
        return (jax.lax.stop_gradient(p[0]) * p[0] - 4.0)[None]

    def run(numeric):
        p = Problem()
        x = p.add_parameter_block([10.0])
        p.add_residual_block(broken_ad, None, [x], numeric_diff=numeric)
        s = solve(SolverOptions(max_num_iterations=60), p)
        return float(x.value[0]), s

    x_num, s_num = run(True)
    assert abs(abs(x_num) - 2.0) < 1e-3, x_num
    assert s_num.final_cost < 1e-8

    # smooth problem: numeric and analytic agree to the step-size order
    def smooth(params, data):
        (p,) = params
        return (p[0] ** 2 - 4.0)[None]

    p2 = Problem()
    y = p2.add_parameter_block([10.0])
    p2.add_residual_block(smooth, None, [y], numeric_diff=True)
    solve(SolverOptions(max_num_iterations=60), p2)
    assert abs(abs(float(y.value[0])) - 2.0) < 1e-3


def test_evaluate_residual_block_subset():
    """Problem.evaluate(residual_blocks=[...]) restricts the evaluation to
    the chosen subset (reference: EvaluateOptions::residual_blocks), and
    apply_loss_function=False drops the robustifier."""
    from skeres.ops.loss import CauchyLoss

    p = Problem()
    x = p.add_parameter_block([3.0])

    def r1(params, data):
        (v,) = params
        return (v[0] - 1.0)[None]

    def r2(params, data):
        (v,) = params
        return (2.0 * v[0])[None]

    id1 = p.add_residual_block(r1, None, [x])
    id2 = p.add_residual_block(r2, CauchyLoss(1.0), [x])

    full = p.evaluate()
    only1 = p.evaluate(residual_blocks=[id1])
    only2 = p.evaluate(residual_blocks=[id2])
    np.testing.assert_allclose(only1, 0.5 * (3.0 - 1.0) ** 2, rtol=1e-6)
    np.testing.assert_allclose(full, only1 + only2, rtol=1e-6)
    # Cauchy(1): rho(s) = log(1 + s); s = 36
    np.testing.assert_allclose(only2, 0.5 * np.log(1.0 + 36.0), rtol=1e-5)
    # without the loss, block 2 is the raw quadratic
    raw2 = p.evaluate(residual_blocks=[id2], apply_loss_function=False)
    np.testing.assert_allclose(raw2, 0.5 * 36.0, rtol=1e-6)
    # residual vector of the subset
    out = p.evaluate(residuals=True, residual_blocks=[id1])
    np.testing.assert_allclose(out["residuals"], [2.0], rtol=1e-6)
    # unknown handle -> KeyError
    import pytest as _pytest

    p.remove_residual_block(id1)
    with _pytest.raises(KeyError):
        p.evaluate(residual_blocks=[id1])


def test_numeric_diff_methods():
    """forward / central / ridders (reference: NumericDiffMethodType) all
    solve; ridders beats plain central differences in f32 on an
    ill-scaled residual (cancellation noise at small h is exactly what
    Richardson extrapolation from large h avoids)."""
    import jax.numpy as jnp

    def smooth(params, data):
        (p,) = params
        return (p[0] ** 2 - 4.0)[None]

    for method in ("forward", "central", "ridders"):
        p = Problem()
        x = p.add_parameter_block([10.0])
        p.add_residual_block(
            smooth, None, [x], numeric_diff=True, numeric_diff_method=method
        )
        s = solve(SolverOptions(max_num_iterations=60), p)
        assert abs(abs(float(x.value[0])) - 2.0) < 1e-3, (method, x.value)

    # unit-level accuracy: f32 central at h=1e-6 is cancellation-dominated,
    # ridders from h=1e-2 recovers ~full f32 precision
    from skeres.core.gradient_checker import (
        numeric_jacobian,
        ridders_jacobian,
    )

    def f(t):
        return jnp.exp(3.0 * t)  # d/dt at 0 = 3

    t32 = jnp.float32
    j_central = numeric_jacobian(f, 1, t32, 1e-6)[0, 0]
    j_ridders = ridders_jacobian(f, 1, t32, 1e-2)[0, 0]
    err_central = abs(float(j_central) - 3.0)
    err_ridders = abs(float(j_ridders) - 3.0)
    assert err_ridders < 1e-4, err_ridders
    assert err_ridders < err_central / 10.0, (err_central, err_ridders)


def test_numeric_diff_bad_method_raises():
    def smooth(params, data):
        (p,) = params
        return (p[0] ** 2 - 4.0)[None]

    p = Problem()
    x = p.add_parameter_block([1.0])
    p.add_residual_block(
        smooth, None, [x], numeric_diff=True, numeric_diff_method="sideways"
    )
    import pytest

    with pytest.raises(ValueError, match="numeric_diff_method"):
        solve(SolverOptions(max_num_iterations=2), p)


def test_jacobian_diff_modes_agree():
    """forward (T jvps, the reference's Jet layout) and reverse (m vjps)
    Jacobian construction must produce the same solve trajectory; auto
    picks reverse for wide blocks (BA: m=2 vs T=12)."""
    from skeres.core.types import LinearSolverType
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=5, num_points=40,
                        observations_per_point=3)

    def run(mode):
        problem, cams, _ = build_bal_problem(bal)
        s = solve(
            SolverOptions(
                linear_solver_type=LinearSolverType.DENSE_SCHUR,
                max_num_iterations=8,
                jacobian_diff_mode=mode,
            ),
            problem,
        )
        return s, cams.values.copy()

    s_f, c_f = run("forward")
    s_r, c_r = run("reverse")
    s_a, c_a = run("auto")
    import numpy as np

    np.testing.assert_allclose(s_r.final_cost, s_f.final_cost, rtol=1e-6)
    np.testing.assert_allclose(c_r, c_f, rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(c_a, c_r, rtol=1e-6, atol=1e-10)
