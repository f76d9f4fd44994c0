"""Streamed (chunked) evaluation: ``SolverOptions.evaluation_chunk_size``
must change memory behavior only — cost/r/J/g/diag and full solves must
match the unchunked path bit-tolerantly (reference counterpart:
``program_evaluator.h``'s streaming over residual blocks; SURVEY.md §6
"chunked/streamed evaluation ... lets ~1M-point venice fit")."""

import jax
import jax.numpy as jnp
import numpy as np

import skeres as st
from skeres.core.evaluator import Evaluator
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType, TerminationType
from skeres.io.bal import build_bal_problem, synthetic_bal


def _bal_problem():
    bal = synthetic_bal(
        num_cameras=5, num_points=60, observations_per_point=3, seed=3,
    )
    problem, cams, pts = build_bal_problem(bal)
    return problem


def test_chunked_eval_matches_unchunked():
    problem = _bal_problem()
    program = problem.compile()
    ev_full = Evaluator(program)
    ev_chunk = Evaluator(program, chunk_size=16)  # 180 obs -> pads to 192
    state = program.initial_state(ev_full.dtype)

    assert any(ev_chunk._chunk_count(bi) > 1
               for bi in range(len(program.batches)))

    c_full = jax.jit(ev_full.cost)(state)
    c_chunk = jax.jit(ev_chunk.cost)(state)
    np.testing.assert_allclose(float(c_full), float(c_chunk), rtol=1e-12)

    cost_f, blocks_f = jax.jit(ev_full.blocks)(state)
    cost_c, blocks_c = jax.jit(ev_chunk.blocks)(state)
    np.testing.assert_allclose(float(cost_f), float(cost_c), rtol=1e-12)
    g_f, d_f = jax.jit(ev_full.gradient_and_diag)(blocks_f)
    g_c, d_c = jax.jit(ev_chunk.gradient_and_diag)(blocks_c)
    np.testing.assert_allclose(np.asarray(g_f), np.asarray(g_c), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(d_f), np.asarray(d_c), rtol=1e-10)


def test_chunked_solve_matches_full_trajectory():
    opts = dict(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        max_num_iterations=8,
    )
    p1 = _bal_problem()
    s1 = st.solve(SolverOptions(**opts), p1)
    p2 = _bal_problem()
    s2 = st.solve(SolverOptions(evaluation_chunk_size=16, **opts), p2)
    assert s1.termination_type == s2.termination_type
    # chunked and full passes reassociate sums differently; after several
    # LM iterations the trajectories agree to ~1e-8 relative, not bitwise
    np.testing.assert_allclose(s1.final_cost, s2.final_cost, rtol=1e-6)
    assert len(s1.iterations) == len(s2.iterations)


def test_padded_layouts_survive_chunk_padding():
    """Evaluator chunk padding repeats row 0's indices; the camera-padded
    layout and the explicit-S plan must ignore those rows instead of
    letting block 0's apparent count trip the waste gates (regression:
    bench_venice with --chunk silently lost BOTH fast paths)."""
    import jax
    from skeres.core.evaluator import Evaluator
    from skeres.core.schur import SchurSolver
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=6, num_points=90, observations_per_point=3)
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    # chunk that does NOT divide B=270 -> padding rows appended
    ev = Evaluator(program, chunk_size=64)
    assert ev._batch_const[0][1][0].shape[0] % 64 == 0
    assert ev._batch_const[0][1][0].shape[0] > bal.num_observations

    srt = SchurSolver(ev, iterative=True, sort_threshold=1)
    assert srt.sorted_info, "camera-padded layout lost under chunk padding"

    dns = SchurSolver(ev, iterative=False)
    dns.dense_w = None
    assert dns.explicit_plan is not None, "explicit plan lost under padding"

    # and the solves still match the unchunked evaluator's
    ev0 = Evaluator(program)
    from skeres.core.linear_solvers import lm_diagonal

    def damped(ev_, solver):
        state = program.initial_state(ev_.dtype)
        _, blocks = jax.jit(ev_.blocks)(state)
        g, diag = jax.jit(ev_.gradient_and_diag)(blocks)
        data = solver.solver_data(blocks)
        dx, _, _ = jax.jit(
            lambda: solver.solve_damped(data, g, diag, 1e-3, 1e-6, 1e32)
        )()
        return np.asarray(dx)

    ref = damped(ev0, SchurSolver(ev0, iterative=False))
    got = damped(ev, dns)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-9)
