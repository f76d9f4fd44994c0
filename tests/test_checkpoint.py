"""Checkpoint/resume tests (SURVEY.md §6: state-light TR loop snapshot)."""

import os

import numpy as np

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import TerminationType
from skeres.utils.checkpoint import load_checkpoint, save_checkpoint


def _curve_problem():
    import jax.numpy as jnp

    rng = np.random.default_rng(77)
    x = np.linspace(0.0, 5.0, 50)
    y = np.exp(0.3 * x + 0.1) + rng.normal(0.0, 0.1, size=x.shape)

    def resid(params, data):
        (p,) = params
        return data[1:2] - jnp.exp(p[0] * data[0] + p[1])

    problem = st.Problem()
    mc = problem.add_parameter_block([0.0, 0.0])
    problem.add_residual_blocks(
        resid,
        None,
        [(mc.array, np.zeros(len(x), dtype=np.int32))],
        data=np.stack([x, y], axis=1),
    )
    return problem, mc


def test_checkpoint_roundtrip(tmp_path):
    path = os.path.join(tmp_path, "ck.npz")
    vals = [np.arange(6.0).reshape(2, 3), np.ones((1, 4))]
    save_checkpoint(path, vals, radius=123.5, iteration=7, cost=2.5)
    groups, radius, iteration, cost = load_checkpoint(path)
    assert radius == 123.5 and iteration == 7 and cost == 2.5
    np.testing.assert_array_equal(groups[0], vals[0])
    np.testing.assert_array_equal(groups[1], vals[1])


def test_solve_checkpoint_and_resume(tmp_path):
    ck = os.path.join(tmp_path, "solve.npz")

    # phase 1: a few iterations, checkpoint every step (early LM iterations
    # can be rejected while the trust region shrinks, so give it enough
    # budget for at least one accepted step)
    problem, mc = _curve_problem()
    opts = SolverOptions(
        max_num_iterations=10,
        checkpoint_path=ck,
        checkpoint_every_n_iterations=1,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
    )
    s1 = st.solve(opts, problem)
    assert os.path.exists(ck)
    groups, radius, iteration, _ = load_checkpoint(ck)
    assert iteration >= 1

    # phase 2: fresh problem object, resume from the checkpoint
    problem2, mc2 = _curve_problem()
    opts2 = SolverOptions(max_num_iterations=100, resume_from=ck)
    s2 = st.solve(opts2, problem2)
    assert s2.termination_type == TerminationType.CONVERGENCE, s2.message
    # the resumed solve starts from the checkpointed (already improved) state
    assert s2.initial_cost <= s1.initial_cost + 1e-9
    m, c = mc2.value
    assert abs(m - 0.3) < 0.1 and abs(c - 0.1) < 0.25
