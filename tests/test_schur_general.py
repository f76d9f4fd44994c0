"""General Schur-eliminator structure (reference:
``internal/ceres/schur_eliminator_impl.h`` handles arbitrary E/F block
mixes): multiple eliminated-x-retained batch signatures, multiple retained
groups, and retained-only batches (priors) must all solve through
DENSE_SCHUR / ITERATIVE_SCHUR and agree with the dense normal-equations
ground truth."""

import jax.numpy as jnp
import numpy as np
import pytest

import skeres as st
from skeres.core.evaluator import Evaluator
from skeres.core.minimizer import TrustRegionMinimizer
from skeres.core.options import SolverOptions
from skeres.core.schur import SchurSolver
from skeres.core.summary import Summary
from skeres.core.types import LinearSolverType, TerminationType


def _general_ba_problem(seed=11):
    """3 poses (4-param) + 3 intrinsics (2-param) + 12 points (3-param),
    with THREE residual-batch signatures:
      A. mono obs:    (pose, intr, point) -> 2 residuals   [2 retained slots]
      B. stereo obs:  (pose, point)       -> 3 residuals   [different signature]
      C. pose prior:  (pose,)             -> 4 residuals   [retained-only]
    Points are the eliminated group."""
    rng = np.random.default_rng(seed)
    n_pose, n_intr, n_pts = 3, 3, 12
    problem = st.Problem()
    poses = problem.add_parameter_block_array(
        rng.standard_normal((n_pose, 4)) * 0.5, name="poses"
    )
    intrs = problem.add_parameter_block_array(
        1.0 + 0.1 * rng.standard_normal((n_intr, 2)), name="intrs"
    )
    pts = problem.add_parameter_block_array(
        rng.standard_normal((n_pts, 3)), name="points"
    )
    problem.set_schur_elimination_group(pts, 0)
    problem.set_schur_elimination_group(poses, 1)
    problem.set_schur_elimination_group(intrs, 1)

    # A: every (pose, point) pair with intr = pose index
    pose_idx = np.repeat(np.arange(n_pose), n_pts).astype(np.int32)
    pt_idx = np.tile(np.arange(n_pts), n_pose).astype(np.int32)
    mono_data = rng.standard_normal((len(pose_idx), 2))

    def mono(params, data):
        pose, intr, pt = params
        u = jnp.tanh(pose[0] + 0.3 * pt[0]) * intr[0]
        v = (pose[2] + pose[3] * pt[2]) * intr[1]
        return jnp.stack([u - data[0], v * 0.5 - data[1]])

    problem.add_residual_blocks(
        mono, None,
        [(poses, pose_idx), (intrs, pose_idx.copy()), (pts, pt_idx)],
        data=jnp.asarray(mono_data), name="mono",
    )

    # B: stereo-ish observations for a subset of pairs (different signature)
    sel = rng.choice(len(pose_idx), size=14, replace=False)
    st_pose = pose_idx[sel]
    st_pt = pt_idx[sel]
    st_data = rng.standard_normal((len(sel), 3))

    def stereo(params, data):
        pose, pt = params
        a = pose[0] * pt[0] + pose[1]
        b = pose[2] * pt[1] - pose[3] * pt[2]
        c = jnp.sum(pose[:3] * pt)
        return jnp.stack([a, b, c]) - data

    problem.add_residual_blocks(
        stereo, None, [(poses, st_pose), (pts, st_pt)],
        data=jnp.asarray(st_data), name="stereo",
    )

    # C: pose prior (retained-only batch)
    prior_mu = rng.standard_normal((n_pose, 4)) * 0.1

    def prior(params, data):
        (pose,) = params
        return 0.7 * (pose - data)

    problem.add_residual_blocks(
        prior, None, [(poses, np.arange(n_pose, dtype=np.int32))],
        data=jnp.asarray(prior_mu), name="prior",
    )
    return problem


@pytest.mark.parametrize("iterative", [False, True])
def test_general_structure_damped_step_matches_dense(iterative):
    """One damped Schur solve on the 3-signature problem == the f64 dense
    normal-equations solve to 1e-8 (extends tests/test_schur.py's
    elimination-equals-dense check to the general structure)."""
    radius = 3.0
    problem = _general_ba_problem()
    program = problem.compile()
    ev = Evaluator(program)
    solver_type = (
        LinearSolverType.ITERATIVE_SCHUR if iterative else LinearSolverType.DENSE_SCHUR
    )
    schur = SchurSolver(ev, iterative=iterative, eta=1e-14, max_cg_iterations=1000)
    assert len(schur.e_batches) == 2  # mono + stereo signatures
    assert len(schur.ret_blocks) == 2  # poses + intrinsics retained
    minimizer = TrustRegionMinimizer(
        ev, SolverOptions(), Summary(), solver_type, schur_solver=schur
    )
    state = program.initial_state(ev.dtype)
    cost, g, diag, data, scale, _, _ = minimizer.linearize(state)

    _, blocks = ev.blocks(state)
    jd, _ = ev.jacobian_dense(blocks)
    J = np.asarray(jd, np.float64) * np.asarray(scale, np.float64)[None, :]
    diag_s = np.asarray(diag, np.float64) * np.asarray(scale, np.float64) ** 2
    lhs = J.T @ J + np.diag(np.clip(diag_s, 1e-6, 1e32) / radius)
    y_star = np.linalg.solve(lhs, -(np.asarray(g, np.float64) * np.asarray(scale, np.float64)))

    gs = g * scale
    y, _, _ = minimizer._solve_scaled(
        data, gs, jnp.asarray(diag_s, ev.dtype), jnp.asarray(radius, ev.dtype),
        scale,
    )
    np.testing.assert_allclose(np.asarray(y), y_star, rtol=0, atol=1e-8)


@pytest.mark.parametrize(
    "solver",
    [LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR,
     LinearSolverType.DENSE_NORMAL_CHOLESKY],
)
def test_general_structure_full_solve(solver):
    """End-to-end solves across solvers agree on the final cost."""
    problem = _general_ba_problem()
    s = st.solve(
        SolverOptions(linear_solver_type=solver, max_num_iterations=100,
                      eta=1e-10),
        problem,
    )
    assert s.termination_type == TerminationType.CONVERGENCE, str(s.message)
    assert s.final_cost < s.initial_cost
    if not hasattr(test_general_structure_full_solve, "_ref"):
        test_general_structure_full_solve._ref = s.final_cost
    np.testing.assert_allclose(
        s.final_cost, test_general_structure_full_solve._ref, rtol=1e-6
    )
