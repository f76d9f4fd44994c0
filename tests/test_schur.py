"""Schur-complement solver tests on synthetic bundle adjustment.

Counterpart of the reference lineage's solver cross-product system tests
(``internal/ceres/bundle_adjustment_test_util.h``, ``system_test.cc``):
all linear solvers must agree on the solution of the same problem within
tolerance — no golden numbers, solvers certify each other.
"""

import jax
import numpy as np
import pytest

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import (
    LinearSolverType,
    PreconditionerType,
    TerminationType,
)
from skeres.io.bal import build_bal_problem, synthetic_bal


def _solve(linear_solver, bal, **kw):
    problem, cameras, points = build_bal_problem(bal)
    options = SolverOptions(
        linear_solver_type=linear_solver,
        max_num_iterations=30,
        **kw,
    )
    summary = st.solve(options, problem)
    return summary, cameras.values.copy(), points.values.copy()


@pytest.fixture(scope="module")
def small_bal():
    return synthetic_bal(num_cameras=6, num_points=60, observations_per_point=3)


@pytest.fixture(scope="module")
def dense_solution(small_bal):
    return _solve(LinearSolverType.DENSE_NORMAL_CHOLESKY, small_bal)


def test_dense_reference_converges(dense_solution):
    summary, _, _ = dense_solution
    assert summary.termination_type == TerminationType.CONVERGENCE, summary.message
    assert summary.final_cost < summary.initial_cost * 0.1


@pytest.mark.parametrize(
    "solver,precond",
    [
        (LinearSolverType.DENSE_SCHUR, PreconditionerType.JACOBI),
        (LinearSolverType.ITERATIVE_SCHUR, PreconditionerType.SCHUR_JACOBI),
        (LinearSolverType.ITERATIVE_SCHUR, PreconditionerType.POWER_SERIES_EXPANSION),
        (LinearSolverType.CGNR, PreconditionerType.JACOBI),
    ],
)
def test_solvers_agree_with_dense(dense_solution, small_bal, solver, precond):
    ref_summary, ref_cams, ref_pts = dense_solution
    summary, cams, pts = _solve(solver, small_bal, preconditioner_type=precond)
    assert summary.termination_type == TerminationType.CONVERGENCE, summary.message
    # final costs agree within the convergence-tolerance regime
    np.testing.assert_allclose(
        summary.final_cost, ref_summary.final_cost, rtol=1e-4
    )


def test_schur_step_equals_dense_step(small_bal):
    """One damped solve: DENSE_SCHUR elimination must reproduce the full
    dense normal-equation solution exactly (it is algebraically identical).
    Mirror of the reference's schur_eliminator_test strategy."""
    import jax.numpy as jnp

    from skeres.core.evaluator import Evaluator
    from skeres.core.linear_solvers import solve_dense_normal_cholesky
    from skeres.core.schur import SchurSolver

    problem, cameras, points = build_bal_problem(small_bal)
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)

    cost, blocks = ev.blocks(state)
    g, diag = ev.gradient_and_diag(blocks)
    jtj = ev.jtj_dense(blocks)

    mu = 1e-4
    dense_step, _ = solve_dense_normal_cholesky(jtj, g, diag, mu, 1e-6, 1e32)

    schur = SchurSolver(ev, iterative=False)
    data = schur.solver_data(blocks)
    schur_step, _, _ = schur.solve_damped(
        data, g, diag, jnp.asarray(mu, dtype=ev.dtype), 1e-6, 1e32
    )
    np.testing.assert_allclose(
        np.asarray(schur_step), np.asarray(dense_step), rtol=1e-8, atol=1e-10
    )


def test_iterative_schur_matvec_matches_dense_s(small_bal):
    """Implicit S matvec == materialized dense S product (random vectors)."""
    import jax.numpy as jnp

    from skeres.core.evaluator import Evaluator
    from skeres.core.linear_solvers import lm_diagonal
    from skeres.core.schur import SchurSolver

    problem, cameras, points = build_bal_problem(small_bal)
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    _, blocks = ev.blocks(state)
    g, diag = ev.gradient_and_diag(blocks)

    schur = SchurSolver(ev, iterative=False)
    data = schur.solver_data(blocks)
    d = lm_diagonal(diag, 1e-3, 1e-6, 1e32)
    asm = schur._assemble(data, g, d)
    s_dense = schur._dense_s(asm)

    rng = np.random.default_rng(3)
    for _ in range(3):
        v = jnp.asarray(rng.normal(size=(schur.num_f,)))
        sv_implicit = schur._ftf_apply(asm, v) - schur._w_apply(
            asm, jnp.einsum("pef,pf->pe", asm["cinv"], schur._wt_apply(asm, v))
        )
        np.testing.assert_allclose(
            np.asarray(s_dense @ v), np.asarray(sv_implicit), rtol=1e-8, atol=1e-9
        )

    # SCHUR_JACOBI blocks must equal the diagonal blocks of dense S
    blocks_sj = schur._schur_jacobi_blocks(asm)
    for (start, nb, t), blk in zip(schur.ret_blocks, blocks_sj):
        for b in range(nb):
            lo = start + b * t
            np.testing.assert_allclose(
                np.asarray(blk[b]),
                np.asarray(s_dense[lo : lo + t, lo : lo + t]),
                rtol=1e-8,
                atol=1e-9,
            )


def test_gradient_checker_on_snavely(small_bal):
    from skeres.core.evaluator import Evaluator
    from skeres.core.gradient_checker import check_program_gradients

    problem, _, _ = build_bal_problem(small_bal)
    program = problem.compile()
    ev = Evaluator(program)
    ok, msg = check_program_gradients(program, ev)
    assert ok, msg


def test_sorted_camera_layout_matches_unsorted():
    """The camera-sorted matvec layout (sort_threshold forces it on) must
    reproduce the default path bit-tolerantly: same damped solve, same
    SCHUR_JACOBI blocks."""
    from skeres.core.evaluator import Evaluator
    from skeres.core.linear_solvers import lm_diagonal
    from skeres.core.schur import SchurSolver
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=6, num_points=80, observations_per_point=3)
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    _, blocks = jax.jit(ev.blocks)(state)
    g, diag = jax.jit(ev.gradient_and_diag)(blocks)

    # eta=0 disables BOTH termination criteria (residual and the
    # reference's Q-based zeta test), so each path runs the identical,
    # fixed number of CG iterations to full convergence — isolating the
    # layout comparison from truncation-order effects
    plain = SchurSolver(ev, iterative=True, eta=0.0, max_cg_iterations=120)
    srt = SchurSolver(ev, iterative=True, eta=0.0, max_cg_iterations=120,
                      sort_threshold=1)
    assert not plain.sorted_info and srt.sorted_info

    data = plain.solver_data(blocks)
    dx0, _, _ = jax.jit(
        lambda: plain.solve_damped(data, g, diag, 1e-3, 1e-6, 1e32)
    )()
    dx1, _, _ = jax.jit(
        lambda: srt.solve_damped(data, g, diag, 1e-3, 1e-6, 1e32)
    )()
    # both paths converge exactly (58 f64 CG iterations); the remaining
    # ~1e-8 relative difference is reduction-order fp noise amplified
    # through the CG recurrence
    np.testing.assert_allclose(np.asarray(dx1), np.asarray(dx0), rtol=1e-6,
                               atol=1e-10)

    d = lm_diagonal(diag, 1e-3, 1e-6, 1e32)
    asm0 = plain._assemble(data, g, d)
    asm1 = srt._assemble(data, g, d)
    b0 = plain._schur_jacobi_blocks(asm0)
    b1 = srt._schur_jacobi_blocks(asm1)
    for x, y in zip(b0, b1):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=1e-9,
                                   atol=1e-12)


def test_spse_tolerance_early_termination(dense_solution, small_bal):
    """spse_tolerance (reference: solver.h) terminates the Neumann series
    early; the preconditioner changes but the PCG solution must not —
    solve quality is certified against the dense reference at both a
    truncating tolerance and tolerance 0 (full fixed-length series)."""
    ref_summary, _, _ = dense_solution
    for tol in (0.0, 0.5):
        summary, _, _ = _solve(
            LinearSolverType.ITERATIVE_SCHUR,
            small_bal,
            preconditioner_type=PreconditionerType.POWER_SERIES_EXPANSION,
            spse_tolerance=tol,
        )
        assert summary.termination_type == TerminationType.CONVERGENCE
        np.testing.assert_allclose(
            summary.final_cost, ref_summary.final_cost, rtol=1e-4
        )


def test_trust_region_problem_dumps(tmp_path, small_bal):
    """trust_region_problem_dump_* (reference: solver.h): TEXTFILE writes
    one npz per dumped iteration holding the linear system."""
    problem, _, _ = build_bal_problem(small_bal)
    options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_NORMAL_CHOLESKY,
        max_num_iterations=3,
        trust_region_problem_dump_directory=str(tmp_path),
        trust_region_minimizer_iterations_to_dump=(1, 2),
    )
    st.solve(options, problem)
    for it in (1, 2):
        f = tmp_path / f"lm_iteration_{it:03d}.npz"
        assert f.exists(), f
        dump = np.load(f)
        assert "gradient" in dump and "lm_diagonal" in dump
        assert "step" in dump and "solver_data_0" in dump
        assert dump["gradient"].ndim == 1
    assert not (tmp_path / "lm_iteration_003.npz").exists()


def test_trust_region_dump_console(capsys, small_bal):
    from skeres.core.types import DumpFormatType

    problem, _, _ = build_bal_problem(small_bal)
    options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_NORMAL_CHOLESKY,
        max_num_iterations=2,
        trust_region_minimizer_iterations_to_dump=(1,),
        trust_region_problem_dump_format_type=DumpFormatType.CONSOLE,
    )
    st.solve(options, problem)
    out = capsys.readouterr().out
    assert "LM iteration 1" in out and "solver_data[0]" in out


def _explicit_vs_probe(problem, check_iterative=True):
    """Build S via the explicit pair-product plan and via the implicit
    column probe on the same assembly; they must agree to fp tolerance."""
    from skeres.core.evaluator import Evaluator
    from skeres.core.linear_solvers import lm_diagonal
    from skeres.core.schur import SchurSolver

    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    _, blocks = jax.jit(ev.blocks)(state)
    g, diag = jax.jit(ev.gradient_and_diag)(blocks)

    solver = SchurSolver(ev, iterative=False)
    assert solver.explicit_plan is not None, "plan should be viable here"
    solver.dense_w = None  # force the explicit path past the small fast path
    data = solver.solver_data(blocks)
    d = lm_diagonal(diag, 1e-3, 1e-6, 1e32)
    asm = jax.jit(lambda: solver._assemble(data, g, d))()

    s_explicit = np.asarray(jax.jit(lambda: solver._dense_s_explicit(asm))())
    solver.explicit_plan = None
    s_probe = np.asarray(jax.jit(lambda: solver._dense_s(asm))())
    np.testing.assert_allclose(s_explicit, s_probe, rtol=5e-6, atol=1e-7)


def test_explicit_schur_matches_probe_uniform(small_bal):
    problem, _, _ = build_bal_problem(small_bal)
    _explicit_vs_probe(problem)


def test_explicit_schur_matches_probe_adversarial():
    """Non-uniform observation counts, a camera observing the same point
    twice (diagonal same-camera pair), and a camera-prior batch (extra
    signature added via index maps)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    bal = synthetic_bal(num_cameras=5, num_points=40, observations_per_point=3)
    # non-uniform: drop some observations, duplicate others (same camera
    # re-observing the same point)
    keep = rng.random(bal.num_observations) > 0.25
    cam = bal.camera_index[keep]
    pt = bal.point_index[keep]
    obs = bal.observations[keep]
    dup = slice(0, 6)
    cam = np.concatenate([cam, cam[dup]])
    pt = np.concatenate([pt, pt[dup]])
    obs = np.concatenate([obs, obs[dup] + 0.5])
    bal.camera_index, bal.point_index, bal.observations = cam, pt, obs

    problem, cameras, _ = build_bal_problem(bal)

    def camera_prior(params, data):
        (c,) = params
        return 0.05 * (c - data)

    problem.add_residual_blocks(
        camera_prior,
        None,
        [(cameras, np.arange(bal.num_cameras, dtype=np.int32))],
        data=bal.cameras.copy(),
        name="prior",
    )
    _explicit_vs_probe(problem)


def test_iterative_explicit_schur_solves(dense_solution, small_bal):
    """use_explicit_schur_complement=True (reference: solver.h): the PCG
    runs on the materialized S and must reach the dense reference cost."""
    ref_summary, _, _ = dense_solution
    summary, _, _ = _solve(
        LinearSolverType.ITERATIVE_SCHUR,
        small_bal,
        preconditioner_type=PreconditionerType.SCHUR_JACOBI,
        use_explicit_schur_complement=True,
    )
    assert summary.termination_type == TerminationType.CONVERGENCE
    np.testing.assert_allclose(
        summary.final_cost, ref_summary.final_cost, rtol=1e-4
    )


def test_dense_schur_factor_failure_cg_fallback(small_bal):
    """A failed (NaN) Cholesky factorization must not produce an invalid
    step: the DENSE_SCHUR path falls back to PCG on the explicit S and
    returns the same solution (the reference wastes the LM step on
    LinearSolverFailure; we recover it)."""
    from skeres.core.evaluator import Evaluator
    from skeres.core.schur import SchurSolver

    problem, _, _ = build_bal_problem(small_bal)
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    _, blocks = jax.jit(ev.blocks)(state)
    g, diag = jax.jit(ev.gradient_and_diag)(blocks)

    ref_solver = SchurSolver(ev, iterative=False)
    data = ref_solver.solver_data(blocks)
    dx_ref, it_ref, _ = jax.jit(
        lambda: ref_solver.solve_damped(data, g, diag, 1e-3, 1e-6, 1e32)
    )()
    assert int(it_ref) == 1  # healthy factor path

    broken = SchurSolver(ev, iterative=False)
    orig = broken._factor_solve

    def nan_factor(s, rhs):
        dx, solve = orig(s, rhs)
        return dx * jnp.nan, solve

    import jax.numpy as jnp  # noqa: F811

    broken._factor_solve = nan_factor
    dx_cg, it_cg, _ = jax.jit(
        lambda: broken.solve_damped(data, g, diag, 1e-3, 1e-6, 1e32)
    )()
    assert int(it_cg) == 32  # fallback engaged
    assert np.isfinite(np.asarray(dx_cg)).all()
    # 32 capped CG iterations produce a usable (not exact) step: it must
    # point the same way as the true solution and be a decent approximation
    a, b = np.asarray(dx_cg), np.asarray(dx_ref)
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.99, cos
    assert abs(np.linalg.norm(a) / np.linalg.norm(b) - 1.0) < 0.1


def test_factor_failure_jittered_refactor_recovers_step():
    """A gauge-free BA problem at mu ~ 0 has a singular S: the f32
    Cholesky fails (NaN). The reference reports LinearSolverFailure and
    wastes the LM step; here an escalating-jitter refactor of the
    equilibrated S (delta*I with delta in {1e-5, 1e-3}, a whisker of extra
    Tikhonov damping) must recover a finite step, with the linear-solver
    iteration count recording the retry."""
    import jax.numpy as jnp

    from skeres.core.evaluator import Evaluator
    from skeres.core.schur import SchurSolver
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(
        num_cameras=6, num_points=60, observations_per_point=4
    )
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    _, blocks = jax.jit(ev.blocks)(state)
    g, diag = jax.jit(ev.gradient_and_diag)(blocks)
    schur = SchurSolver(ev, iterative=False)
    schur.dense_w = None  # force the explicit-S path
    data = schur.solver_data(blocks)
    dx, iters, jitter_used = jax.jit(
        lambda: schur.solve_damped(
            data, g, diag, jnp.asarray(1e-32, ev.dtype), 1e-6, 1e32
        )
    )()
    assert bool(jnp.all(jnp.isfinite(dx)))
    # at least one jitter retry actually ran (otherwise this fixture no
    # longer triggers the failure and must be re-tuned)
    assert int(iters) >= 2, int(iters)
    assert float(jitter_used) > 0.0  # the ratchet records the used delta
    # warm-started at the recorded delta, the solve succeeds first try
    dx2, iters2, j2 = jax.jit(
        lambda: schur.solve_damped(
            data, g, diag, jnp.asarray(1e-32, ev.dtype), 1e-6, 1e32,
            jitter0=jitter_used,
        )
    )()
    assert bool(jnp.all(jnp.isfinite(dx2)))
    assert int(iters2) == 1, int(iters2)
    assert float(j2) == float(jitter_used)


def test_cluster_jacobi_preconditioner():
    """CLUSTER_JACOBI (reference: cluster_jacobi_preconditioner.cc, with
    contiguous-index clusters replacing the serial visibility clustering)
    must converge to the SCHUR_JACOBI solution while spending strictly
    fewer CG iterations — its blocks subsume SCHUR_JACOBI's, so the
    preconditioned system is strictly better conditioned. cluster_size <
    num_cameras so the test exercises genuine multi-cluster blocks."""
    import skeres as st
    from skeres.core.options import SolverOptions
    from skeres.core.types import (
        LinearSolverType,
        PreconditionerType,
        TerminationType,
    )
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(
        num_cameras=24, num_points=200, observations_per_point=4
    )
    totals = {}
    for pc in (
        PreconditionerType.SCHUR_JACOBI,
        PreconditionerType.CLUSTER_JACOBI,
    ):
        problem, _, _ = build_bal_problem(bal)
        s = st.solve(
            SolverOptions(
                linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
                preconditioner_type=pc,
                cluster_jacobi_size=8,
                max_num_iterations=40,
            ),
            problem,
        )
        assert s.termination_type == TerminationType.CONVERGENCE, s.message
        totals[pc] = (
            s.final_cost,
            sum(it.linear_solver_iterations for it in s.iterations),
        )
    sj = totals[PreconditionerType.SCHUR_JACOBI]
    cj = totals[PreconditionerType.CLUSTER_JACOBI]
    np.testing.assert_allclose(cj[0], sj[0], rtol=1e-3)
    assert cj[1] < sj[1], (cj[1], sj[1])


def test_cluster_jacobi_downgrades_without_structure():
    """A non-Schur-structured problem with CLUSTER_JACOBI requested must
    still solve (downgrade to SCHUR_JACOBI semantics, reference
    preprocessor behavior) — via CGNR since there is no elimination
    group at all here."""
    import jax.numpy as jnp

    import skeres as st
    from skeres.core.options import SolverOptions
    from skeres.core.types import LinearSolverType, PreconditionerType

    problem = st.Problem()
    x = problem.add_parameter_block([2.0, -1.0])

    def resid(params, data):
        (p,) = params
        return jnp.stack([p[0] - 1.0, p[1] + 3.0, p[0] + p[1]])

    problem.add_residual_block(resid, None, [x])
    s = st.solve(
        SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=PreconditionerType.CLUSTER_JACOBI,
            max_num_iterations=30,
        ),
        problem,
    )
    assert s.final_cost < 1e-6 or s.termination_type is not None


def test_jtj_quadratic_padded_matches_generic():
    """jtj_quadratic's camera-padded fast path (broadcast camera vector,
    e-only point gather) must equal the generic per-row tangent-gather
    path."""
    import jax.numpy as jnp

    from skeres.core.evaluator import Evaluator
    from skeres.core.schur import SchurSolver
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=7, num_points=60, observations_per_point=4)
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    _, blocks = jax.jit(ev.blocks)(state)

    srt = SchurSolver(ev, iterative=False, sort_threshold=1)
    assert srt.sorted_info
    data = srt.solver_data(blocks)
    prep = jax.jit(srt.prepare)(data)

    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=(ev.num_tangent,)), dtype=ev.dtype)
    q_padded = jax.jit(srt.jtj_quadratic)(prep, v)
    q_generic = jax.jit(srt.jtj_quadratic)(data, v)
    np.testing.assert_allclose(
        float(q_padded), float(q_generic), rtol=1e-6
    )


def test_padded_gradient_diag_and_scale_match_generic():
    """gradient_and_diag_padded must equal the evaluator's generic
    reductions, and prepare(cam_raw, scale) — scaling the placed copy in
    padded space — must equal prepare() over pre-scaled rows."""
    import jax.numpy as jnp

    from skeres.core.evaluator import Evaluator
    from skeres.core.schur import SchurSolver
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=9, num_points=70, observations_per_point=3)
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    _, blocks = jax.jit(ev.blocks)(state)

    srt = SchurSolver(ev, iterative=False, sort_threshold=1)
    assert srt.sorted_info

    g0, d0 = jax.jit(ev.gradient_and_diag)(blocks)
    g1, d1, cam_raw = jax.jit(srt.gradient_and_diag_padded)(blocks)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d0), rtol=1e-6,
                               atol=1e-12)

    # prep over reused UNSCALED copies (consumers conjugate with the
    # scale vectors) must produce the same solver quantities as prep over
    # re-placed pre-scaled rows
    from skeres.core.linear_solvers import lm_diagonal

    scale = 1.0 / (1.0 + jnp.sqrt(jnp.maximum(d0, 0.0)))
    data = srt.solver_data(blocks)
    sdata = srt.scale_data(data, scale)
    prep_ref = jax.jit(srt.prepare)(sdata)
    prep_new = jax.jit(
        lambda sd, cr, sc: srt.prepare(sd, cam_raw=cr, scale=sc)
    )(sdata, cam_raw, scale)
    gs = g0 * scale
    d = lm_diagonal(d0 * scale * scale, 1e-3, 1e-6, 1e32)
    rng = np.random.default_rng(1)
    for prep, label in ((prep_ref, "ref"), (prep_new, "reused")):
        asm = jax.jit(lambda p: srt._assemble(p, gs, d))(prep)
        if label == "ref":
            rhs_ref = np.asarray(srt._schur_rhs(asm))
            sjb_ref = np.asarray(srt._schur_jacobi_blocks(asm)[0])
            vq = jnp.asarray(
                rng.normal(size=(ev.num_tangent,)), dtype=ev.dtype
            )
            q_ref = float(srt.jtj_quadratic(prep, vq))
        else:
            np.testing.assert_allclose(
                np.asarray(srt._schur_rhs(asm)), rhs_ref, rtol=1e-6,
                atol=1e-10,
            )
            np.testing.assert_allclose(
                np.asarray(srt._schur_jacobi_blocks(asm)[0]), sjb_ref,
                rtol=1e-6, atol=1e-10,
            )
            np.testing.assert_allclose(
                float(srt.jtj_quadratic(prep, vq)), q_ref, rtol=1e-6
            )


def test_padded_linearize_end_to_end_trajectory():
    """Full solves with the padded-linearize path (sort_threshold forced
    on) and the generic path must produce the same trajectory."""
    import skeres as st
    from skeres.core.options import SolverOptions
    from skeres.core.types import LinearSolverType
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=8, num_points=90, observations_per_point=3)

    def run(thresh):
        problem, cams, _ = build_bal_problem(bal)
        s = st.solve(
            SolverOptions(
                linear_solver_type=LinearSolverType.DENSE_SCHUR,
                max_num_iterations=12,
                jacobian_sort_threshold=thresh,
                jacobian_pad_waste=100.0,
            ),
            problem,
        )
        return s, cams.values.copy()

    s0, c0 = run(10**9)
    s1, c1 = run(1)
    assert s0.num_successful_steps == s1.num_successful_steps
    np.testing.assert_allclose(s1.final_cost, s0.final_cost, rtol=1e-5)
    np.testing.assert_allclose(c1, c0, rtol=1e-4, atol=1e-7)


def test_placed_dual_eval_matches_placement_gather():
    """The dual-eval padded copy (:meth:`_placed_eval` — a second row
    evaluation directly in camera-padded order) must produce the same
    placed (jac | r) values as the placement gather, and
    gradient_and_diag_padded(state=...) must match the generic
    reductions."""
    import jax.numpy as jnp

    from skeres.core.evaluator import Evaluator
    from skeres.core.schur import SchurSolver
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=7, num_points=60, observations_per_point=3)
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    _, blocks = jax.jit(ev.blocks)(state)

    srt = SchurSolver(ev, iterative=False, sort_threshold=1,
                      placed_eval=True)
    assert srt.sorted_info
    (bi,) = list(srt.sorted_info)
    assert srt.sorted_info[bi].get("placed") is not None

    b = blocks[bi]
    bsz, m, T = b.jac.shape
    placed_ref = jax.jit(
        lambda fl: srt._place_rows(bi, fl)
    )(jnp.concatenate([b.jac.reshape(bsz, m * T), b.r], axis=1))
    jac_p, r_p = jax.jit(lambda st: srt._placed_eval(bi, st))(state)
    np.testing.assert_allclose(
        np.asarray(jac_p), np.asarray(placed_ref[..., : m * T]),
        rtol=1e-6, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(r_p), np.asarray(placed_ref[..., m * T :]),
        rtol=1e-6, atol=1e-12,
    )

    g0, d0 = jax.jit(ev.gradient_and_diag)(blocks)
    g1, d1, _ = jax.jit(
        lambda bl, st: srt.gradient_and_diag_padded(bl, state=st)
    )(blocks, state)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0), rtol=1e-6,
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d0), rtol=1e-6,
                               atol=1e-10)


def test_placed_dual_eval_respects_constant_blocks_and_loss():
    """Placed eval must reproduce the gather placement when a loss
    corrects the rows and some parameter blocks are constant (non-trivial
    free mask -> placed mask copy)."""
    import jax.numpy as jnp

    from skeres.core.evaluator import Evaluator
    from skeres.core.schur import SchurSolver
    from skeres.io.bal import build_bal_problem, synthetic_bal
    from skeres.ops.loss import HuberLoss

    bal = synthetic_bal(num_cameras=6, num_points=50, observations_per_point=3)
    problem, cameras, _ = build_bal_problem(bal, loss=HuberLoss(1.0))
    problem.set_parameter_block_constant(cameras[0])
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    _, blocks = jax.jit(ev.blocks)(state)

    srt = SchurSolver(ev, iterative=False, sort_threshold=1,
                      placed_eval=True)
    (bi,) = list(srt.sorted_info)
    assert srt.sorted_info[bi].get("placed") is not None
    # non-trivial mask -> a real placed mask copy, not the ones row
    assert srt.sorted_info[bi]["placed"][2].shape[0] > 1

    b = blocks[bi]
    bsz, m, T = b.jac.shape
    placed_ref = jax.jit(
        lambda fl: srt._place_rows(bi, fl)
    )(jnp.concatenate([b.jac.reshape(bsz, m * T), b.r], axis=1))
    jac_p, r_p = jax.jit(lambda st: srt._placed_eval(bi, st))(state)
    np.testing.assert_allclose(
        np.asarray(jac_p), np.asarray(placed_ref[..., : m * T]),
        rtol=1e-6, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(r_p), np.asarray(placed_ref[..., m * T :]),
        rtol=1e-6, atol=1e-12,
    )
