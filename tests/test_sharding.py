"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §5.6): the sharded, psum-reduced evaluation must agree with the
single-device result, and the full sharded LM step must execute.

There is no reference counterpart (the lineage is single-process); this is
the new distributed capability's correctness harness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import skeres as st
from skeres.core.evaluator import Evaluator
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType, TerminationType
from skeres.io.bal import build_bal_problem, synthetic_bal


requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:8]), axis_names=("obs",))


@pytest.fixture(scope="module")
def bal():
    # 6 cameras / 50 points / 3 obs -> 150 observations, not divisible by 8:
    # exercises the padding + weight-masking path
    return synthetic_bal(num_cameras=6, num_points=50, observations_per_point=3)


@requires_multidevice
def test_sharded_eval_matches_single_device(mesh, bal):
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()

    ev1 = Evaluator(program)
    state1 = program.initial_state(ev1.dtype)
    cost1, blocks1 = jax.jit(ev1.blocks)(state1)
    g1, diag1 = jax.jit(ev1.gradient_and_diag)(blocks1)

    ev8 = Evaluator(program, mesh=mesh)
    state8 = ev8.prepare_state(program.initial_state(ev8.dtype))
    cost8, blocks8 = jax.jit(ev8.blocks)(state8)
    g8, diag8 = jax.jit(ev8.gradient_and_diag)(blocks8)

    np.testing.assert_allclose(float(cost8), float(cost1), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g8), np.asarray(g1), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(diag8), np.asarray(diag1), rtol=1e-10)


@requires_multidevice
def test_sharded_solve_matches_single_device(mesh, bal):
    def run(mesh_arg):
        problem, cams, pts = build_bal_problem(bal)
        options = SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            max_num_iterations=40,
            mesh=mesh_arg,
        )
        summary = st.solve(options, problem)
        return summary

    s1 = run(None)
    s8 = run(mesh)
    assert s8.num_devices == len(jax.devices())
    np.testing.assert_allclose(s8.initial_cost, s1.initial_cost, rtol=1e-10)
    # the sharded path reduces per-shard windows then psums, the
    # single-device path uses global gather/one-hot plans
    # (ops/segment_reduce.py); different summation orders perturb the LM
    # trajectory, so compare the *converged* cost rather than a
    # bitwise-identical trajectory
    assert s1.termination_type == TerminationType.CONVERGENCE
    assert s8.termination_type == TerminationType.CONVERGENCE
    np.testing.assert_allclose(s8.final_cost, s1.final_cost, rtol=1e-5)


@requires_multidevice
def test_sharded_padded_matvec_matches_generic(mesh, bal):
    """The sharded camera-padded (gather-free) Schur path must agree with
    the sharded generic-plan path; exact same arithmetic per shard modulo
    reduction order, so tolerances are tight."""
    from skeres.core.linear_solvers import lm_diagonal
    from skeres.core.schur import SchurSolver

    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program, mesh=mesh)
    state = ev.prepare_state(program.initial_state(ev.dtype))
    cost, blocks = jax.jit(ev.blocks)(state)
    g, diag = jax.jit(ev.gradient_and_diag)(blocks)
    d = lm_diagonal(diag, 1e-4, 1e-6, 1e32)

    outs = {}
    for label, thresh in (("generic", 10**12), ("padded", 1)):
        schur = SchurSolver(
            ev, iterative=True, sort_threshold=thresh, pad_waste=100.0
        )
        if label == "padded":
            assert schur.sorted_info, "padded path not engaged"
            assert all(
                si["kind"] == "sharded" for si in schur.sorted_info.values()
            )
        data = schur.solver_data(blocks)
        asm = jax.jit(lambda dd: schur._assemble(data, g, dd))(d)
        rhs = schur._schur_rhs(asm)
        v = jnp.asarray(
            np.random.default_rng(3).normal(size=rhs.shape), rhs.dtype
        )
        outs[label] = (
            np.asarray(rhs),
            np.asarray(schur._s_matvec(asm, v)),
            [np.asarray(b) for b in schur._schur_jacobi_blocks(asm)],
        )

    np.testing.assert_allclose(outs["padded"][0], outs["generic"][0], rtol=1e-9)
    np.testing.assert_allclose(outs["padded"][1], outs["generic"][1], rtol=1e-9)
    for bp, bg in zip(outs["padded"][2], outs["generic"][2]):
        np.testing.assert_allclose(bp, bg, rtol=1e-9)


@requires_multidevice
def test_sharded_padded_solve_matches_single_device(mesh, bal):
    """Full solve through the public API with the sharded padded layout."""
    def run(mesh_arg, thresh):
        problem, _, _ = build_bal_problem(bal)
        options = SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            max_num_iterations=40,
            mesh=mesh_arg,
            jacobian_sort_threshold=thresh,
        )
        return st.solve(options, problem)

    s1 = run(None, 10**12)
    s8 = run(mesh, 1)
    assert s1.termination_type == TerminationType.CONVERGENCE
    assert s8.termination_type == TerminationType.CONVERGENCE
    np.testing.assert_allclose(s8.final_cost, s1.final_cost, rtol=1e-5)


@requires_multidevice
def test_graft_dryrun_multichip():
    """The driver's multi-chip entry must run on the fake mesh."""
    import importlib.util, os

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


@requires_multidevice
def test_sharded_explicit_s_matches_single_device(mesh, bal):
    """The flagship explicit-S assembly must produce the same reduced
    camera system under the mesh (per-shard pair products + hierarchical
    partial sums + one psum over the unique-pair table + replicated
    straddle fixup) as on a single device."""
    from skeres.core.linear_solvers import lm_diagonal
    from skeres.core.schur import SchurSolver

    def build(mesh_arg):
        problem, _, _ = build_bal_problem(bal)
        program = problem.compile()
        ev = Evaluator(program, mesh=mesh_arg)
        state = ev.prepare_state(program.initial_state(ev.dtype))
        cost, blocks = jax.jit(ev.blocks)(state)
        g, diag = jax.jit(ev.gradient_and_diag)(blocks)
        schur = SchurSolver(ev, iterative=False)
        assert schur.explicit_plan is not None
        if mesh_arg is not None:
            assert schur.explicit_plan.mesh is not None, "plan not sharded"
        data = schur.solver_data(blocks)
        d = lm_diagonal(diag, 1e-4, 1e-6, 1e32)

        def f(dd):
            asm = schur._assemble(data, g, dd)
            return schur._dense_s_explicit(asm), schur._schur_rhs(asm)

        s, rhs = jax.jit(f)(d)
        return np.asarray(s), np.asarray(rhs)

    s1, rhs1 = build(None)
    s8, rhs8 = build(mesh)
    scale = np.abs(s1).max()
    np.testing.assert_allclose(s8, s1, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(rhs8, rhs1, rtol=1e-5,
                               atol=1e-5 * np.abs(rhs1).max())


@requires_multidevice
def test_sharded_dense_schur_solve_matches_single_device(mesh, bal):
    """Full DENSE_SCHUR solve through the public API on the mesh — runs
    the sharded explicit-S path end to end."""
    def run(mesh_arg):
        problem, _, _ = build_bal_problem(bal)
        options = SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR,
            max_num_iterations=40,
            mesh=mesh_arg,
        )
        return st.solve(options, problem)

    s1 = run(None)
    s8 = run(mesh)
    assert s1.termination_type == TerminationType.CONVERGENCE
    assert s8.termination_type == TerminationType.CONVERGENCE
    np.testing.assert_allclose(s8.final_cost, s1.final_cost, rtol=1e-4)


@requires_multidevice
def test_sharded_iterative_explicit_solve(mesh, bal):
    """ITERATIVE_SCHUR + use_explicit_schur_complement under the mesh:
    S materialized via the sharded pair-product plan, PCG on the
    replicated S."""
    problem, _, _ = build_bal_problem(bal)
    s8 = st.solve(
        SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            use_explicit_schur_complement=True,
            max_num_iterations=40,
            mesh=mesh,
        ),
        problem,
    )
    assert s8.termination_type == TerminationType.CONVERGENCE
    problem1, _, _ = build_bal_problem(bal)
    s1 = st.solve(
        SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR,
            max_num_iterations=40,
        ),
        problem1,
    )
    np.testing.assert_allclose(s8.final_cost, s1.final_cost, rtol=1e-4)


@requires_multidevice
def test_sharded_padded_gradient_diag_matches_generic(mesh, bal):
    """gradient_and_diag_padded under a mesh (per-shard K-sums + one
    psum) must equal the generic sharded reductions, and the
    padded-space scaling must equal re-placing scaled rows."""
    from skeres.core.schur import SchurSolver

    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program, mesh=mesh)
    state = ev.prepare_state(program.initial_state(ev.dtype))
    _, blocks = jax.jit(ev.blocks)(state)

    schur = SchurSolver(
        ev, iterative=True, sort_threshold=1, pad_waste=100.0
    )
    assert schur.sorted_info
    g0, d0 = jax.jit(ev.gradient_and_diag)(blocks)
    g1, d1, cam_raw = jax.jit(schur.gradient_and_diag_padded)(blocks)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d0), rtol=1e-9)

    from skeres.core.linear_solvers import lm_diagonal

    scale = 1.0 / (1.0 + jnp.sqrt(jnp.maximum(d0, 0.0)))
    data = schur.solver_data(blocks)
    sdata = schur.scale_data(data, scale)
    prep_ref = jax.jit(schur.prepare)(sdata)
    prep_new = jax.jit(
        lambda sd, cr, sc: schur.prepare(sd, cam_raw=cr, scale=sc)
    )(sdata, cam_raw, scale)
    gs = g0 * scale
    d = lm_diagonal(d0 * scale * scale, 1e-3, 1e-6, 1e32)
    asm_ref = jax.jit(lambda p: schur._assemble(p, gs, d))(prep_ref)
    asm_new = jax.jit(lambda p: schur._assemble(p, gs, d))(prep_new)
    np.testing.assert_allclose(
        np.asarray(schur._schur_rhs(asm_new)),
        np.asarray(schur._schur_rhs(asm_ref)),
        rtol=1e-9,
    )
    for bn, br in zip(
        schur._schur_jacobi_blocks(asm_new),
        schur._schur_jacobi_blocks(asm_ref),
    ):
        np.testing.assert_allclose(np.asarray(bn), np.asarray(br), rtol=1e-9)
