"""CLUSTER_TRIDIAGONAL preconditioner (reference:
visibility_based_preconditioner.cc): CLUSTER_JACOBI's block diagonal plus
the adjacent-cluster coupling band, factored by block LDL^T."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import skeres as st
from skeres.core.evaluator import Evaluator
from skeres.core.linear_solvers import lm_diagonal
from skeres.core.options import SolverOptions
from skeres.core.schur import SchurSolver
from skeres.core.types import (
    LinearSolverType,
    PreconditionerType,
    TerminationType,
)
from skeres.io.bal import build_bal_problem, synthetic_bal


def _setup(nc=9, cluster=3):
    bal = synthetic_bal(num_cameras=nc, num_points=80,
                        observations_per_point=4)
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    _, blocks = jax.jit(ev.blocks)(state)
    g, diag = jax.jit(ev.gradient_and_diag)(blocks)
    return ev, blocks, g, diag


def test_tridiag_apply_inverts_the_masked_s():
    """precond(T v) == v where T is the dense S masked to the cluster
    tridiagonal pattern (boost zeroed; f64 CPU)."""
    ev, blocks, g, diag = _setup()
    srt = SchurSolver(
        ev,
        iterative=True,
        preconditioner=PreconditionerType.CLUSTER_TRIDIAGONAL,
        cluster_size=3,
        cluster_boost=0.0,
    )
    assert srt.cluster_plan is not None and srt.cluster_plan.cluster_band
    dense = SchurSolver(ev, iterative=False)
    data = srt.solver_data(blocks)
    d = lm_diagonal(diag, 1e-3, 1e-6, 1e32)
    asm = srt._assemble(data, g, d)
    asm_d = dense._assemble(data, g, d)
    s = np.asarray(dense._dense_s(asm_d))

    f = srt.cluster_plan.f
    nc = srt.cluster_plan.nc
    cl = np.arange(nc) // 3
    mask = np.abs(cl[:, None] - cl[None, :]) <= 1
    mask_full = np.kron(mask, np.ones((f, f), dtype=bool))
    t_mat = np.where(mask_full, s, 0.0)

    precond = srt._cluster_tridiag_precond(asm)
    rng = np.random.default_rng(0)
    v = rng.normal(size=s.shape[0])
    r = t_mat @ v
    v_rec = np.asarray(precond(jnp.asarray(r, dtype=ev.dtype)))
    np.testing.assert_allclose(v_rec, v, rtol=1e-6, atol=1e-8)


def test_tridiag_is_at_least_as_strong_as_cluster_jacobi():
    """End-to-end ITERATIVE_SCHUR solves: CLUSTER_TRIDIAGONAL must reach
    the SCHUR_JACOBI solution and not need more PCG iterations than
    CLUSTER_JACOBI (it extends it with the coupling band)."""
    bal = synthetic_bal(num_cameras=12, num_points=100,
                        observations_per_point=4)

    def run(precond):
        problem, _, _ = build_bal_problem(bal)
        s = st.solve(
            SolverOptions(
                linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
                preconditioner_type=precond,
                cluster_jacobi_size=4,
                max_num_iterations=20,
            ),
            problem,
        )
        its = sum(it.linear_solver_iterations for it in s.iterations)
        return s, its

    s_ct, it_ct = run(PreconditionerType.CLUSTER_TRIDIAGONAL)
    s_cj, it_cj = run(PreconditionerType.CLUSTER_JACOBI)
    s_sj, _ = run(PreconditionerType.SCHUR_JACOBI)
    assert s_ct.termination_type == TerminationType.CONVERGENCE, s_ct.message
    np.testing.assert_allclose(s_ct.final_cost, s_sj.final_cost, rtol=1e-3)
    assert it_ct <= it_cj * 1.1, (it_ct, it_cj)


def test_tridiag_downgrades_without_structure():
    """Non-Schur-structured problems downgrade to SCHUR_JACOBI (reference
    preprocessor downgrade semantics) instead of failing."""
    problem = st.Problem()
    x = problem.add_parameter_block([1.0, 2.0])

    def r(params, data):
        (p,) = params
        return p - jnp.asarray([3.0, 4.0])

    problem.add_residual_block(r, None, [x])
    s = st.solve(
        SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=PreconditionerType.CLUSTER_TRIDIAGONAL,
            max_num_iterations=20,
        ),
        problem,
    )
    assert s.is_solution_usable


@pytest.mark.gpu
@pytest.mark.parametrize(
    "precond",
    [PreconditionerType.CLUSTER_JACOBI, PreconditionerType.CLUSTER_TRIDIAGONAL],
)
def test_cluster_preconditioned_pcg_matches_dense_factor_on_gpu(gpu, precond):
    """f32 on the card, 240 cameras: the cluster-preconditioned PCG damped
    solve (factor inverses hoisted out of the PCG while_loop) must land
    near the DENSE_SCHUR factorization's step. Healthy f32 PCG with the
    Q-test stops 0.1-0.5 away in relative terms (0.42 and 0.12 on the
    CPU); a broken preconditioner gives steps orders of magnitude off, so
    1.0 separates the two."""
    bal = synthetic_bal(num_cameras=240, num_points=20_000,
                        observations_per_point=4)
    problem, _, _ = build_bal_problem(bal)
    ev = Evaluator(problem.compile(), dtype=jnp.float32)
    state = ev.program.initial_state(ev.dtype)

    def lin(consts, state):
        with ev.bind(consts):
            _, blocks = ev.blocks(state)
            return (blocks,) + ev.gradient_and_diag(blocks)

    blocks, g, diag = jax.jit(lin)(ev.device_consts, state)

    def step(solver):
        data = solver.solver_data(blocks)

        def run(consts, g, diag):
            with ev.bind(consts):
                return solver.solve_damped(data, g, diag, 1e-4, 1e-6, 1e32)[0]

        return np.asarray(jax.jit(run)(ev.device_consts, g, diag))

    dx_ref = step(SchurSolver(ev, iterative=False))
    dx = step(SchurSolver(ev, iterative=True, preconditioner=precond,
                          cluster_size=48, max_cg_iterations=200, eta=1e-7))
    rel = np.linalg.norm(dx - dx_ref) / np.linalg.norm(dx_ref)
    assert np.isfinite(rel) and rel < 1.0, rel
