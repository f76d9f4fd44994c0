"""ExplicitSchurPlan unit tests against a brute-force oracle.

The scatter-free pair-product assembly (core/explicit_schur.py) is the
flagship DENSE_SCHUR path (reference counterpart:
``schur_complement_solver.cc`` assembling S cell by cell); these tests pin
its arithmetic — including the SPMD mode's per-shard hierarchical sums,
placement levels, and the replicated straddle-point fixup — against a
direct numpy evaluation of  sum_p  Y_pk A_pl^T  (k < l) on random
problems with NON-uniform observation counts and evaluator-style padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from skeres.core.explicit_schur import ExplicitSchurPlan

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

F, E = 5, 3  # deliberately not the BAL 9/3


def _random_case(seed, num_points=37, num_cameras=11, n_shards=1):
    """Point-sorted rows with varying per-point counts + padded tail."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 7, size=num_points)
    pt_idx = np.repeat(np.arange(num_points), counts)
    n_valid = len(pt_idx)
    cam_idx = rng.integers(0, num_cameras, size=n_valid)
    pad = (-n_valid) % max(n_shards, 1)
    # evaluator padding convention: repeat row 0's indices
    pt_idx = np.concatenate([pt_idx, np.full(pad, pt_idx[0])])
    cam_idx = np.concatenate([cam_idx, np.full(pad, cam_idx[0])])
    a_flat = rng.normal(size=(len(pt_idx), F * E)).astype(np.float32)
    a_flat[n_valid:] = 0.0
    cinv = rng.normal(size=(num_points, E, E)).astype(np.float32)
    cinv = cinv + np.swapaxes(cinv, 1, 2)  # symmetric like C^-1
    return pt_idx, cam_idx, n_valid, a_flat, cinv, num_cameras, num_points


def _oracle_offdiag(pt_idx, cam_idx, n_valid, a_flat, cinv, nc):
    """Dense (nc*F, nc*F) off-diagonal correction, brute force in f64."""
    a = a_flat[:n_valid].astype(np.float64).reshape(n_valid, F, E)
    y = np.einsum("rfe,reg->rfg", a, cinv.astype(np.float64)[pt_idx[:n_valid]])
    out = np.zeros((nc * F, nc * F))
    for p in np.unique(pt_idx[:n_valid]):
        rows = np.nonzero(pt_idx[:n_valid] == p)[0]
        for i, r in enumerate(rows):
            for s in rows[i + 1 :]:
                ca, cb = cam_idx[r], cam_idx[s]
                t = y[r] @ a[s].T  # (F, F)
                out[ca * F : ca * F + F, cb * F : cb * F + F] += t
                out[cb * F : cb * F + F, ca * F : ca * F + F] += t.T
    return out


def _plan_offdiag(plan, a_flat, cinv, mesh=None):
    a = jnp.asarray(a_flat)
    if mesh is not None:
        a = jax.device_put(a, NamedSharding(mesh, PartitionSpec("obs")))

    def f(a, cinv_flat):
        grid = plan.build_grid(a)
        uniq = plan.correction_offdiag(grid, cinv_flat)
        return plan.dense_s_offdiag(uniq)

    return np.asarray(
        jax.jit(f)(a, jnp.asarray(cinv.reshape(-1, E * E)))
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_local_plan_matches_oracle(seed):
    pt, cam, nv, a, cinv, nc, npts = _random_case(seed)
    plan = ExplicitSchurPlan(
        cam_idx=cam, pt_idx=pt, num_cameras=nc, num_points=npts,
        f_size=F, e_size=E, n_valid=nv, pad_waste=100.0,
    )
    got = _plan_offdiag(plan, a, cinv)
    want = _oracle_offdiag(pt, cam, nv, a, cinv, nc)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@requires_multidevice
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_sharded_plan_matches_oracle(seed):
    """SPMD mode: contiguous row shards, per-shard hierarchical sums, one
    psum over the global unique-pair table, replicated straddle fixup —
    must reproduce the oracle AND the local plan bit-for-tolerance."""
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("obs",))
    pt, cam, nv, a, cinv, nc, npts = _random_case(seed, n_shards=8)
    plan8 = ExplicitSchurPlan(
        cam_idx=cam, pt_idx=pt, num_cameras=nc, num_points=npts,
        f_size=F, e_size=E, n_valid=nv, pad_waste=100.0,
        mesh=mesh, n_shards=8,
    )
    assert plan8.mesh is not None
    # contiguous split of point-sorted rows: straddle count is bounded
    assert plan8.n_straddle <= 7
    got = _plan_offdiag(plan8, a, cinv, mesh=mesh)
    want = _oracle_offdiag(pt, cam, nv, a, cinv, nc)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)

    plan1 = ExplicitSchurPlan(
        cam_idx=cam, pt_idx=pt, num_cameras=nc, num_points=npts,
        f_size=F, e_size=E, n_valid=nv, pad_waste=100.0,
    )
    local = _plan_offdiag(plan1, a, cinv)
    np.testing.assert_allclose(got, local, rtol=1e-5, atol=1e-5)


@requires_multidevice
def test_sharded_plan_small_shards_and_empty():
    """More shards than points-per-shard; some shards own zero whole
    points (everything straddles or is empty) — the padded level plans
    must still reduce correctly."""
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("obs",))
    # 3 points with many observations each: every point straddles shards
    rng = np.random.default_rng(5)
    counts = np.array([9, 8, 7])
    pt = np.repeat(np.arange(3), counts)
    cam = rng.integers(0, 4, size=len(pt))
    a = rng.normal(size=(len(pt), F * E)).astype(np.float32)
    cinv = rng.normal(size=(3, E, E)).astype(np.float32)
    cinv = cinv + np.swapaxes(cinv, 1, 2)
    plan = ExplicitSchurPlan(
        cam_idx=cam, pt_idx=pt, num_cameras=4, num_points=3,
        f_size=F, e_size=E, n_valid=len(pt), pad_waste=100.0,
        mesh=mesh, n_shards=8,
    )
    got = _plan_offdiag(plan, a, cinv, mesh=mesh)
    want = _oracle_offdiag(pt, cam, len(pt), a, cinv, 4)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_chunked_assembly_bounded_and_correct():
    """Standalone-jit memory sanity: the pair-product
    pipeline streams in byte-budgeted chunks, so compiling the assembly
    ALONE must not materialize intermediates far beyond the (by-design)
    pair-value table itself; and a tiny chunk budget must not change the
    result."""
    pt, cam, nv, a, cinv, nc, npts = _random_case(
        7, num_points=4000, num_cameras=40
    )

    def run(budget):
        plan = ExplicitSchurPlan(
            cam_idx=cam, pt_idx=pt, num_cameras=nc, num_points=npts,
            f_size=F, e_size=E, n_valid=nv, pad_waste=100.0,
            chunk_value_budget=budget,
        )

        def f(a_in, cinv_flat):
            grid = plan.build_grid(a_in)
            return plan.correction_offdiag(grid, cinv_flat)

        lowered = jax.jit(f).lower(
            jnp.asarray(a), jnp.asarray(cinv.reshape(-1, E * E))
        )
        compiled = lowered.compile()
        uniq = np.asarray(
            compiled(jnp.asarray(a), jnp.asarray(cinv.reshape(-1, E * E)))
        )
        return plan, compiled.memory_analysis().temp_size_in_bytes, uniq

    plan_small, temp_small, uniq_small = run(1 << 18)  # ~256 KB chunks
    plan_big, temp_big, uniq_big = run(1 << 30)  # effectively unchunked
    assert plan_small.chunk_points < plan_big.chunk_points
    np.testing.assert_allclose(uniq_small, uniq_big, rtol=1e-5, atol=1e-4)
    # the pair-value table itself is materialized by design; everything
    # else must stay within a small multiple of it
    pair_value_bytes = npts * plan_small.kp * (plan_small.kp - 1) // 2 * F * F * 4
    assert temp_small < 4 * pair_value_bytes + (1 << 22), (
        temp_small,
        pair_value_bytes,
    )


@pytest.mark.parametrize("seed", [1, 4])
def test_pair_values_match_oracle(seed):
    """The XLA pair-value path (chunked so several lax.map chunks run)
    reduced and gather-built into the dense off-diagonal must match the
    brute-force oracle."""
    pt, cam, nv, a, cinv, nc, npts = _random_case(seed, num_points=23)
    plan = ExplicitSchurPlan(
        cam_idx=cam, pt_idx=pt, num_cameras=nc, num_points=npts,
        f_size=F, e_size=E, n_valid=nv, pad_waste=100.0,
    )
    plan.chunk_points = 8
    got = _plan_offdiag(plan, a, cinv)
    oracle = _oracle_offdiag(pt, cam, nv, a, cinv, nc)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


# -- Summary.schur_complement_path surfacing -----------------------------------


def _solve_bal(**opt_kwargs):
    import skeres as st
    from skeres.core.options import SolverOptions
    from skeres.core.types import LinearSolverType
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=6, num_points=50, observations_per_point=3)
    problem, _, _ = build_bal_problem(bal)
    options = SolverOptions(
        max_num_iterations=2,
        **opt_kwargs,
    )
    return st.solve(options, problem)


def test_schur_path_explicit_reported():
    from skeres.core.types import LinearSolverType

    s = _solve_bal(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        use_explicit_schur_complement=True,
    )
    assert s.schur_complement_path == "explicit"
    assert "Schur complement" in s.full_report()


def test_schur_path_gate_rejection_reported():
    """Force the size gate to reject the wanted explicit plan: the path
    string must say so (and name the reason) instead of silently running
    the implicit fallback."""
    from skeres.core.types import LinearSolverType

    s = _solve_bal(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        use_explicit_schur_complement=True,
        explicit_schur_limit_bytes=0,
    )
    assert s.schur_complement_path.startswith("implicit (gate: S too large")


def test_schur_path_dense_small_problem():
    from skeres.core.types import LinearSolverType

    s = _solve_bal(linear_solver_type=LinearSolverType.DENSE_SCHUR)
    # small problems take the dense-W einsum path; no gate string
    assert s.schur_complement_path in ("dense-W", "explicit")
    assert "gate" not in s.schur_complement_path


def test_direct_grid_build_matches_flat_path():
    """_explicit_a_grid (k-strided direct grid construction, used when the
    grid is a pure reshape of point-grouped rows) must equal
    build_grid(_explicit_a_flat(...))."""
    import jax
    import jax.numpy as jnp

    from skeres.core.evaluator import Evaluator
    from skeres.core.schur import SchurSolver
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=9, num_points=80, observations_per_point=4)
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    _, blocks = jax.jit(ev.blocks)(state)
    schur = SchurSolver(ev, iterative=False, sort_threshold=1)
    plan = schur.explicit_plan
    if plan is None or not getattr(plan, "grid_is_reshape", False):
        import pytest

        pytest.skip("fixture did not produce a reshape grid")
    per_batch = [(b.r, b.jac, schur._split_E(bi, b.jac))
                 for bi, b in enumerate(blocks)]
    ref = jax.jit(
        lambda pb: plan.build_grid(schur._explicit_a_flat(pb))["grid"]
    )(per_batch)
    got = jax.jit(
        lambda pb: schur._explicit_a_grid(pb, plan.kp, plan.np_ * plan.kp)
    )(per_batch)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-6, atol=1e-12)


def test_reshape_grid_with_chunk_pad_tail():
    """grid_is_reshape must survive evaluator chunk padding (pad rows are
    not grid slots); the padded batch's grid — both the build_grid
    reshape and the direct strided build — must equal the unpadded
    problem's grid."""
    import jax

    from skeres.core.evaluator import Evaluator
    from skeres.core.schur import SchurSolver
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(num_cameras=9, num_points=90, observations_per_point=4)

    def grids(chunk):
        problem, _, _ = build_bal_problem(bal)
        program = problem.compile()
        ev = Evaluator(program, chunk_size=chunk)
        state = program.initial_state(ev.dtype)
        _, blocks = jax.jit(ev.blocks)(state)
        schur = SchurSolver(ev, iterative=False, sort_threshold=1)
        plan = schur.explicit_plan
        assert plan is not None and plan.grid_is_reshape
        per_batch = [(b.r, b.jac, schur._split_E(bi, b.jac))
                     for bi, b in enumerate(blocks)]
        g1 = jax.jit(
            lambda pb: plan.build_grid(schur._explicit_a_flat(pb))["grid"]
        )(per_batch)
        g2 = jax.jit(
            lambda pb: schur._explicit_a_grid(
                pb, plan.kp, plan.np_ * plan.kp
            )
        )(per_batch)
        return np.asarray(g1), np.asarray(g2), blocks[0].jac.shape[0]

    # chunk 90 divides into 4 chunks of 90 with no pad? B=360 -> lcm
    # quantum 90 -> no pad; use 100: pad to 400
    g1p, g2p, rows_padded = grids(100)
    assert rows_padded == 400  # really padded
    g1u, g2u, rows_u = grids(None)
    assert rows_u == 360
    np.testing.assert_allclose(g1p, g1u, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(g2p, g1u, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(g2u, g1u, rtol=1e-6, atol=1e-12)
