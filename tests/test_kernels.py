"""Tests for the kernel layer: the reduced-camera-system Cholesky solve,
segment-reduce plans, and closed-form small SPD inverses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skeres.core.schur import SchurSolver
from skeres.ops.segment_reduce import apply_reduce_plan, build_reduce_plan
from skeres.ops.small_inverse import batched_spd_inverse


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    return m @ m.T + n * np.eye(n), rng.standard_normal(n)


@pytest.mark.parametrize("n", [5, 37, 128, 300, 441, 515])
def test_factor_solve_matches_numpy(n):
    """The single Cholesky path (441 is BAL-49's S) against float64."""
    a, b = _spd(n, n)
    x = jax.jit(lambda a, b: SchurSolver._factor_solve(a, b)[0])(
        jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)
    )
    want = np.linalg.solve(a, b)
    np.testing.assert_allclose(np.asarray(x), want, rtol=0,
                               atol=5e-4 * np.abs(want).max())


def test_factor_solve_closure_reuses_the_factor():
    """Mixed-precision refinement calls the returned solve closure on new
    right-hand sides: it must solve with the same factor, and one f64
    refinement step must shrink the f32 residual."""
    a, b = _spd(200, 1)
    a32 = jnp.asarray(a, jnp.float32)

    def refine(a32, b32):
        x, solve = SchurSolver._factor_solve(a32, b32)
        r = b32.astype(jnp.float64) - a32.astype(jnp.float64) @ x.astype(
            jnp.float64
        )
        return x, x + solve(r.astype(jnp.float32)), solve(2.0 * b32)

    x, x_ref, x2 = jax.jit(refine)(a32, jnp.asarray(b, jnp.float32))
    want = np.linalg.solve(a, b)
    np.testing.assert_allclose(np.asarray(x2), 2.0 * np.asarray(x),
                               rtol=1e-5, atol=1e-7)
    err = np.linalg.norm(np.asarray(x, np.float64) - want)
    err_ref = np.linalg.norm(np.asarray(x_ref, np.float64) - want)
    assert err_ref <= err


def test_factor_solve_non_pd_gives_nonfinite():
    """The jitter ladder in solve_damped detects a failed factor by a
    non-finite solution."""
    a = np.diag([1.0, -1.0, 2.0])
    x, _ = SchurSolver._factor_solve(jnp.asarray(a, jnp.float32),
                                     jnp.ones(3, jnp.float32))
    assert not np.all(np.isfinite(np.asarray(x)))


@pytest.mark.parametrize("kind_cfg", [
    # (n_dest, force) combos that exercise each plan kind
    dict(n_dest=7, force=False),        # onehot
    dict(n_dest=5000, force=False),     # gather (bounded fan-in)
    dict(n_dest=7, force=True),         # scatter
])
def test_reduce_plans_match_scatter(kind_cfg):
    rng = np.random.default_rng(0)
    b, d = 2000, 6
    idx = rng.integers(0, kind_cfg["n_dest"], size=b)
    vals = rng.standard_normal((b, d))
    plan = build_reduce_plan(
        idx, kind_cfg["n_dest"], force_scatter=kind_cfg["force"]
    )
    got = np.asarray(apply_reduce_plan(plan, jnp.asarray(vals)))
    want = np.zeros((kind_cfg["n_dest"], d))
    np.add.at(want, idx, vals)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_gather_plan_selected_for_bounded_fanin():
    # many destinations, each hit at most a few times, NOT grouped
    # contiguously (the grouped shape now takes the 'contig' plan —
    # tests/test_segment_reduce.py) -> 'gather'
    rng = np.random.default_rng(0)
    idx = np.repeat(np.arange(4096), 3)
    rng.shuffle(idx)
    plan = build_reduce_plan(idx, 4096)
    assert plan.kind == "gather"
    vals = rng.standard_normal((len(idx), 2))
    got = np.asarray(apply_reduce_plan(plan, jnp.asarray(vals)))
    want = np.zeros((4096, 2))
    np.add.at(want, idx, vals)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("e", [1, 2, 3, 5])
def test_batched_spd_inverse(e):
    rng = np.random.default_rng(e)
    m = rng.standard_normal((64, e, e))
    a = m @ np.swapaxes(m, 1, 2) + 2 * e * np.eye(e)
    inv = np.asarray(batched_spd_inverse(jnp.asarray(a)))
    np.testing.assert_allclose(inv, np.linalg.inv(a), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("spec,sa,sb", [
    ("bme,bmf->bef", (100, 2, 3), (100, 2, 3)),
    ("bmi,bm->bi", (100, 2, 12), (100, 2)),
    ("bmi,bi->bm", (100, 2, 12), (100, 12)),
    ("bme,be->bm", (100, 2, 3), (100, 3)),
    ("pef,pf->pe", (50, 3, 3), (50, 3)),
    ("bfe,beg->bfg", (40, 9, 3), (40, 3, 9)),
    ("bfe,bge->bfg", (40, 9, 3), (40, 9, 3)),
    ("bmf,bmg->bfg", (40, 2, 9), (40, 2, 9)),
    ("pcfe,peg->pcfg", (7, 5, 9, 3), (7, 3, 9)),
])
def test_vpu_einsum_matches_einsum(spec, sa, sb):
    from skeres.ops.small_einsum import vpu_einsum

    rng = np.random.default_rng(3)
    a = jnp.asarray(rng.standard_normal(sa))
    b = jnp.asarray(rng.standard_normal(sb))
    np.testing.assert_allclose(
        np.asarray(vpu_einsum(spec, a, b)),
        np.asarray(jnp.einsum(spec, a, b)),
        rtol=1e-12, atol=1e-12,
    )
