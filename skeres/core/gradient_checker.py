"""Gradient checking: jvp-Jacobians vs numeric differentiation.

JAX counterpart of the reference lineage's gradient-checking layer
(``include/ceres/gradient_checker.h``,
``internal/ceres/gradient_checking_cost_function.cc``,
``internal/ceres/numeric_diff.h``). The reference wraps every CostFunction
in a checking proxy; here the check runs once per *batch* (all blocks of a
batch share one residual function, so checking the whole batch at the
initial state covers every block's actual evaluation point).

Central finite differences are taken in the *tangent space* of each block
(through ``manifold.plus``), matching how the solver's Jacobians are
defined, and compared against the ``jax.linearize`` Jacobian.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["check_program_gradients", "numeric_jacobian"]


def numeric_jacobian(
    f, t_dim: int, dtype, relative_step_size: float = 1e-6, method="central"
):
    """Central- or forward-difference Jacobian of ``f: (T,) -> (m,)`` at 0.

    Step size per coordinate follows the reference's NumericDiffOptions:
    ``h = relative_step_size`` around the zero tangent (the tangent origin
    has no scale, so the relative step degenerates to an absolute one —
    same as the reference at x = 0).
    """
    h = relative_step_size
    basis = jnp.eye(t_dim, dtype=dtype)

    if method == "forward":
        f0 = f(jnp.zeros((t_dim,), dtype=dtype))

        def col(e):
            return (f(h * e) - f0) / h

    elif method == "central":

        def col(e):
            return (f(h * e) - f(-h * e)) / (2.0 * h)

    else:
        raise ValueError(
            f"unknown numeric_diff_method {method!r} "
            "(expected 'central', 'forward', or 'ridders')"
        )

    cols = jax.vmap(col)(basis)  # (T, m)
    return jnp.swapaxes(cols, 0, 1)  # (m, T)


def ridders_jacobian(
    f,
    t_dim: int,
    dtype,
    relative_step_size: float = 1e-2,
    max_extrapolations: int = 5,
    step_shrink: float = 2.0,
):
    """Ridders-extrapolated numeric Jacobian of ``f: (T,) -> (m,)`` at 0
    (reference: ``internal/ceres/numeric_diff.h`` RIDDERS, after Ridders
    '82 / Numerical Recipes ``dfridr``).

    Central differences at geometrically shrinking steps h, h/s, h/s^2,
    ... fill the first column of a Neville tableau; Richardson
    extrapolation in h^2 eliminates successive even error terms. The
    reference adapts the number of levels per coordinate at run time;
    under jit the tableau is a STATIC unroll of ``max_extrapolations``
    levels (data-dependent early-out would break tracing), and the
    best-converged entry is selected per output element with a masked
    argmin over adjacent-entry differences — same estimator, fixed
    schedule. The larger default first step (1e-2 vs central's 1e-6) is
    the reference's: extrapolation kills the truncation error, so the
    first step can be big enough to dodge cancellation noise.
    """
    n = max_extrapolations
    s2 = step_shrink * step_shrink
    basis = jnp.eye(t_dim, dtype=dtype)

    def col(e):
        # first tableau column: central differences at shrinking steps
        hs = relative_step_size / (step_shrink ** jnp.arange(n, dtype=dtype))
        d0 = jax.vmap(lambda h: (f(h * e) - f(-h * e)) / (2.0 * h))(hs)
        # Neville/Richardson: T[i,j] from T[i,j-1], T[i+1,j-1]
        tableau = [d0[i] for i in range(n)]
        best = tableau[0]
        best_err = jnp.full(best.shape, jnp.inf, dtype)
        fac = jnp.asarray(1.0, dtype)
        for j in range(1, n):
            fac = fac * s2
            nxt = []
            for i in range(n - j):
                t_ij = (tableau[i + 1] * fac - tableau[i]) / (fac - 1.0)
                err = jnp.maximum(
                    jnp.abs(t_ij - tableau[i]), jnp.abs(t_ij - tableau[i + 1])
                )
                if i == 0:
                    take = err <= best_err
                    best = jnp.where(take, t_ij, best)
                    best_err = jnp.where(take, err, best_err)
                nxt.append(t_ij)
            tableau = nxt
        return best

    cols = jax.vmap(col)(basis)  # (T, m)
    return jnp.swapaxes(cols, 0, 1)  # (m, T)


def check_program_gradients(
    program,
    evaluator,
    relative_precision: float = 1e-8,
    step_size: float = 1e-6,
) -> Tuple[bool, str]:
    """Check every batch's analytic-vs-numeric Jacobian at the current state.

    Returns (ok, message); message names the first offending batch and the
    worst relative error, mirroring the reference's log-and-abort behavior.
    """
    state = program.initial_state(evaluator.dtype)
    dtype = evaluator.dtype

    for bi, batch in enumerate(program.batches):
        if batch.numeric_diff:
            # this batch SOLVES with numeric derivatives — comparing them
            # against themselves is vacuous, and against jax.linearize is
            # exactly the mismatch the user opted out of
            continue
        data, idx, _, _, _ = evaluator._batch_const[bi]
        xs = evaluator._gather_slots(batch, idx, state)
        manifolds = [program.groups[gi].manifold for gi in batch.slot_groups]
        T = batch.block_tangent_size

        def one_block(data_row, *x_row):
            def f(delta):
                ds = evaluator._split_delta(batch, delta)
                xp = tuple(
                    m.plus(x, d) for m, x, d in zip(manifolds, x_row, ds)
                )
                return batch.fn(xp, data_row)

            zero = jnp.zeros((T,), dtype=dtype)
            r, lin = jax.linearize(f, zero)
            basis = jnp.eye(T, dtype=dtype)
            j_analytic = jnp.swapaxes(jax.vmap(lin)(basis), 0, 1)
            j_numeric = numeric_jacobian(f, T, dtype, step_size)
            return j_analytic, j_numeric

        if data is None:
            ja, jn = jax.vmap(lambda *x: one_block(None, *x))(*xs)
        else:
            ja, jn = jax.vmap(one_block)(data, *xs)

        ja = np.asarray(ja)
        jn = np.asarray(jn)
        scale = np.maximum(np.abs(ja), np.abs(jn))
        # absolute tolerance floor mirrors the reference: entries whose
        # magnitude is below sqrt(precision) are compared absolutely
        denom = np.maximum(scale, np.sqrt(relative_precision))
        rel_err = np.abs(ja - jn) / denom
        worst = float(rel_err.max()) if rel_err.size else 0.0
        if worst > relative_precision * 1e4 and worst > np.sqrt(step_size):
            bad = np.unravel_index(int(rel_err.argmax()), rel_err.shape)
            return False, (
                f"batch '{batch.name}' (index {bi}): max relative error "
                f"{worst:.3e} at block {bad[0]}, residual {bad[1]}, "
                f"tangent coord {bad[2]} (analytic={ja[bad]:.6e}, "
                f"numeric={jn[bad]:.6e})"
            )
    return True, ""
