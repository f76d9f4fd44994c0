"""Device-side linear solvers for the damped Gauss-Newton step.

JAX re-design of the reference lineage's linear-solver layer
(``internal/ceres/linear_solver.h``, ``dense_normal_cholesky_solver.cc``,
``dense_qr_solver.cc``, ``cgnr_solver.cc``, ``conjugate_gradients_solver.cc``):
every solver here is a *pure function* solving

    (J^T J + diag(d_clamped) / radius) step = -g

in the global tangent space, jit-compiled by the caller. The reference's
general fill-reducing sparse Cholesky (SuiteSparse) is deliberately not
ported — a poor fit for batched device programs; sparse problems route to
CGNR or Schur solvers
(documented deviation, SURVEY.md §3.6).

Conventions:
  g     = J^T r                    (gradient of 0.5 ||r||^2)
  diag  = squared column norms of J (= diag(J^T J)), already Jacobi-scaled
  mu    = 1 / trust_region_radius  (scalar device array -> no recompiles)
Returns (step, num_iterations) where a failed solve yields non-finite step
(the minimizer treats that as an invalid step, like the reference's
LINEAR_SOLVER_FAILURE).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = [
    "lm_diagonal",
    "solve_dense_normal_cholesky",
    "solve_dense_qr",
    "preconditioned_conjugate_gradients",
    "solve_cgnr",
]


def lm_diagonal(diag, mu, min_diagonal, max_diagonal):
    """Clamped LM regularizer: diag(J^T J) -> the per-coordinate damping.

    Mirrors the reference's LevenbergMarquardtStrategy: clamp each squared
    column norm to [min_diagonal, max_diagonal], then scale by 1/radius.
    """
    return jnp.clip(diag, min_diagonal, max_diagonal) * mu


def solve_dense_normal_cholesky(
    jtj, g, diag, mu, min_diagonal, max_diagonal, refinement_iterations: int = 0
):
    """Cholesky of the damped normal equations (DENSE_NORMAL_CHOLESKY).

    With ``refinement_iterations > 0``, runs mixed-precision iterative
    refinement (reference: ``use_mixed_precision_solves`` +
    ``max_num_refinement_iterations``): the factorization stays in the
    working dtype (f32 on the device), residuals are recomputed in f64 and the
    correction re-uses the factor — restores ~f64 step accuracy at f32
    factorization cost.
    """
    d = lm_diagonal(diag, mu, min_diagonal, max_diagonal)
    a = jtj + jnp.diag(d)
    l = jax.lax.linalg.cholesky(a)  # NaN fill on indefinite -> invalid step
    b = -g
    step = jax.scipy.linalg.cho_solve((l, True), b)
    for _ in range(refinement_iterations):
        r64 = b.astype(jnp.float64) - a.astype(jnp.float64) @ step.astype(
            jnp.float64
        )
        corr = jax.scipy.linalg.cho_solve((l, True), r64.astype(a.dtype))
        step = step + corr
    return step, jnp.ones((), dtype=jnp.int32)


def solve_dense_qr(j_dense, r_dense, diag, mu, min_diagonal, max_diagonal):
    """QR of the row-appended system [J; sqrt(damping)] (DENSE_QR).

    More stable than normal equations; for small dense problems.
    """
    n = j_dense.shape[1]
    d = jnp.sqrt(lm_diagonal(diag, mu, min_diagonal, max_diagonal))
    a = jnp.concatenate([j_dense, jnp.diag(d)], axis=0)
    b = jnp.concatenate([-r_dense, jnp.zeros((n,), dtype=r_dense.dtype)], axis=0)
    q, rr = jnp.linalg.qr(a)
    step = jax.scipy.linalg.solve_triangular(rr, q.T @ b, lower=False)
    return step, jnp.ones((), dtype=jnp.int32)


def preconditioned_conjugate_gradients(
    matvec: Callable,
    b,
    precond_apply: Callable,
    max_iterations: int,
    rtol,
    min_iterations: int = 0,
    q_tolerance=None,
):
    """PCG on a PSD system A x = b (reference:
    ``internal/ceres/conjugate_gradients_solver.cc``), as a
    ``lax.while_loop`` so the whole solve is one device program.

    Termination, matching the reference exactly:
    - residual: ||r|| <= rtol * ||b|| (r_tolerance with the eta forcing
      sequence) — used by CGNR;
    - with ``q_tolerance`` set, the Nash-Sofer (1990) Q-based criterion the
      reference uses for ITERATIVE_SCHUR: with Q(x) = 0.5 x'Ax - b'x
      (monotonically decreased by CG), stop when the per-iteration relative
      decrease ``zeta = i * (Q_i - Q_{i-1}) / Q_i`` drops below
      ``q_tolerance`` — truncates far earlier than the residual test once
      the quadratic model stops improving, which is all the trust-region
      step needs.
    """
    bnorm2 = jnp.dot(b, b)
    tol2 = (rtol * rtol) * bnorm2

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond_apply(r0)
    rz0 = jnp.dot(r0, z0)
    zero = jnp.zeros((), dtype=b.dtype)
    state0 = (x0, r0, z0, r0 * 0.0 + z0, rz0, jnp.zeros((), jnp.int32),
              zero, jnp.asarray(False))
    # p0 = z0 (written as broadcast-safe expression above)

    def cond(state):
        x, r, z, p, rz, i, q_prev, q_stop = state
        rnorm2 = jnp.dot(r, r)
        not_converged = (rnorm2 > tol2) | (i < min_iterations)
        if q_tolerance is not None:
            not_converged = not_converged & ~q_stop
        return not_converged & (i < max_iterations) & (rnorm2 > 0.0)

    def body(state):
        x, r, z, p, rz, i, q_prev, _ = state
        ap = matvec(p)
        pap = jnp.dot(p, ap)
        alpha = rz / jnp.where(pap > 0.0, pap, jnp.ones_like(pap))
        alpha = jnp.where(pap > 0.0, alpha, jnp.zeros_like(alpha))
        x = x + alpha * p
        r = r - alpha * ap
        z = precond_apply(r)
        rz_new = jnp.dot(r, z)
        beta = rz_new / jnp.where(rz > 0.0, rz, jnp.ones_like(rz))
        p = z + beta * p
        if q_tolerance is not None:
            # Q(x) = 0.5 x'Ax - b'x = -0.5 (x'b + x'r) with r = b - Ax
            q = -0.5 * (jnp.dot(x, b) + jnp.dot(x, r))
            zeta = (i + 1).astype(q.dtype) * (q - q_prev) / jnp.where(
                q != 0.0, q, jnp.ones_like(q)
            )
            # the reference enables the Nash-Sofer test only for
            # q_tolerance > 0 (per_solve_options.q_tolerance > 0); without
            # the guard, floating-point non-monotonicity of Q near
            # convergence makes zeta negative and stops CG early even when
            # the caller asked for a fixed iteration count (eta = 0)
            q_stop = (q_tolerance > 0.0) & (q != 0.0) & (zeta < q_tolerance)
        else:
            q = q_prev
            q_stop = jnp.asarray(False)
        return (x, r, z, p, rz_new, i + 1, q, q_stop)

    x, r, z, p, rz, iters, _, _ = jax.lax.while_loop(cond, body, state0)
    return x, iters


def solve_cgnr(
    jtj_matvec: Callable,
    g,
    diag,
    mu,
    min_diagonal,
    max_diagonal,
    max_iterations: int,
    rtol,
):
    """CGNR: CG on (J^T J + damping) x = -g without forming J^T J
    (reference: ``internal/ceres/cgnr_solver.cc``), with Jacobi (diagonal of
    the damped normal equations) preconditioning."""
    d = lm_diagonal(diag, mu, min_diagonal, max_diagonal)

    def matvec(v):
        return jtj_matvec(v) + d * v

    m_inv = 1.0 / jnp.maximum(diag + d, jnp.finfo(g.dtype).tiny)

    def precond(v):
        return m_inv * v

    return preconditioned_conjugate_gradients(
        matvec, -g, precond, max_iterations, rtol
    )
