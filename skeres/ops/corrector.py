"""Triggs robust-loss correction of residuals and Jacobians.

JAX re-design of Ceres' Corrector (reference lineage:
``internal/ceres/corrector.cc``). Where the reference corrects one residual
block at a time inside a threaded loop, here the correction is a pure
batched function applied to whole residual batches ``r: (B, m)`` and
Jacobian blocks ``J: (B, m, n)`` in one fused elementwise + rank-1 update —
it composes under ``jit`` with the residual evaluation so XLA fuses it into
the evaluation kernel.

Math (B. Triggs et al., "Bundle Adjustment — A Modern Synthesis"):
with s = ||r||^2 and (rho, rho', rho''):
  if s == 0 or rho'' <= 0:   r <- sqrt(rho') r,  J <- sqrt(rho') J
  else: alpha solves  alpha^2 - 2 alpha - (2 s rho''/rho') = 0, taking the
  smaller root alpha = 1 - sqrt(1 + 2 s rho''/rho'); then
      r <- sqrt(rho') / (1 - alpha) * r
      J <- sqrt(rho') (I - alpha/s r r^T) J        (r = *uncorrected* residual)
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["corrector_coefficients", "correct_residuals", "correct_jacobian"]


def corrector_coefficients(s, rho0, rho1, rho2):
    """Per-block scalars (residual_scaling, alpha_sq_norm).

    All args elementwise arrays of shape (B,). Mirrors the reference's
    constructor logic, including the first-order-only fallback when the
    curvature term is non-positive.
    """
    sqrt_rho1 = jnp.sqrt(rho1)
    first_order = (s == 0.0) | (rho2 <= 0.0)

    s_safe = jnp.where(first_order, jnp.ones_like(s), s)
    d = 1.0 + 2.0 * s_safe * rho2 / rho1
    d = jnp.maximum(d, 1e-30)  # reference asserts d > 0; clamp for safety
    alpha = 1.0 - jnp.sqrt(d)

    residual_scaling = jnp.where(first_order, sqrt_rho1, sqrt_rho1 / (1.0 - alpha))
    alpha_sq_norm = jnp.where(first_order, jnp.zeros_like(s), alpha / s_safe)
    return residual_scaling, alpha_sq_norm


def correct_residuals(residual_scaling, r):
    """r: (B, m), residual_scaling: (B,) -> corrected residuals."""
    return residual_scaling[..., None] * r


def correct_jacobian(sqrt_rho1, alpha_sq_norm, r, jac):
    """Correct one Jacobian block batch.

    Args:
      sqrt_rho1: (B,) sqrt(rho').
      alpha_sq_norm: (B,) alpha/s (0 on the first-order branch).
      r: (B, m) *uncorrected* residuals.
      jac: (B, m, n) Jacobian block w.r.t. one parameter slot.

    Returns (B, m, n): sqrt(rho') (J - alpha/s r (r^T J)).
    """
    rtj = jnp.einsum("bm,bmn->bn", r, jac)  # (B, n)
    corrected = jac - alpha_sq_norm[..., None, None] * r[..., :, None] * rtj[..., None, :]
    return sqrt_rho1[..., None, None] * corrected


def apply_loss(loss, r, jacs):
    """Fused loss application to a residual batch and its Jacobian blocks.

    Args:
      loss: LossFunction or None (identity).
      r: (B, m) residuals.
      jacs: sequence of (B, m, n_k) Jacobian blocks (may be empty).

    Returns (cost_per_block (B,), corrected_r, corrected_jacs).
    """
    s = jnp.sum(r * r, axis=-1)
    if loss is None:
        return 0.5 * s, r, list(jacs)
    rho0, rho1, rho2 = loss.evaluate(s)
    residual_scaling, alpha_sq_norm = corrector_coefficients(s, rho0, rho1, rho2)
    sqrt_rho1 = jnp.sqrt(rho1)
    new_jacs = [correct_jacobian(sqrt_rho1, alpha_sq_norm, r, j) for j in jacs]
    new_r = correct_residuals(residual_scaling, r)
    return 0.5 * rho0, new_r, new_jacs
