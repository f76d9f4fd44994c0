"""Closed-form batched inverses of small SPD blocks.

The reference eliminates BAL point blocks by inverting per-point 3x3
``E^T E + D`` matrices (``internal/ceres/schur_eliminator_impl.h`` via
``InvertPSDMatrix<kEBlockSize>``, which also special-cases small sizes).
The cofactor formulas below are a handful of fused elementwise ops over
the whole (num_points, 3, 3) batch, instead of a vmapped
``jnp.linalg.cholesky`` + triangular solve per block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["batched_spd_inverse"]


def _inv_1x1(a):
    return 1.0 / a


def _inv_2x2(a):
    a00 = a[..., 0, 0]
    a01 = a[..., 0, 1]
    a11 = a[..., 1, 1]
    det = a00 * a11 - a01 * a01
    inv_det = 1.0 / det
    out = jnp.stack(
        [
            jnp.stack([a11, -a01], axis=-1),
            jnp.stack([-a01, a00], axis=-1),
        ],
        axis=-2,
    )
    return out * inv_det[..., None, None]


def _inv_3x3(a):
    a00 = a[..., 0, 0]
    a01 = a[..., 0, 1]
    a02 = a[..., 0, 2]
    a11 = a[..., 1, 1]
    a12 = a[..., 1, 2]
    a22 = a[..., 2, 2]
    # cofactors of the symmetric matrix
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / det
    out = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c01, c11, c12], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ],
        axis=-2,
    )
    return out * inv_det[..., None, None]


def batched_spd_inverse(a):
    """Invert a batch of small SPD matrices ``a (..., e, e)``.

    Closed-form for e in {1, 2, 3} (the bundle-adjustment cases); Cholesky
    fallback for larger blocks.
    """
    e = a.shape[-1]
    if e == 1:
        return _inv_1x1(a)
    if e == 2:
        return _inv_2x2(a)
    if e == 3:
        return _inv_3x3(a)
    chol = jnp.linalg.cholesky(a)
    eye = jnp.broadcast_to(jnp.eye(e, dtype=a.dtype), a.shape)
    return jax.vmap(lambda l, i: jax.scipy.linalg.cho_solve((l, True), i))(
        chol.reshape(-1, e, e), eye.reshape(-1, e, e)
    ).reshape(a.shape)
