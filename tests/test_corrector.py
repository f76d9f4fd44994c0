"""Corrector tests: the robust-corrected Gauss-Newton system must reproduce
the gradient and (Triggs-approximate) Hessian of 0.5 * rho(||f||^2)
(counterpart of the reference lineage's corrector_test)."""

import jax
import jax.numpy as jnp
import numpy as np

from skeres.ops import loss as L
from skeres.ops.corrector import apply_loss, corrector_coefficients

RNG = np.random.default_rng(7)


def _setup(B=16, m=3, n=4):
    r = jnp.asarray(RNG.normal(size=(B, m)))
    jac = jnp.asarray(RNG.normal(size=(B, m, n)))
    return r, jac


def test_gradient_consistency():
    """J_c^T r_c == rho' J^T r  (gradient of the robustified cost)."""
    r, jac = _setup()
    loss = L.CauchyLoss(0.9)
    s = jnp.sum(r * r, axis=-1)
    rho0, rho1, rho2 = loss.evaluate(s)

    cost, rc, (jc,) = apply_loss(loss, r, [jac])
    grad_corrected = jnp.einsum("bmn,bm->bn", jc, rc)
    grad_true = rho1[:, None] * jnp.einsum("bmn,bm->bn", jac, r)
    np.testing.assert_allclose(grad_corrected, grad_true, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(cost, 0.5 * rho0, rtol=1e-12)


def test_gn_hessian_matches_triggs():
    """J_c^T J_c == rho' J^T J + 2 rho'' (J^T r)(J^T r)^T   when rho'' > 0.

    This is the defining property of the Triggs correction: the corrected
    Gauss-Newton Hessian equals the full robust Hessian minus the residual
    curvature term. The corrector (matching the reference's semantics)
    applies the rank-1 term only on the positive-curvature branch
    rho'' > 0, so the identity is checked there; losses with rho'' <= 0
    (Huber outliers, Cauchy, ...) take the first-order fallback, covered by
    test_negative_curvature_falls_back_to_first_order.
    """
    r, jac = _setup()
    loss = L.TolerantLoss(0.5, 1.0)  # rho'' = sig(1-sig)/b > 0 everywhere
    s = jnp.sum(r * r, axis=-1)
    rho0, rho1, rho2 = loss.evaluate(s)
    ok = np.asarray((rho2 > 0) & (1.0 + 2.0 * s * rho2 / rho1 > 0))
    assert ok.sum() >= 8, "need enough blocks in the valid-curvature regime"

    _, rc, (jc,) = apply_loss(loss, r, [jac])
    h_corrected = jnp.einsum("bmn,bmk->bnk", jc, jc)
    jtr = jnp.einsum("bmn,bm->bn", jac, r)
    h_true = (
        rho1[:, None, None] * jnp.einsum("bmn,bmk->bnk", jac, jac)
        + 2.0 * rho2[:, None, None] * jtr[:, :, None] * jtr[:, None, :]
    )
    np.testing.assert_allclose(
        np.asarray(h_corrected)[ok], np.asarray(h_true)[ok], rtol=1e-8, atol=1e-10
    )


def test_trivial_loss_is_identity():
    r, jac = _setup()
    cost, rc, (jc,) = apply_loss(None, r, [jac])
    np.testing.assert_allclose(rc, r)
    np.testing.assert_allclose(jc, jac)
    np.testing.assert_allclose(cost, 0.5 * jnp.sum(r * r, axis=-1))


def test_negative_curvature_falls_back_to_first_order():
    """When rho'' <= 0 branch triggers, only sqrt(rho') scaling is applied."""
    r, jac = _setup(B=4)
    # Huber has rho2 < 0 on the outlier branch -> first-order fallback? No:
    # fallback only for rho2 <= 0, which Huber outliers hit.
    loss = L.HuberLoss(0.1)
    s = jnp.sum(r * r, axis=-1)
    rho0, rho1, rho2 = loss.evaluate(s)
    assert bool(jnp.all(rho2 < 0))
    rs, alpha = corrector_coefficients(s, rho0, rho1, rho2)
    np.testing.assert_allclose(alpha, 0.0)
    np.testing.assert_allclose(rs, jnp.sqrt(rho1))


def test_zero_residual_block():
    r = jnp.zeros((2, 3))
    jac = jnp.asarray(RNG.normal(size=(2, 3, 4)))
    cost, rc, (jc,) = apply_loss(L.CauchyLoss(0.5), r, [jac])
    assert np.all(np.isfinite(rc)) and np.all(np.isfinite(jc))
    np.testing.assert_allclose(rc, 0.0)
    np.testing.assert_allclose(jc, jac)  # sqrt(rho'(0)) = 1 for Cauchy
