"""Loss function tests: derivative consistency of (rho, rho', rho'')
via jax.grad (counterpart of the reference lineage's loss_function_test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skeres.ops import loss as L

LOSSES = [
    ("trivial", L.TrivialLoss()),
    ("huber07", L.HuberLoss(0.7)),
    ("huber13", L.HuberLoss(1.3)),
    ("softl1", L.SoftLOneLoss(1.3)),
    ("cauchy", L.CauchyLoss(1.3)),
    ("arctan", L.ArctanLoss(1.3)),
    ("tolerant", L.TolerantLoss(0.7, 0.4)),
    ("tukey", L.TukeyLoss(1.3)),
    ("scaled", L.ScaledLoss(L.CauchyLoss(1.3), 0.5)),
    ("composed", L.ComposedLoss(L.ScaledLoss(L.CauchyLoss(1.3), 0.5), L.HuberLoss(0.7))),
]

S_VALUES = [0.0, 1e-6, 0.25, 0.64, 1.0, 1.69, 4.0, 25.0, 1e4]


@pytest.mark.parametrize("name,loss", LOSSES, ids=[n for n, _ in LOSSES])
def test_derivative_consistency(name, loss):
    def rho0(s):
        return loss.evaluate(s)[0]

    def rho1(s):
        return loss.evaluate(s)[1]

    for s in S_VALUES:
        s = jnp.float64(s)
        r0, r1, r2 = loss.evaluate(s)
        assert np.isfinite(r0) and np.isfinite(r1) and np.isfinite(r2)
        # skip AD check exactly at kink/boundary points
        interior = True
        if name.startswith("huber") or name == "composed":
            interior = abs(float(s) - 0.7 ** 2) > 1e-3 and abs(float(s) - 1.3 ** 2) > 1e-3
        if name == "tukey":
            interior = abs(float(s) - 1.3 ** 2) > 1e-3
        if interior and float(s) > 0:
            g1 = jax.grad(rho0)(s)
            np.testing.assert_allclose(r1, g1, rtol=1e-8, atol=1e-12)
            g2 = jax.grad(rho1)(s)
            np.testing.assert_allclose(r2, g2, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("name,loss", LOSSES, ids=[n for n, _ in LOSSES])
def test_at_zero_behaves_like_identity(name, loss):
    """All robust losses are ~identity near s=0 (up to the scale factor)."""
    r0, r1, r2 = loss.evaluate(jnp.float64(0.0))
    np.testing.assert_allclose(r0, 0.0, atol=0.3)  # tolerant loss offset ~0
    assert r1 > 0


def test_huber_values():
    loss = L.HuberLoss(1.0)
    r0, r1, r2 = loss.evaluate(jnp.float64(0.25))
    np.testing.assert_allclose([r0, r1, r2], [0.25, 1.0, 0.0])
    r0, r1, r2 = loss.evaluate(jnp.float64(4.0))
    np.testing.assert_allclose([r0, r1, r2], [2 * 2.0 - 1.0, 0.5, -0.0625])


def test_cauchy_values():
    loss = L.CauchyLoss(1.0)
    r0, r1, r2 = loss.evaluate(jnp.float64(1.0))
    np.testing.assert_allclose([r0, r1, r2], [np.log(2.0), 0.5, -0.25])


def test_vectorized():
    s = jnp.asarray(S_VALUES)
    r0, r1, r2 = L.CauchyLoss(1.3).evaluate(s)
    assert r0.shape == s.shape == r1.shape == r2.shape
