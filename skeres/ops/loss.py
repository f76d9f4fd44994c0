"""Robust loss functions rho(s) with first and second derivatives.

JAX re-design of the Ceres loss layer (reference lineage:
``include/ceres/loss_function.h`` / ``internal/ceres/loss_function.cc``).
Each loss evaluates ``rho(s), rho'(s), rho''(s)`` for the *squared* residual
norm ``s = ||f(x)||^2`` as pure ``jnp`` math so it vmaps/jits over whole
residual batches at once.

All formulas are the standard published ones (Huber, Cauchy, Soft-L1,
Arctan, Tolerant, Tukey); data-dependent branches use ``jnp.where`` so the
functions are trace-safe and differentiable.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "LossFunction",
    "TrivialLoss",
    "HuberLoss",
    "SoftLOneLoss",
    "CauchyLoss",
    "ArctanLoss",
    "TolerantLoss",
    "TukeyLoss",
    "ScaledLoss",
    "ComposedLoss",
    "LossFunctionWrapper",
]

_TINY = 1e-300  # floor for rho' so sqrt(rho') in the corrector stays valid


class LossFunction:
    """Base protocol: ``evaluate(s) -> (rho, rho', rho'')``, elementwise."""

    def evaluate(self, s):
        raise NotImplementedError

    def __call__(self, s):
        return self.evaluate(s)


class TrivialLoss(LossFunction):
    """rho(s) = s."""

    def evaluate(self, s):
        return s, jnp.ones_like(s), jnp.zeros_like(s)


class HuberLoss(LossFunction):
    """rho(s) = s for s <= a^2, else 2a sqrt(s) - a^2."""

    def __init__(self, a: float):
        self.a = float(a)
        self.b = self.a * self.a

    def evaluate(self, s):
        out = s > self.b
        # guard sqrt at s == 0 on the inlier branch
        r = jnp.sqrt(jnp.where(out, s, jnp.ones_like(s)))
        rho0 = jnp.where(out, 2.0 * self.a * r - self.b, s)
        rho1 = jnp.where(out, jnp.maximum(_TINY, self.a / r), jnp.ones_like(s))
        rho2 = jnp.where(out, -rho1 / (2.0 * jnp.maximum(s, _TINY)),
                         jnp.zeros_like(s))
        return rho0, rho1, rho2


class SoftLOneLoss(LossFunction):
    """rho(s) = 2 b (sqrt(1 + s/b) - 1), b = a^2."""

    def __init__(self, a: float):
        self.b = float(a) * float(a)
        self.c = 1.0 / self.b

    def evaluate(self, s):
        total = 1.0 + s * self.c
        tmp = jnp.sqrt(total)
        rho0 = 2.0 * self.b * (tmp - 1.0)
        rho1 = jnp.maximum(_TINY, 1.0 / tmp)
        rho2 = -(self.c) / (2.0 * total * tmp)
        return rho0, rho1, rho2


class CauchyLoss(LossFunction):
    """rho(s) = b log(1 + s/b), b = a^2."""

    def __init__(self, a: float):
        self.b = float(a) * float(a)
        self.c = 1.0 / self.b

    def evaluate(self, s):
        total = 1.0 + s * self.c
        inv = 1.0 / total
        rho0 = self.b * jnp.log(total)
        rho1 = jnp.maximum(_TINY, inv)
        rho2 = -self.c * inv * inv
        return rho0, rho1, rho2


class ArctanLoss(LossFunction):
    """rho(s) = a atan2(s, a)."""

    def __init__(self, a: float):
        self.a = float(a)
        self.b = 1.0 / (self.a * self.a)

    def evaluate(self, s):
        total = 1.0 + s * s * self.b
        inv = 1.0 / total
        rho0 = self.a * jnp.arctan2(s, jnp.full_like(s, self.a))
        rho1 = jnp.maximum(_TINY, inv)
        rho2 = -2.0 * s * self.b * inv * inv
        return rho0, rho1, rho2


class TolerantLoss(LossFunction):
    """rho(s) = b log(1 + exp((s - a)/b)) - b log(1 + exp(-a/b)).

    Flat (near-zero) for s << a, linear for s >> a. Overflow-safe softplus.
    """

    def __init__(self, a: float, b: float):
        self.a = float(a)
        self.b = float(b)
        import math

        self.c = self.b * math.log1p(math.exp(-self.a / self.b))

    def evaluate(self, s):
        x = (s - self.a) / self.b
        # stable softplus and sigmoid
        softplus = jnp.where(x > 30.0, x, jnp.log1p(jnp.exp(jnp.minimum(x, 30.0))))
        sig = jnp.where(
            x >= 0.0,
            1.0 / (1.0 + jnp.exp(-x)),
            jnp.exp(jnp.minimum(x, 0.0)) / (1.0 + jnp.exp(jnp.minimum(x, 0.0))),
        )
        rho0 = self.b * softplus - self.c
        rho1 = jnp.maximum(_TINY, sig)
        rho2 = sig * (1.0 - sig) / self.b
        return rho0, rho1, rho2


class TukeyLoss(LossFunction):
    """Tukey biweight: rho(s) = a^2/3 (1 - (1 - s/a^2)^3) for s <= a^2 else a^2/3."""

    def __init__(self, a: float):
        self.a2 = float(a) * float(a)

    def evaluate(self, s):
        v = 1.0 - s / self.a2
        inlier = s <= self.a2
        v = jnp.where(inlier, v, jnp.zeros_like(v))
        rho0 = jnp.where(inlier, self.a2 / 3.0 * (1.0 - v * v * v),
                         jnp.full_like(s, self.a2 / 3.0))
        rho1 = jnp.where(inlier, v * v, jnp.zeros_like(s))
        rho2 = jnp.where(inlier, -2.0 * v / self.a2, jnp.zeros_like(s))
        return rho0, rho1, rho2


class ScaledLoss(LossFunction):
    """a * rho(s); with rho=None it scales the trivial loss (a*s)."""

    def __init__(self, loss: LossFunction | None, a: float):
        self.loss = loss
        self.a = float(a)

    def evaluate(self, s):
        if self.loss is None:
            return self.a * s, jnp.full_like(s, self.a), jnp.zeros_like(s)
        r0, r1, r2 = self.loss.evaluate(s)
        return self.a * r0, self.a * r1, self.a * r2


class ComposedLoss(LossFunction):
    """f(g(s)) with full chain rule on first/second derivatives."""

    def __init__(self, f: LossFunction, g: LossFunction):
        self.f = f
        self.g = g

    def evaluate(self, s):
        g0, g1, g2 = self.g.evaluate(s)
        f0, f1, f2 = self.f.evaluate(g0)
        return f0, f1 * g1, f2 * g1 * g1 + f1 * g2


class LossFunctionWrapper(LossFunction):
    """A loss whose underlying robustifier can be swapped after problem
    construction (reference: ``LossFunctionWrapper``,
    ``include/ceres/loss_function.h``).

    JIT semantics differ from the reference: the wrapped loss is traced at
    ``solve()`` time, so :meth:`reset` takes effect on the NEXT solve, not
    mid-solve (each solve re-traces the evaluation programs)."""

    def __init__(self, loss: LossFunction | None):
        self.loss = loss

    def reset(self, loss: LossFunction | None) -> None:
        self.loss = loss

    def evaluate(self, s):
        if self.loss is None:
            return s, jnp.ones_like(s), jnp.zeros_like(s)
        return self.loss.evaluate(s)
