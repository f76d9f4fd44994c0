"""Differentiable cubic interpolation of sampled grids.

JAX counterpart of the reference lineage's cubic interpolation
(``include/ceres/cubic_interpolation.h``): Catmull-Rom style cubic Hermite
interpolation over uniformly sampled 1D/2D grids, usable inside residual
functions (jvp-safe — derivatives flow through the cubic weights). The
reference's Grid1D/Grid2D bounds behavior (clamp to the edge) is kept.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["CubicInterpolator", "BiCubicInterpolator"]


def _cubic_hermite(p0, p1, p2, p3, x):
    """Catmull-Rom spline value at x in [0, 1] given 4 samples.

    Matches the reference's CubicHermiteSpline coefficients:
      a = -0.5 p0 + 1.5 p1 - 1.5 p2 + 0.5 p3
      b =      p0 - 2.5 p1 + 2.0 p2 - 0.5 p3
      c = -0.5 p0          + 0.5 p2
      d =              p1
    """
    a = -0.5 * p0 + 1.5 * p1 - 1.5 * p2 + 0.5 * p3
    b = p0 - 2.5 * p1 + 2.0 * p2 - 0.5 * p3
    c = -0.5 * p0 + 0.5 * p2
    d = p1
    return d + x * (c + x * (b + x * a))


class CubicInterpolator:
    """f(x) for x in [0, n-1] over samples (n,) or (n, k) (vector-valued)."""

    def __init__(self, values):
        self.values = jnp.asarray(values)
        self.n = self.values.shape[0]

    def evaluate(self, x):
        n = self.n
        xi = jnp.floor(x)
        xi = jnp.clip(xi, 0.0, n - 1.0)
        frac = x - xi
        i = xi.astype(jnp.int32)

        def at(j):
            return self.values[jnp.clip(j, 0, n - 1)]

        return _cubic_hermite(at(i - 1), at(i), at(i + 1), at(i + 2), frac)

    __call__ = evaluate


class BiCubicInterpolator:
    """f(r, c) over a (rows, cols) or (rows, cols, k) grid."""

    def __init__(self, values):
        self.values = jnp.asarray(values)
        self.rows = self.values.shape[0]
        self.cols = self.values.shape[1]

    def evaluate(self, r, c):
        rows, cols = self.rows, self.cols
        ri = jnp.clip(jnp.floor(r), 0.0, rows - 1.0)
        ci = jnp.clip(jnp.floor(c), 0.0, cols - 1.0)
        fr, fc = r - ri, c - ci
        i = ri.astype(jnp.int32)
        j = ci.astype(jnp.int32)

        def at(a, b):
            return self.values[
                jnp.clip(a, 0, rows - 1), jnp.clip(b, 0, cols - 1)
            ]

        # interpolate along columns for 4 neighboring rows, then along rows
        rows_interp = [
            _cubic_hermite(
                at(i + di, j - 1),
                at(i + di, j),
                at(i + di, j + 1),
                at(i + di, j + 2),
                fc,
            )
            for di in (-1, 0, 1, 2)
        ]
        return _cubic_hermite(*rows_interp, fr)

    __call__ = evaluate
