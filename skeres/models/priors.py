"""Prior and conditioning residuals.

JAX counterparts of the reference lineage's
``include/ceres/normal_prior.h`` and ``conditioned_cost_function.h``: both
are trivial residual-function combinators here — no class hierarchy, just
closures over pure jnp functions.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax.numpy as jnp
import numpy as np

__all__ = ["normal_prior", "conditioned_residual"]


def normal_prior(a, mu):
    """Residual r(x) = A (x - mu): the Gaussian prior with sqrt-information
    A (reference: NormalPrior). Returns a residual fn for add_residual_block;
    A may also be passed per-block through ``data`` as
    ``{"a": ..., "mu": ...}`` for batched priors."""
    a = jnp.asarray(np.asarray(a, dtype=np.float64))
    mu = jnp.asarray(np.asarray(mu, dtype=np.float64)).reshape(-1)

    def fn(params, data):
        (x,) = params
        if data is not None:
            return data["a"].astype(x.dtype) @ (x - data["mu"].astype(x.dtype))
        return a.astype(x.dtype) @ (x - mu.astype(x.dtype))

    fn.__name__ = "normal_prior"
    return fn


def conditioned_residual(fn: Callable, conditioners: Sequence[Callable]):
    """Apply per-residual conditioners s_i(r_i) to a wrapped residual fn
    (reference: ConditionedCostFunction). Each conditioner is a scalar
    jnp function r_i -> conditioned r_i."""

    def wrapped(params, data):
        r = fn(params, data)
        parts = [c(r[i]) for i, c in enumerate(conditioners)]
        return jnp.stack(parts)

    wrapped.__name__ = f"conditioned_{getattr(fn, '__name__', 'residual')}"
    return wrapped
