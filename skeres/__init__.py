"""skeres — a nonlinear least-squares framework in JAX.

A from-scratch re-design (not a port) of the skeres/Ceres capability
surface: residual blocks are pure JAX functions batched with ``vmap``;
Jacobians come from ``jax.jvp``/``jacfwd``; the block-sparse Jacobian lives
as batched dense blocks in device memory; trust-region control runs as a
host-side loop (or a ``lax.while_loop``) over jitted device programs;
linear solves are XLA programs; multi-device scaling shards residual
blocks over a ``jax.sharding.Mesh`` with ``psum`` reduction of the normal
equations.
"""

import jax as _jax

# On NVIDIA GPUs XLA runs f32 matrix products in TF32 by default, which
# keeps about three decimal digits, far short of the 1e-6..1e-10
# tolerances this solver chases (and of the reference, which is all f64).
# Force full-f32 matmuls framework-wide. Users can still override per call.
_jax.config.update("jax_default_matmul_precision", "highest")

from skeres.ops.loss import (
    ArctanLoss,
    CauchyLoss,
    ComposedLoss,
    HuberLoss,
    LossFunction,
    LossFunctionWrapper,
    ScaledLoss,
    SoftLOneLoss,
    TolerantLoss,
    TrivialLoss,
    TukeyLoss,
)
from skeres.models.manifolds import (
    AngleManifold,
    EigenQuaternionManifold,
    EuclideanManifold,
    LineManifold,
    Manifold,
    ProductManifold,
    QuaternionManifold,
    SphereManifold,
    SubsetManifold,
)

__version__ = "0.1.0"

# Solver-facing API is imported lazily to keep `import skeres` light and
# to avoid import cycles while the core grows.


def __getattr__(name):
    from importlib import import_module

    _core = {
        "Problem": "skeres.core.problem",
        "ResidualBlockId": "skeres.core.problem",
        "EvaluationCallback": "skeres.core.callbacks",
        "StateUpdatingCallback": "skeres.core.callbacks",
        "LoggingCallback": "skeres.core.callbacks",
        "SolverOptions": "skeres.core.options",
        "Summary": "skeres.core.summary",
        "solve": "skeres.core.solver",
        "Covariance": "skeres.core.covariance",
        "GradientProblem": "skeres.core.gradient_problem",
        "GradientProblemSolver": "skeres.core.gradient_problem",
    }
    if name in _core:
        return getattr(import_module(_core[name]), name)
    raise AttributeError(f"module 'skeres' has no attribute {name!r}")
