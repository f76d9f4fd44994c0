"""Enums and their string forms (reference lineage: ``include/ceres/types.h``,
``internal/ceres/types.cc``)."""

from __future__ import annotations

import enum

__all__ = [
    "MinimizerType",
    "TrustRegionStrategyType",
    "DoglegType",
    "LinearSolverType",
    "PreconditionerType",
    "LineSearchDirectionType",
    "LineSearchType",
    "TerminationType",
    "CallbackReturnType",
    "LoggingType",
]


class MinimizerType(enum.Enum):
    TRUST_REGION = "TRUST_REGION"
    LINE_SEARCH = "LINE_SEARCH"


class TrustRegionStrategyType(enum.Enum):
    LEVENBERG_MARQUARDT = "LEVENBERG_MARQUARDT"
    DOGLEG = "DOGLEG"


class DoglegType(enum.Enum):
    TRADITIONAL_DOGLEG = "TRADITIONAL_DOGLEG"
    SUBSPACE_DOGLEG = "SUBSPACE_DOGLEG"


class LinearSolverType(enum.Enum):
    DENSE_QR = "DENSE_QR"
    DENSE_NORMAL_CHOLESKY = "DENSE_NORMAL_CHOLESKY"
    SPARSE_NORMAL_CHOLESKY = "SPARSE_NORMAL_CHOLESKY"
    CGNR = "CGNR"
    DENSE_SCHUR = "DENSE_SCHUR"
    SPARSE_SCHUR = "SPARSE_SCHUR"
    ITERATIVE_SCHUR = "ITERATIVE_SCHUR"


class PreconditionerType(enum.Enum):
    IDENTITY = "IDENTITY"
    JACOBI = "JACOBI"
    SCHUR_JACOBI = "SCHUR_JACOBI"
    POWER_SERIES_EXPANSION = "POWER_SERIES_EXPANSION"
    # block-diagonal-of-S by camera CLUSTER (reference:
    # cluster_jacobi_preconditioner via visibility clustering; here
    # clusters are contiguous camera-index ranges — capture order implies
    # view locality in BAL datasets — since canonical-views clustering is
    # a serial CPU graph algorithm with no batched device mapping)
    CLUSTER_JACOBI = "CLUSTER_JACOBI"
    # block-TRIDIAGONAL-of-S over the same camera clusters: the
    # CLUSTER_JACOBI diagonal plus the (c, c+1) adjacent-cluster coupling
    # band, factored by block LDL^T (reference:
    # visibility_based_preconditioner.cc CLUSTER_TRIDIAGONAL; the
    # reference couples clusters by a degree-2 maximum spanning forest of
    # the visibility graph — here the chain over contiguous camera-index
    # ranges, the same clustering deviation as CLUSTER_JACOBI)
    CLUSTER_TRIDIAGONAL = "CLUSTER_TRIDIAGONAL"
    # J_sub^T J_sub + D over a user-tagged residual-block subset
    # (reference: subset_preconditioner.cc; CGNR only). The reference
    # factors it with a sparse Cholesky; here the subset normal matrix is
    # formed densely and Cholesky-factored — viable for the problem sizes
    # CGNR serves (documented deviation: no general sparse factorization)
    SUBSET = "SUBSET"


class LineSearchDirectionType(enum.Enum):
    STEEPEST_DESCENT = "STEEPEST_DESCENT"
    NONLINEAR_CONJUGATE_GRADIENT = "NONLINEAR_CONJUGATE_GRADIENT"
    LBFGS = "LBFGS"
    BFGS = "BFGS"


class LineSearchType(enum.Enum):
    ARMIJO = "ARMIJO"
    WOLFE = "WOLFE"


class TerminationType(enum.Enum):
    CONVERGENCE = "CONVERGENCE"
    NO_CONVERGENCE = "NO_CONVERGENCE"
    FAILURE = "FAILURE"
    USER_SUCCESS = "USER_SUCCESS"
    USER_FAILURE = "USER_FAILURE"


class CallbackReturnType(enum.Enum):
    SOLVER_CONTINUE = "SOLVER_CONTINUE"
    SOLVER_ABORT = "SOLVER_ABORT"
    SOLVER_TERMINATE_SUCCESSFULLY = "SOLVER_TERMINATE_SUCCESSFULLY"


class LoggingType(enum.Enum):
    SILENT = "SILENT"
    PER_MINIMIZER_ITERATION = "PER_MINIMIZER_ITERATION"


class CovarianceAlgorithmType(enum.Enum):
    """Reference: ``covariance.h`` CovarianceAlgorithmType. DENSE_SVD is
    the reference algorithm verbatim; SCHUR_COMPLEMENT replaces the
    reference's SPARSE_QR for Schur-structured (bundle-adjustment)
    problems — the block inverse of [[B, W], [W^T, C]] is computed through
    the reduced camera system S instead of a general sparse factorization
    (no batched device mapping for the latter; documented deviation,
    SURVEY.md §3.6)."""

    DENSE_SVD = "DENSE_SVD"
    SCHUR_COMPLEMENT = "SCHUR_COMPLEMENT"


class DumpFormatType(enum.Enum):
    """Trust-region problem dump format (reference: ``solver.h``
    DumpFormatType). CONSOLE logs norms/shapes; TEXTFILE writes the full
    linear system per dumped iteration — here as ``.npz`` of the
    batch-block arrays (the batched Jacobian representation) instead of
    the reference's per-matrix text files."""

    CONSOLE = "CONSOLE"
    TEXTFILE = "TEXTFILE"
