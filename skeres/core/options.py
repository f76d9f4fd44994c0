"""Solver options (reference lineage: ``include/ceres/solver.h`` —
``Solver::Options``). Field names and defaults match the reference exactly
where a counterpart exists; convergence-parity tests depend on the defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

from skeres.core.types import (
    DoglegType,
    DumpFormatType,
    LinearSolverType,
    LineSearchDirectionType,
    LineSearchType,
    LoggingType,
    MinimizerType,
    PreconditionerType,
    TrustRegionStrategyType,
)

__all__ = ["SolverOptions"]


@dataclasses.dataclass
class SolverOptions:
    # -- top-level choices ---------------------------------------------------
    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT
    )
    dogleg_type: DoglegType = DoglegType.TRADITIONAL_DOGLEG
    linear_solver_type: LinearSolverType = LinearSolverType.DENSE_QR
    preconditioner_type: PreconditionerType = PreconditionerType.JACOBI
    # series length for POWER_SERIES_EXPANSION (reference default: 5)
    max_num_spse_iterations: int = 5
    # early-terminate the power series when the latest term's norm drops
    # below spse_tolerance * norm(accumulated preconditioned vector)
    # (reference default: 0.1); 0 runs all max_num_spse_iterations terms
    spse_tolerance: float = 0.1
    # ITERATIVE_SCHUR: materialize S once per damped solve (scatter-free
    # pair-product assembly, core/explicit_schur.py) so every PCG matvec is
    # one dense GEMV instead of two gather-bound observation passes
    # (reference: solver.h use_explicit_schur_complement, same default)
    use_explicit_schur_complement: bool = False

    # -- iteration/time limits ----------------------------------------------
    max_num_iterations: int = 50
    max_solver_time_in_seconds: float = 1e6

    # -- trust region --------------------------------------------------------
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    max_num_consecutive_invalid_steps: int = 5
    use_nonmonotonic_steps: bool = False
    max_consecutive_nonmonotonic_steps: int = 5
    jacobi_scaling: bool = True
    # Deviation knob: the reference computes the Jacobi column scaling
    # ONCE at iteration zero and keeps it for the whole solve
    # (trust_region_preprocessor.cc); this build refreshes it at every
    # accepted step by default (recompile-free here, impossible there).
    # False restores the reference's iteration-zero pinning exactly.
    refresh_jacobi_scaling: bool = True

    # -- convergence tolerances ----------------------------------------------
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8

    # -- iterative linear solvers ---------------------------------------------
    min_linear_solver_iterations: int = 0
    max_linear_solver_iterations: int = 500
    eta: float = 1e-1

    # -- line search (LINE_SEARCH minimizer) ----------------------------------
    line_search_direction_type: LineSearchDirectionType = (
        LineSearchDirectionType.LBFGS
    )
    line_search_type: LineSearchType = LineSearchType.WOLFE
    max_lbfgs_rank: int = 20
    use_approximate_eigenvalue_bfgs_scaling: bool = True
    line_search_sufficient_function_decrease: float = 1e-4
    line_search_sufficient_curvature_decrease: float = 0.9
    max_num_line_search_step_size_iterations: int = 20
    max_num_line_search_direction_restarts: int = 5
    min_line_search_step_size: float = 1e-9
    # bracketing-phase step growth bound in the Wolfe search
    # (reference default: 10)
    max_line_search_step_expansion: float = 10.0

    # -- gradient checking -----------------------------------------------------
    check_gradients: bool = False
    gradient_check_relative_precision: float = 1e-8
    gradient_check_numeric_derivative_relative_step_size: float = 1e-6

    # -- mixed precision --------------------------------------------------------
    use_mixed_precision_solves: bool = False
    max_num_refinement_iterations: int = 0

    # -- inner iterations --------------------------------------------------------
    use_inner_iterations: bool = False
    inner_iteration_tolerance: float = 1e-3

    # -- logging / callbacks -------------------------------------------------
    logging_type: LoggingType = LoggingType.PER_MINIMIZER_ITERATION
    minimizer_progress_to_stdout: bool = False
    callbacks: Sequence[Callable] = dataclasses.field(default_factory=list)
    update_state_every_iteration: bool = False
    # pre-evaluation hook (reference: include/ceres/evaluation_callback.h):
    # object with prepare_for_evaluation(evaluate_jacobians, new_point),
    # fired on the host before each device dispatch that re-evaluates
    evaluation_callback: Optional[Any] = None

    # -- debug dumps (reference: trust_region_problem_dump_*) -----------------
    # dump the trust-region linear system at these iterations: TEXTFILE
    # writes lm_iteration_NNN.npz (state, gradient, diag, radius, step, and
    # every batch's residual/Jacobian blocks — the batched form of the
    # reference's per-matrix text files); CONSOLE logs norms/shapes only
    trust_region_problem_dump_directory: str = ""
    trust_region_minimizer_iterations_to_dump: Sequence[int] = ()
    trust_region_problem_dump_format_type: DumpFormatType = (
        DumpFormatType.TEXTFILE
    )

    # -- checkpoint/resume (built-in form of the reference's
    # update_state_every_iteration callback idiom, SURVEY.md §6) --------------
    checkpoint_path: Optional[str] = None
    checkpoint_every_n_iterations: int = 10
    resume_from: Optional[str] = None

    # -- device-specific (no reference counterpart) ---------------------------
    # run the whole LM loop on device (lax.while_loop, chunked); avoids
    # per-iteration host<->device synchronization. LM-only; callbacks fire per
    # chunk boundary rather than per iteration.
    use_device_loop: bool = False
    device_loop_chunk_iterations: int = 25
    # dtype for device-side math; None = follow jax x64 config
    dtype: Any = None
    # shard residual batches over this mesh axis spec; None = single device
    mesh: Any = None
    # chunk size for streamed (scan-accumulated) evaluation; None = no chunking
    evaluation_chunk_size: Optional[int] = None
    # "auto" | "forward" | "reverse": how per-block Jacobians are built —
    # T tangent-basis jvps (the reference's Jet layout) or m
    # cotangent-basis vjps; auto picks reverse when 2*m < T (the BA case
    # does 6x fewer passes). Residuals defining only a custom_jvp need
    # "forward".
    jacobian_diff_mode: str = "auto"
    # observation-batch row count above which the Schur solver keeps a
    # camera-sorted/padded Jacobian copy (gather-free PCG matvecs); see
    # SchurSolver(sort_threshold=...)
    jacobian_sort_threshold: int = 100_000
    # padding-waste bound for that camera-padded layout: the layout is used
    # only when n_cams * max_obs_per_cam <= jacobian_pad_waste * n_rows
    # (skewed camera-degree distributions fall back to the gather-plan
    # path); see SchurSolver(pad_waste=...)
    jacobian_pad_waste: float = 1.5
    # explicit-S assembly viability/shape knobs (SchurSolver /
    # ExplicitSchurPlan): the byte cap on the dense reduced camera system
    # (beyond it DENSE_SCHUR falls back to the implicit column probe and
    # ITERATIVE_SCHUR to the implicit matvec), and the per-level fan-in of
    # the hierarchical padded pair sums
    explicit_schur_limit_bytes: int = 2 << 30
    schur_pair_cap: int = 32
    # CLUSTER_JACOBI preconditioner: cameras per cluster (contiguous
    # index ranges; see PreconditionerType.CLUSTER_JACOBI)
    cluster_jacobi_size: int = 64
    # f32-robustness boost ladder rung for the cluster preconditioners'
    # factors ({0, this, 1e-1} relative to each cluster's max diagonal,
    # accepted per cluster by the factorization residual — see
    # SchurSolver._cluster_jacobi_precond)
    cluster_jacobi_boost: float = 1e-3
    # True (default): synchronize between the damped-solve and
    # candidate-evaluation dispatches so Summary's per-phase times
    # (linear_solver / residual_evaluation) are exact, like the
    # reference. False: let the dispatches pipeline, which saves one
    # host-device synchronization per step (material for small problems);
    # the combined execution time then lands in residual_evaluation_time.
    detailed_step_timings: bool = True
    # write a Perfetto/XProf trace of the minimizer to this directory
    # (SURVEY.md §6 tracing; view with xprof / perfetto)
    trace_dir: Optional[str] = None
    # residual blocks (ResidualBlockIds from add_residual_block) whose
    # J_sub^T J_sub + D forms the SUBSET preconditioner (reference:
    # Solver::Options::residual_blocks_for_subset_preconditioner; CGNR
    # only). Dense-factored here (documented deviation: no general sparse
    # Cholesky), so it requires num_effective_parameters <=
    # subset_preconditioner_max_parameters.
    residual_blocks_for_subset_preconditioner: Any = None
    subset_preconditioner_max_parameters: int = 4096
    # Benchmark/diagnostic mode: never terminate before max_num_iterations.
    # All convergence/failure tests (ftol/gtol/ptol, min trust-region
    # radius, consecutive-invalid-steps) are skipped, so the solve runs a
    # FIXED iteration budget regardless of where the trajectory lands — a
    # converged problem keeps producing (rejected) steps at the radius
    # floor. This exists because a throughput benchmark needs a
    # deterministic step-count denominator: zeroing the tolerances is not
    # enough (an exactly-zero f32 step at an underflowed radius still
    # passes `step_norm <= 0`, and the radius floor triggers the
    # min-radius test). No reference counterpart.
    run_full_iteration_budget: bool = False

    # -- reference fields with NO counterpart here (audit) -------------------
    # Each absent ``Solver::Options`` field of the reference lineage, with
    # why it is absent. N/A = no meaningful counterpart by design;
    # TODO = would be meaningful but is not yet implemented.
    #
    #   num_threads                       N/A — vmap/SPMD replace the thread
    #                                     pool (SURVEY.md §3.8); use `mesh`.
    #   dense_linear_algebra_library_type N/A — XLA is the backend
    #                                     (reference: EIGEN/LAPACK/CUDA).
    #   sparse_linear_algebra_library_type, use_postordering,
    #   dynamic_sparsity                  N/A — no general sparse Cholesky
    #                                     (documented deviation; pose
    #                                     graphs route to CGNR).
    #   linear_solver_ordering,
    #   inner_iteration_ordering          replaced by declared groups:
    #                                     Problem.set_schur_elimination_group
    #                                     (SURVEY §3.3 "declared, not
    #                                     discovered").
    #   visibility_clustering_type      partially covered: CLUSTER_JACOBI
    #                                     exists with contiguous
    #                                     camera-index clusters
    #                                     (cluster_jacobi_size);
    #                                     CANONICAL_VIEWS clustering is a
    #                                     serial CPU graph algorithm with
    #                                     no batched device mapping
    #                                     (documented deviation). SUBSET is present
    #                                     (dense-factored);
    #                                     CLUSTER_TRIDIAGONAL remains out
    #                                     of scope.
    #   residual_blocks_for_subset_preconditioner  present (SUBSET
    #                                     preconditioner, dense-factored).
    #   line_search_interpolation_type,
    #   max/min_line_search_step_contraction
    #                                     N/A — the Wolfe/Armijo searches use
    #                                     a quadratic-interpolating
    #                                     bisection-safeguarded zoom
    #                                     (line_search.py _interpolate_step)
    #                                     with the contraction window fixed
    #                                     at the reference defaults
    #                                     ([0.1, 0.9] safeguard).
    #   eta (per-solve forcing sequence)  present (`eta`).
    #   update_state_every_iteration      present.
    #   disable_all_safety_checks         N/A — checks are trace-time here
    #                                     and cost nothing at run time.

    def is_valid(self) -> tuple[bool, str]:
        """Counterpart of Solver::Options::IsValid."""
        checks = [
            (self.max_num_iterations >= 0, "max_num_iterations >= 0"),
            (self.max_solver_time_in_seconds > 0, "max_solver_time_in_seconds > 0"),
            (self.function_tolerance >= 0, "function_tolerance >= 0"),
            (self.gradient_tolerance >= 0, "gradient_tolerance >= 0"),
            (self.parameter_tolerance >= 0, "parameter_tolerance >= 0"),
            (
                self.initial_trust_region_radius > 0,
                "initial_trust_region_radius > 0",
            ),
            (self.max_trust_region_radius > 0, "max_trust_region_radius > 0"),
            (
                self.min_trust_region_radius <= self.max_trust_region_radius,
                "min_trust_region_radius <= max_trust_region_radius",
            ),
            (self.min_relative_decrease >= 0, "min_relative_decrease >= 0"),
            (self.min_lm_diagonal > 0, "min_lm_diagonal > 0"),
            (self.max_lm_diagonal >= self.min_lm_diagonal,
             "max_lm_diagonal >= min_lm_diagonal"),
            (self.max_num_consecutive_invalid_steps >= 0,
             "max_num_consecutive_invalid_steps >= 0"),
            (self.eta > 0, "eta > 0"),
            (self.max_linear_solver_iterations >= 1,
             "max_linear_solver_iterations >= 1"),
            (self.min_linear_solver_iterations >= 0,
             "min_linear_solver_iterations >= 0"),
            (
                self.min_linear_solver_iterations
                <= self.max_linear_solver_iterations,
                "min_linear_solver_iterations <= max_linear_solver_iterations",
            ),
            (
                not (
                    self.preconditioner_type == PreconditionerType.SUBSET
                    and not self.residual_blocks_for_subset_preconditioner
                ),
                "residual_blocks_for_subset_preconditioner non-empty when "
                "preconditioner_type == SUBSET",
            ),
        ]
        for ok, msg in checks:
            if not ok:
                return False, f"invalid SolverOptions: expected {msg}"
        return True, ""
