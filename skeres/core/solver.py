"""``solve(options, problem)`` — the user-facing façade.

JAX counterpart of the reference lineage's ``ceres::Solve``
(``internal/ceres/solver.cc``) and its preprocessors
(``trust_region_preprocessor.cc``): "preprocessing" here is compiling the
Problem into a Program (batch grouping + tangent offsets), building the
Evaluator's jitted device programs, and selecting/validating the linear
solver; the minimizer then runs as a host loop over those programs.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import jax
import numpy as np

from skeres.core.evaluator import Evaluator
from skeres.core.minimizer import TrustRegionMinimizer
from skeres.core.options import SolverOptions
from skeres.core.problem import Problem, Program
from skeres.core.summary import Summary
from skeres.core.types import (
    LinearSolverType,
    MinimizerType,
    TerminationType,
)

__all__ = ["solve"]


def _select_linear_solver(
    options: SolverOptions, program: Program
) -> LinearSolverType:
    """Downgrade/upgrade the linear solver like the reference preprocessor.

    SPARSE_NORMAL_CHOLESKY / SPARSE_SCHUR have no batched general
    fill-reducing factorization (documented deviation, SURVEY.md §3.6);
    they route to CGNR / DENSE_SCHUR respectively.
    """
    given = options.linear_solver_type
    if given == LinearSolverType.SPARSE_NORMAL_CHOLESKY:
        return LinearSolverType.CGNR
    if given == LinearSolverType.SPARSE_SCHUR:
        return LinearSolverType.DENSE_SCHUR
    if given in (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR):
        has_schur = any(g.schur_group == 0 for g in program.groups)
        if not has_schur:
            # no user-declared elimination group: discover one, like the
            # reference preprocessor's automatic Schur ordering
            # (reorder_program.cc ComputeStableSchurOrdering)
            from skeres.core.ordering import apply_schur_ordering

            if apply_schur_ordering(program) is None:
                return LinearSolverType.DENSE_NORMAL_CHOLESKY
    return given


def solve(
    options: SolverOptions,
    problem: Problem,
    program: Optional[Program] = None,
) -> Summary:
    """Solve the problem; writes the solution back into the problem's
    parameter arrays and returns a Summary (reference: ``ceres::Solve``)."""
    summary = Summary()
    total_start = time.time()

    ok, msg = options.is_valid()
    if not ok:
        summary.termination_type = TerminationType.FAILURE
        summary.message = msg
        return summary

    # -- preprocess -----------------------------------------------------------
    t0 = time.time()
    if program is None:
        program = problem.compile()

    summary.num_parameter_blocks = program.num_parameter_blocks
    summary.num_parameters = program.num_parameters
    summary.num_effective_parameters = program.num_effective_parameters
    summary.num_residual_blocks = program.num_residual_blocks
    summary.num_residuals = program.num_residuals
    summary.num_parameter_blocks_reduced = program.num_parameter_blocks_reduced
    summary.num_parameters_reduced = program.num_parameters_reduced
    summary.num_effective_parameters_reduced = (
        program.num_effective_parameters_reduced
    )
    summary.num_residual_blocks_reduced = program.num_residual_blocks
    summary.num_residuals_reduced = program.num_residuals
    summary.minimizer_type = options.minimizer_type
    summary.trust_region_strategy_type = options.trust_region_strategy_type
    summary.linear_solver_type_given = options.linear_solver_type
    summary.preconditioner_type_given = options.preconditioner_type
    summary.preconditioner_type_used = options.preconditioner_type
    summary.num_devices = len(jax.devices())

    if program.num_residual_blocks == 0 or program.num_tangent == 0:
        summary.termination_type = TerminationType.CONVERGENCE
        summary.message = "Problem is empty or all parameter blocks constant."
        cost = problem.evaluate() if program.num_residual_blocks else 0.0
        summary.initial_cost = summary.final_cost = cost
        return summary

    solver_type = _select_linear_solver(options, program)
    summary.linear_solver_type_used = solver_type

    evaluator = Evaluator(
        program,
        dtype=options.dtype,
        chunk_size=options.evaluation_chunk_size,
        mesh=options.mesh,
        diff_mode=options.jacobian_diff_mode,
    )
    summary.dtype = str(np.dtype(evaluator.dtype))

    schur_solver = None
    if solver_type in (
        LinearSolverType.DENSE_SCHUR,
        LinearSolverType.ITERATIVE_SCHUR,
    ):
        from skeres.core.schur import SchurSolver

        schur_solver = SchurSolver(
            evaluator,
            iterative=solver_type == LinearSolverType.ITERATIVE_SCHUR,
            preconditioner=options.preconditioner_type,
            max_cg_iterations=options.max_linear_solver_iterations,
            eta=options.eta,
            refinement_iterations=(
                options.max_num_refinement_iterations
                if options.use_mixed_precision_solves
                else 0
            ),
            max_power_series_terms=options.max_num_spse_iterations,
            spse_tolerance=options.spse_tolerance,
            sort_threshold=options.jacobian_sort_threshold,
            pad_waste=options.jacobian_pad_waste,
            use_explicit=options.use_explicit_schur_complement,
            explicit_s_limit_bytes=options.explicit_schur_limit_bytes,
            pair_cap=options.schur_pair_cap,
            cluster_size=options.cluster_jacobi_size,
            cluster_boost=options.cluster_jacobi_boost,
        )
        from skeres.core.types import PreconditionerType

        if options.preconditioner_type == PreconditionerType.SUBSET:
            # reference semantics: SUBSET serves CGNR only; the Schur
            # solvers downgrade to diagonal scaling
            logging.getLogger("skeres").warning(
                "SUBSET preconditioner is CGNR-only (reference: "
                "subset_preconditioner.cc); downgrading to JACOBI"
            )
            summary.preconditioner_type_used = PreconditionerType.JACOBI
        summary.schur_complement_path = schur_solver.schur_path
        if schur_solver.explicit_reject_reason is not None:
            # a wanted explicit-S plan was rejected; the fallback can be
            # much slower — say so
            # instead of leaving users to file perf bugs the gate predicted
            logging.getLogger("skeres").warning(
                "explicit Schur complement plan rejected (%s); using %s",
                schur_solver.explicit_reject_reason,
                summary.schur_complement_path,
            )

    inner_refiner = None
    if options.use_inner_iterations:
        from skeres.core.inner_iterations import InnerIterationRefiner

        if any(g.schur_group == 0 for g in program.groups):
            inner_refiner = InnerIterationRefiner(
                evaluator,
                num_sweeps=5,
                tolerance=options.inner_iteration_tolerance,
            )
        else:
            summary.message = (
                "use_inner_iterations ignored: no independent group declared "
                "(set_schur_elimination_group(arr, 0))"
            )

    if options.minimizer_type == MinimizerType.LINE_SEARCH:
        from skeres.core.line_search import LineSearchMinimizer

        minimizer = LineSearchMinimizer(evaluator, options, summary)
    elif options.use_device_loop:
        from skeres.core.device_loop import DeviceLoopMinimizer

        minimizer = DeviceLoopMinimizer(
            evaluator,
            options,
            summary,
            solver_type,
            schur_solver=schur_solver,
            inner_refiner=inner_refiner,
            chunk_iterations=min(
                options.device_loop_chunk_iterations, options.max_num_iterations
            ),
        )
    else:
        minimizer = TrustRegionMinimizer(
            evaluator,
            options,
            summary,
            solver_type,
            schur_solver=schur_solver,
            inner_refiner=inner_refiner,
        )

    if options.resume_from:
        from skeres.utils.checkpoint import load_checkpoint

        groups, radius, iteration, _cost = load_checkpoint(options.resume_from)
        if len(groups) != len(program.groups):
            summary.termination_type = TerminationType.FAILURE
            summary.message = (
                f"checkpoint has {len(groups)} parameter groups, problem has "
                f"{len(program.groups)}"
            )
            return summary
        for g, v in zip(program.groups, groups):
            if v.shape != g.values.shape:
                summary.termination_type = TerminationType.FAILURE
                summary.message = "checkpoint group shape mismatch"
                return summary
            g.values = v
        if hasattr(minimizer, "initial_radius_override"):
            minimizer.initial_radius_override = radius
            minimizer.initial_iteration = iteration

    if options.check_gradients:
        from skeres.core.gradient_checker import check_program_gradients

        ok, msg = check_program_gradients(
            program,
            evaluator,
            relative_precision=options.gradient_check_relative_precision,
            step_size=(
                options.gradient_check_numeric_derivative_relative_step_size
            ),
        )
        if not ok:
            summary.termination_type = TerminationType.FAILURE
            summary.message = f"Gradient check failed: {msg}"
            return summary

    state = evaluator.prepare_state(program.initial_state(evaluator.dtype))
    # AOT-compile the device programs now so minimizer time measures
    # steady-state execution (compilation is preprocessing, mirroring the
    # reference's preprocessor/minimizer time split in Solver::Summary)
    if hasattr(minimizer, "compile_programs"):
        minimizer.compile_programs(state)
    summary.preprocessor_time_in_seconds = time.time() - t0

    # -- minimize ---------------------------------------------------------------
    t0 = time.time()
    if options.trace_dir:
        with jax.profiler.trace(options.trace_dir):
            state = minimizer.minimize(state)
    else:
        state = minimizer.minimize(state)
    summary.minimizer_time_in_seconds = time.time() - t0

    # -- postprocess -------------------------------------------------------------
    t0 = time.time()
    program.write_back(state)
    # the minimizer sets final_cost to the cost of the parameters it
    # returned (reference semantics — a min over iteration rows could pick
    # a REJECTED candidate's cost); the row-min is only a fallback for
    # minimizers that don't track it
    if summary.final_cost < 0.0 and summary.iterations:
        summary.final_cost = min(it.cost for it in summary.iterations)
    summary.postprocessor_time_in_seconds = time.time() - t0
    summary.total_time_in_seconds = time.time() - total_start
    return summary
