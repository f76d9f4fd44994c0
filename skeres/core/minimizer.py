"""Trust-region minimizer: the outer Levenberg-Marquardt / Dogleg loop.

JAX re-design of the reference lineage's minimizer layer
(``internal/ceres/trust_region_minimizer.cc``,
``levenberg_marquardt_strategy.cc``, ``dogleg_strategy.cc``,
``trust_region_step_evaluator.cc``). The architecture differs from the
reference deliberately:

- The reference runs everything on host threads; here the loop body is 2-3
  jitted device programs and only *scalars* (cost, step quality, radius)
  cross the device->host boundary each iteration.
- The trust-region radius enters the device programs as a device scalar
  argument so changing it never triggers a recompile.
- Jacobians are reused across rejected steps exactly like the reference:
  ``linearize`` (full J pass) runs only after accepted steps; rejected
  steps re-run only ``solve_step`` + ``try_step`` (damped solve +
  residual-only eval).

Numerical details (D clamping, radius update formula, non-monotonic step
evaluator, convergence tests) mirror the reference's formulas exactly;
those constants are what make iteration counts comparable.
"""

from __future__ import annotations

import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from skeres.core.evaluator import Evaluator
from skeres.core.linear_solvers import (
    lm_diagonal,
    preconditioned_conjugate_gradients,
    solve_dense_normal_cholesky,
    solve_dense_qr,
)
from skeres.core.options import SolverOptions
from skeres.core.summary import IterationSummary, Summary
from skeres.core.types import (
    CallbackReturnType,
    LinearSolverType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
    DoglegType,
)

__all__ = ["TrustRegionMinimizer", "TrustRegionStepEvaluator"]


class TrustRegionStepEvaluator:
    """Step-quality evaluation with the non-monotonic acceptance window
    (reference: ``internal/ceres/trust_region_step_evaluator.cc``)."""

    def __init__(self, initial_cost: float, max_consecutive_nonmonotonic_steps: int):
        self.max_consecutive_nonmonotonic_steps = max_consecutive_nonmonotonic_steps
        self.minimum_cost = initial_cost
        self.current_cost = initial_cost
        self.reference_cost = initial_cost
        self.candidate_cost = initial_cost
        self.accumulated_reference_model_cost_change = 0.0
        self.accumulated_candidate_model_cost_change = 0.0
        self.num_consecutive_nonmonotonic_steps = 0

    def step_quality(self, cost: float, model_cost_change: float) -> float:
        relative_decrease = (self.current_cost - cost) / model_cost_change
        historical_relative_decrease = (self.reference_cost - cost) / (
            self.accumulated_reference_model_cost_change + model_cost_change
        )
        return max(relative_decrease, historical_relative_decrease)

    def step_accepted(self, cost: float, model_cost_change: float) -> None:
        self.current_cost = cost
        self.accumulated_candidate_model_cost_change += model_cost_change
        self.accumulated_reference_model_cost_change += model_cost_change

        if self.current_cost < self.minimum_cost:
            self.minimum_cost = self.current_cost
            self.num_consecutive_nonmonotonic_steps = 0
            self.candidate_cost = self.current_cost
            self.accumulated_candidate_model_cost_change = 0.0
        else:
            self.num_consecutive_nonmonotonic_steps += 1
            if self.current_cost > self.candidate_cost:
                self.candidate_cost = self.current_cost
                self.accumulated_candidate_model_cost_change = 0.0

        if (
            self.num_consecutive_nonmonotonic_steps
            == self.max_consecutive_nonmonotonic_steps
        ):
            self.reference_cost = self.candidate_cost
            self.accumulated_reference_model_cost_change = (
                self.accumulated_candidate_model_cost_change
            )


class TrustRegionMinimizer:
    """Host-side driver over jitted device programs.

    Device programs built once per solve:
      linearize(state, scale_prev, use_prev) -> cost, g, diag, solver_data
      solve_step(state, data, g, diag, scale, ctrl)
          ctrl = [radius, jitter_prev, cost] -> candidate + step stats
      try_step(new_state)                    -> candidate cost, |x|
    """

    def __init__(
        self,
        evaluator: Evaluator,
        options: SolverOptions,
        summary: Summary,
        solver_type: LinearSolverType,
        schur_solver=None,
        inner_refiner=None,
    ):
        self.ev = evaluator
        self.options = options
        self.summary = summary
        self.solver_type = solver_type
        self.schur_solver = schur_solver
        self.inner_refiner = inner_refiner
        # set by solve() when resuming from a checkpoint
        self.initial_radius_override: Optional[float] = None
        self.initial_iteration = 0
        self._subset_masks = self._build_subset_masks()
        self._build_programs()

    def _build_subset_masks(self):
        """Host-planned per-batch row masks for the SUBSET preconditioner
        (reference: subset_preconditioner.cc over
        residual_blocks_for_subset_preconditioner). Returns None when the
        preconditioner is not selected or must downgrade (too many
        parameters for the dense factor, or no tagged rows resolve) —
        the CGNR solve then falls back to JACOBI, logged like the
        reference preprocessor's downgrades."""
        import logging

        o = self.options
        if (
            o.preconditioner_type != PreconditionerType.SUBSET
            or self.solver_type != LinearSolverType.CGNR
            or not o.residual_blocks_for_subset_preconditioner
        ):
            return None
        log = logging.getLogger("skeres")
        if self.ev.num_tangent > o.subset_preconditioner_max_parameters:
            log.warning(
                "SUBSET preconditioner downgraded to JACOBI: %d effective "
                "parameters exceed subset_preconditioner_max_parameters=%d "
                "(the dense subset factor would not fit)",
                self.ev.num_tangent,
                o.subset_preconditioner_max_parameters,
            )
            self.summary.preconditioner_type_used = PreconditionerType.JACOBI
            return None
        wanted = {
            getattr(rb, "_rid", rb)
            for rb in o.residual_blocks_for_subset_preconditioner
        }
        masks, any_hit = [], False
        for bi, batch in enumerate(self.ev.program.batches):
            b_pad = int(self.ev._batch_const[bi][4].shape[0])
            m = np.zeros(b_pad, dtype=np.float64)
            if batch.row_ids is not None:
                hit = np.asarray(
                    [1.0 if rid in wanted else 0.0 for rid in batch.row_ids]
                )
                m[: len(hit)] = hit
                any_hit = any_hit or bool(hit.any())
            masks.append(jnp.asarray(m, dtype=self.ev.dtype))
        if not any_hit:
            log.warning(
                "SUBSET preconditioner downgraded to JACOBI: none of the "
                "tagged residual blocks resolve to solver rows"
            )
            self.summary.preconditioner_type_used = PreconditionerType.JACOBI
            return None
        return masks

    def _maybe_checkpoint(self, state, radius, iteration, cost):
        o = self.options
        if o.checkpoint_path is None:
            return
        if iteration % max(o.checkpoint_every_n_iterations, 1) != 0:
            return
        from skeres.utils.checkpoint import save_checkpoint

        save_checkpoint(
            o.checkpoint_path,
            [np.asarray(x) for x in state],
            radius,
            iteration,
            cost,
        )

    def _maybe_dump(self, iteration, state, data, g, diag, radius, dx):
        """Trust-region linear-system debug dumps (reference:
        TrustRegionMinimizer::MaybeDumpLinearLeastSquaresProblem,
        ``solver.h`` trust_region_problem_dump_*). TEXTFILE writes one
        ``lm_iteration_NNN.npz`` with the state, gradient, LM diagonal,
        radius, step, and every batch's residual/Jacobian block arrays —
        the batched linear system (there is no global sparse J here to
        print as text). CONSOLE logs shapes and norms only."""
        o = self.options
        if iteration not in o.trust_region_minimizer_iterations_to_dump:
            return
        from skeres.core.types import DumpFormatType

        g_np = np.asarray(g)
        # data's structure depends on the solver: dense J (DENSE_QR), a
        # (JtJ,) tuple (DENSE_NORMAL_CHOLESKY), or per-batch block tuples
        # (CGNR / the Schur solvers) — flatten generically
        leaves = jax.tree_util.tree_leaves(data)
        if o.trust_region_problem_dump_format_type == DumpFormatType.CONSOLE:
            lines = [
                f"LM iteration {iteration}: radius={float(radius):.6e} "
                f"|g|={np.linalg.norm(g_np):.6e} "
                f"|step|={np.linalg.norm(np.asarray(dx)):.6e}"
            ]
            for k, leaf in enumerate(leaves):
                lines.append(
                    f"  solver_data[{k}]: shape {tuple(leaf.shape)} "
                    f"dtype {leaf.dtype}"
                )
            print("\n".join(lines), flush=True)
            return
        if not o.trust_region_problem_dump_directory:
            return
        import os

        os.makedirs(o.trust_region_problem_dump_directory, exist_ok=True)
        arrays = {
            "gradient": g_np,
            "lm_diagonal": np.asarray(diag),
            "trust_region_radius": np.asarray(radius),
            "step": np.asarray(dx),
        }
        for gi, xs in enumerate(jax.tree_util.tree_leaves(state)):
            arrays[f"state_{gi}"] = np.asarray(xs)
        for k, leaf in enumerate(leaves):
            arrays[f"solver_data_{k}"] = np.asarray(leaf)
        path = os.path.join(
            o.trust_region_problem_dump_directory,
            f"lm_iteration_{iteration:03d}.npz",
        )
        np.savez_compressed(path, **arrays)

    # -- device program construction ------------------------------------------

    def _solver_data(self, blocks):
        """What the damped solve needs, computed once per linearization."""
        st = self.solver_type
        if st == LinearSolverType.DENSE_NORMAL_CHOLESKY:
            return (self.ev.jtj_dense(blocks),)
        if st == LinearSolverType.DENSE_QR:
            return self.ev.jacobian_dense(blocks)
        if st in (LinearSolverType.CGNR,):
            # keep the corrected blocks resident; matvec re-derives from them
            return tuple((b.r, b.jac, b.idx) for b in blocks)
        if st in (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR):
            return self.schur_solver.solver_data(blocks)
        raise NotImplementedError(st)

    def _solve_damped(self, data, g, diag, radius, jitter=None):
        """Solve (J^T J + clamp(diag)/radius) dx = -g in *scaled* space.

        Returns (step, iterations, jitter_used). ``jitter`` is the Schur
        path's factor-jitter ratchet (see SchurSolver.solve_damped);
        other solvers pass it through unchanged."""
        o = self.options
        st = self.solver_type
        mu = 1.0 / radius
        if jitter is None:
            jitter = jnp.zeros((), g.dtype)
        if st in (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR):
            return self.schur_solver.solve_damped(
                data, g, diag, mu, o.min_lm_diagonal, o.max_lm_diagonal,
                jitter0=jitter,
            )
        if st == LinearSolverType.DENSE_NORMAL_CHOLESKY:
            (jtj,) = data
            y, it = solve_dense_normal_cholesky(
                jtj,
                g,
                diag,
                mu,
                o.min_lm_diagonal,
                o.max_lm_diagonal,
                refinement_iterations=(
                    o.max_num_refinement_iterations
                    if o.use_mixed_precision_solves
                    else 0
                ),
            )
            return y, it, jitter
        if st == LinearSolverType.DENSE_QR:
            j_dense, r_dense = data
            y, it = solve_dense_qr(
                j_dense, r_dense, diag, mu, o.min_lm_diagonal, o.max_lm_diagonal
            )
            return y, it, jitter
        if st == LinearSolverType.CGNR:
            d = lm_diagonal(diag, mu, o.min_lm_diagonal, o.max_lm_diagonal)
            from skeres.core.evaluator import BatchBlocks

            blocks = [
                BatchBlocks(r, jac, idx) for (r, jac, idx) in data
            ]

            def matvec(v):
                # planned scatter-free reductions (ops/segment_reduce.py)
                return d * v + self.ev.jtj_matvec(blocks, v)

            if self._subset_masks is not None:
                # SUBSET preconditioner (reference:
                # subset_preconditioner.cc): M = J_sub^T J_sub + D over
                # the tagged rows, dense-Cholesky-factored once per
                # damped solve; each PCG application is two triangular
                # solves
                masked = [
                    BatchBlocks(
                        r * mask[:, None],
                        jac * mask[:, None, None],
                        idx,
                    )
                    for (r, jac, idx), mask in zip(
                        data, self._subset_masks
                    )
                ]
                m_sub = self.ev.jtj_dense(masked) + jnp.diag(d)
                l_sub = jax.lax.linalg.cholesky(m_sub)

                def precond(v):
                    return jax.scipy.linalg.cho_solve((l_sub, True), v)

            else:
                m_inv = 1.0 / jnp.maximum(
                    diag + d, jnp.finfo(g.dtype).tiny
                )

                def precond(v):
                    return m_inv * v

            y, it = preconditioned_conjugate_gradients(
                matvec,
                -g,
                precond,
                o.max_linear_solver_iterations,
                jnp.asarray(o.eta, dtype=g.dtype),
                o.min_linear_solver_iterations,
            )
            return y, it, jitter
        raise NotImplementedError(st)

    # -- Schur scaled-prep helpers (hoist mu-independent work) -------------
    # For the Schur solvers, column scaling and the per-linearization prep
    # (padded Jacobian copies, undamped E^T E) are computed ONCE per
    # linearization; every re-solve after a rejected step reuses them.
    # Other solvers keep the scale-at-solve-time path (cheap for them).

    def _prep_data(self, blocks, scale, cam_raw=None):
        data = self._solver_data(blocks)
        if self.schur_solver is not None:
            return self.schur_solver.prepare(
                self._scale_data(data, scale), cam_raw=cam_raw, scale=scale
            )
        return data

    def _solve_scaled(self, pdata, gs, diag_s, radius, scale, jitter=None):
        if self.schur_solver is not None:
            return self._solve_damped(pdata, gs, diag_s, radius, jitter)
        return self._solve_damped(
            self._scale_data(pdata, scale), gs, diag_s, radius, jitter
        )

    def _model_quadratic(self, pdata, dx, scale):
        """dx^T (J^T J) dx — the only JtJ quantity the model-cost needs.
        The Schur path computes it as ||J_s (dx/scale)||^2 in one forward
        pass (half the passes, none of the reduction gathers)."""
        if self.schur_solver is not None:
            return self.schur_solver.jtj_quadratic(pdata, dx / scale)
        return jnp.dot(dx, self._jtj_dx(pdata, None, dx))

    def _jtj_scaled(self, pdata, u, scale):
        """(J S)^T (J S) u in scaled space."""
        if self.schur_solver is not None:
            return self.schur_solver.jtj_matvec(pdata, u)
        return scale * self._jtj_dx(pdata, None, scale * u)

    def _jtj_dx(self, data, blocks_free, dx):
        """(J^T J) dx for the model-cost computation, solver-specific."""
        st = self.solver_type
        if st == LinearSolverType.DENSE_NORMAL_CHOLESKY:
            (jtj,) = data
            return jtj @ dx
        if st == LinearSolverType.DENSE_QR:
            j_dense, _ = data
            return j_dense.T @ (j_dense @ dx)
        if st == LinearSolverType.CGNR:
            from skeres.core.evaluator import BatchBlocks

            blocks = [BatchBlocks(r, jac, idx) for (r, jac, idx) in data]
            return self.ev.jtj_matvec(blocks, dx)
        if st in (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR):
            return self.schur_solver.jtj_matvec(data, dx)
        raise NotImplementedError(st)

    def _build_programs(self):
        ev = self.ev
        o = self.options
        dtype = ev.dtype
        dogleg = (
            o.trust_region_strategy_type == TrustRegionStrategyType.DOGLEG
        )

        def linearize(state, consts, scale_prev, use_prev):
            # consts: ev.device_consts — passed as an argument (not closed
            # over) so the programs work under jax.distributed, where jit
            # may not capture globally-sharded arrays
            with ev.bind(consts):
                return _linearize(state, scale_prev, use_prev)

        def _linearize(state, scale_prev, use_prev):
            cost, blocks = ev.blocks(state)
            if self.schur_solver is not None and self.schur_solver.sorted_info:
                # camera-slot reductions ride the padded layout, and the
                # placed copies are reused by prepare() below (scaled in
                # padded space) — one placement gather per linearization
                g, diag, cam_raw = (
                    self.schur_solver.gradient_and_diag_padded(
                        blocks, state=state
                    )
                )
            else:
                g, diag = ev.gradient_and_diag(blocks)
                cam_raw = None
            # Jacobi column scaling (reference:
            # jacobian_scaling_ = 1 / (1 + sqrt(squared column norms)),
            # computed at iteration zero). ``use_prev`` (device bool) keeps
            # the caller-supplied previous scale instead — the
            # refresh_jacobi_scaling=False reference-pinning path — so the
            # prep below is always consistent with the scale the damped
            # solve will use, with no recompilation.
            if not o.jacobi_scaling:
                scale = jnp.ones_like(diag)
            else:
                scale_fresh = 1.0 / (1.0 + jnp.sqrt(jnp.maximum(diag, 0.0)))
                scale = jnp.where(use_prev, scale_prev, scale_fresh)
            # Schur path: scaled + prepared ONCE here; re-solves after
            # rejected steps reuse it (see _prep_data)
            data = self._prep_data(blocks, scale, cam_raw)
            if ev.program.has_bounds:
                # bounded problems converge where the PROJECTED gradient
                # vanishes (reference: trust_region_minimizer.cc uses
                # |x - P(x - g)|_inf as gradient_max_norm) — the raw |g|
                # never goes to zero at an active bound, so gtol could
                # not fire there
                pg = ev.tangent_diff(
                    ev.project_bounds(ev.plus(state, -g)), state
                )
                g_max_norm = jnp.max(jnp.abs(pg))
            elif ev.num_tangent:
                g_max_norm = jnp.max(jnp.abs(g))
            else:
                g_max_norm = jnp.zeros((), dtype)
            g_norm = jnp.sqrt(jnp.sum(g * g))
            if dogleg:
                # Gauss-Newton point: one (nearly) undamped solve per
                # linearization, reused across every radius change
                # (reference: dogleg_strategy.cc ComputeGaussNewtonStep —
                # this reuse is dogleg's raison d'etre)
                gs = g * scale
                diag_s = diag * scale * scale
                y_gn, _, _ = self._solve_scaled(
                    data, gs, diag_s, jnp.asarray(1e32, dtype=dtype), scale
                )
                gn = (y_gn,)
            else:
                gn = ()
            return (cost, g, diag, data, scale, g_max_norm, g_norm) + gn

        def solve_step(state, data, g, diag, scale, ctrl, consts, *gn):
            # ctrl: (3,) device array [trust_region_radius, jitter_prev,
            # current_cost] — ONE per-iteration host->device transfer
            # instead of three; current_cost feeds the projected line
            # search's Armijo test on bounds-active steps
            with ev.bind(consts):
                return _solve_step(state, data, g, diag, scale, ctrl, *gn)

        def _solve_step(state, data, g, diag, scale, ctrl, *gn):
            radius, jitter_prev = ctrl[0], ctrl[1]
            # scaled-space damped solve: J_s = J S  (S = diag(scale))
            gs = g * scale
            diag_s = diag * scale * scale
            if dogleg:
                (y_gn,) = gn
                if o.dogleg_type == DoglegType.SUBSPACE_DOGLEG:
                    y, lin_iters = self._subspace_dogleg_step(
                        data, scale, gs, y_gn, radius
                    )
                else:
                    y, lin_iters = self._dogleg_step(data, scale, gs, y_gn, radius)
                jitter_used = jitter_prev
            else:
                y, lin_iters, jitter_used = self._solve_scaled(
                    data, gs, diag_s, radius, scale, jitter_prev
                )
            dx = y * scale

            new_state = ev.plus(state, dx)
            if ev.program.has_bounds:
                # reference bounds semantics (trust_region_minimizer.cc):
                # the candidate is the projection onto the bounds box, and
                # model_cost_change / step_norm must see the EFFECTIVE
                # (projected) step, else step quality is corrupted whenever
                # a bound is active.
                projected = ev.project_bounds(new_state)
                if o.max_num_line_search_step_size_iterations > 0:
                    # Projected line search (reference role:
                    # trust_region_minimizer.cc DoLineSearch — "a
                    # projected line search improves the quality of
                    # bounds-active steps"). Engaged only when the
                    # projection CLIPPED the step (lax.cond), so interior
                    # steps keep exact TR semantics and pay nothing. Two
                    # stages:
                    #   1. direction: the clipped TR step — UNLESS its
                    #      projection is an ASCENT direction along the
                    #      active face (the unconstrained optimum pulls
                    #      the clipped coordinate through the bound; no
                    #      step length helps). Then the projected
                    #      Cauchy/gradient direction -t_c * g is used —
                    #      the standard projected-gradient safeguard,
                    #      without which the solve spirals through
                    #      invalid (mcc <= 0) steps into the
                    #      consecutive-invalid-steps failure at exactly
                    #      the box faces bounds exist for.
                    #   2. projected Armijo backtracking (Bertsekas):
                    #      accept the first a with
                    #      f(P(x + a d)) <= f(x) + c1 g.(P(x + a d) - x).
                    #      On failure keep the plain projected TR step
                    #      and let the trust region reject/shrink.
                    cost0 = ctrl[2]
                    dx_raw = dx
                    eff0 = ev.tangent_diff(projected, state)
                    dphi0 = jnp.dot(g, eff0)
                    c1 = jnp.asarray(
                        o.line_search_sufficient_function_decrease, dtype
                    )
                    K = int(o.max_num_line_search_step_size_iterations)

                    # Cauchy step length along -g: |g|^2 / |J g|^2
                    g2 = jnp.sum(g * g)
                    gjtjg = self._model_quadratic(data, g, scale)
                    t_c = g2 / jnp.maximum(gjtjg, jnp.finfo(dtype).tiny)
                    d_vec = jnp.where(dphi0 < 0.0, dx_raw, -t_c * g)

                    def _ls(_):
                        def body(c_):
                            alpha, k, _ok = c_
                            cand = ev.project_bounds(
                                ev.plus(state, alpha * d_vec)
                            )
                            de = ev.tangent_diff(cand, state)
                            ok = ev.cost(cand) <= cost0 + c1 * jnp.dot(
                                g, de
                            )
                            return (
                                jnp.where(ok, alpha, alpha * 0.5),
                                k + 1,
                                ok,
                            )

                        def cond_fn(c_):
                            _alpha, k, ok = c_
                            return (~ok) & (k <= K)

                        alpha, _k, ok = jax.lax.while_loop(
                            cond_fn,
                            body,
                            (
                                jnp.ones((), dtype),
                                jnp.zeros((), jnp.int32),
                                jnp.zeros((), jnp.bool_),
                            ),
                        )
                        return alpha, ok

                    clipped = jnp.any(jnp.abs(eff0 - dx_raw) > 0.0)
                    alpha, ok = jax.lax.cond(
                        clipped,
                        _ls,
                        lambda _: (
                            jnp.ones((), dtype),
                            jnp.zeros((), jnp.bool_),
                        ),
                        operand=None,
                    )
                    use_ls = clipped & ok
                    step_vec = jnp.where(
                        use_ls, alpha * d_vec, dx_raw
                    )
                    new_state = ev.project_bounds(
                        ev.plus(state, step_vec)
                    )
                else:
                    new_state = projected
                dx = ev.tangent_diff(new_state, state)
                y = dx / scale

            dx_jtj_dx = self._model_quadratic(data, dx, scale)
            model_cost_change = -(jnp.dot(g, dx) + 0.5 * dx_jtj_dx)
            step_norm = jnp.sqrt(jnp.sum(y * y))  # scaled-space norm (ref param_tol)

            if self.inner_refiner is not None:
                # reference order (trust_region_minimizer.cc): inner
                # iterations refine the candidate BEFORE step acceptance
                new_state = self.inner_refiner.refine(new_state)
            return (
                new_state,
                model_cost_change,
                step_norm,
                lin_iters,
                dx,
                jitter_used,
            )

        def try_step(new_state, consts):
            """Residual-only evaluation of the candidate (its host timing
            populates Summary.residual_evaluation_time_in_seconds, the
            reference's residual/Jacobian/linear-solver time split)."""
            with ev.bind(consts):
                return ev.cost(new_state), ev.x_norm(new_state)

        self._linearize_jit = jax.jit(linearize)
        self._solve_step_jit = jax.jit(solve_step)
        self._try_step_jit = jax.jit(try_step)
        self._zero_scale = jnp.zeros((ev.num_tangent,), dtype=dtype)
        # device-resident flag constants: a fresh jnp.asarray(bool) per
        # call would be a host->device transfer on every linearization
        self._flag_false = jnp.asarray(False)
        self._flag_true = jnp.asarray(True)
        self.linearize = lambda state, scale_prev=None: self._linearize_jit(
            state,
            ev.device_consts,
            self._zero_scale if scale_prev is None else scale_prev,
            self._flag_false if scale_prev is None else self._flag_true,
        )
        self.solve_step = lambda state, data, g, diag, scale, ctrl, *gn: (
            self._solve_step_jit(
                state, data, g, diag, scale, ctrl, ev.device_consts, *gn
            )
        )
        self.try_step = lambda new_state: self._try_step_jit(
            new_state, ev.device_consts
        )

    def compile_programs(self, state):
        """AOT-compile the device programs (preprocessor phase) so
        ``minimize()`` measures steady-state execution only — the
        device-side counterpart of the reference preprocessor's one-time setup
        (``trust_region_preprocessor.cc``). Safe to skip: jit compiles
        lazily on first call otherwise."""
        if self.ev.mesh is not None:
            # lowering from ShapeDtypeStructs drops sharding layouts;
            # the sharded path lets jit compile lazily instead
            return
        dtype = self.ev.dtype
        ev = self.ev
        consts = ev.device_consts
        flag = jnp.asarray(False)
        out = jax.eval_shape(
            self._linearize_jit, state, consts, self._zero_scale, flag
        )
        self._linearize_jit = self._linearize_jit.lower(
            state, consts, self._zero_scale, flag
        ).compile()
        self.linearize = lambda state, scale_prev=None: self._linearize_jit(
            state,
            ev.device_consts,
            self._zero_scale if scale_prev is None else scale_prev,
            self._flag_false if scale_prev is None else self._flag_true,
        )
        cost_s, g_s, diag_s, data_s, scale_s, _gm, _gn, *gn_s = out
        state_s = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), state
        )
        consts_s = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), consts
        )
        ctrl_s = jax.ShapeDtypeStruct((3,), dtype)
        solve_out = jax.eval_shape(
            self._solve_step_jit,
            state_s, data_s, g_s, diag_s, scale_s, ctrl_s, consts_s, *gn_s,
        )
        self._solve_step_jit = self._solve_step_jit.lower(
            state_s, data_s, g_s, diag_s, scale_s, ctrl_s, consts_s, *gn_s
        ).compile()
        self.solve_step = lambda state, data, g, diag, scale, ctrl, *gn: (
            self._solve_step_jit(
                state, data, g, diag, scale, ctrl, ev.device_consts, *gn
            )
        )
        new_state_s = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), solve_out[0]
        )
        self._try_step_jit = self._try_step_jit.lower(
            new_state_s, consts_s
        ).compile()
        self.try_step = lambda new_state: self._try_step_jit(
            new_state, ev.device_consts
        )
        # Residency barrier: device constants upload lazily; without this
        # the transfers complete inside minimize()'s first dispatch and
        # are billed to minimizer time. One throwaway linearize forces
        # every upload while the clock still says "preprocessor".
        jax.block_until_ready(self.linearize(state))

    def _dogleg_step(self, data, scale, gs, y_gn, radius):
        """Traditional dogleg in the Jacobi-scaled space (reference:
        ``dogleg_strategy.cc`` ComputeTraditionalDoglegStep): interpolate
        between the Cauchy point and the Gauss-Newton point on the
        trust-region boundary. Pure vector ops — no linear solve here."""
        # (J S)^T (J S) v  (data may be pre-scaled Schur prep)
        jtj_s_gs = self._jtj_scaled(data, gs, scale)
        g2 = jnp.dot(gs, gs)
        gBg = jnp.dot(gs, jtj_s_gs)
        alpha = g2 / jnp.where(gBg > 0.0, gBg, jnp.ones_like(gBg))
        pc = -alpha * gs  # Cauchy point
        pc_norm = jnp.sqrt(jnp.sum(pc * pc))
        gn_norm = jnp.sqrt(jnp.sum(y_gn * y_gn))
        gn_ok = jnp.isfinite(gn_norm)

        # segment pc -> gn: ||pc + beta d|| = radius
        d = jnp.where(gn_ok, y_gn, pc) - pc
        dd = jnp.dot(d, d)
        pd = jnp.dot(pc, d)
        disc = jnp.maximum(pd * pd + dd * (radius * radius - pc_norm * pc_norm), 0.0)
        beta = (-pd + jnp.sqrt(disc)) / jnp.where(dd > 0.0, dd, jnp.ones_like(dd))
        beta = jnp.clip(beta, 0.0, 1.0)
        interp = pc + beta * d

        g_norm = jnp.sqrt(g2)
        cauchy_capped = -(radius / jnp.where(g_norm > 0.0, g_norm, 1.0)) * gs

        y = jnp.where(
            gn_ok & (gn_norm <= radius),
            jnp.where(gn_ok, y_gn, pc),
            jnp.where(pc_norm >= radius, cauchy_capped, interp),
        )
        return y, jnp.ones((), dtype=jnp.int32)

    def _subspace_dogleg_step(self, data, scale, gs, y_gn, radius):
        """2-D subspace dogleg (reference: ``dogleg_strategy.cc``
        ComputeSubspaceDoglegStep): minimize the quadratic model exactly on
        the trust-region disk restricted to span{gradient, Gauss-Newton
        point} (Jacobi-scaled space). Where the reference root-solves a
        quartic for the boundary Lagrange multiplier, here the boundary is
        parametrized by angle and minimized by a dense theta grid + Newton
        polish — branch-free, compiler-friendly, and accurate to machine
        precision after polishing (batched equivalent of the same
        exact subproblem)."""
        dtype = gs.dtype
        g_norm = jnp.sqrt(jnp.dot(gs, gs))
        b1 = gs / jnp.where(g_norm > 0.0, g_norm, 1.0)
        proj = jnp.dot(y_gn, b1)
        v = y_gn - proj * b1
        v_norm = jnp.sqrt(jnp.dot(v, v))
        # degenerate subspace (gn ~ parallel to g, or non-finite gn):
        # fall back to the traditional dogleg step
        gn_ok = jnp.isfinite(jnp.dot(y_gn, y_gn))
        ok = gn_ok & (v_norm > 1e-12 * jnp.maximum(g_norm, 1.0))
        b2 = v / jnp.where(v_norm > 0.0, v_norm, 1.0)

        def bmul(u):
            return self._jtj_scaled(data, u, scale)

        bb1 = bmul(b1)
        bb2 = bmul(b2)
        b_sub = jnp.stack(
            [
                jnp.stack([jnp.dot(b1, bb1), jnp.dot(b1, bb2)]),
                jnp.stack([jnp.dot(b2, bb1), jnp.dot(b2, bb2)]),
            ]
        )
        g_sub = jnp.stack([jnp.dot(gs, b1), jnp.dot(gs, b2)])

        # interior minimizer of the 2x2 model (if PD and inside the disk)
        det = b_sub[0, 0] * b_sub[1, 1] - b_sub[0, 1] * b_sub[1, 0]
        pd = (b_sub[0, 0] > 0.0) & (det > 0.0)
        inv = (
            jnp.stack(
                [
                    jnp.stack([b_sub[1, 1], -b_sub[0, 1]]),
                    jnp.stack([-b_sub[1, 0], b_sub[0, 0]]),
                ]
            )
            / jnp.where(det != 0.0, det, 1.0)
        )
        x_int = -(inv @ g_sub)
        interior_ok = pd & (jnp.dot(x_int, x_int) <= radius * radius)

        # boundary: x = radius (cos t, sin t); m(t) periodic — grid + Newton
        t = jnp.linspace(0.0, 2.0 * np.pi, 256, endpoint=False).astype(dtype)

        def model(t):
            c, s = jnp.cos(t), jnp.sin(t)
            x0 = radius * c
            x1 = radius * s
            return (
                0.5
                * (
                    b_sub[0, 0] * x0 * x0
                    + 2.0 * b_sub[0, 1] * x0 * x1
                    + b_sub[1, 1] * x1 * x1
                )
                + g_sub[0] * x0
                + g_sub[1] * x1
            )

        vals = jax.vmap(model)(t)
        t0 = t[jnp.argmin(vals)]
        # m(t) has frequency content {1, 2} only, so m'(t) has at most 4
        # zeros -> at most TWO local minima on the circle. Polishing from
        # the best grid point AND from the best grid point more than pi/2
        # away (the other basin's representative, if one exists) covers
        # every basin deterministically — no grid-resolution failure mode.
        far = jnp.cos(t - t0) < 0.0  # angular distance > pi/2
        vals_far = jnp.where(far, vals, jnp.inf)
        t1 = t[jnp.argmin(vals_far)]
        dm = jax.grad(model)
        d2m = jax.grad(dm)

        def newton(t, _):
            h = d2m(t)
            return t - dm(t) / jnp.where(jnp.abs(h) > 1e-30, h, 1.0), None

        t_star0, _ = jax.lax.scan(newton, t0, None, length=4)
        t_star1, _ = jax.lax.scan(newton, t1, None, length=4)
        # guard: Newton may walk to a maximum; pick the best of all four
        cands = jnp.stack([t_star0, t_star1, t0, t1])
        t_star = cands[jnp.argmin(jax.vmap(model)(cands))]
        x_bnd = radius * jnp.stack([jnp.cos(t_star), jnp.sin(t_star)])

        x_sub = jnp.where(interior_ok, x_int, x_bnd)
        y_sub = x_sub[0] * b1 + x_sub[1] * b2

        y_trad, _ = self._dogleg_step(data, scale, gs, y_gn, radius)
        y = jnp.where(ok, y_sub, y_trad)
        return y, jnp.ones((), dtype=jnp.int32)

    def _scale_data(self, data, scale):
        """Apply column scaling to the solver data (J -> J S)."""
        st = self.solver_type
        if st == LinearSolverType.DENSE_NORMAL_CHOLESKY:
            (jtj,) = data
            return (jtj * scale[None, :] * scale[:, None],)
        if st == LinearSolverType.DENSE_QR:
            j_dense, r_dense = data
            return (j_dense * scale[None, :], r_dense)
        if st == LinearSolverType.CGNR:
            return tuple(
                (r, jac * self.ev.v_rows(bi, scale)[:, None, :], idx)
                for bi, (r, jac, idx) in enumerate(data)
            )
        if st in (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR):
            return self.schur_solver.scale_data(data, scale)
        raise NotImplementedError(st)

    # -- the outer loop ---------------------------------------------------------

    def minimize(self, state):
        """Run the trust-region loop; returns the best iterate seen.

        Reference semantics (``trust_region_minimizer.cc``): with
        ``use_nonmonotonic_steps`` the loop may accept cost-increasing
        steps, but the PARAMETERS returned correspond to the minimum cost
        over all iterations, and ``Summary.final_cost`` is the cost of
        those returned parameters (not a min over candidate costs, which
        can belong to rejected steps)."""
        self._best_cost = float("inf")
        self._best_state = None
        self._current_cost = float("inf")
        out = self._minimize_loop(state)
        s = self.summary
        if self._best_state is not None and self._best_cost < self._current_cost:
            out = self._best_state
            s.final_cost = self._best_cost + s.fixed_cost
        elif np.isfinite(self._current_cost):
            s.final_cost = self._current_cost + s.fixed_cost
        return out

    def _track_iterate(self, state, cost: float):
        self._current_cost = cost
        if cost < self._best_cost:
            self._best_cost = cost
            self._best_state = state

    def _minimize_loop(self, state):
        o = self.options
        s = self.summary
        start = time.time()

        radius = float(
            self.initial_radius_override
            if self.initial_radius_override is not None
            else o.initial_trust_region_radius
        )
        decrease_factor = 2.0
        num_consecutive_invalid_steps = 0
        self._jitter = 0.0  # factor-jitter ratchet (Schur solvers)

        t0 = time.time()
        self._prepare_for_evaluation(True, True)
        cost, g, diag, data, scale, g_max_norm, g_norm, *gn = self.linearize(state)
        cost, g_max_norm, g_norm = (
            float(v) for v in jax.device_get((cost, g_max_norm, g_norm))
        )
        s.jacobian_evaluation_time_in_seconds += time.time() - t0
        s.num_jacobian_evaluations += 1
        if not np.isfinite(cost):
            s.termination_type = TerminationType.FAILURE
            s.message = "Initial cost evaluation produced non-finite values."
            return state
        s.initial_cost = cost + s.fixed_cost
        self._track_iterate(state, cost)

        step_evaluator = TrustRegionStepEvaluator(
            cost,
            o.max_consecutive_nonmonotonic_steps if o.use_nonmonotonic_steps else 0,
        )

        it = IterationSummary(
            iteration=0,
            cost=cost + s.fixed_cost,
            gradient_max_norm=float(g_max_norm),
            gradient_norm=float(g_norm),
            trust_region_radius=radius,
            step_is_valid=True,
            step_is_successful=True,
            iteration_time_in_seconds=time.time() - start,
            cumulative_time_in_seconds=time.time() - start,
        )
        s.iterations.append(it)
        self._log_iteration(it)

        if (
            not o.run_full_iteration_budget
            and float(g_max_norm) <= o.gradient_tolerance
        ):
            s.termination_type = TerminationType.CONVERGENCE
            s.message = (
                f"Gradient tolerance reached. Gradient max norm: {float(g_max_norm):e}"
                f" <= {o.gradient_tolerance:e}"
            )
            return state

        if self._run_callbacks(it, state):
            return state

        iteration = 0
        while True:
            if iteration >= o.max_num_iterations:
                s.termination_type = TerminationType.NO_CONVERGENCE
                s.message = "Maximum number of iterations reached."
                return state
            if time.time() - start > o.max_solver_time_in_seconds:
                s.termination_type = TerminationType.NO_CONVERGENCE
                s.message = "Maximum solver time reached."
                return state
            iteration += 1
            iter_start = time.time()

            t0 = time.time()
            ctrl = jnp.asarray(
                [radius, self._jitter, cost], dtype=self.ev.dtype
            )
            (
                new_state,
                model_cost_change,
                step_norm,
                lin_iters,
                dx,
                jitter_used,
            ) = self.solve_step(state, data, g, diag, scale, ctrl, *gn)
            if o.detailed_step_timings:
                # exact per-phase split (reference Summary semantics); the
                # sync stalls dispatch pipelining — bench harnesses turn
                # it off
                jax.block_until_ready(new_state)
            step_solver_time = time.time() - t0
            s.linear_solver_time_in_seconds += step_solver_time
            s.num_linear_solves += 1
            self._maybe_dump(iteration, state, data, g, diag, radius, dx)

            t0 = time.time()
            self._prepare_for_evaluation(False, True)
            new_cost, x_norm = self.try_step(new_state)
            # one batched device->host fetch instead of one per scalar
            (
                new_cost,
                model_cost_change,
                step_norm_f,
                x_norm_f,
                lin_iters,
                jitter_f,
            ) = (
                float(v)
                for v in jax.device_get(
                    (
                        new_cost,
                        model_cost_change,
                        step_norm,
                        x_norm,
                        lin_iters,
                        jitter_used,
                    )
                )
            )
            # factor-jitter ratchet: start the next damped solve's ladder
            # at the last successful delta (skips doomed plain factors on
            # gauge-free problems)
            self._jitter = jitter_f
            s.residual_evaluation_time_in_seconds += time.time() - t0
            s.num_residual_evaluations += 1

            step_is_valid = (
                np.isfinite(new_cost)
                and np.isfinite(model_cost_change)
                and np.isfinite(step_norm_f)
                and model_cost_change > 0.0
            )

            it = IterationSummary(
                iteration=iteration,
                cost=new_cost + s.fixed_cost,
                step_norm=step_norm_f,
                trust_region_radius=radius,
                linear_solver_iterations=int(lin_iters),
                step_solver_time_in_seconds=step_solver_time,
                step_is_valid=step_is_valid,
            )

            if not step_is_valid:
                num_consecutive_invalid_steps += 1
                if (
                    not o.run_full_iteration_budget
                    and num_consecutive_invalid_steps
                    >= o.max_num_consecutive_invalid_steps
                ):
                    s.termination_type = TerminationType.FAILURE
                    s.message = (
                        "Number of consecutive invalid steps more than "
                        f"{o.max_num_consecutive_invalid_steps}"
                    )
                    return state
                # reference semantics: treat as unsuccessful step, shrink region
                radius = radius / decrease_factor
                decrease_factor *= 2.0
                radius = max(radius, o.min_trust_region_radius)
                it.cost = step_evaluator.current_cost + s.fixed_cost
                it.step_is_successful = False
                s.num_unsuccessful_steps += 1
                it.iteration_time_in_seconds = time.time() - iter_start
                it.cumulative_time_in_seconds = time.time() - start
                s.iterations.append(it)
                self._log_iteration(it)
                if o.run_full_iteration_budget:
                    radius = max(
                        radius, float(jnp.finfo(self.ev.dtype).tiny)
                    )
                elif radius <= o.min_trust_region_radius:
                    s.termination_type = TerminationType.CONVERGENCE
                    s.message = "Minimum trust region radius reached."
                    return state
                continue

            num_consecutive_invalid_steps = 0
            current_cost = step_evaluator.current_cost
            relative_decrease = step_evaluator.step_quality(new_cost, model_cost_change)
            it.relative_decrease = relative_decrease
            it.cost_change = current_cost - new_cost

            step_is_successful = relative_decrease > o.min_relative_decrease

            if step_is_successful:
                # reference radius update:
                # radius /= max(1/3, 1 - (2q - 1)^3); decrease_factor = 2
                q = relative_decrease
                radius = radius / max(1.0 / 3.0, 1.0 - (2.0 * q - 1.0) ** 3)
                radius = min(radius, o.max_trust_region_radius)
                decrease_factor = 2.0
                step_evaluator.step_accepted(new_cost, model_cost_change)

                state = new_state
                s.num_successful_steps += 1

                t0 = time.time()
                self._prepare_for_evaluation(True, False)
                # refresh_jacobi_scaling=True (default, a deviation):
                # recompute the column scaling at each accepted step;
                # False pins the iteration-zero scaling exactly like the
                # reference — the pinned scale is passed back in so the
                # device-side prep stays consistent with it
                pinned = (
                    self.options.jacobi_scaling
                    and not self.options.refresh_jacobi_scaling
                )
                (
                    cost_d,
                    g,
                    diag,
                    data,
                    scale,
                    g_max_norm,
                    g_norm,
                    *gn,
                ) = self.linearize(state, scale if pinned else None)
                cost, gmax_f, gnorm_f = (
                    float(v)
                    for v in jax.device_get((cost_d, g_max_norm, g_norm))
                )
                s.jacobian_evaluation_time_in_seconds += time.time() - t0
                s.num_jacobian_evaluations += 1
                self._track_iterate(state, cost)

                it.gradient_max_norm = gmax_f
                it.gradient_norm = gnorm_f
                it.step_is_successful = True
            else:
                radius = radius / decrease_factor
                decrease_factor *= 2.0
                it.step_is_successful = False
                s.num_unsuccessful_steps += 1

            it.iteration_time_in_seconds = time.time() - iter_start
            it.cumulative_time_in_seconds = time.time() - start
            s.iterations.append(it)
            self._log_iteration(it)
            if step_is_successful:
                self._maybe_checkpoint(
                    state, radius, self.initial_iteration + iteration, cost
                )

            if self._run_callbacks(it, state):
                return state

            # -- convergence tests (reference order & formulas) ---------------
            if o.run_full_iteration_budget:
                # benchmark mode: fixed iteration budget, no termination;
                # floor the radius above dtype underflow so mu = 1/radius
                # stays finite while the post-convergence radius collapses
                radius = max(radius, float(jnp.finfo(self.ev.dtype).tiny))
                continue
            if step_is_successful:
                if it.gradient_max_norm <= o.gradient_tolerance:
                    s.termination_type = TerminationType.CONVERGENCE
                    s.message = (
                        f"Gradient tolerance reached. Gradient max norm: "
                        f"{it.gradient_max_norm:e} <= {o.gradient_tolerance:e}"
                    )
                    return state
                cost_change = abs(it.cost_change)
                if cost_change <= o.function_tolerance * abs(current_cost):
                    s.termination_type = TerminationType.CONVERGENCE
                    s.message = (
                        f"Function tolerance reached. |cost_change|/cost: "
                        f"{cost_change / max(abs(current_cost), 1e-300):e} <= "
                        f"{o.function_tolerance:e}"
                    )
                    return state
            # ptol == 0 disables the test: an exactly-zero f32 step (radius
            # underflow after convergence) would otherwise pass
            # `step_norm <= 0` (r4 judge finding)
            if o.parameter_tolerance > 0 and step_norm_f <= o.parameter_tolerance * (
                x_norm_f + o.parameter_tolerance
            ):
                s.termination_type = TerminationType.CONVERGENCE
                s.message = (
                    f"Parameter tolerance reached. Relative step_norm: "
                    f"{step_norm_f / (x_norm_f + o.parameter_tolerance):e} <= "
                    f"{o.parameter_tolerance:e}"
                )
                return state
            if radius <= o.min_trust_region_radius:
                s.termination_type = TerminationType.CONVERGENCE
                s.message = "Minimum trust region radius reached."
                return state

    # -- helpers ------------------------------------------------------------------

    def _log_iteration(self, it: IterationSummary):
        from skeres.core.types import LoggingType

        if (
            self.options.logging_type == LoggingType.SILENT
            or not self.options.minimizer_progress_to_stdout
        ):
            return
        if it.iteration == 0:
            print(
                f"{'iter':>4} {'cost':>13} {'cost_change':>12} {'|gradient|':>11}"
                f" {'|step|':>10} {'tr_ratio':>9} {'tr_radius':>10} {'ls_iter':>8}"
                f" {'iter_time':>10} {'total_time':>11}"
            )
        print(
            f"{it.iteration:4d} {it.cost:13.6e} {it.cost_change:12.2e}"
            f" {it.gradient_max_norm:11.2e} {it.step_norm:10.2e}"
            f" {it.relative_decrease:9.2e} {it.trust_region_radius:10.2e}"
            f" {it.linear_solver_iterations:8d}"
            f" {it.iteration_time_in_seconds:10.2e}"
            f" {it.cumulative_time_in_seconds:11.2e}"
        )

    def _prepare_for_evaluation(self, evaluate_jacobians: bool, new_point: bool):
        """Fire the user's EvaluationCallback before a device dispatch that
        (re)evaluates the problem (reference:
        ``include/ceres/evaluation_callback.h``)."""
        cb = getattr(self.options, "evaluation_callback", None)
        if cb is not None:
            cb.prepare_for_evaluation(evaluate_jacobians, new_point)

    def _callback_wants_state(self, cb) -> bool:
        """True if the callback takes a second REQUIRED parameter (the
        state pytree). Counting only parameters without defaults keeps a
        one-arg callback with an optional kwarg (``def cb(it, verbose=False)``)
        on the one-arg protocol; the result is cached per callback."""
        cache = getattr(self, "_cb_arity_cache", None)
        if cache is None:
            cache = self._cb_arity_cache = {}
        key = id(cb)
        if key not in cache:
            try:
                import inspect

                params = inspect.signature(cb).parameters.values()
                required = [
                    p
                    for p in params
                    if p.default is inspect.Parameter.empty
                    and p.kind
                    in (
                        inspect.Parameter.POSITIONAL_ONLY,
                        inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    )
                ]
                cache[key] = len(required) >= 2
            except (TypeError, ValueError):
                cache[key] = False
        return cache[key]

    def _run_callbacks(self, it: IterationSummary, state) -> bool:
        """Returns True if the solve should stop (sets termination)."""
        if self.options.update_state_every_iteration:
            # reference StateUpdatingCallback semantics: user-visible
            # parameter storage tracks the iterate every iteration
            self.ev.program.write_back(state)
        for cb in self.options.callbacks:
            ret = cb(it, state) if self._callback_wants_state(cb) else cb(it)
            if ret == CallbackReturnType.SOLVER_ABORT:
                self.summary.termination_type = TerminationType.USER_FAILURE
                self.summary.message = "User callback returned SOLVER_ABORT."
                return True
            if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
                self.summary.termination_type = TerminationType.USER_SUCCESS
                self.summary.message = (
                    "User callback returned SOLVER_TERMINATE_SUCCESSFULLY."
                )
                return True
        return False
