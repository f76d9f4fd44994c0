"""Built-in iteration callbacks.

Counterparts of the reference lineage's ``internal/ceres/callbacks.cc`` /
``include/ceres/iteration_callback.h``: callbacks are plain callables
``cb(IterationSummary) -> CallbackReturnType | None`` invoked by the host
loop after every iteration (after every chunk in the device-loop mode).
"""

from __future__ import annotations

from typing import Callable, Optional

from skeres.core.summary import IterationSummary
from skeres.core.types import CallbackReturnType

__all__ = [
    "LoggingCallback",
    "AbortAtIterationCallback",
    "HistoryCallback",
    "StateUpdatingCallback",
    "EvaluationCallback",
]


class LoggingCallback:
    """Prints the canonical per-iteration line (reference: LoggingCallback)."""

    def __init__(self, log_to_stdout: bool = True):
        self.log_to_stdout = log_to_stdout

    def __call__(self, it: IterationSummary):
        msg = (
            f"{it.iteration:4d}: f:{it.cost: .6e} d:{it.cost_change: .2e} "
            f"g:{it.gradient_max_norm: .2e} h:{it.step_norm: .2e} "
            f"rho:{it.relative_decrease: .2e} mu:{it.trust_region_radius: .2e} "
            f"li:{it.linear_solver_iterations:3d} "
            f"it:{it.iteration_time_in_seconds: .2e} "
            f"tt:{it.cumulative_time_in_seconds: .2e}"
        )
        if self.log_to_stdout:
            print(msg)
        return CallbackReturnType.SOLVER_CONTINUE


class AbortAtIterationCallback:
    """Terminates the solve at a given iteration (testing / budget caps)."""

    def __init__(self, max_iteration: int, successfully: bool = True):
        self.max_iteration = max_iteration
        self.successfully = successfully

    def __call__(self, it: IterationSummary):
        if it.iteration >= self.max_iteration:
            return (
                CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY
                if self.successfully
                else CallbackReturnType.SOLVER_ABORT
            )
        return CallbackReturnType.SOLVER_CONTINUE


class HistoryCallback:
    """Records every IterationSummary (hook point for external metrics)."""

    def __init__(self):
        self.history: list[IterationSummary] = []

    def __call__(self, it: IterationSummary):
        self.history.append(it)
        return CallbackReturnType.SOLVER_CONTINUE


class StateUpdatingCallback:
    """Writes the current iterate back into the problem's user-visible
    parameter storage every iteration (reference: StateUpdatingCallback in
    ``internal/ceres/callbacks.cc``).

    Two-argument callback: the minimizer passes ``(IterationSummary, state)``
    to callbacks whose signature takes two required parameters. Equivalent
    to setting ``SolverOptions.update_state_every_iteration = True`` (which
    is the recommended path — it needs no handle at all).

    Accepts either a ``Problem`` (resolved to its compiled ``Program`` on
    first use; ``solve()`` compiles internally, so users typically only
    have the Problem at options-building time) or a ``Program``.
    """

    def __init__(self, problem_or_program):
        self._target = problem_or_program
        self._program = None

    def __call__(self, it: IterationSummary, state):
        if self._program is None:
            t = self._target
            self._program = t if hasattr(t, "write_back") else t.compile()
        self._program.write_back(state)
        return CallbackReturnType.SOLVER_CONTINUE


class EvaluationCallback:
    """Pre-evaluation hook protocol (reference:
    ``include/ceres/evaluation_callback.h``). Set an instance on
    ``SolverOptions.evaluation_callback``; the minimizer calls
    ``prepare_for_evaluation`` on the host before every device dispatch
    that (re)evaluates residuals or Jacobians.

    IMPORTANT semantic difference from the reference: residual functions
    are traced once and AOT/jit-compiled, so host data they *close over*
    is baked in at trace time — mutating it inside this hook has NO effect
    on later dispatches. Mutable per-evaluation data must instead flow
    through the residual's ``data`` pytree, and a change requires a fresh
    ``solve()`` (each solve re-uploads the data arrays registered on the
    problem). Also,
    unlike the reference, the hook cannot inspect the candidate evaluation
    point: the iterate lives on device and is not written back before the
    hook fires (``(False, True)`` dispatches fire immediately before the
    candidate-cost evaluation, but the hook receives no state).
    """

    def prepare_for_evaluation(
        self, evaluate_jacobians: bool, new_evaluation_point: bool
    ) -> None:
        raise NotImplementedError
