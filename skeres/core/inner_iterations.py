"""Inner iterations: coordinate descent over an independent parameter group.

JAX counterpart of the reference lineage's inner-iteration machinery
(``internal/ceres/inner_iteration_minimizer.cc``,
``coordinate_descent_minimizer.cc``): after a trust-region candidate is
computed, the blocks of an *independent* group (no residual couples two of
its blocks — e.g. BAL points) are re-optimized with everything else fixed,
squeezing extra cost decrease out of each outer step.

Where the reference runs per-block Ceres solves on a thread pool, here all
blocks refine simultaneously: per-block (t x t) damped normal equations are
accumulated by segment-sum over the batches touching the group and solved
as one batched Cholesky — a handful of einsums per sweep, fused under the
outer jit (this runs *inside* ``solve_and_try``, matching the reference's
order: inner iterations influence step acceptance).

The independent group is the one declared with
``set_schur_elimination_group(arr, 0)``; the reference's automatic
independent-set discovery is intentionally not ported (structure is
declared, SURVEY.md §3.3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from skeres.ops.small_einsum import vpu_einsum

__all__ = ["InnerIterationRefiner"]


class InnerIterationRefiner:
    """Builds a pure ``refine(state) -> state`` for the independent group."""

    def __init__(
        self,
        evaluator,
        num_sweeps: int = 1,
        damping: float = 1e-9,
        tolerance: float = 0.0,
    ):
        self.ev = evaluator
        self.num_sweeps = int(num_sweeps)
        self.damping = float(damping)
        # reference: Solver::Options::inner_iteration_tolerance — stop the
        # sweeps early once the relative cost decrease falls below this
        self.tolerance = float(tolerance)
        program = evaluator.program

        elim = [i for i, g in enumerate(program.groups) if g.schur_group == 0]
        if len(elim) != 1:
            raise ValueError(
                "inner iterations need exactly one independent group "
                "(set_schur_elimination_group(arr, 0))"
            )
        self.group = elim[0]
        g = program.groups[self.group]
        self.t = g.tangent_size
        self.n_blocks = g.num_blocks
        self.manifold = g.manifold
        import numpy as np

        self._free = jnp.asarray(
            np.array([0.0 if c else 1.0 for c in g.constant]), dtype=evaluator.dtype
        )[:, None]

        # per batch: which slot (if any) belongs to the group, its tangent
        # columns, and the padded per-row block indices
        self.batch_cols = []
        for bi, b in enumerate(program.batches):
            e_slots = [s for s, gi in enumerate(b.slot_groups) if gi == self.group]
            if not e_slots:
                self.batch_cols.append(None)
                continue
            if len(e_slots) > 1:
                raise ValueError(
                    "group is not independent: a residual block touches "
                    "two of its parameter blocks"
                )
            import numpy as np

            cols = np.concatenate(
                [
                    np.arange(t) + sum(b.tangent_sizes[:s])
                    for s, t in ((e_slots[0], b.tangent_sizes[e_slots[0]]),)
                ]
            )
            # index from the HOST copy: a device array here would be closed
            # over by the jitted programs, which jax.distributed forbids
            # for globally-sharded arrays
            self.batch_cols.append(
                (
                    jnp.asarray(cols),
                    jnp.asarray(evaluator._batch_idx_np[bi][e_slots[0]]),
                )
            )

    def refine(self, state):
        """num_sweeps Gauss-Newton sweeps over the independent group."""
        ev = self.ev
        t = self.t

        def sweep(state, _):
            # one full evaluation; only the group's columns are used
            _, blocks = ev.blocks(state)
            h = jnp.zeros((self.n_blocks, t, t), dtype=ev.dtype)
            rhs = jnp.zeros((self.n_blocks, t), dtype=ev.dtype)
            for cols_idx, b in zip(self.batch_cols, blocks):
                if cols_idx is None:
                    continue
                cols, pidx = cols_idx
                jac = b.jac[:, :, cols]  # (B, m, t)
                h = h.at[pidx].add(vpu_einsum("bmi,bmj->bij", jac, jac))
                rhs = rhs.at[pidx].add(-vpu_einsum("bmi,bm->bi", jac, b.r))
            h = h + self.damping * jnp.broadcast_to(
                jnp.eye(t, dtype=ev.dtype), h.shape
            )
            chol = jax.vmap(jnp.linalg.cholesky)(h)
            step = jax.vmap(
                lambda l, b_: jax.scipy.linalg.cho_solve((l, True), b_)
            )(chol, rhs)
            step = jnp.where(jnp.isfinite(step), step, 0.0) * self._free

            x = state[self.group]
            x_new = jax.vmap(self.manifold.plus)(x, step.astype(x.dtype))
            new_state = tuple(
                x_new if gi == self.group else s for gi, s in enumerate(state)
            )
            return new_state, None

        if self.num_sweeps == 1 or self.tolerance <= 0.0:
            state, _ = jax.lax.scan(sweep, state, None, length=self.num_sweeps)
            return state

        # tolerance-controlled sweeps (reference: inner_iteration_tolerance):
        # stop once the relative cost decrease of a sweep falls below tol
        ev = self.ev

        def cond(carry):
            _, cost, decrease, i = carry
            return (i < self.num_sweeps) & (
                decrease > self.tolerance * jnp.abs(cost)
            )

        def body(carry):
            state, cost, _, i = carry
            new_state, _ = sweep(state, None)
            new_cost = ev.cost(new_state)
            return new_state, new_cost, cost - new_cost, i + 1

        cost0 = ev.cost(state)
        state, _, _, _ = jax.lax.while_loop(
            cond,
            body,
            (state, cost0, jnp.asarray(jnp.inf, ev.dtype), jnp.zeros((), jnp.int32)),
        )
        return state
