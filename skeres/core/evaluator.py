"""The evaluator: batched residual + tangent-Jacobian evaluation.

JAX re-design of the reference lineage's ProgramEvaluator
(``internal/ceres/evaluator.cc``, ``program_evaluator.h``): instead of a
thread pool looping over residual blocks with per-thread scratch and a
JacobianWriter, each homogeneous batch evaluates as ONE vmapped program:

    r, J = vmap(linearize(fn ∘ manifold.plus))(blocks)

with the robust-loss (Triggs) correction fused in, and the normal equations
assembled by scatter-add (``segment_sum``-style) into dense/tangent space.
The reference's BlockSparseMatrix becomes "a list of per-batch dense block
arrays + integer index maps" — all products are batched einsums.

All public methods are pure functions of the state pytree, intended to be
wrapped in ``jax.jit`` (the Minimizer does this).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from skeres.core.problem import CompiledBatch, Program
from skeres.ops.corrector import apply_loss
from skeres.ops.small_einsum import vpu_einsum

__all__ = ["Evaluator", "BatchBlocks"]


def default_dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


class BatchBlocks:
    """Device-side view of one batch's Jacobian blocks: the batched
    counterpart of a row-slice of the reference's BlockSparseMatrix. Registered as a
    pytree so it crosses jit boundaries."""

    def __init__(self, r, jac, idx):
        self.r = r  # (B, m) corrected residuals
        self.jac = jac  # (B, m, T) corrected tangent Jacobian blocks
        self.idx = idx  # (B, T) global tangent indices


jax.tree_util.register_pytree_node(
    BatchBlocks,
    lambda b: ((b.r, b.jac, b.idx), None),
    lambda aux, children: BatchBlocks(*children),
)


class Evaluator:
    """Builds jittable evaluation functions from a compiled Program."""

    def __init__(
        self,
        program: Program,
        dtype=None,
        chunk_size: Optional[int] = None,
        mesh=None,
        apply_loss_function: bool = True,
        diff_mode: str = "auto",
    ):
        self.program = program
        self.dtype = dtype or default_dtype()
        # Jacobian differentiation mode per batch: "forward" builds the
        # (m, T) block from T tangent-basis jvps (the reference's Jet
        # layout), "reverse" from m cotangent-basis vjps. "auto" picks
        # reverse when the residual dim is well below the block tangent
        # size — the BA case (m=2, T=12) does 6x fewer differentiation
        # passes. Residuals that only define a custom_jvp (no transpose)
        # need "forward".
        assert diff_mode in ("auto", "forward", "reverse"), diff_mode
        self.diff_mode = diff_mode
        # False: skip the robust-loss corrector (reference:
        # Covariance::Options::apply_loss_function = false evaluates the
        # covariance from the unweighted Jacobians)
        self.apply_loss_function = apply_loss_function
        # streamed evaluation reshapes the row axis into (chunks, rows) —
        # incompatible with sharding that same axis; under a mesh the
        # per-shard row count is already 1/n_shards of the batch, which is
        # the same transient bound chunking buys on one device
        self.chunk_size = None if mesh is not None else chunk_size
        self.mesh = mesh  # jax.sharding.Mesh for residual-block sharding
        self.num_tangent = program.num_tangent

        # sharding setup: residual batches are data-parallel over the mesh's
        # 'obs' axis (SPMD; XLA inserts the psum for the scatter-adds into
        # replicated outputs — SURVEY.md §3.8: DP over residual blocks is
        # the only parallelism axis in this workload)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec

            axis = mesh.axis_names[0]
            self._n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
            self._obs_sharding = lambda ndim: NamedSharding(
                mesh, PartitionSpec(axis, *([None] * (ndim - 1)))
            )
            self._replicated = NamedSharding(mesh, PartitionSpec())
        else:
            self._n_shards = 1
            self._obs_sharding = None
            self._replicated = None

        def place_obs(a):
            if self._obs_sharding is None:
                return a
            return jax.device_put(a, self._obs_sharding(a.ndim))

        # device constants per batch (padded to a multiple of the shard
        # count when sharded — and of the evaluation chunk size when
        # streamed eval is on; `weight` zeroes padded rows' contributions)
        self._batch_const = []
        # host copies of the padded per-slot/tangent index arrays: plan and
        # Schur-structure building must not fetch device arrays (under
        # jax.distributed they span non-addressable devices)
        self._batch_idx_np = []
        self._batch_tidx_np = []
        for b in program.batches:
            B = b.num_blocks
            quantum = self._n_shards
            if self.chunk_size and B > self.chunk_size:
                quantum = int(np.lcm(quantum, self.chunk_size))
            pad = (-B) % quantum
            weight_np = np.concatenate(
                [np.ones(B), np.zeros(pad)]
            )

            def pad_rows(a):
                a = np.asarray(a)
                if pad == 0:
                    return a
                fill = np.repeat(a[:1], pad, axis=0)
                return np.concatenate([a, fill], axis=0)

            data = (
                None
                if b.data is None
                else jax.tree_util.tree_map(
                    lambda a: place_obs(
                        jnp.asarray(
                            pad_rows(a),
                            dtype=self.dtype
                            if np.issubdtype(np.asarray(a).dtype, np.floating)
                            else None,
                        )
                    ),
                    b.data,
                )
            )
            idx_np = tuple(pad_rows(ix) for ix in b.slot_indices)
            self._batch_idx_np.append(idx_np)
            idx = tuple(place_obs(jnp.asarray(ix)) for ix in idx_np)
            tidx_np = pad_rows(b.tangent_index)
            self._batch_tidx_np.append(tidx_np)
            tidx = place_obs(jnp.asarray(tidx_np))
            # free-coordinate mask gathered per block (B, T)
            mask = place_obs(
                jnp.asarray(
                    pad_rows(program.free_mask[b.tangent_index]), dtype=self.dtype
                )
            )
            weight = place_obs(jnp.asarray(weight_np, dtype=self.dtype))
            self._batch_const.append((data, idx, tidx, mask, weight))

        self._free_mask = jnp.asarray(program.free_mask, dtype=self.dtype)
        if self._replicated is not None:
            self._free_mask = jax.device_put(self._free_mask, self._replicated)

        # scatter-free reduction plans per (batch, slot): destination
        # indices are static, so the strategy is planned host-side
        # (ops/segment_reduce.py).
        # Under SPMD sharding, plain gathers from sharded operands would
        # allgather — so the mesh path uses *sharded* plans instead: each
        # shard runs its own local windowed gather/one-hot reduction inside
        # shard_map, combined by one explicit psum (SURVEY.md §3.8).
        from skeres.ops.segment_reduce import (
            build_reduce_plan,
            build_sharded_reduce_plan,
        )

        self._slot_plans = []
        for bi, b in enumerate(program.batches):
            idx_pad = self._batch_idx_np[bi]
            if mesh is None:
                plans = tuple(
                    build_reduce_plan(
                        ix,
                        program.groups[gi].num_blocks,
                        n_valid=b.num_blocks,
                    )
                    for gi, ix in zip(b.slot_groups, idx_pad)
                )
            else:
                plans = tuple(
                    build_sharded_reduce_plan(
                        ix,
                        program.groups[gi].num_blocks,
                        self._n_shards,
                        n_valid=b.num_blocks,
                    )
                    for gi, ix in zip(b.slot_groups, idx_pad)
                )
            self._slot_plans.append(plans)
        # tangent column span per slot within each batch's T axis
        self._slot_cols = []
        for b in program.batches:
            cols, c = [], 0
            for t in b.tangent_sizes:
                cols.append((c, t))
                c += t
            self._slot_cols.append(tuple(cols))

    @property
    def device_consts(self):
        """The evaluator's device-resident constants as a pytree. Under
        ``jax.distributed`` these span non-addressable devices, and jit may
        not close over such arrays — the minimizer passes this pytree as an
        explicit argument to every device program and rebinds it during
        tracing (:meth:`bind`). Single-process behavior is unchanged."""
        return {"batch": self._batch_const, "free_mask": self._free_mask}

    def bind(self, consts):
        """Context manager: temporarily swap in (traced) device constants
        while tracing a jitted program."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            old = self._batch_const, self._free_mask
            self._batch_const = consts["batch"]
            self._free_mask = consts["free_mask"]
            try:
                yield
            finally:
                self._batch_const, self._free_mask = old

        return _ctx()

    def slot_reduce(self, bi: int, s: int, values):
        """Sum per-row contributions ``values (B, D)`` into the slot's
        destination blocks -> ``(n_blocks, D)``."""
        from skeres.ops.segment_reduce import (
            apply_reduce_plan,
            apply_sharded_reduce_plan,
        )

        plan = self._slot_plans[bi][s]
        if self.mesh is not None:
            return apply_sharded_reduce_plan(
                plan, values, self.mesh, self.mesh.axis_names[0]
            )
        return apply_reduce_plan(plan, values)

    def assemble_tangent(self, per_group):
        """Concatenate per-group ``(n_blocks, t)`` arrays into the global
        tangent vector (groups are laid out contiguously in group order)."""
        return jnp.concatenate([a.reshape(-1) for a in per_group])

    def prepare_state(self, state):
        """Place the state pytree (replicated) for the evaluator's mesh."""
        if self._replicated is None:
            return state
        return jax.device_put(state, self._replicated)

    # -- core batched eval -----------------------------------------------------

    def _gather_slots(self, batch: CompiledBatch, idx, state):
        return tuple(state[gi][ix] for gi, ix in zip(batch.slot_groups, idx))

    def _split_delta(self, batch: CompiledBatch, delta):
        parts = []
        col = 0
        for t in batch.tangent_sizes:
            parts.append(delta[col : col + t])
            col += t
        return parts

    def _chunk_count(self, bi: int) -> int:
        """Number of lax.map chunks for batch bi (1 = unchunked)."""
        if not self.chunk_size:
            return 1
        B = int(self._batch_const[bi][4].shape[0])
        if B <= self.chunk_size or B % self.chunk_size != 0:
            return 1
        return B // self.chunk_size

    def _rows_residuals(self, batch, data, idx, weight, state):
        """Residual-only eval over the given rows: cost-per-block (B,)."""
        xs = self._gather_slots(batch, idx, state)
        if data is None:
            r = jax.vmap(lambda *x: batch.fn(tuple(x), None))(*xs)
        else:
            r = jax.vmap(lambda d, *x: batch.fn(tuple(x), d))(data, *xs)

        r = r * weight[:, None]
        s = jnp.sum(r * r, axis=-1)
        loss = batch.loss if self.apply_loss_function else None
        if loss is None:
            return 0.5 * s
        rho0, _, _ = loss.evaluate(s)
        return 0.5 * rho0

    def _batch_residuals(self, bi: int, state):
        """Residual-only eval: (cost_per_block (B,),)."""
        batch = self.program.batches[bi]
        data, idx, _, _, weight = self._batch_const[bi]
        C = self._chunk_count(bi)
        if C == 1:
            return self._rows_residuals(batch, data, idx, weight, state)

        def chunk_fn(args):
            data_c, idx_c, weight_c = args
            return self._rows_residuals(batch, data_c, idx_c, weight_c, state)

        split = lambda a: a.reshape((C, -1) + a.shape[1:])
        args = (
            None if data is None else jax.tree_util.tree_map(split, data),
            tuple(split(ix) for ix in idx),
            split(weight),
        )
        out = jax.lax.map(chunk_fn, args)
        return out.reshape(-1)

    def _rows_residuals_and_jacobian(
        self, batch, data, idx, mask, weight, state
    ):
        """Full eval over the given rows: (cost (B,), r (B,m), J (B,m,T))
        corrected. Gathers, linearization, and the Triggs correction all
        happen on just these rows, so chunked callers bound the transient
        footprint to one chunk (SURVEY.md §6: streamed evaluation is what
        lets ~1M-point venice fit; reference counterpart is
        ``program_evaluator.h``'s streaming over residual blocks)."""
        xs = self._gather_slots(batch, idx, state)
        manifolds = [self.program.groups[gi].manifold for gi in batch.slot_groups]
        T = batch.block_tangent_size

        def one_block(data_row, *x_row):
            def f(delta):
                ds = self._split_delta(batch, delta)
                xp = tuple(m.plus(x, d) for m, x, d in zip(manifolds, x_row, ds))
                return batch.fn(xp, data_row)

            if batch.numeric_diff:
                # user-requested numeric differentiation (reference:
                # NumericDiffCostFunction, internal/ceres/numeric_diff.h)
                # — for residuals whose AD derivative is unavailable or
                # wrong. Methods: "central" (default) / "forward" one
                # f-eval cheaper / "ridders" Richardson-extrapolated for
                # ill-scaled residuals
                from skeres.core.gradient_checker import (
                    numeric_jacobian,
                    ridders_jacobian,
                )

                zero = jnp.zeros((T,), dtype=self.dtype)
                if batch.numeric_diff_method == "ridders":
                    return f(zero), ridders_jacobian(
                        f, T, self.dtype, batch.numeric_diff_step
                    )
                return f(zero), numeric_jacobian(
                    f,
                    T,
                    self.dtype,
                    batch.numeric_diff_step,
                    method=batch.numeric_diff_method,
                )
            zero = jnp.zeros((T,), dtype=self.dtype)
            m = batch.residual_dim
            use_reverse = self.diff_mode == "reverse" or (
                self.diff_mode == "auto" and 2 * m < T
            )
            if use_reverse:
                # m cotangent pulls beat T tangent pushes when the
                # residual dim is small against the block tangent size
                # (BA: 2 vs 12)
                r, vjp = jax.vjp(f, zero)
                basis = jnp.eye(m, dtype=self.dtype)
                (jac_rows,) = jax.vmap(vjp)(basis)  # (m, T)
                return r, jac_rows
            r, lin = jax.linearize(f, zero)
            basis = jnp.eye(T, dtype=self.dtype)
            jac_cols = jax.vmap(lin)(basis)  # (T, m)
            return r, jnp.swapaxes(jac_cols, 0, 1)  # (m,), (m, T)

        if data is None:
            r, jac = jax.vmap(lambda *x: one_block(None, *x))(*xs)
        else:
            r, jac = jax.vmap(one_block)(data, *xs)

        r = r * weight[:, None]  # padded rows contribute nothing
        jac = jac * weight[:, None, None]
        loss = batch.loss if self.apply_loss_function else None
        cost, r_c, (jac_c,) = apply_loss(loss, r, [jac])
        jac_c = jac_c * mask[:, None, :]  # zero out constant coordinates
        return cost, r_c, jac_c

    def _batch_residuals_and_jacobian(self, bi: int, state):
        """Full eval for one batch: (cost (B,), r (B,m), J (B,m,T)) corrected.

        With ``chunk_size`` set (SolverOptions.evaluation_chunk_size) and
        B > chunk_size, the pass streams over row chunks with ``lax.map``
        (sequential scan): outputs are still materialized (the solvers keep
        them resident), but the linearize/corrector transients are bounded
        by one chunk instead of the whole batch."""
        batch = self.program.batches[bi]
        data, idx, _, mask, weight = self._batch_const[bi]
        C = self._chunk_count(bi)
        if C == 1:
            return self._rows_residuals_and_jacobian(
                batch, data, idx, mask, weight, state
            )

        def chunk_fn(args):
            data_c, idx_c, mask_c, weight_c = args
            return self._rows_residuals_and_jacobian(
                batch, data_c, idx_c, mask_c, weight_c, state
            )

        split = lambda a: a.reshape((C, -1) + a.shape[1:])
        args = (
            None if data is None else jax.tree_util.tree_map(split, data),
            tuple(split(ix) for ix in idx),
            split(mask),
            split(weight),
        )
        cost, r, jac = jax.lax.map(chunk_fn, args)
        return (
            cost.reshape(-1),
            r.reshape((-1,) + r.shape[2:]),
            jac.reshape((-1,) + jac.shape[2:]),
        )

    # -- public pure functions (wrap in jit at the call site) -----------------

    def cost(self, state):
        total = jnp.zeros((), dtype=self.dtype)
        for bi in range(len(self.program.batches)):
            total = total + jnp.sum(self._batch_residuals(bi, state))
        return total

    def blocks(self, state) -> Tuple[Any, List[BatchBlocks]]:
        """Full evaluation: (cost, per-batch corrected blocks)."""
        total = jnp.zeros((), dtype=self.dtype)
        out = []
        for bi in range(len(self.program.batches)):
            _, idx, tidx, _, _ = self._batch_const[bi]
            cost, r, jac = self._batch_residuals_and_jacobian(bi, state)
            total = total + jnp.sum(cost)
            out.append(BatchBlocks(r, jac, tidx))
        return total, out

    def gradient_and_diag(self, blocks: Sequence[BatchBlocks]):
        """g = J^T r and diag(J^T J), assembled scatter-free: per (batch,
        slot) segment reduction into per-group accumulators, concatenated in
        tangent layout order (replaces the reference's BlockJacobianWriter
        scatter; see ops/segment_reduce.py for why not ``.at[].add``)."""
        accs = [
            jnp.zeros((g.num_blocks, 2 * g.tangent_size), dtype=self.dtype)
            for g in self.program.groups
        ]
        for bi, b in enumerate(blocks):
            batch = self.program.batches[bi]
            gb = vpu_einsum("bmi,bm->bi", b.jac, b.r)
            db = jnp.sum(b.jac * b.jac, axis=1)  # (B, T)
            for s, gi in enumerate(batch.slot_groups):
                c, t = self._slot_cols[bi][s]
                vals = jnp.concatenate(
                    [gb[:, c : c + t], db[:, c : c + t]], axis=1
                )
                accs[gi] = accs[gi] + self.slot_reduce(bi, s, vals)
        g = self.assemble_tangent([a[:, : a.shape[1] // 2] for a in accs])
        diag = self.assemble_tangent([a[:, a.shape[1] // 2 :] for a in accs])
        return g, diag

    def jtj_dense(self, blocks: Sequence[BatchBlocks]):
        """Dense (N, N) J^T J via batched block outer products + scatter-add."""
        n = self.num_tangent
        h = jnp.zeros((n, n), dtype=self.dtype)
        for b in blocks:
            hb = jnp.einsum("bmi,bmj->bij", b.jac, b.jac)
            h = h.at[b.idx[:, :, None], b.idx[:, None, :]].add(hb)
        return h

    def jacobian_dense(self, blocks: Sequence[BatchBlocks]):
        """Materialized dense Jacobian (M, N) and residual vector (M,).

        Only for small problems (DENSE_QR); row order is batch order.
        """
        n = self.num_tangent
        m_total = sum(
            int(b.r.shape[0]) * spec.residual_dim
            for spec, b in zip(self.program.batches, blocks)
        )
        jd = jnp.zeros((m_total, n), dtype=self.dtype)
        rd = jnp.zeros((m_total,), dtype=self.dtype)
        row0 = 0
        for spec, b in zip(self.program.batches, blocks):
            B, m = int(b.r.shape[0]), spec.residual_dim
            rows = row0 + jnp.arange(B * m).reshape(B, m)
            jd = jd.at[rows[:, :, None], b.idx[:, None, :]].add(b.jac)
            rd = rd.at[rows.reshape(-1)].set(b.r.reshape(-1))
            row0 += B * m
        return jd, rd

    def v_rows(self, bi: int, v):
        """Per-row tangent vectors (B, T) for batch ``bi``, built from
        per-slot ROW gathers of the (n_blocks, t) group views. The naive
        ``v[tangent_index]`` with a (B, T) index array is an ELEMENT
        gather — T times the rows of the slot-wise form."""
        batch = self.program.batches[bi]
        _, idx, _, _, _ = self._batch_const[bi]
        parts = []
        for s, gi in enumerate(batch.slot_groups):
            g = self.program.groups[gi]
            o = self.program.tangent_offset[gi]
            view = v[o : o + g.num_blocks * g.tangent_size].reshape(
                g.num_blocks, g.tangent_size
            )
            parts.append(view[idx[s]])
        return (
            jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
        )

    def jtj_matvec(self, blocks: Sequence[BatchBlocks], v):
        """v -> J^T (J v) without forming J^T J (CGNR hot path).
        Gather on the way in, planned segment-reduce on the way out."""
        accs = [
            jnp.zeros((g.num_blocks, g.tangent_size), dtype=v.dtype)
            for g in self.program.groups
        ]
        for bi, b in enumerate(blocks):
            batch = self.program.batches[bi]
            jv = vpu_einsum("bmi,bi->bm", b.jac, self.v_rows(bi, v))
            jtv = vpu_einsum("bmi,bm->bi", b.jac, jv)  # (B, T)
            for s, gi in enumerate(batch.slot_groups):
                c, t = self._slot_cols[bi][s]
                accs[gi] = accs[gi] + self.slot_reduce(bi, s, jtv[:, c : c + t])
        return self.assemble_tangent(accs)

    def plus(self, state, step):
        """x <- x (+) step, step (N,) in global tangent space."""
        step = step * self._free_mask
        new_state = []
        for g, o, x in zip(self.program.groups, self.program.tangent_offset, state):
            nb, t = g.num_blocks, g.tangent_size
            delta = step[o : o + nb * t].reshape(nb, t).astype(x.dtype)
            new_state.append(jax.vmap(g.manifold.plus)(x, delta))
        return tuple(new_state)

    def tangent_diff(self, y_state, x_state):
        """Global tangent step ``y (-) x`` (N,): per-group vmapped
        ``manifold.minus``. Used for bounds-correct stepping — after
        projecting a candidate onto the bounds box, the *effective* step
        (what the model-cost computation must see, per the reference's
        ``trust_region_minimizer.cc`` bounds semantics) is the tangent
        difference of the projected point from the current point."""
        parts = []
        for g, y, x in zip(self.program.groups, y_state, x_state):
            d = jax.vmap(g.manifold.minus)(y, x).astype(self.dtype)
            parts.append(d.reshape(-1))
        out = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        return out * self._free_mask

    def x_norm(self, state):
        sq = jnp.zeros((), dtype=self.dtype)
        for x in state:
            sq = sq + jnp.sum(x.astype(self.dtype) ** 2)
        return jnp.sqrt(sq)

    def project_bounds(self, state):
        """Clamp ambient coordinates into [lower, upper] (bounds support)."""
        if not self.program.has_bounds:
            return state
        lowers, uppers = self.program.bounds_arrays(self.dtype)
        return tuple(
            jnp.clip(x, lo, hi) for x, lo, hi in zip(state, lowers, uppers)
        )
