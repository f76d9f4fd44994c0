"""Schur-complement elimination for bundle-adjustment structure.

JAX re-design of the reference lineage's Schur pipeline
(``internal/ceres/schur_eliminator_impl.h``, ``schur_complement_solver.cc``,
``implicit_schur_complement.cc``, ``iterative_schur_complement_solver.cc``,
``schur_jacobi_preconditioner.cc``). Where the reference runs a threaded
row-chunk loop with template-specialized small GEMMs and lock-guarded
scatter into a block-random-access S, here everything is batched over the
observation axis and assembled **scatter-free** (ops/segment_reduce.py —
destination indices are static, so every reduction is planned host-side):

  - per-point ``C = E^T E + D_e`` by a planned segment reduction of batched
    ``e x e`` outer products, inverted in closed form (3x3 cofactors —
    the reference's ``InvertPSDMatrix<3>`` counterpart),
  - retained-side (camera) reductions by one-hot matmuls,
  - DENSE_SCHUR's S via a dense per-point W (bounded size, checked) built
    by a planned gather — every FLOP an einsum,
  - the reduced camera system factored by ``lax.linalg.cholesky``,
  - back-substitution ``dx_e = C^{-1}(b_e - W^T dx_f)`` batched per point.

ITERATIVE_SCHUR never forms S: the matvec
``S v = (F^T F + D_f) v - W C^{-1} W^T v`` is gather/einsum/segment-reduce
passes over observations, run inside a ``lax.while_loop`` PCG with the
SCHUR_JACOBI (block-diagonal-of-S) preconditioner.

Structure is declared, not discovered: parameter groups tagged with
``set_schur_elimination_group(0)`` are eliminated (points), everything else
is retained (cameras) — the counterpart of the reference's
ParameterBlockOrdering groups.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from skeres.core.evaluator import BatchBlocks, Evaluator
from skeres.core.linear_solvers import (
    lm_diagonal,
    preconditioned_conjugate_gradients,
)
from skeres.core.types import PreconditionerType
from skeres.ops.segment_reduce import apply_reduce_plan, build_reduce_plan
from skeres.ops.small_einsum import vpu_einsum
from skeres.ops.small_inverse import batched_spd_inverse

__all__ = ["SchurSolver"]


def _cam_padded_src(
    idx_np: np.ndarray, nc: int, K: int, n_valid: Optional[int] = None,
    sentinel: Optional[int] = None,
) -> np.ndarray:
    """Row-placement map for the camera-padded layout: returns ``src`` of
    shape (nc*K,) with ``src[cam*K + j]`` = the row index of camera ``cam``'s
    j-th observation, and ``sentinel`` (a zero row appended by the
    consumer; defaults to ``len(idx_np)``) in unused slots.

    ``n_valid``: evaluator padding appends copies of row 0's indices at the
    END of each batch (chunked eval / sharding quanta); only the first
    ``n_valid`` rows are real and get slots — without this, block 0's
    apparent observation count explodes and the padding-waste gates
    spuriously reject the layout."""
    b = len(idx_np)
    if sentinel is None:
        sentinel = b
    if n_valid is None:
        n_valid = b
    idx_v = idx_np[:n_valid]
    order = np.argsort(idx_v, kind="stable")
    sorted_cam = idx_v[order]
    starts = np.searchsorted(sorted_cam, np.arange(nc))
    pos = np.arange(n_valid) - starts[sorted_cam]
    src = np.full(nc * K, sentinel, dtype=np.int64)
    src[sorted_cam * K + pos] = order
    return src


class SchurSolver:
    """Damped-normal-equation solver eliminating the group-0 parameters."""

    def __init__(
        self,
        evaluator: Evaluator,
        iterative: bool = False,
        preconditioner: PreconditionerType = PreconditionerType.SCHUR_JACOBI,
        max_cg_iterations: int = 500,
        eta: float = 1e-1,
        pair_chunk: Optional[int] = None,
        refinement_iterations: int = 0,
        max_power_series_terms: int = 5,
        spse_tolerance: float = 0.1,
        sort_threshold: int = 100_000,
        pad_waste: float = 1.5,
        use_explicit: bool = False,
        explicit_s_limit_bytes: int = 2 << 30,
        pair_cap: int = 32,
        cluster_size: int = 64,
        cluster_boost: float = 1e-3,
        placed_eval: Optional[bool] = None,
    ):
        # dual-eval placed Jacobian copies (see _build_placed_consts):
        # OPT-IN, off by default; its speed on the GPU is not measured.
        # The per-row point-state gather in camera order is a random
        # gather like the row placement it replaces. Selectable (ctor arg
        # or SKERES_PLACED_EVAL=1) for problems whose retained state is
        # small enough to stay cache-resident.
        if placed_eval is None:
            import os

            placed_eval = os.environ.get("SKERES_PLACED_EVAL") == "1"
        self.placed_eval = placed_eval
        self.ev = evaluator
        self.iterative = iterative
        self.preconditioner = preconditioner
        self.max_cg_iterations = max_cg_iterations
        self.eta = eta
        self.pair_chunk = pair_chunk
        self.refinement_iterations = refinement_iterations
        self.max_power_series_terms = max_power_series_terms
        self.spse_tolerance = spse_tolerance
        # CLUSTER_JACOBI factor regularization (relative to each
        # cluster's max diagonal); larger = more robust, weaker
        # preconditioner (the 4000-camera bench showed per-step quality
        # loss at 1e-3 — a tuning knob, not a constant of nature)
        self.cluster_boost = cluster_boost
        # hoist the explicit-S point grid into prepare() (1x per
        # linearization). The device-loop minimizer turns this OFF: its
        # lax.while_loop carry would hold the grid (0.54 GB at venice,
        # f32) across iterations; the grid is rebuilt per damped solve
        # instead.
        self.hoist_explicit_grid = True
        program = evaluator.program

        elim = [i for i, g in enumerate(program.groups) if g.schur_group == 0]
        if len(elim) != 1:
            raise NotImplementedError(
                "SchurSolver v1 requires exactly one eliminated parameter "
                f"group (got {len(elim)}); tag points with "
                "set_schur_elimination_group(arr, 0)"
            )
        self.elim_group = elim[0]
        ge = program.groups[self.elim_group]
        self.e_size = ge.tangent_size
        self.num_points = ge.num_blocks
        self.elim_offset = program.tangent_offset[self.elim_group]
        self.elim_span = self.num_points * self.e_size

        # retained (global tangent) index list, and global -> retained map
        n = program.num_tangent
        mask = np.ones(n, dtype=bool)
        mask[self.elim_offset : self.elim_offset + self.elim_span] = False
        self.ret_index = np.nonzero(mask)[0].astype(np.int32)  # (N_f,)
        self.num_f = len(self.ret_index)
        glob2ret = np.full(n, -1, dtype=np.int32)
        glob2ret[self.ret_index] = np.arange(self.num_f, dtype=np.int32)

        # retained block structure: contiguous (start_in_retained, n_blocks,
        # t) span per retained group (groups are contiguous in tangent
        # layout and the eliminated span is removed wholesale)
        self.ret_blocks = []  # (start_in_retained, n_blocks, t) in group order
        self._ret_start = {}  # group index -> start in retained coords
        pos = 0
        self._ret_group_order = []
        for gi, g in enumerate(program.groups):
            if gi == self.elim_group:
                continue
            self.ret_blocks.append((pos, g.num_blocks, g.tangent_size))
            self._ret_start[gi] = pos
            self._ret_group_order.append(gi)
            pos += g.num_blocks * g.tangent_size

        # per-batch slot metadata: which slot is eliminated (if any), and
        # the (col_offset, tangent_size, group, slot) of retained slots
        self.batch_info = []
        e_batches = []
        for bi, b in enumerate(program.batches):
            idx_pad = evaluator._batch_idx_np[bi]
            tidx_pad = evaluator._batch_tidx_np[bi]
            e_slots = [
                s for s, gi in enumerate(b.slot_groups) if gi == self.elim_group
            ]
            if len(e_slots) > 1:
                raise NotImplementedError(
                    "residual blocks touching >1 eliminated block are not "
                    "supported (mirror of the reference's one-E-block-per-row "
                    "requirement)"
                )
            cols = []
            c = 0
            ret_slots = []
            e_col = None
            for s, (gi, t) in enumerate(zip(b.slot_groups, b.tangent_sizes)):
                if gi == self.elim_group:
                    e_col = (c, t)
                else:
                    ret_slots.append((s, gi, c, t))
                c += t
            pidx = (
                jnp.asarray(np.asarray(idx_pad[e_slots[0]]), dtype=jnp.int32)
                if e_slots
                else None
            )
            # also keep retained-coordinate index map (B, Tf) for the
            # generic dense-S fallback path
            col_group = np.concatenate(
                [np.full(t, gi) for gi, t in zip(b.slot_groups, b.tangent_sizes)]
            ).astype(np.int64)
            all_cols = np.arange(b.block_tangent_size)
            f_cols = all_cols[col_group != self.elim_group]
            fidx = glob2ret[tidx_pad[:, f_cols]]
            assert (fidx >= 0).all()
            info = dict(
                ret_slots=ret_slots,
                e_col=e_col,
                pidx=pidx,
                f_cols=jnp.asarray(f_cols, dtype=jnp.int32),
                fidx=jnp.asarray(fidx),
                tf=len(f_cols),
            )
            self.batch_info.append(info)
            if e_slots and ret_slots:
                e_batches.append(bi)

        # any number of eliminated-x-retained batch signatures is supported
        # (reference: schur_eliminator_impl.h handles arbitrary E/F block
        # mixes); e_batch is kept only as the dense-W fast-path candidate
        self.e_batches = e_batches
        self.e_batch = e_batches[0] if len(e_batches) == 1 else None

        # Camera-padded layout for huge observation batches (the reference
        # keeps both row-major E blocks and camera-chunked F access —
        # schur_eliminator_impl.h's chunk structure; this is its batched
        # counterpart): observations arrive point-sorted, so the POINT-side
        # reductions read sequentially, but the CAMERA-side work of every
        # PCG matvec would gather 5M rows in random order at ~36B
        # granularity. Instead, rows are placed into a dense (n_cams, K) padded
        # layout (K = max observations per camera; gaps are zero rows that
        # contribute nothing) ONCE per damped solve, after which every
        # camera-side reduction is a pure ``reshape(n_cams, K, D).sum(1)``
        # and the per-row camera-vector reads are broadcasts — zero gathers
        # inside the matvec. Applied when padding waste is bounded; the
        # generic plan path remains the fallback.
        self.sorted_info = {}
        for bi in e_batches:
            info = self.batch_info[bi]
            b = program.batches[bi]
            if len(info["ret_slots"]) != 1:
                continue
            s, gi, c, t = info["ret_slots"][0]
            idx_np = evaluator._batch_idx_np[bi][s].astype(np.int64)
            B = len(idx_np)
            # only the first num_blocks rows are real; evaluator padding
            # repeats row 0's indices (chunk/shard quanta) and would
            # otherwise explode block 0's apparent count
            B_real = b.num_blocks
            if B_real < sort_threshold:
                continue
            nc = program.groups[gi].num_blocks
            e_slot = b.slot_groups.index(self.elim_group)
            pidx_np = evaluator._batch_idx_np[bi][e_slot].astype(np.int64)
            if evaluator.mesh is None:
                counts = np.bincount(idx_np[:B_real], minlength=nc)
                K = int(counts.max())
                if nc * K > pad_waste * B_real:  # skewed: waste too high
                    continue
                src = _cam_padded_src(idx_np, nc, K, n_valid=B_real,
                                      sentinel=B)
                pidx_pad = np.concatenate([pidx_np, [0]])[src]
                self.sorted_info[bi] = dict(
                    kind="local",
                    src=jnp.asarray(src.astype(np.int32)),
                    pidx_pad=jnp.asarray(pidx_pad.astype(np.int32)),
                    K=K,
                    nc=nc,
                    placed=self._build_placed_consts(bi, src, B_real, B),
                )
            else:
                # per-shard padded layout: rows are split contiguously over
                # the mesh (same convention as build_sharded_reduce_plan);
                # each shard builds a (nc, K) grid of ITS rows, camera
                # reductions become per-shard reshape+sum combined by one
                # psum — the sharded path keeps the gather-free matvec.
                ns = evaluator._n_shards
                bs = B // ns
                parts = idx_np.reshape(ns, bs)
                # per-shard real-row counts (padding occupies the tail of
                # the LAST shards only — rows are contiguous)
                valid = np.clip(B_real - bs * np.arange(ns), 0, bs)
                K = int(
                    max(
                        np.bincount(p[: valid[i]], minlength=nc).max()
                        if valid[i] else 0
                        for i, p in enumerate(parts)
                    )
                )
                if K == 0 or ns * nc * K > pad_waste * B_real:
                    continue
                src = np.stack(
                    [
                        _cam_padded_src(p, nc, K, n_valid=int(valid[i]),
                                        sentinel=bs)
                        for i, p in enumerate(parts)
                    ]
                )  # (ns, nc*K), sentinel = bs
                pparts = pidx_np.reshape(ns, bs)
                pidx_pad = np.stack(
                    [
                        np.concatenate([pp, [0]])[sr]
                        for pp, sr in zip(pparts, src)
                    ]
                )
                sh = evaluator._obs_sharding
                self.sorted_info[bi] = dict(
                    kind="sharded",
                    src=jax.device_put(
                        jnp.asarray(src.astype(np.int32)), sh(2)
                    ),
                    pidx_pad=jax.device_put(
                        jnp.asarray(pidx_pad.astype(np.int32)), sh(2)
                    ),
                    K=K,
                    nc=nc,
                    bs=bs,
                )

        # Dense-W fast path for DENSE_SCHUR: viable when the E-batch couples
        # one point block to ONE retained block per row (the BA case) and
        # the dense per-point W = (n_pts, n_cams, f, e) fits memory.
        self.dense_w = None
        if self.e_batch is not None and not iterative:
            bi = self.e_batch
            b = program.batches[bi]
            info = self.batch_info[bi]
            if len(b.slot_groups) == 2 and len(info["ret_slots"]) == 1:
                s, gi, c, f_size = info["ret_slots"][0]
                gr = program.groups[gi]
                n_cams = gr.num_blocks
                w_bytes = self.num_points * n_cams * f_size * self.e_size * 4
                if len(self.ret_blocks) == 1 and w_bytes <= 2 << 30:
                    idx_pad = evaluator._batch_idx_np[bi]
                    e_slot = b.slot_groups.index(self.elim_group)
                    cam_idx = idx_pad[s].astype(np.int64)
                    pidx_np = idx_pad[e_slot].astype(np.int64)
                    lin_idx = pidx_np * n_cams + cam_idx
                    # each (point, camera) cell receives at most a few
                    # observations; a planned gather builds W with zero
                    # scatters (force gather: the waste heuristic compares
                    # against B, but here the large output IS the result)
                    w_plan = build_reduce_plan(
                        lin_idx,
                        self.num_points * n_cams,
                        onehot_limit=0,
                        gather_waste=float("inf"),
                    )
                    self.dense_w = dict(
                        n_cams=n_cams,
                        f_size=f_size,
                        w_plan=w_plan,
                    )

        # Explicit-S assembly plan (reference: schur_complement_solver.cc /
        # use_explicit_schur_complement): scatter-free pair-product
        # assembly of the dense reduced camera system. Viable for the
        # single-retained-slot BA structure when S fits memory; makes
        # DENSE_SCHUR practical at venice scale (S 16k^2 = 1 GB) where the
        # dense-W path (192 TB) and column probing (N_f matvecs) cannot.
        self.explicit_plan = None
        # why the explicit plan was rejected, when one was wanted (surfaced
        # as Summary.schur_complement_path: the fallback to implicit
        # matvecs can be much slower, and must not be silent)
        self.explicit_reject_reason = None
        _want_explicit = not iterative or use_explicit
        if (
            self.e_batch is not None
            and len(self.ret_blocks) == 1
            and len(self.batch_info[self.e_batch]["ret_slots"]) == 1
            and _want_explicit
        ):
            bi = self.e_batch
            b = program.batches[bi]
            info = self.batch_info[bi]
            s, gi, c, f_size = info["ret_slots"][0]
            nc = program.groups[gi].num_blocks
            s_bytes = (nc * f_size) ** 2 * 4
            if s_bytes <= explicit_s_limit_bytes:
                from skeres.core.explicit_schur import (
                    ExplicitSchurPlan,
                )

                e_slot = b.slot_groups.index(self.elim_group)
                try:
                    # under a mesh the plan shards itself: per-shard pair
                    # products + hierarchical partial sums + ONE psum over
                    # the unique-pair table (SURVEY §3.8 "psum(S)")
                    self.explicit_plan = ExplicitSchurPlan(
                        cam_idx=evaluator._batch_idx_np[bi][s].astype(
                            np.int64
                        ),
                        pt_idx=evaluator._batch_idx_np[bi][e_slot].astype(
                            np.int64
                        ),
                        num_cameras=nc,
                        num_points=self.num_points,
                        f_size=f_size,
                        e_size=self.e_size,
                        n_valid=b.num_blocks,
                        pad_waste=pad_waste,
                        pair_cap=pair_cap,
                        mesh=evaluator.mesh,
                        n_shards=evaluator._n_shards,
                    )
                except ValueError as exc:  # point-degree skew too high
                    self.explicit_plan = None
                    self.explicit_reject_reason = str(exc)
            else:
                self.explicit_reject_reason = (
                    f"S too large: {s_bytes >> 20} MiB > "
                    f"explicit_schur_limit_bytes "
                    f"({explicit_s_limit_bytes >> 20} MiB)"
                )
        elif _want_explicit:
            self.explicit_reject_reason = (
                "structure: the explicit plan needs one eliminated batch "
                "coupling one retained block group via a single slot"
            )
        self.use_explicit = use_explicit and self.explicit_plan is not None

        # CLUSTER_JACOBI preconditioner plan (reference:
        # cluster_jacobi_preconditioner.cc via visibility clustering; here
        # clusters are contiguous camera-index ranges — capture order
        # implies view locality in BAL data — because canonical-views
        # clustering is a serial CPU graph algorithm with no batched
        # device mapping).
        # Unlike the explicit-S plan this has NO size cap: the
        # intra-cluster unique-pair table stays tiny however many cameras,
        # which is exactly the beyond-explicit-S (>~23k retained coords)
        # regime it exists for.
        self.cluster_plan = None
        if (
            iterative
            and preconditioner
            in (
                PreconditionerType.CLUSTER_JACOBI,
                PreconditionerType.CLUSTER_TRIDIAGONAL,
            )
            and self.e_batch is not None
            and len(self.ret_blocks) == 1
            and len(self.batch_info[self.e_batch]["ret_slots"]) == 1
        ):
            bi = self.e_batch
            b = program.batches[bi]
            info = self.batch_info[bi]
            s, gi, c, f_size = info["ret_slots"][0]
            nc = program.groups[gi].num_blocks
            from skeres.core.explicit_schur import ExplicitSchurPlan

            e_slot = b.slot_groups.index(self.elim_group)
            try:
                self.cluster_plan = ExplicitSchurPlan(
                    cam_idx=evaluator._batch_idx_np[bi][s].astype(np.int64),
                    pt_idx=evaluator._batch_idx_np[bi][e_slot].astype(
                        np.int64
                    ),
                    num_cameras=nc,
                    num_points=self.num_points,
                    f_size=f_size,
                    e_size=self.e_size,
                    n_valid=b.num_blocks,
                    pad_waste=pad_waste,
                    pair_cap=pair_cap,
                    mesh=evaluator.mesh,
                    n_shards=evaluator._n_shards,
                    cluster_of=np.arange(nc) // max(cluster_size, 1),
                    cluster_band=(
                        preconditioner
                        == PreconditionerType.CLUSTER_TRIDIAGONAL
                    ),
                )
            except ValueError:
                self.cluster_plan = None
            if self.cluster_plan is not None:
                # host-side inverse slot map for the batched apply
                cam_of = self.cluster_plan.cluster_cam_of
                ncl, cs = cam_of.shape
                pos_of_cam = np.zeros(nc, dtype=np.int64)
                flat = cam_of.reshape(-1)
                pos_of_cam[flat[flat >= 0]] = np.nonzero(flat >= 0)[0]
                self._cluster_pos_of_cam = jnp.asarray(
                    pos_of_cam.astype(np.int32)
                )
                # diag-block gather: slot -> camera (sentinel nc = pad);
                # pad slots read an identity block so the factor stays PD
                self._cluster_slot_cam = jnp.asarray(
                    np.where(flat >= 0, flat, nc).astype(np.int32)
                )

        self._ret_index_dev = jnp.asarray(self.ret_index)

    # -- solver_data / scaling ---------------------------------------------------

    def solver_data(self, blocks: Sequence[BatchBlocks]):
        """Keep corrected per-batch (r, jac) resident; splitting into E/F
        happens inside the solve (pure index ops, fused by XLA)."""
        return tuple((b.r, b.jac) for b in blocks)

    def scale_data(self, data, scale):
        out = []
        for bi, (r, jac) in enumerate(data):
            # per-slot row gathers, NOT scale[tidx] — the (B, T) tangent
            # index form is an element gather (T x the rows; row-limited)
            out.append((r, jac * self.ev.v_rows(bi, scale)[:, None, :]))
        return tuple(out)

    # -- retained-space helpers ----------------------------------------------------

    def _ret_view(self, v_f, gi):
        """Slice of the retained vector belonging to group gi, as
        (n_blocks, t)."""
        start = self._ret_start[gi]
        g = self.ev.program.groups[gi]
        return jax.lax.dynamic_slice_in_dim(
            v_f, start, g.num_blocks * g.tangent_size
        ).reshape(g.num_blocks, g.tangent_size)

    def _ret_assemble(self, per_group):
        """per_group: dict gi -> (n_blocks, t) -> retained vector (N_f,)."""
        parts = []
        for gi in self._ret_group_order:
            parts.append(per_group[gi].reshape(-1))
        return jnp.concatenate(parts) if len(parts) > 1 else parts[0]

    def _zero_ret_accs(self, dtype):
        return {
            gi: jnp.zeros(
                (
                    self.ev.program.groups[gi].num_blocks,
                    self.ev.program.groups[gi].tangent_size,
                ),
                dtype=dtype,
            )
            for gi in self._ret_group_order
        }

    def _split_E(self, bi, jac):
        info = self.batch_info[bi]
        if info["e_col"] is None:
            return None
        c, t = info["e_col"]
        return jac[:, :, c : c + t]

    def _gather_ge(self, g):
        return g[self.elim_offset : self.elim_offset + self.elim_span].reshape(
            self.num_points, self.e_size
        )

    def _cam_conj(self, asm, bi):
        """Conjugation factors for consuming an UNSCALED padded copy in
        scaled space (prepare() reuses gradient_and_diag_padded's raw
        placement; the Jacobi scaling is diagonal so J_s = J S factors
        out of every padded product): (s_ret (N_f,), s_f (nc, t),
        s_e (n_pts, e)). None when the copy is pre-scaled."""
        scale = asm.get("cam_scale")
        if scale is None:
            return None
        info = self.batch_info[bi]
        s, gi, c, t = info["ret_slots"][0]
        s_ret = scale[self._ret_index_dev]
        return s_ret, self._ret_view(s_ret, gi), self._gather_ge(scale)

    # -- shared assembly pieces ---------------------------------------------------

    def gradient_and_diag_padded(self, blocks, state=None):
        """g = J^T r and diag(J^T J) with the camera-slot reductions ridden
        on the camera-padded layout (reshape+K-sum instead of the
        hierarchical gather-plan), plus the UNSCALED padded Jacobian copies for
        :meth:`prepare` to reuse.

        With ``state`` given and placed eval constants available
        (opt-in ``placed_eval``; local layout, unchunked), the padded
        copy comes from a SECOND row evaluation directly in placed order
        (:meth:`_placed_eval`), see :meth:`_build_placed_consts`. Default: one placement gather
        places (jac | r) together (the gather is per-row latency-bound,
        so placing the narrow residual separately would cost nearly as
        much).

        Returns (g, diag, cam_raw) where cam_raw maps batch index -> the
        placed flat copy. Point-slot and non-padded-batch reductions take
        the evaluator's generic planned path unchanged.
        """
        ev = self.ev
        program = ev.program
        accs = [
            jnp.zeros((gr.num_blocks, 2 * gr.tangent_size), dtype=ev.dtype)
            for gr in program.groups
        ]
        cam_raw = {}
        padded_slot = {}
        for bi in self.sorted_info:
            info = self.batch_info[bi]
            s, gi, c, t = info["ret_slots"][0]
            b = blocks[bi]
            bsz, m, T = b.jac.shape
            if state is not None and self.sorted_info[bi].get("placed"):
                cam_raw[bi], r_pad = self._placed_eval(bi, state)
            else:
                placed = self._place_rows(
                    bi,
                    jnp.concatenate(
                        [b.jac.reshape(bsz, m * T), b.r], axis=1
                    ),
                )
                cam_raw[bi] = placed[..., : m * T]
                r_pad = placed[..., m * T :]
            padded_slot[bi] = s

            def row_fn(jac_cam, pidx_pad, rp, c=c, t=t):
                F = jac_cam[:, :, c : c + t]
                gb = vpu_einsum("bmf,bm->bf", F, rp)
                db = jnp.sum(F * F, axis=1)
                return jnp.concatenate([gb, db], axis=1)

            accs[gi] = accs[gi] + self._cam_reduce(
                bi, cam_raw[bi], (), row_fn, (2 * t,), row_ops=(r_pad,)
            )
        ete0_raw = None
        for bi, b in enumerate(blocks):
            batch = program.batches[bi]
            e_col = self.batch_info[bi]["e_col"]
            for s, gi in enumerate(batch.slot_groups):
                if padded_slot.get(bi) == s:
                    continue
                c, t = ev._slot_cols[bi][s]
                cols = b.jac[:, :, c : c + t]
                gb = vpu_einsum("bmi,bm->bi", cols, b.r)
                if e_col == (c, t):
                    # E slot: ride the UNDAMPED raw E^T E on the same
                    # reduction pass (flat 2D (B, e*e) per-m form — see
                    # _explicit_a_flat). prepare() then conjugates with the
                    # Jacobi scale instead of re-reading the 5M-row
                    # Jacobian: ete0_scaled = s_e (x) s_e * ete0_raw. The
                    # slot diag is exactly ete_flat's diagonal.
                    e = t
                    # per-column slice + concat (NOT repeat/tile, which
                    # lowers via a 3D broadcast — see _explicit_a_flat)
                    pieces = []
                    for i in range(e):
                        piece = None
                        for m in range(cols.shape[1]):
                            term = cols[:, m, i : i + 1] * cols[:, m, :]
                            piece = term if piece is None else piece + term
                        pieces.append(piece)
                    ete_flat = jnp.concatenate(pieces, axis=1)
                    red = ev.slot_reduce(
                        bi, s, jnp.concatenate([gb, ete_flat], axis=1)
                    )
                    gb_r, ete_r = red[:, :e], red[:, e:]
                    diag_cols = tuple(i * e + i for i in range(e))
                    db_r = ete_r[:, diag_cols]
                    accs[gi] = accs[gi] + jnp.concatenate(
                        [gb_r, db_r], axis=1
                    )
                    ete0_raw = (
                        ete_r if ete0_raw is None else ete0_raw + ete_r
                    )
                    continue
                db = jnp.sum(cols * cols, axis=1)
                vals = jnp.concatenate([gb, db], axis=1)
                accs[gi] = accs[gi] + ev.slot_reduce(bi, s, vals)
        if ete0_raw is not None:
            # key -1 (an int, so the pytree dict stays sortable; batch
            # indices are >= 0): the raw undamped E^T E rode the reduction
            # pass — prepare() recovers the scaled ete0 by conjugation
            cam_raw[-1] = ete0_raw
        g = ev.assemble_tangent([a[:, : a.shape[1] // 2] for a in accs])
        diag = ev.assemble_tangent([a[:, a.shape[1] // 2 :] for a in accs])
        return g, diag, cam_raw

    def prepare(self, data, cam_raw=None, scale=None):
        """Per-LINEARIZATION prep over (scaled) solver data — everything
        that does not depend on the damping mu: the E split, the undamped
        per-point ``E^T E``, and the camera-padded Jacobian copies. The LM
        strategy re-solves with a new mu after every rejected step WITHOUT
        re-linearizing; hoisting this out of the damped solve removes a
        ~1 GB-traffic rebuild (padded-copy gather + ete reduction, venice
        scale) from every such re-solve.

        ``cam_raw``/``scale``: when :meth:`gradient_and_diag_padded`
        already placed the UNSCALED padded copies, pass them with the
        Jacobi scale — scaling in padded space (broadcast + e-floats/row
        gather) replaces the second full placement gather. When it also
        rode the raw undamped ``E^T E`` on its reduction pass
        (``cam_raw[-1]``), the scaled ``ete0`` is recovered by
        conjugation with the per-point scale rows — no second pass over
        the observation-sized Jacobian at all."""
        e = self.e_size
        dtype = data[0][1].dtype
        ete0_raw = cam_raw.get(-1) if cam_raw is not None else None
        if ete0_raw is not None and scale is not None:
            s_e = self._gather_ge(scale)
            ete0 = (
                ete0_raw.reshape(self.num_points, e, e)
                * s_e[:, :, None]
                * s_e[:, None, :]
            )
        else:
            ete0_raw = None
            ete0 = jnp.zeros((self.num_points, e, e), dtype=dtype)
        per_batch = []
        for bi, (r, jac) in enumerate(data):
            E = self._split_E(bi, jac)
            if E is not None and ete0_raw is None:
                outer = vpu_einsum("bme,bmf->bef", E, E).reshape(-1, e * e)
                s_e = self.ev.program.batches[bi].slot_groups.index(
                    self.elim_group
                )
                ete0 = ete0 + self.ev.slot_reduce(bi, s_e, outer).reshape(
                    self.num_points, e, e
                )
            per_batch.append((r, jac, E))
        cam = {}
        cam_scale = None
        for bi in self.sorted_info:
            if cam_raw is not None and scale is not None and bi in cam_raw:
                # reuse the UNSCALED copies placed by
                # gradient_and_diag_padded; consumers conjugate with the
                # small per-camera/per-point scale vectors instead of a
                # full scaling pass over the ~0.5 GB copy (exact: the
                # Jacobi scaling is diagonal, so J_s = J S factors out of
                # every padded product)
                cam[bi] = cam_raw[bi]
                cam_scale = scale
            else:
                cam[bi] = self._sorted_cam_jac(bi, per_batch[bi][1])
        prep = dict(
            per_batch=per_batch, cam=cam, ete0=ete0, cam_scale=cam_scale
        )
        gplan = self.explicit_plan or self.cluster_plan
        if gplan is not None and self.hoist_explicit_grid:
            # hoisted mu-independent half of explicit-S assembly: the flat
            # A = F^T E rows and their point grid(s). Rejected-step
            # re-solves (new mu, same linearization) then pay only the
            # cinv-dependent pair contraction. The grid layout depends
            # only on the row structure, so the explicit-S and
            # CLUSTER_JACOBI plans share one grid.
            if getattr(gplan, "grid_is_reshape", False) and gplan.mesh is None:
                # uniform point-grouped rows: build the (n_pts, kp*f*e)
                # grid rows DIRECTLY with k-strided slices — one fused
                # write of the final layout instead of materializing the
                # (B, f*e) flat rows and relayouting them into grid shape
                prep["explicit_grid"] = {
                    "grid": self._explicit_a_grid(
                        per_batch, gplan.kp, gplan.np_ * gplan.kp
                    )
                }
            else:
                prep["explicit_grid"] = gplan.build_grid(
                    self._explicit_a_flat(per_batch)
                )
        return prep

    def _explicit_a_flat(self, per_batch):
        """Fully-2D construction of the flat per-row A = F^T E rows:
        a_flat[b, f*e + g] = sum_m F[b,m,f] E[b,m,g]. The einsum form
        produces a (B, f, e) value that XLA may materialize with a padded
        layout for the tiny trailing dims when it declines to fuse the
        trailing reshape, and ``jnp.repeat``/``tile`` lower to a 3D
        broadcast + reshape with the same risk; per-column slicing + one
        concat never creates a 3D value at all."""
        bi = self.e_batch
        info = self.batch_info[bi]
        _, jac, _ = per_batch[bi]
        s, gi, c, t = info["ret_slots"][0]
        ec, et = info["e_col"]
        m_res = jac.shape[1]
        pieces = []
        for i in range(t):
            piece = None
            for m in range(m_res):
                term = jac[:, m, c + i : c + i + 1] * jac[:, m, ec : ec + et]
                piece = term if piece is None else piece + term
            pieces.append(piece)  # (B, e)
        return jnp.concatenate(pieces, axis=1)

    def _explicit_a_grid(self, per_batch, kp, n_rows):
        """Direct construction of the point-grid A rows
        (n_pts, kp * f * e) when the grid is a pure reshape of row order
        (uniform kp observations per point, point-grouped rows): the k-th
        observation rows of every point are the k-strided row slice of
        the batch, so each (k, i) column block is one fused
        slice-multiply — the final grid layout is written once, with no
        (B, f*e) intermediate or relayout. ``n_rows`` = n_pts * kp slices
        off any evaluator pad tail. Values identical to
        ``build_grid(_explicit_a_flat(...))``."""
        bi = self.e_batch
        info = self.batch_info[bi]
        _, jac, _ = per_batch[bi]
        jac = jac[:n_rows]
        s, gi, c, t = info["ret_slots"][0]
        ec, et = info["e_col"]
        m_res = jac.shape[1]
        pieces = []
        for k in range(kp):
            jk = jac[k::kp]  # (n_pts, m, T): point p's k-th observation
            for i in range(t):
                piece = None
                for m in range(m_res):
                    term = jk[:, m, c + i : c + i + 1] * jk[:, m, ec : ec + et]
                    piece = term if piece is None else piece + term
                pieces.append(piece)  # (n_pts, e)
        return jnp.concatenate(pieces, axis=1)

    def _assemble(self, data, g, d):
        """Per-mu elimination state: damped C^-1 and the rhs pieces.

        ``data`` is either a ``prepare()`` dict (the minimizer's hoisted
        path) or a raw solver-data tuple (auto-prepared, for direct
        callers/tests).

        d: (N,) clamped damping diagonal (already includes mu).
        Returns dict of device arrays.
        """
        prep = data if isinstance(data, dict) else self.prepare(data)
        g_f = g[self._ret_index_dev]
        d_f = d[self._ret_index_dev]
        g_e = self._gather_ge(g)
        d_e = self._gather_ge(d)

        ete = prep["ete0"] + jax.vmap(jnp.diag)(d_e)
        # closed-form batched SPD inverse (3x3 cofactors for BAL)
        cinv = batched_spd_inverse(ete)
        return dict(
            per_batch=prep["per_batch"],
            cinv=cinv,
            g_f=g_f,
            d_f=d_f,
            g_e=g_e,
            cam=prep["cam"],
            cam_scale=prep.get("cam_scale"),
            explicit_grid=prep.get("explicit_grid"),
        )

    def _sorted_cam_jac(self, bi, jac):
        """Camera-padded copy of a batch Jacobian, stored FLAT:
        (nc*K, m*T) locally, or (ns, nc*K, m*T) row-sharded under a mesh —
        built inside shard_map so the placement gather stays shard-local
        (no allgather). Consumers reshape to (rows, m, T) at the use site
        (:meth:`_cam_reduce`).

        Why flat: gathering (rows, m, T) directly lets XLA pick a padded
        3D layout for the result (tiny trailing dims), which turns a
        row-limited gather into a relayout. The flat form is also the only
        shape ever placed in loop-carried state (the device loop's
        lax.while_loop)."""
        b, m, t = jac.shape
        return self._place_rows(bi, jac.reshape(b, m * t))

    def _build_placed_consts(self, bi, src_np, B_real, B_pad):
        """Permuted per-row eval constants in the camera-padded order,
        built host-side ONCE: with them the padded (jac|r) copy is
        produced by a SECOND row evaluation directly in placed order
        (dual-eval, :meth:`_placed_eval`) instead of the 5M-row placement
        gather. The camera-ordered rows gather their point parameters in
        random order, like the row placement it replaces, and the extra
        row evaluation costs on top; its speed on the GPU is not
        measured. Off by default (``placed_eval`` ctor arg
        / SKERES_PLACED_EVAL=1); retained for problems whose eliminated
        state fits cache. Sentinel slots replicate row 0's inputs with
        weight 0 (the eval zeroes their r/jac rows by weight, so they
        contribute nothing — identical semantics to the zero rows the
        placement gather produced). Only built for unchunked batches.
        Returns (data_p, idx_p, mask_p, weight_p) or None."""
        if not self.placed_eval:
            return None
        ev = self.ev
        program = ev.program
        b = program.batches[bi]
        if ev._chunk_count(bi) != 1:
            return None
        dtype = ev.dtype

        def permute(a, cast_float):
            a = np.asarray(a)
            if len(a) < B_pad:  # evaluator pad rows replicate row 0
                a = np.concatenate(
                    [a, np.repeat(a[:1], B_pad - len(a), axis=0)], axis=0
                )
            ext = np.concatenate([a, a[:1]], axis=0)  # sentinel -> row 0
            out = ext[src_np]
            if cast_float and np.issubdtype(out.dtype, np.floating):
                out = out.astype(dtype)
            return out

        data_p = (
            None
            if b.data is None
            else jax.tree_util.tree_map(
                lambda a: jnp.asarray(permute(a, True)), b.data
            )
        )
        idx_p = tuple(
            jnp.asarray(permute(ix, False)) for ix in ev._batch_idx_np[bi]
        )
        weight_p = jnp.asarray(
            (src_np < B_real).astype(np.float32), dtype=dtype
        )
        if bool(np.all(program.free_mask)):
            # all coordinates free: a broadcastable ones row replaces the
            # (rows, T) placed mask copy (saves ~250 MB at venice scale)
            mask_p = jnp.ones((1, b.block_tangent_size), dtype=dtype)
        else:
            mask_p = jnp.asarray(
                permute(program.free_mask[b.tangent_index], True)
            )
        return (data_p, idx_p, mask_p, weight_p)

    def _placed_eval(self, bi, state):
        """Dual-eval: residual+Jacobian rows evaluated DIRECTLY in the
        camera-padded order using the permuted constants of
        :meth:`_build_placed_consts`. Returns (flat (rows, m*T) Jacobian
        copy, r_pad (rows, m)) — the same values the placement gather
        would place, produced by sequential writes."""
        sinfo = self.sorted_info[bi]
        data_p, idx_p, mask_p, weight_p = sinfo["placed"]
        batch = self.ev.program.batches[bi]
        _, r, jac = self.ev._rows_residuals_and_jacobian(
            batch, data_p, idx_p, mask_p, weight_p, state
        )
        rows, m, T = jac.shape
        return jac.reshape(rows, m * T), r

    def _place_rows(self, bi, flat):
        """Place (B, W) per-observation rows into the camera-padded order:
        (nc*K, W) locally, (ns, nc*K, W) row-sharded under a mesh (the
        placement gather stays shard-local inside shard_map). Sentinel
        slots become zero rows."""
        sinfo = self.sorted_info[bi]
        w = flat.shape[-1]
        if sinfo["kind"] == "local":
            zero_row = jnp.zeros((1, w), flat.dtype)
            return jnp.concatenate([flat, zero_row])[sinfo["src"]]
        from jax.sharding import PartitionSpec as P

        mesh = self.ev.mesh
        axis = mesh.axis_names[0]

        def body(flat_l, src_l):
            z = jnp.zeros((1, w), flat_l.dtype)
            return jnp.concatenate([flat_l[0], z])[src_l[0]][None]

        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=P(axis),
        )(flat.reshape(sinfo["src"].shape[0], -1, w), sinfo["src"])

    def _cam_reduce(self, bi, cam, rep, row_fn, out_tail, row_ops=()):
        """Camera-side reduction over a padded batch: ``row_fn(jac_cam,
        pidx_pad, *rep, *row_ops) -> (nc*K,) + out_tail`` per-padded-row
        values, summed over each camera's K slots -> ``(nc,) + out_tail``.
        ``rep`` are replicated operands (retained/point vectors);
        ``row_ops`` are padded-row-aligned operands (e.g. a placed
        residual copy), sharded like ``cam`` under a mesh. Under a mesh
        the per-shard partial sums are combined by one psum.

        ``cam`` arrives FLAT (rows, m*T) — see :meth:`_sorted_cam_jac` —
        and is reshaped to (rows, m, T) here, inside the consuming
        program, where XLA fuses it."""
        sinfo = self.sorted_info[bi]
        nc, K = sinfo["nc"], sinfo["K"]
        m = self.ev.program.batches[bi].residual_dim
        if sinfo["kind"] == "local":
            val = row_fn(cam.reshape(cam.shape[0], m, -1),
                         sinfo["pidx_pad"], *rep, *row_ops)
            return val.reshape((nc, K) + out_tail).sum(axis=1)
        from jax.sharding import PartitionSpec as P

        mesh = self.ev.mesh
        axis = mesh.axis_names[0]

        def body(cam_l, pidx_l, *rest):
            rep_l = rest[: len(rep)]
            row_l = tuple(r[0] for r in rest[len(rep):])
            cam3 = cam_l[0].reshape(cam_l.shape[1], m, -1)
            val = row_fn(cam3, pidx_l[0], *rep_l, *row_l)
            return jax.lax.psum(
                val.reshape((nc, K) + out_tail).sum(axis=1), axis
            )

        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis), P(axis))
            + (P(),) * len(rep)
            + (P(axis),) * len(row_ops),
            out_specs=P(),
        )(cam, sinfo["pidx_pad"], *rep, *row_ops)

    def _w_apply(self, asm, v_e):
        """W v_e (points -> cameras): (n_pt, e) -> (N_f,)."""
        accs = self._zero_ret_accs(v_e.dtype)
        for bi, (r, jac, E) in enumerate(asm["per_batch"]):
            info = self.batch_info[bi]
            if E is None or not info["ret_slots"]:
                continue
            if bi in self.sorted_info:
                ec, et = info["e_col"]
                s, gi, c, t = info["ret_slots"][0]

                def row_fn(jac_cam, pidx_pad, ve, ec=ec, et=et, c=c, t=t):
                    E_cam = jac_cam[:, :, ec : ec + et]
                    Ev = vpu_einsum("bme,be->bm", E_cam, ve[pidx_pad])
                    return vpu_einsum(
                        "bmf,bm->bf", jac_cam[:, :, c : c + t], Ev
                    )

                conj = self._cam_conj(asm, bi)
                ve_in = v_e if conj is None else v_e * conj[2]
                red = self._cam_reduce(
                    bi, asm["cam"][bi], (ve_in,), row_fn, (t,)
                )
                if conj is not None:
                    red = red * conj[1]
                accs[gi] = accs[gi] + red
                continue
            Ev = vpu_einsum("bme,be->bm", E, v_e[info["pidx"]])
            for s, gi, c, t in info["ret_slots"]:
                Fs = jac[:, :, c : c + t]
                val = vpu_einsum("bmf,bm->bf", Fs, Ev)
                accs[gi] = accs[gi] + self.ev.slot_reduce(bi, s, val)
        return self._ret_assemble(accs)

    def _wt_apply(self, asm, v_f):
        """W^T v_f (cameras -> points): (N_f,) -> (n_pt, e)."""
        out = jnp.zeros((self.num_points, self.e_size), dtype=v_f.dtype)
        for bi, (r, jac, E) in enumerate(asm["per_batch"]):
            info = self.batch_info[bi]
            if E is None or not info["ret_slots"]:
                continue
            _, idx_pad, _, _, _ = self.ev._batch_const[bi]
            Fv = jnp.zeros((jac.shape[0], jac.shape[1]), dtype=v_f.dtype)
            for s, gi, c, t in info["ret_slots"]:
                Fs = jac[:, :, c : c + t]
                vs = self._ret_view(v_f, gi)[idx_pad[s]]  # (B, t)
                Fv = Fv + vpu_einsum("bmf,bf->bm", Fs, vs)
            ef_v = vpu_einsum("bme,bm->be", E, Fv)
            s_e = self.ev.program.batches[bi].slot_groups.index(self.elim_group)
            out = out + self.ev.slot_reduce(bi, s_e, ef_v)
        return out

    def _ftf_apply(self, asm, v_f):
        """(F^T F + D_f) v."""
        accs = self._zero_ret_accs(v_f.dtype)
        for bi, (r, jac, E) in enumerate(asm["per_batch"]):
            info = self.batch_info[bi]
            if not info["ret_slots"]:
                continue
            if bi in self.sorted_info:
                sinfo = self.sorted_info[bi]
                s, gi, c, t = info["ret_slots"][0]
                nc, K = sinfo["nc"], sinfo["K"]

                def row_fn(jac_cam, pidx_pad, vf, gi=gi, c=c, t=t, nc=nc, K=K):
                    Fs = jac_cam[:, :, c : c + t]
                    # per-row camera vector as a broadcast, not a gather
                    vs = jnp.broadcast_to(
                        self._ret_view(vf, gi)[:, None, :], (nc, K, t)
                    ).reshape(nc * K, t)
                    Fv = vpu_einsum("bmf,bf->bm", Fs, vs)
                    return vpu_einsum("bmf,bm->bf", Fs, Fv)

                conj = self._cam_conj(asm, bi)
                v_in = v_f if conj is None else v_f * conj[0]
                red = self._cam_reduce(
                    bi, asm["cam"][bi], (v_in,), row_fn, (t,)
                )
                if conj is not None:
                    red = red * conj[1]
                accs[gi] = accs[gi] + red
                continue
            _, idx_pad, _, _, _ = self.ev._batch_const[bi]
            Fv = jnp.zeros((jac.shape[0], jac.shape[1]), dtype=v_f.dtype)
            for s, gi, c, t in info["ret_slots"]:
                Fs = jac[:, :, c : c + t]
                vs = self._ret_view(v_f, gi)[idx_pad[s]]
                Fv = Fv + vpu_einsum("bmf,bf->bm", Fs, vs)
            for s, gi, c, t in info["ret_slots"]:
                Fs = jac[:, :, c : c + t]
                accs[gi] = accs[gi] + self.ev.slot_reduce(
                    bi, s, vpu_einsum("bmf,bm->bf", Fs, Fv)
                )
        return asm["d_f"] * v_f + self._ret_assemble(accs)

    def _schur_rhs(self, asm):
        """b_f - W C^{-1} b_e with b = -g."""
        cinv_be = vpu_einsum("pef,pf->pe", asm["cinv"], -asm["g_e"])
        return -asm["g_f"] - self._w_apply(asm, cinv_be)

    def _back_substitute(self, asm, dx_f):
        b_e = -asm["g_e"] - self._wt_apply(asm, dx_f)
        return vpu_einsum("pef,pf->pe", asm["cinv"], b_e)

    def _schur_jacobi_blocks(self, asm, include_e_correction=True,
                             only_batch=None):
        """Block diagonal of S per retained block (for the SCHUR_JACOBI
        preconditioner); with ``include_e_correction=False``, the block
        diagonal of B = F^T F + D_f instead (the POWER_SERIES_EXPANSION
        preconditioner's base matrix). Cross-slot contributions to the same
        retained block (a residual touching one block through two slots) are
        dropped — same approximation quality class as the reference's
        preconditioner assembly."""
        outs = {
            gi: jnp.zeros(
                (
                    self.ev.program.groups[gi].num_blocks,
                    self.ev.program.groups[gi].tangent_size,
                    self.ev.program.groups[gi].tangent_size,
                ),
                dtype=asm["g_f"].dtype,
            )
            for gi in self._ret_group_order
        }
        for bi, (r, jac, E) in enumerate(asm["per_batch"]):
            if only_batch is not None and bi != only_batch:
                continue
            info = self.batch_info[bi]
            if bi in self.sorted_info and info["ret_slots"]:
                s, gi, c, t = info["ret_slots"][0]
                corr = E is not None and include_e_correction
                ec, et = info["e_col"] if corr else (0, 0)

                def row_fn(
                    jac_cam, pidx_pad, cinv,
                    c=c, t=t, corr=corr, ec=ec, et=et,
                ):
                    Fs = jac_cam[:, :, c : c + t]
                    ftf = vpu_einsum("bmf,bmg->bfg", Fs, Fs)
                    if corr:
                        E_cam = jac_cam[:, :, ec : ec + et]
                        A = vpu_einsum("bmf,bme->bfe", Fs, E_cam)
                        Y = vpu_einsum("bfe,beg->bfg", A, cinv[pidx_pad])
                        ftf = ftf - vpu_einsum("bfe,bge->bfg", Y, A)
                    return ftf

                conj = self._cam_conj(asm, bi)
                if conj is None:
                    cinv_in = asm["cinv"]
                else:
                    se = conj[2]
                    cinv_in = asm["cinv"] * se[:, :, None] * se[:, None, :]
                red = self._cam_reduce(
                    bi, asm["cam"][bi], (cinv_in,), row_fn, (t, t)
                )
                if conj is not None:
                    sf = conj[1]
                    red = red * sf[:, :, None] * sf[:, None, :]
                outs[gi] = outs[gi] + red
                continue
            for s, gi, c, t in info["ret_slots"]:
                Fs = jac[:, :, c : c + t]
                ftf = vpu_einsum("bmf,bmg->bfg", Fs, Fs)
                if E is not None and include_e_correction:
                    A = vpu_einsum("bmf,bme->bfe", Fs, E)
                    Y = vpu_einsum(
                        "bfe,beg->bfg", A, asm["cinv"][info["pidx"]]
                    )
                    ftf = ftf - vpu_einsum("bfe,bge->bfg", Y, A)
                red = self.ev.slot_reduce(bi, s, ftf.reshape(-1, t * t))
                outs[gi] = outs[gi] + red.reshape(-1, t, t)

        d_f = asm["d_f"]
        blocks = []
        for (start, nb, t), gi in zip(self.ret_blocks, self._ret_group_order):
            dd = jax.lax.dynamic_slice_in_dim(d_f, start, nb * t).reshape(nb, t)
            blocks.append(outs[gi] + jax.vmap(jnp.diag)(dd))
        return blocks

    # -- DENSE_SCHUR -----------------------------------------------------------------

    def _dense_s_dense_w(self, asm):
        """Scatter-free S assembly (BA fast path): everything is planned
        gathers and batched einsums.

          S = blockdiag(F^T F) - sum_p W_p C_p^{-1} W_p^T + diag(d_f)

        with W (n_pts, n_cams, f, e) materialized densely (bounded size,
        checked at construction)."""
        dw = self.dense_w
        nc, f, e = dw["n_cams"], dw["f_size"], self.e_size
        dtype = asm["g_f"].dtype
        bi = self.e_batch
        info = self.batch_info[bi]
        r, jac, E = asm["per_batch"][bi]
        s, gi, c, t = info["ret_slots"][0]
        Fs = jac[:, :, c : c + t]

        # block-diagonal F^T F via the slot's planned reduction (one-hot
        # matmul for the few-camera case)
        ftf = vpu_einsum("bmf,bmg->bfg", Fs, Fs)  # (B, f, f)
        diag_blocks = self.ev.slot_reduce(bi, s, ftf.reshape(-1, f * f)).reshape(
            nc, f, f
        )

        # dense W via the precomputed (point, camera)-cell gather plan
        a = vpu_einsum("bmf,bme->bfe", Fs, E)  # (B, f, e)
        w = apply_reduce_plan(dw["w_plan"], a.reshape(-1, f * e)).reshape(
            self.num_points, nc, f, e
        )
        y = vpu_einsum("pcfe,peg->pcfg", w, asm["cinv"])
        corr = jnp.einsum("pcfe,pdge->cfdg", y, w)  # (nc, f, nc, f)

        s_mat = -corr.reshape(nc * f, nc * f)
        rows = jnp.arange(nc * f).reshape(nc, f)
        s_mat = s_mat.at[rows[:, :, None], rows[:, None, :]].add(diag_blocks)
        s_mat = s_mat + jnp.diag(asm["d_f"])

        # any other batches (e.g. camera priors) take the generic path;
        # they are tiny compared to the observation batch
        for bj, (rb, jacb, Eb) in enumerate(asm["per_batch"]):
            if bj == self.e_batch or self.batch_info[bj]["tf"] == 0:
                continue
            infob = self.batch_info[bj]
            Fb = jacb[:, :, infob["f_cols"]]
            ftfb = vpu_einsum("bmf,bmg->bfg", Fb, Fb)
            fidxb = infob["fidx"]
            s_mat = s_mat.at[fidxb[:, :, None], fidxb[:, None, :]].add(ftfb)
        return s_mat

    def _s_matvec(self, asm, v):
        """The implicit Schur-complement product
        ``S v = (F^T F + D_f) v - W C^{-1} W^T v`` — fully generic over any
        number of eliminated-x-retained batch signatures and retained
        groups (every term loops all batches).

        Camera-padded batches fuse the ``F^T F v`` and ``W (C^{-1} W^T v)``
        terms into ONE pass over the camera-padded Jacobian copy:
        ``F^T (F v - E wc)`` with a reshape+sum camera reduction. At venice
        scale each pass streams ~0.5 GB of Jacobian from device memory, so
        collapsing
        the matvec from three passes (wt, ftf, w) to two is a direct
        bandwidth win on the PCG inner loop (reference counterpart:
        implicit_schur_complement.cc RightMultiplyAndAccumulate, which is
        likewise structured around J-product passes)."""
        wc = vpu_einsum("pef,pf->pe", asm["cinv"], self._wt_apply(asm, v))
        accs = self._zero_ret_accs(v.dtype)
        for bi, (r, jac, E) in enumerate(asm["per_batch"]):
            info = self.batch_info[bi]
            if not info["ret_slots"]:
                continue
            if bi in self.sorted_info:
                sinfo = self.sorted_info[bi]
                s, gi, c, t = info["ret_slots"][0]
                nc, K = sinfo["nc"], sinfo["K"]
                has_e = E is not None
                ec, et = info["e_col"] if has_e else (0, 0)

                def row_fn(
                    jac_cam, pidx_pad, vf, wcp,
                    gi=gi, c=c, t=t, nc=nc, K=K, has_e=has_e, ec=ec, et=et,
                ):
                    Fs = jac_cam[:, :, c : c + t]
                    vs = jnp.broadcast_to(
                        self._ret_view(vf, gi)[:, None, :], (nc, K, t)
                    ).reshape(nc * K, t)
                    m = vpu_einsum("bmf,bf->bm", Fs, vs)
                    if has_e:
                        E_cam = jac_cam[:, :, ec : ec + et]
                        m = m - vpu_einsum("bme,be->bm", E_cam, wcp[pidx_pad])
                    return vpu_einsum("bmf,bm->bf", Fs, m)

                accs[gi] = accs[gi] + self._cam_reduce(
                    bi, asm["cam"][bi], (v, wc), row_fn, (t,)
                )
                continue
            # generic path: F^T F v and (if eliminated) F^T E wc
            _, idx_pad, _, _, _ = self.ev._batch_const[bi]
            Fv = jnp.zeros((jac.shape[0], jac.shape[1]), dtype=v.dtype)
            for s, gi, c, t in info["ret_slots"]:
                Fs = jac[:, :, c : c + t]
                vs = self._ret_view(v, gi)[idx_pad[s]]
                Fv = Fv + vpu_einsum("bmf,bf->bm", Fs, vs)
            if E is not None:
                Fv = Fv - vpu_einsum("bme,be->bm", E, wc[info["pidx"]])
            for s, gi, c, t in info["ret_slots"]:
                Fs = jac[:, :, c : c + t]
                accs[gi] = accs[gi] + self.ev.slot_reduce(
                    bi, s, vpu_einsum("bmf,bm->bf", Fs, Fv)
                )
        return asm["d_f"] * v + self._ret_assemble(accs)

    def _dense_s_explicit(self, asm):
        """Explicit S via the scatter-free pair-product plan
        (core/explicit_schur.py):

          off-diagonal blocks   sum_p Y_pk A_pl^T (k<l), hierarchical
                                padded sums onto unique camera pairs,
                                gather-built into the dense matrix;
          diagonal blocks       the SCHUR_JACOBI blocks of the observation
                                batch (F^T F - Y C^-1 Y^T + D_f), which
                                already ride the camera-padded K-reduce;
          other batches         (priors etc.) added via their retained
                                index maps.
        """
        plan = self.explicit_plan
        bi = self.e_batch
        e = self.e_size
        grid = asm.get("explicit_grid")
        if grid is None:  # direct callers that skipped prepare()
            grid = plan.build_grid(self._explicit_a_flat(asm["per_batch"]))
        cinv_flat = asm["cinv"].reshape(-1, e * e)
        uniq = plan.correction_offdiag(grid, cinv_flat)
        # diagonal blocks of the observation batch, incl. damping; their
        # internal one-ulp asymmetry is symmetrized HERE (nc*f*f — free)
        # so the dense matrix needs no full 16k x 16k transpose pass, and
        # they ride the gather-build as an appended table region so no
        # scatter-add touches the 1 GB matrix
        diag_blocks = self._schur_jacobi_blocks(asm, only_batch=bi)[0]
        diag_blocks = 0.5 * (
            diag_blocks + jnp.swapaxes(diag_blocks, 1, 2)
        )
        nc, f = plan.nc, plan.f
        s_mat = -plan.dense_s_full(
            uniq, -diag_blocks.reshape(nc, f * f)
        )
        # remaining batches (e.g. priors): full coupling via index maps
        extra = False
        for bj, (rb, jacb, Eb) in enumerate(asm["per_batch"]):
            if bj == bi or self.batch_info[bj]["tf"] == 0:
                continue
            extra = True
            infob = self.batch_info[bj]
            Fb = jacb[:, :, infob["f_cols"]]
            ftfb = vpu_einsum("bmf,bmg->bfg", Fb, Fb)
            fidxb = infob["fidx"]
            s_mat = s_mat.at[fidxb[:, :, None], fidxb[:, None, :]].add(ftfb)
        if extra:
            # the extra batches' scatter contributions are not
            # symmetrized by construction
            s_mat = 0.5 * (s_mat + s_mat.T)
        return s_mat

    def _dense_s(self, asm):
        """Materialize S (N_f, N_f).

        Path priority: the dense-W einsum (small problems), the explicit
        pair-product plan (scales to venice), then the generic implicit
        column probe — scatter-free, O(N_f) passes over the observations,
        and structure-agnostic (it replaces the old host-side camera-pair
        enumeration + XLA scatter, which could not scale past toy problems
        and supported only one batch signature; reference counterpart:
        ``schur_complement_solver.cc`` assembling S cell by cell)."""
        # under a mesh the explicit pair-product plan is the sharded-native
        # path (per-shard sums + one psum); the dense-W gather plan would
        # allgather the sharded value rows
        if self.explicit_plan is not None and self.ev.mesh is not None:
            return self._dense_s_explicit(asm)
        if self.dense_w is not None:
            return self._dense_s_dense_w(asm)
        if self.explicit_plan is not None:
            return self._dense_s_explicit(asm)
        dtype = asm["g_f"].dtype
        eye = jnp.eye(self.num_f, dtype=dtype)
        cols = jax.lax.map(
            lambda e: self._s_matvec(asm, e),
            eye,
            batch_size=min(self.num_f, self.pair_chunk or 128),
        )
        # S is symmetric; average out any one-ulp asymmetry so Cholesky
        # sees an exactly-symmetric operand
        return 0.5 * (cols + cols.T)

    @staticmethod
    def _factor_solve(s, rhs):
        """Solve S x = rhs by Cholesky (cuSOLVER potrf/potrs on the GPU).
        Returns (x, solve_fn) so refinement can reuse the factorization; a
        failed factor (S not numerically PD) yields non-finite x."""
        l = jax.lax.linalg.cholesky(s)
        solve = lambda b: jax.scipy.linalg.cho_solve((l, True), b)
        return solve(rhs), solve

    # -- public interface used by the minimizer -----------------------------------

    @property
    def schur_path(self):
        """Human-readable description of the S-assembly path the damped
        solves will take, with the gate reason when a wanted explicit plan
        was rejected (Summary.schur_complement_path)."""
        reason = self.explicit_reject_reason
        if self.iterative:
            if self.use_explicit:
                return "explicit"
            if reason is not None:
                return f"implicit (gate: {reason})"
            return "implicit"
        if self.explicit_plan is not None and (
            self.ev.mesh is not None or self.dense_w is None
        ):
            return "explicit"
        if self.dense_w is not None:
            return "dense-W"
        return f"column-probe (gate: {reason})"

    def solve_damped(
        self, data, g, diag, mu, min_diagonal, max_diagonal, jitter0=None
    ):
        """Returns (dx, linear_solver_iterations, jitter_used).

        ``jitter0``: device scalar — the caller's RATCHET: start the
        jittered-refactor ladder at the last successful delta instead of
        re-paying the doomed plain factor every solve (on a gauge-free BA
        problem the plain f32 factor fails at nearly every healthy
        radius; see the ladder NOTE below). ``jitter_used`` feeds the
        next call."""
        dtype = g.dtype
        if jitter0 is None:
            jitter0 = jnp.zeros((), dtype)
        d = lm_diagonal(diag, mu, min_diagonal, max_diagonal)
        asm = self._assemble(data, g, d)
        rhs = self._schur_rhs(asm)
        jitter_out = jitter0.astype(dtype)  # pass-through (iterative path)

        if not self.iterative:
            s = self._dense_s(asm)
            # symmetric equilibration: factor D^-1/2 S D^-1/2 (pivots ~1)
            # instead of S — mathematically the same solve, but in f32 it
            # moves the feasibility boundary (where assembly noise makes S
            # numerically indefinite) out by orders of magnitude
            d_eq = jnp.sqrt(
                jnp.maximum(jnp.diag(s), jnp.finfo(s.dtype).tiny)
            )
            s = s / d_eq[:, None] / d_eq[None, :]
            rhs_eq = rhs / d_eq
            n = s.shape[0]
            eye0 = (
                jnp.arange(n)[:, None] == jnp.arange(n)[None, :]
            ).astype(s.dtype)
            dx_f, solve = self._factor_solve(s + jitter0 * eye0, rhs_eq)
            # mixed-precision iterative refinement on the reduced camera
            # system (reference: use_mixed_precision_solves)
            for _ in range(self.refinement_iterations):
                r64 = rhs_eq.astype(jnp.float64) - s.astype(jnp.float64) @ (
                    dx_f.astype(jnp.float64)
                )
                dx_f = dx_f + solve(r64.astype(s.dtype))
            # The f32 Cholesky can fail (NaN) when S is nearly singular at
            # low damping — catastrophic cancellation in F^T F - W C^-1 W^T
            # for well-observed cameras. The reference reports
            # LinearSolverFailure and wastes the LM step; here the step is
            # recovered instead, in two stages:
            #
            # 1. JITTERED REFACTOR: Cholesky of S + delta*I in the
            #    equilibrated space (pivots ~1, so delta is relative),
            #    delta escalating 1e-3 -> 1e-1. Why these rungs: for a
            #    gauge-free BA problem the equilibrated damped S has
            #    relative eigenvalues ~ mu*scale along the 7 gauge
            #    directions (3e-5 at venice radius 3e4) — BELOW f32
            #    Cholesky stability (n*eps ~ 2e-3 at n=16k), so the plain
            #    factor fails at nearly every healthy radius and a 1e-5
            #    rung is always still inside the noise.
            #    Even a 0.1 bump is a valid, merely more conservative
            #    descent step — strictly better than the reference's
            #    wasted LinearSolverFailure step (venice rows with
            #    delta=0.1 were accepted at tr_ratio ~1.0). Adding
            #    delta*I equals
            #    adding delta*D to the raw S — a whisker of extra Tikhonov
            #    damping on the cameras, far below the LM damping that
            #    matters — so the step solves a negligibly-more-damped
            #    model and the trust region judges it on actual decrease.
            #    This converts the reference's wasted step into a useful
            #    one whenever f32 assembly noise (not genuine
            #    indefiniteness) killed the factor. One extra Cholesky
            #    instance total (lax.while_loop); executes only on failure.
            # 2. capped PCG on the explicit S (below) if even the jittered
            #    factors fail.
            def _retry_cond(c):
                dx, delta, used, k = c
                return (~jnp.all(jnp.isfinite(dx))) & (k < 2)

            def _retry_body(c):
                dx, delta, used, k = c
                x2, _ = self._factor_solve(s + delta * eye0, rhs_eq)
                return (
                    x2,
                    jnp.minimum(delta * 100.0, 0.1),
                    delta,
                    k + 1,
                )

            # the ratchet: retries escalate from (at least) two decades
            # above the caller's starting delta
            delta_start = jnp.clip(
                jnp.maximum(jitter0 * 100.0, 1e-3), 0.0, 0.1
            ).astype(s.dtype)
            dx_f, _, jitter_used, n_retries = jax.lax.while_loop(
                _retry_cond,
                _retry_body,
                (
                    dx_f,
                    delta_start,
                    jitter0.astype(s.dtype),
                    jnp.zeros((), jnp.int32),
                ),
            )
            bad = ~jnp.all(jnp.isfinite(dx_f))
            if len(self.ret_blocks) == 1:
                # block-Jacobi preconditioner read off the explicit S
                fb_precond = self._block_inverse_apply(
                    [self._diag_blocks_of(s)]
                )
            else:
                d_s = jnp.maximum(
                    jnp.abs(jnp.diag(s)), jnp.finfo(s.dtype).tiny
                )

                def fb_precond(vv):
                    return vv / d_s

            # NOTE on scope: when the factor fails because S is genuinely
            # INDEFINITE in f32 (radius beyond the f32 feasibility
            # boundary: assembly noise eps*||S|| exceeds the damping), CG
            # cannot save the step either — it returns a large step the
            # trust region rejects, which is the reference's
            # LinearSolverFailure outcome. The capped attempt costs ~30
            # GEMVs and only rescues the borderline cases where the
            # factor failed but S is still PSD.
            def cg_fallback(_):
                x, _it = preconditioned_conjugate_gradients(
                    lambda vv: s @ vv,
                    rhs_eq,
                    fb_precond,
                    32,
                    jnp.asarray(1e-8, dtype=s.dtype),
                )
                return x

            dx_f = jax.lax.cond(
                bad, cg_fallback, lambda _: dx_f, operand=None
            )
            dx_f = dx_f / d_eq  # undo the equilibration
            iters = jnp.where(bad, 32, 1 + n_retries).astype(jnp.int32)
            jitter_out = jitter_used.astype(dtype)
        else:
            s_explicit = None
            if self.use_explicit:
                # reference: use_explicit_schur_complement — materialize S
                # once per solve; every PCG matvec is then ONE dense GEMV
                # streaming S instead of two gather-bound passes over the
                # observations
                s_explicit = self._dense_s(asm)

            if s_explicit is not None:

                def s_matvec(v):
                    return s_explicit @ v

            else:

                def s_matvec(v):
                    return self._s_matvec(asm, v)

            if (
                s_explicit is not None
                and self.preconditioner == PreconditionerType.SCHUR_JACOBI
                and len(self.ret_blocks) == 1
            ):
                # block diagonal read straight off the explicit S
                precond = self._block_inverse_apply(
                    [self._diag_blocks_of(s_explicit)]
                )

            elif (
                self.preconditioner == PreconditionerType.CLUSTER_JACOBI
                and self.cluster_plan is not None
            ):
                precond = self._cluster_jacobi_precond(asm)

            elif (
                self.preconditioner
                == PreconditionerType.CLUSTER_TRIDIAGONAL
                and self.cluster_plan is not None
                and self.cluster_plan.n_clusters > 1
            ):
                precond = self._cluster_tridiag_precond(asm)

            elif self.preconditioner in (
                PreconditionerType.SCHUR_JACOBI,
                # the cluster preconditioners downgrade to SCHUR_JACOBI
                # when the problem structure doesn't admit the cluster
                # plan (reference preprocessor downgrade semantics); a
                # single cluster makes TRIDIAGONAL degenerate too
                PreconditionerType.CLUSTER_JACOBI,
                PreconditionerType.CLUSTER_TRIDIAGONAL,
            ):
                blocks = self._schur_jacobi_blocks(asm)
                precond = self._block_inverse_apply(blocks)

            elif self.preconditioner == PreconditionerType.POWER_SERIES_EXPANSION:
                # truncated Neumann series (reference:
                # power_series_expansion_preconditioner.cc; "Power Bundle
                # Adjustment" idea): with B = blockdiag(F^T F) + D_f (exactly
                # block-diagonal for BA structure),
                #   S^{-1} ~= sum_k (B^{-1} W C^{-1} W^T)^k B^{-1}
                # and each term uses W C^{-1} W^T y = B y - S y, so one
                # S-matvec per series term — all einsum/segment-reduce.
                blocks_b = self._schur_jacobi_blocks(asm, include_e_correction=False)
                binv_apply = self._block_inverse_apply(blocks_b)
                n_terms = self.max_power_series_terms
                tol2 = self.spse_tolerance**2

                def precond(v):
                    # series terminates early once the latest term is small
                    # relative to the accumulated vector (reference:
                    # spse_tolerance); while_loop keeps it one traced program
                    y0 = binv_apply(v)

                    def cond(carry):
                        k, y, acc = carry
                        return jnp.logical_and(
                            k < n_terms,
                            jnp.vdot(y, y) > tol2 * jnp.vdot(acc, acc),
                        )

                    def body(carry):
                        k, y, acc = carry
                        y2 = y - binv_apply(s_matvec(y))
                        return (k + 1, y2, acc + y2)

                    _, _, acc = jax.lax.while_loop(
                        cond, body, (jnp.zeros((), jnp.int32), y0, y0)
                    )
                    return acc

            else:  # JACOBI / IDENTITY fall back to diagonal scaling
                d_f = asm["d_f"] + self._ftf_diag(asm)

                def precond(v):
                    return v / jnp.maximum(d_f, jnp.finfo(v.dtype).tiny)

            # reference parity (iterative_schur_complement_solver.cc):
            # Q-based termination with q_tolerance = eta; the residual
            # criterion is disabled (r_tolerance = -1)
            dx_f, iters = preconditioned_conjugate_gradients(
                s_matvec,
                rhs,
                precond,
                self.max_cg_iterations,
                jnp.zeros((), dtype=g.dtype),
                q_tolerance=jnp.asarray(self.eta, dtype=g.dtype),
            )

        dx_e = self._back_substitute(asm, dx_f)
        dx = jnp.zeros_like(g)
        dx = dx.at[self._ret_index_dev].set(dx_f)
        dx = dx.at[
            self.elim_offset + jnp.arange(self.elim_span)
        ].set(dx_e.reshape(-1))
        return dx, iters, jitter_out

    def _cluster_mats(self, asm):
        """Shared cluster-preconditioner assembly: the (ncl, cs*f, cs*f)
        block-diagonal-of-S cluster matrices (pair correction + per-camera
        diagonal blocks + damping) plus the unique-pair table (the
        TRIDIAGONAL band reuses it) and the boost bookkeeping."""
        plan = self.cluster_plan
        f = plan.f
        ncl, cs = plan.n_clusters, plan.cluster_slot_size
        grid = asm.get("explicit_grid")
        if grid is None:
            grid = plan.build_grid(self._explicit_a_flat(asm["per_batch"]))
        cinv_flat = asm["cinv"].reshape(-1, self.e_size * self.e_size)
        uniq = plan.correction_offdiag(grid, cinv_flat)
        mats = -plan.cluster_offdiag(uniq)  # (ncl, cs*f, cs*f)

        # per-camera diagonal blocks (F^T F - sum_r Y_r A_r^T + D_f) into
        # the cluster slots; padded slots get identity so Cholesky is PD.
        # Placement is a pure GATHER + mask, never a scatter, consistent
        # with this repo's no-scatter discipline.
        diag_blocks = self._schur_jacobi_blocks(asm)[0]  # (nc, f, f)
        db_flat = diag_blocks.reshape(-1, f * f)
        eye_row = jnp.eye(f, dtype=db_flat.dtype).reshape(1, f * f)
        db_sel = jnp.concatenate([db_flat, eye_row])[
            self._cluster_slot_cam
        ].reshape(ncl, cs, f * f)
        rr = jnp.arange(cs * f)
        slot_i = rr // f  # (csf,)
        same = slot_i[:, None] == slot_i[None, :]
        col = (rr % f)[:, None] * f + (rr % f)[None, :]  # (csf, csf)
        bd = db_sel[:, slot_i[:, None], col]  # (ncl, csf, csf) gather
        mats = mats + jnp.where(same[None, :, :], bd, 0.0)

        # f32 robustness (same inherent issue as the full-S factor: on a
        # gauge-free problem near-null directions sit below f32 Cholesky
        # stability, and a preconditioner doesn't need exactness): boost
        # every diagonal slot by 1e-3 of the CLUSTER'S max diagonal — a
        # per-slot relative boost is useless exactly where it matters
        # (cancellation can leave a slot's diagonal near zero or negative,
        # making its own 1e-3 vanish, and the factor then comes out finite
        # garbage with a huge effective inverse norm). Badness is judged by
        # the factor's pivots against the boost actually added (isfinite alone misses the garbage case);
        # bad clusters refactor with a 1e-1 boost.
        dvec = mats[:, rr, rr]  # (ncl, cs*f)
        dmax = jnp.maximum(
            jnp.max(dvec, axis=1, keepdims=True),
            jnp.finfo(mats.dtype).tiny,
        )  # (ncl, 1)

        eye_full = (rr[:, None] == rr[None, :]).astype(mats.dtype)
        return mats, uniq, dmax, rr, eye_full

    def _cluster_jacobi_precond(self, asm):
        """CLUSTER_JACOBI: factor the block-diagonal-of-S by camera
        cluster. The intra-cluster-restricted pair-product plan supplies
        the off-diagonal coupling; per-camera diagonal blocks (incl. the
        same-observation correction and damping) come from the
        SCHUR_JACOBI machinery; the batched cluster matrices are factored
        once per damped solve and applied with two batched triangular
        solves per PCG iteration."""
        plan = self.cluster_plan
        f = plan.f
        ncl, cs = plan.n_clusters, plan.cluster_slot_size
        mats, _uniq, dmax, rr, eye_full = self._cluster_mats(asm)

        # ADAPTIVE boost ladder {0, cluster_boost, 1e-1}: an
        # unconditional 1e-3 boost costs step quality exactly in the
        # beyond-explicit-S regime this preconditioner exists for. Rung
        # 0 factors the true cluster matrices; a rung is accepted per
        # cluster by the FACTORIZATION RESIDUAL ||L L^T - M||_F <=
        # tol ||M||_F — the f32 failure mode here is finite GARBAGE
        # (a huge effective inverse norm with finite entries), which
        # pivot/isfinite checks miss but the residual cannot. The
        # extra rungs cost two batched GEMM+Cholesky passes, only paid
        # when damping is low enough for rung 0 to fail.
        boost0 = max(self.cluster_boost, 1e-5)
        tol = 1e-3

        def factor_ok(chol, m):
            finite = jnp.all(jnp.isfinite(chol), axis=(1, 2))
            ll = jnp.einsum("bik,bjk->bij", chol, chol)
            rn = jnp.sqrt(jnp.sum((ll - m) ** 2, axis=(1, 2)))
            mn = jnp.sqrt(jnp.sum(m * m, axis=(1, 2)))
            return finite & (rn <= tol * mn + jnp.finfo(m.dtype).tiny)

        chol = jax.lax.linalg.cholesky(mats)
        ok = factor_ok(chol, mats)
        for eps_rel in (boost0, 1e-1):
            m_b = mats + (eps_rel * dmax)[:, :, None] * eye_full[None]
            chol_b = jax.lax.linalg.cholesky(m_b)
            ok_b = factor_ok(chol_b, m_b)
            take = (~ok & ok_b)[:, None, None]
            chol = jnp.where(take, chol_b, chol)
            ok = ok | ok_b
        # nothing passed: keep the most-regularized factor regardless (a
        # preconditioner only needs to be SPD-ish; PCG still converges)
        chol = jnp.where(ok[:, None, None], chol, chol_b)
        chol = jnp.where(jnp.isfinite(chol), chol, 0.0)
        # invert the factors ONCE, outside the PCG loop: with linv
        # precomputed, each PCG application is two plain batched GEMMs
        # instead of a triangular_solve chain inside lax.while_loop.
        eye_b = jnp.broadcast_to(eye_full[None], chol.shape)
        linv = jax.lax.linalg.triangular_solve(
            chol, eye_b, left_side=True, lower=True, transpose_a=False
        )  # (ncl, csf, csf) = L^{-1}
        pos = self._cluster_pos_of_cam
        slot_cam = self._cluster_slot_cam  # (ncl*cs,), sentinel nc = pad

        def precond(v):
            # camera blocks -> cluster slots as a pure GATHER (sentinel ->
            # zero row)
            vblk = v.reshape(-1, f)
            zero = jnp.zeros((1, f), v.dtype)
            vb = jnp.concatenate([vblk, zero])[slot_cam]
            vb = vb.reshape(ncl, cs * f)
            y = jnp.einsum("bij,bj->bi", linv, vb)
            x = jnp.einsum("bji,bj->bi", linv, y)
            return x.reshape(ncl * cs, f)[pos].reshape(-1)

        return precond

    def _cluster_tridiag_precond(self, asm):
        """CLUSTER_TRIDIAGONAL (reference:
        visibility_based_preconditioner.cc): the CLUSTER_JACOBI diagonal
        plus the adjacent-cluster coupling band, factored by BLOCK LDL^T
        along the cluster chain. All triangular solves happen HERE, once
        per damped solve, against identity — the PCG loop applies only
        GEMV scans (see _cluster_jacobi_precond). Clusters are contiguous camera-index
        ranges (documented deviation: the reference couples clusters via
        a spanning forest of the visibility graph)."""
        plan = self.cluster_plan
        if plan.n_clusters == 1:
            return self._cluster_jacobi_precond(asm)
        f = plan.f
        ncl, cs = plan.n_clusters, plan.cluster_slot_size
        csf = cs * f
        mats, uniq, dmax, rr, eye_full = self._cluster_mats(asm)
        # B_c couples cluster c (rows) to c+1 (cols); correction enters S
        # negated, like the diagonal's off-slot terms
        band = -plan.cluster_band_offdiag(uniq)  # (ncl-1, csf, csf)

        boost0 = max(self.cluster_boost, 1e-5)
        d_mats = mats

        def safe_inv(m, dmax_c):
            """PD-robust inverse via the same adaptive boost ladder as
            _cluster_jacobi_precond: rungs {0, boost, 1e-1}, accepted by
            the factorization residual (isfinite alone misses
            finite-garbage factors)."""
            tol = 1e-3

            def factor_ok(chol, mm):
                finite = jnp.all(jnp.isfinite(chol))
                rn = jnp.sqrt(jnp.sum((chol @ chol.T - mm) ** 2))
                mn = jnp.sqrt(jnp.sum(mm * mm))
                return finite & (
                    rn <= tol * mn + jnp.finfo(mm.dtype).tiny
                )

            chol = jax.lax.linalg.cholesky(m)
            ok = factor_ok(chol, m)
            for eps_rel in (boost0, 1e-1):
                m_b = m + (eps_rel * dmax_c) * eye_full
                chol_b = jax.lax.linalg.cholesky(m_b)
                ok_b = factor_ok(chol_b, m_b)
                chol = jnp.where(~ok & ok_b, chol_b, chol)
                ok = ok | ok_b
            chol = jnp.where(ok, chol, chol_b)
            chol = jnp.where(jnp.isfinite(chol), chol, 0.0)
            linv = jax.lax.linalg.triangular_solve(
                chol, eye_full, left_side=True, lower=True,
                transpose_a=False,
            )
            return linv.T @ linv

        # block LDL^T down the chain (ncl is static and modest, so the
        # host loop unrolls): dhat_0 = D_0; L_c = B_{c-1}^T dhatinv_{c-1};
        # dhat_c = D_c - L_c B_{c-1}
        dh_inv = safe_inv(d_mats[0], dmax[0, 0])
        dhatinv = [dh_inv]
        l_blocks = []
        for c in range(1, ncl):
            b_prev = band[c - 1]
            l_c = b_prev.T @ dh_inv
            dh = d_mats[c] - l_c @ b_prev
            dh = 0.5 * (dh + dh.T)
            dh_inv = safe_inv(dh, dmax[c, 0])
            dhatinv.append(dh_inv)
            l_blocks.append(l_c)
        dhatinv = jnp.stack(dhatinv)  # (ncl, csf, csf)
        l_stack = jnp.stack(l_blocks)  # (ncl-1, csf, csf)

        pos = self._cluster_pos_of_cam
        slot_cam = self._cluster_slot_cam

        def precond(v):
            vblk = v.reshape(-1, f)
            zero = jnp.zeros((1, f), v.dtype)
            vb = jnp.concatenate([vblk, zero])[slot_cam].reshape(ncl, csf)

            # forward substitution L z = r (GEMV scan down the chain)
            def fwd(z_prev, inp):
                l_c, r_c = inp
                z = r_c - l_c @ z_prev
                return z, z

            z0 = vb[0]
            _, zs = jax.lax.scan(fwd, z0, (l_stack, vb[1:]))
            z = jnp.concatenate([z0[None], zs])
            w = jnp.einsum("bij,bj->bi", dhatinv, z)

            # back substitution L^T x = w (reverse scan)
            def bwd(x_next, inp):
                l_c1, w_c = inp
                x = w_c - l_c1.T @ x_next
                return x, x

            x_last = w[-1]
            _, xs = jax.lax.scan(
                bwd, x_last, (l_stack, w[:-1]), reverse=True
            )
            x = jnp.concatenate([xs, x_last[None]])
            return x.reshape(ncl * cs, f)[pos].reshape(-1)

        return precond

    def _diag_blocks_of(self, s):
        """(nb, t, t) diagonal blocks of a dense (nb*t, nb*t) matrix.
        Neither the (nb, t, nb, t) reshape nor a vmapped row slice is
        safe — XLA may materialize both with a padded layout for the tiny
        trailing dims. One flat element-gather with a static index
        (nb*t*t = 144k elements) has no such intermediate."""
        start, nb, t = self.ret_blocks[0]
        n = nb * t
        ci = jnp.arange(nb)[:, None, None]
        i = jnp.arange(t)[None, :, None]
        j = jnp.arange(t)[None, None, :]
        idx = ((ci * t + i) * n + ci * t + j).reshape(nb, t * t)
        return s.reshape(-1)[idx].reshape(nb, t, t)

    def _block_inverse_apply(self, blocks):
        """v -> blockdiag(blocks)^{-1} v over the retained coordinates."""
        binvs = [batched_spd_inverse(blk) for blk in blocks]

        def apply(v):
            parts = []
            for (start, nb, t), binv in zip(self.ret_blocks, binvs):
                vb = jax.lax.dynamic_slice_in_dim(v, start, nb * t).reshape(nb, t)
                parts.append(vpu_einsum("bef,bf->be", binv, vb).reshape(-1))
            return jnp.concatenate(parts) if len(parts) > 1 else parts[0]

        return apply

    def _ftf_diag(self, asm):
        accs = self._zero_ret_accs(asm["g_f"].dtype)
        for bi, (r, jac, E) in enumerate(asm["per_batch"]):
            info = self.batch_info[bi]
            for s, gi, c, t in info["ret_slots"]:
                Fs = jac[:, :, c : c + t]
                accs[gi] = accs[gi] + self.ev.slot_reduce(
                    bi, s, jnp.sum(Fs * Fs, axis=1)
                )
        return self._ret_assemble(accs)

    def jtj_quadratic(self, data, v):
        """Scalar quadratic form v^T (J^T J) v = ||J v||^2 in ONE forward
        pass over the observations — the model-cost computation needs only
        this scalar, and the reduction half of the full matvec (with its
        observation-sized output gathers) is pure waste for it.

        When the camera-padded layout is resident (``prepare()`` dict with
        ``cam`` copies), the observation batch's pass rides it: the
        per-row camera vector is a BROADCAST and only the tiny point
        vector (e floats/row) is gathered — versus the generic path's
        full per-row tangent gather (T floats/row over every
        observation)."""
        prep = data if isinstance(data, dict) else None
        pairs = (
            [(r, jac) for (r, jac, _) in data["per_batch"]]
            if isinstance(data, dict)
            else data
        )
        total = jnp.zeros((), dtype=v.dtype)
        for bi, (r, jac) in enumerate(pairs):
            info = self.batch_info[bi]
            if (
                prep is not None
                and bi in self.sorted_info
                and bi in prep.get("cam", {})
                and info["e_col"] is not None
                and len(info["ret_slots"]) == 1
            ):
                ec, et = info["e_col"]
                s, gi, c, t = info["ret_slots"][0]
                sinfo = self.sorted_info[bi]
                nc, K = sinfo["nc"], sinfo["K"]
                v_e = self._gather_ge(v)
                v_ret = v[self._ret_index_dev]
                conj = self._cam_conj(prep, bi)
                if conj is not None:
                    # unscaled copy: J_s y = (F s_f) y_f + (E s_e) y_e —
                    # pre-scale the replicated vectors, output invariant
                    v_ret = v_ret * conj[0]
                    v_e = v_e * conj[2]

                def row_fn(jac_cam, pidx_pad, vv, ve,
                           ec=ec, et=et, c=c, t=t, gi=gi, nc=nc, K=K):
                    vf = jnp.broadcast_to(
                        self._ret_view(vv, gi)[:, None, :], (nc, K, t)
                    ).reshape(nc * K, t)
                    jv = vpu_einsum(
                        "bmf,bf->bm", jac_cam[:, :, c : c + t], vf
                    ) + vpu_einsum(
                        "bme,be->bm",
                        jac_cam[:, :, ec : ec + et],
                        ve[pidx_pad],
                    )
                    return jnp.sum(jv * jv, axis=1)

                per_cam = self._cam_reduce(
                    bi, prep["cam"][bi], (v_ret, v_e), row_fn, ()
                )
                total = total + jnp.sum(per_cam)
                continue
            jv = vpu_einsum("bmi,bi->bm", jac, self.ev.v_rows(bi, v))
            total = total + jnp.sum(jv * jv)  # padded rows: zero jacs
        return total

    def jtj_matvec(self, data, v):
        """Full-space (J^T J) v from the resident blocks (model cost).
        Accepts a ``prepare()`` dict (scaled: computes J_s^T J_s v) or raw
        solver-data tuples."""
        pairs = (
            [(r, jac) for (r, jac, _) in data["per_batch"]]
            if isinstance(data, dict)
            else data
        )
        blocks = [
            BatchBlocks(r, jac, self.ev._batch_const[bi][2])
            for bi, (r, jac) in enumerate(pairs)
        ]
        return self.ev.jtj_matvec(blocks, v)
