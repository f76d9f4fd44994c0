"""Covariance estimation of the solution.

JAX counterpart of the reference lineage's covariance layer
(``include/ceres/covariance.h``, ``internal/ceres/covariance_impl.cc``),
dense-SVD algorithm only (the sparse-QR path is a general-sparse CPU
factorization with no batched device mapping — documented deviation, SURVEY.md
§3.6): the tangent-space covariance is the Moore-Penrose pseudo-inverse of
J^T J with the reference's rank handling (``null_space_rank``,
``min_reciprocal_condition_number``), lifted back to ambient coordinates
through the manifold plus-Jacobians exactly like the reference's
``GetCovarianceBlock``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Covariance", "CovarianceOptions"]


@dataclasses.dataclass
class CovarianceOptions:
    """Reference: ``Covariance::Options`` (dense-SVD relevant fields, plus
    the algorithm selector — SCHUR_COMPLEMENT is this framework's
    replacement for the reference's SPARSE_QR on BA structure)."""

    algorithm_type: "CovarianceAlgorithmType" = None  # default DENSE_SVD
    min_reciprocal_condition_number: float = 1e-14
    # >= 0: treat exactly this many trailing singular values as null space
    # (reference semantics: -1 = automatic via the condition number test)
    null_space_rank: int = 0
    apply_loss_function: bool = True

    def __post_init__(self):
        from skeres.core.types import CovarianceAlgorithmType

        if self.algorithm_type is None:
            self.algorithm_type = CovarianceAlgorithmType.DENSE_SVD


class Covariance:
    """Compute and query covariance blocks of a solved problem."""

    def __init__(self, options: Optional[CovarianceOptions] = None):
        self.options = options or CovarianceOptions()
        self._cov_tangent: Optional[np.ndarray] = None
        self._program = None
        self._rank: Optional[int] = None
        # Schur-path state
        self._schur = None
        self._s_inv: Optional[np.ndarray] = None
        self._cinv: Optional[np.ndarray] = None
        self._jac_host = None
        self._glob2ret: Optional[np.ndarray] = None

    def compute(self, problem, program=None) -> bool:
        """Covariance of the solution.

        DENSE_SVD: Moore-Penrose pseudo-inverse of the full-tangent J^T J.
        SCHUR_COMPLEMENT: block inverse through the reduced camera system —
        never forms the full (N x N) J^T J; the largest dense object is S
        (N_f x N_f, the retained/camera subspace only).

        Returns False when the system is rank-deficient beyond what the
        options allow (the reference returns false from Compute then).
        """
        from skeres.core.types import CovarianceAlgorithmType

        if self.options.algorithm_type == CovarianceAlgorithmType.SCHUR_COMPLEMENT:
            return self._compute_schur(problem, program)
        return self._compute_dense_svd(problem, program)

    def _compute_dense_svd(self, problem, program=None) -> bool:
        from skeres.core.evaluator import Evaluator

        program = program or problem.compile()
        ev = Evaluator(
            program, apply_loss_function=self.options.apply_loss_function
        )
        state = program.initial_state(ev.dtype)
        _, blocks = jax.jit(ev.blocks)(state)
        jtj = np.asarray(jax.jit(ev.jtj_dense)(blocks), dtype=np.float64)

        # restrict to free coordinates; constant blocks get zero covariance
        free = program.free_mask > 0.0
        jtj_f = jtj[np.ix_(free, free)]

        cov_f = self._pinv_spd(jtj_f)
        if cov_f is None:
            return False

        n = program.num_tangent
        cov = np.zeros((n, n))
        idx = np.nonzero(free)[0]
        cov[np.ix_(idx, idx)] = cov_f

        self._cov_tangent = cov
        self._program = program
        return True

    def _pinv_spd(self, a: np.ndarray) -> Optional[np.ndarray]:
        """SVD pseudo-inverse with the reference's rank handling
        (``null_space_rank`` / ``min_reciprocal_condition_number``); sets
        ``self._rank``; returns None on disallowed rank deficiency."""
        u, s, _ = np.linalg.svd(a, hermitian=True)
        if s.size == 0:
            return None
        o = self.options
        if o.null_space_rank < 0:
            keep = s > o.min_reciprocal_condition_number * s[0]
        else:
            keep = np.ones_like(s, dtype=bool)
            cutoff = len(s) - o.null_space_rank
            keep[cutoff:] = False
            # reference: with automatic detection off, a kept singular value
            # below the threshold is an error (rank deficiency)
            bad = s[:cutoff] <= o.min_reciprocal_condition_number * s[0]
            if bad.any():
                self._rank = int(np.sum(~bad))
                return None
        with np.errstate(divide="ignore"):
            inv_s = np.where(keep, 1.0 / np.where(keep, s, 1.0), 0.0)
        self._rank = int(np.sum(keep))
        return (u * inv_s[None, :]) @ u.T

    # -- SCHUR_COMPLEMENT algorithm -------------------------------------------

    def _compute_schur(self, problem, program=None) -> bool:
        """Covariance through the reduced camera system (the batched
        counterpart of [ceres: covariance_impl.cc] SPARSE_QR for
        Schur-structured problems). With H = [[B, W], [W^T, C]] (B =
        camera block of J^T J, C = point block, W the cross term) and
        S = B - W C^{-1} W^T:

            H^-1_ff = S^-1                      (camera-camera)
            H^-1_fe = -S^-1 W C^-1              (camera-point)
            H^-1_ee = C^-1 + (WC^-1)^T S^-1 (WC^-1)   (point-point)

        Only S (N_f x N_f) is ever dense; the full J^T J (N x N, dominated
        by 3x#points) is never formed. Query cost: camera blocks are
        lookups; point queries rebuild that point's W_p rows on demand."""
        from skeres.core.evaluator import Evaluator
        from skeres.core.schur import SchurSolver

        program = program or problem.compile()
        ev = Evaluator(
            program, apply_loss_function=self.options.apply_loss_function
        )
        state = program.initial_state(ev.dtype)
        _, blocks = jax.jit(ev.blocks)(state)
        schur = SchurSolver(ev, iterative=False)
        data = schur.solver_data(blocks)
        n = program.num_tangent
        zeros = jnp.zeros((n,), ev.dtype)

        def build_s(d):
            prep = schur.prepare(d)
            asm = schur._assemble(prep, zeros, zeros)  # undamped: pure J^T J
            return schur._dense_s(asm), asm["cinv"], prep["ete0"]

        s_mat, cinv, ete = jax.jit(build_s)(data)
        s_mat = np.asarray(s_mat, dtype=np.float64)
        cinv_np = np.asarray(cinv, dtype=np.float64)
        # rank-deficiency guard (reference: Covariance::Compute returns
        # false): a singular per-point block C_p (a point with too few
        # observations, masked columns, or degenerate geometry) makes the
        # closed-form cofactor inverse non-finite — or, after working-dtype
        # rounding, huge-but-finite garbage — which would crash the SVD
        # below or poison point-block queries. Detect both and fail
        # cleanly: eigenvalues of the undamped C = E^T E per point, with a
        # threshold no tighter than the working dtype's resolution (a true
        # zero eigenvalue computed in f32 shows up as ~eps_f32 * max_eig).
        if not (np.isfinite(s_mat).all() and np.isfinite(cinv_np).all()):
            return False
        ete_np = np.asarray(ete, dtype=np.float64)
        eigs = np.linalg.eigvalsh(ete_np)  # (P, e), ascending
        eps_work = float(np.finfo(np.asarray(cinv).dtype).eps)
        rcond_min = max(
            self.options.min_reciprocal_condition_number, 100.0 * eps_work
        )
        if (eigs[:, 0] <= rcond_min * np.maximum(eigs[:, -1], 0.0)).any():
            return False

        # restrict to free retained coordinates (constant camera blocks
        # have zeroed Jacobian columns -> zero rows/cols in S)
        free_f = program.free_mask[schur.ret_index] > 0.0
        s_free = s_mat[np.ix_(free_f, free_f)]
        s_inv_free = self._pinv_spd(s_free)
        if s_inv_free is None:
            return False
        s_inv = np.zeros_like(s_mat)
        idx = np.nonzero(free_f)[0]
        s_inv[np.ix_(idx, idx)] = s_inv_free

        self._s_inv = s_inv
        self._cinv = cinv_np
        self._schur = schur
        self._ev = ev
        # host copies of the corrected Jacobian blocks for W_p queries
        self._jac_host = [np.asarray(b.jac, dtype=np.float64) for b in blocks]
        glob2ret = np.full(n, -1, dtype=np.int64)
        glob2ret[schur.ret_index] = np.arange(schur.num_f)
        self._glob2ret = glob2ret
        self._program = program
        self._cov_tangent = None
        return True

    def _point_u(self, p: int) -> np.ndarray:
        """U_p = W_p C_p^{-1} of shape (N_f, e) for point block row p,
        rebuilt on demand from the resident Jacobian blocks."""
        schur = self._schur
        ev = self._ev
        e = schur.e_size
        u = np.zeros((schur.num_f, e))
        for bi, info in enumerate(schur.batch_info):
            if info["e_col"] is None or not info["ret_slots"]:
                continue
            b = self._program.batches[bi]
            e_slot = b.slot_groups.index(schur.elim_group)
            pidx = np.asarray(ev._batch_idx_np[bi][e_slot])
            rows = np.nonzero(pidx == p)[0]
            if rows.size == 0:
                continue
            jac = self._jac_host[bi]
            ec, et = info["e_col"]
            E = jac[rows, :, ec : ec + et]  # (r, m, e)
            for s_, gi, c, t in info["ret_slots"]:
                F = jac[rows, :, c : c + t]  # (r, m, t)
                blk = np.asarray(ev._batch_idx_np[bi][s_])[rows]
                w = np.einsum("rmt,rme->rte", F, E)  # (r, t, e)
                start = schur._ret_start[gi]
                for k, br in enumerate(blk):
                    u[start + br * t : start + (br + 1) * t] += w[k]
        return u @ self._cinv[p]

    # -- queries -------------------------------------------------------------

    def _tangent_span(self, block) -> Tuple[int, int]:
        program = self._program
        g = program.groups[block.group_index]
        off = program.tangent_offset[block.group_index] + block.row * g.tangent_size
        return off, g.tangent_size

    def get_covariance_block_in_tangent_space(self, b1, b2) -> np.ndarray:
        if self._s_inv is not None:
            return self._schur_block(b1, b2)
        assert self._cov_tangent is not None, "call compute() first"
        o1, t1 = self._tangent_span(b1)
        o2, t2 = self._tangent_span(b2)
        return self._cov_tangent[o1 : o1 + t1, o2 : o2 + t2].copy()

    def _schur_block(self, b1, b2) -> np.ndarray:
        schur = self._schur
        elim = schur.elim_group
        e = schur.e_size

        def ret_rows(b):
            o, t = self._tangent_span(b)
            r = self._glob2ret[o : o + t]
            assert (r >= 0).all()
            return r

        p1 = b1.group_index == elim
        p2 = b2.group_index == elim
        if not p1 and not p2:  # camera-camera
            return self._s_inv[np.ix_(ret_rows(b1), ret_rows(b2))].copy()
        if not p1 and p2:  # camera-point: -S^-1 W C^-1
            u = self._point_u(b2.row)
            return -(self._s_inv @ u)[ret_rows(b1)]
        if p1 and not p2:
            u = self._point_u(b1.row)
            return -(u.T @ self._s_inv)[:, ret_rows(b2)]
        # point-point: delta C^-1 + (WC^-1)^T S^-1 (WC^-1)
        u1 = self._point_u(b1.row)
        u2 = u1 if b2.row == b1.row else self._point_u(b2.row)
        out = u1.T @ self._s_inv @ u2
        if b1.row == b2.row:
            out = out + self._cinv[b1.row]
        return out

    def get_covariance_block(self, b1, b2) -> np.ndarray:
        """Ambient-space covariance: J_plus(x1) C J_plus(x2)^T
        (reference: CovarianceImpl::GetCovarianceBlockInTangentOrAmbientSpace)."""
        ct = self.get_covariance_block_in_tangent_space(b1, b2)
        g1 = self._program.groups[b1.group_index]
        g2 = self._program.groups[b2.group_index]
        j1 = np.asarray(
            g1.manifold.plus_jacobian(jnp.asarray(b1.value)), dtype=np.float64
        )
        j2 = np.asarray(
            g2.manifold.plus_jacobian(jnp.asarray(b2.value)), dtype=np.float64
        )
        return j1 @ ct @ j2.T

    @property
    def rank(self) -> Optional[int]:
        return self._rank
