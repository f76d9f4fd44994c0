"""Explicit Schur-complement assembly.

Counterpart of the reference lineage's explicit-S machinery
(``schur_complement_solver.cc`` assembling S into a block random-access
matrix, and ``use_explicit_schur_complement`` for ITERATIVE_SCHUR —
``implicit_schur_complement.cc``'s documented alternative). The reference
scatters small GEMM results into S under locks; this module builds S with
ZERO data-dependent scatters (every index is static problem structure, so
reductions are planned host-side as gathers):

  S = blockdiag(F^T F + D_f) - W C^{-1} W^T

- per-row ``A_r = F_r^T E_r`` and ``Y_r = A_r C_p^{-1}`` are batched
  einsums (bandwidth-bound);
- the DIAGONAL correction blocks ``sum_r Y_r A_r^T`` per camera ride the
  camera-padded K-reduce (gather-free);
- the OFF-diagonal blocks come from strict pair products per point:
  rows are laid on a point-padded grid (P, Kp) (pure reshape when
  observation counts are uniform), pair products ``Y_{pk} A_{pl}^T`` for
  k < l are one broadcast einsum, and the reduction onto unique camera
  pairs uses a host-planned HIERARCHICAL PADDED SUM: destinations are
  split so no grid level exceeds a fan-in cap, each level is one static
  gather + reshape + sum;
- dense S is then GATHER-built: every (ci, cj) block position reads its
  unique-pair sum (or zero) through a static index map.

SPMD (mesh) mode — the flagship path's multi-device form (SURVEY.md §3.8
"psum(S) across hosts"; reference counterpart: none — the lineage is
single-process): observation rows are contiguously sharded over the mesh
axis, so the pair products are SHARD-LOCAL for every point whose rows live
in one shard. Each shard builds its own point grid and runs its own
hierarchical padded sum whose FINAL level places local unique-pair sums
into the GLOBAL unique-pair table (a cap-1 placement level); one ``psum``
over that table — venice: ~7k pairs x 81 f32 ~ 2.3 MB — combines the
shards. The handful of points whose rows straddle a shard boundary
(contiguous split of point-sorted rows: at most n_shards-1 of them) are
excluded from the per-shard grids and handled by a tiny REPLICATED fixup
grid assembled from a psum'd gather of their rows. Dense S is then
gather-built replicated, exactly like the single-device path.

All index arrays are static (problem structure), built once on the host.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from skeres.ops.small_einsum import vpu_einsum

__all__ = ["ExplicitSchurPlan"]


class _SumLevel(NamedTuple):
    src: jnp.ndarray  # (n_dest * cap,) int32 into previous level's rows
    n_dest: int
    cap: int


def _hierarchical_sum_plan(
    ids: np.ndarray, raw_rows: np.ndarray, n_rows: int, cap: int = 32,
    adaptive: bool = False,
) -> Tuple[list, np.ndarray]:
    """Plan ``out[u] = sum(values[raw_rows][ids == uniq[u]])`` as static
    gather+reshape+sum levels with fan-in <= cap per level (all numpy,
    vectorized — venice has ~10M pair rows).

    ``adaptive=True`` shrinks each level's fan-in toward the median group
    size (power of two, >= 2), bounding the padded-row waste even for
    low-fan-in (unstructured-visibility) id distributions — at the cost
    of one or two extra levels. Sharded callers keep a fixed cap (the
    level structure must match across shards).

    Returns (levels, uniq_ids (n_uniq,)) with levels as raw
    ``(src ndarray, n_dest, cap)`` tuples (callers may pad/remap before
    freezing to device arrays). Level k's gather indexes the output rows
    of level k-1 (level 0 indexes the raw value rows); the sentinel index
    == n_rows_of_previous_level selects a zero row appended at runtime.
    """
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    uniq, start = np.unique(sorted_ids, return_index=True)
    counts = np.diff(np.append(start, len(ids)))

    levels = []
    n_prev = n_rows
    cur_counts = counts.astype(np.int64)
    cur_rows = raw_rows[order].astype(np.int64)  # grouped by id
    max_cap = cap
    while True:
        if adaptive and len(cur_counts):
            med = max(int(np.median(cur_counts)), 2)
            cap = min(max_cap, 1 << int(np.ceil(np.log2(med))))
        n_dest = len(cur_counts)
        n_d = (cur_counts + cap - 1) // cap  # sub-rows per destination
        sub_start = np.concatenate([[0], np.cumsum(n_d)[:-1]]).astype(np.int64)
        n_sub = int(n_d.sum())
        # position of the j-th row of destination d: sub_start[d]*cap + j
        dest_of_row = np.repeat(np.arange(n_dest), cur_counts)
        starts = np.concatenate([[0], np.cumsum(cur_counts)[:-1]]).astype(
            np.int64
        )
        j_within = np.arange(len(cur_rows)) - starts[dest_of_row]
        positions = sub_start[dest_of_row] * cap + j_within
        src = np.full(n_sub * cap, n_prev, dtype=np.int64)  # sentinel
        src[positions] = cur_rows
        levels.append((src, n_sub, cap))
        if n_dest == 0 or (n_d == 1).all():
            break
        # next level reduces each destination's sub-rows
        cur_rows = np.arange(n_sub, dtype=np.int64)
        cur_counts = n_d
        n_prev = n_sub
    return levels, uniq


def _freeze_levels(levels) -> List[_SumLevel]:
    return [
        _SumLevel(jnp.asarray(src.astype(np.int32)), n_dest, cap)
        for src, n_dest, cap in levels
    ]


def _apply_hierarchical_sum(levels: List[_SumLevel], values: jnp.ndarray):
    """values: (n_rows, D) -> (n_last_dest, D) via the planned levels."""
    cur = values
    for lvl in levels:
        zero = jnp.zeros((1,) + cur.shape[1:], cur.dtype)
        g = jnp.concatenate([cur, zero])[lvl.src]
        cur = g.reshape(lvl.n_dest, lvl.cap, -1).sum(axis=1)
    return cur


def _check_level0_waste(levels, n_rows: int, factor: float = 3.0):
    """Reject pathological (unstructured) visibility: when unique camera
    pairs have tiny fan-in (every point seeing random cameras), the
    level-0 padded-gather form inflates to n_uniq*cap rows (a 1M-point
    random-visibility case needs a 16 GB intermediate).
    Real BA visibility is structured (venice: 7112 unique pairs, fan-in
    ~1400); structured cases sit near 1.0x here."""
    if levels:
        src, n_dest, cap = levels[0]
        # only material sizes: a few hundred KB of padding on a tiny (or
        # tiny-per-shard) problem is irrelevant and must not reject it
        if n_dest * cap >= (1 << 20) and n_dest * cap > factor * max(
            n_rows, 1
        ):
            raise ValueError(
                "unique-pair fan-in too low for the hierarchical padded "
                f"sum ({n_dest * cap} padded rows vs {n_rows} pair rows)"
            )


def _uniformize_shard_levels(per_shard, n_rows0: int, cap: int):
    """Pad per-shard hierarchical plans to a COMMON level structure so one
    shard_map program runs them all: same level count, same (n_dest, cap)
    per level; per-shard src arrays become stacked sharded operands.

    ``per_shard``: list of (levels, uniq) as returned by
    _hierarchical_sum_plan with n_rows = n_rows0 (uniform across shards).
    Returns (stacked_srcs [(ns, n_dest_j*cap_j) int32 per level],
    shapes [(n_dest_j, cap_j)], n_last) — n_last is the padded output row
    count of the final level, which the placement level indexes into.
    """
    ns = len(per_shard)
    l_max = max(len(lv) for lv, _ in per_shard) if per_shard else 0
    l_max = max(l_max, 1)
    # extend short plans with identity levels over their final rows
    ext = []
    for levels, uniq in per_shard:
        levels = list(levels)
        while len(levels) < l_max:
            n_prev = levels[-1][1] if levels else 0
            src = np.full(n_prev * cap, -1, dtype=np.int64)  # patched below
            src[::cap] = np.arange(n_prev)
            levels.append((src, n_prev, cap))
        ext.append(levels)
    stacked, shapes = [], []
    n_prev_padded = n_rows0
    for j in range(l_max):
        # >= 1: an all-empty level (every shard's points straddle) would
        # otherwise produce a 0-row reshape
        n_dest_j = max(1, max(lv[j][1] for lv in ext))
        cap_j = ext[0][j][2]
        srcs = []
        for levels in ext:
            src, n_dest_s, cap_s = levels[j]
            assert cap_s == cap_j
            # old sentinel (this shard's previous-level count) -> padded
            n_prev_s = n_rows0 if j == 0 else levels[j - 1][1]
            src = src.copy()
            src[(src == n_prev_s) | (src < 0)] = n_prev_padded
            pad = n_dest_j * cap_j - len(src)
            src = np.concatenate(
                [src, np.full(pad, n_prev_padded, dtype=np.int64)]
            )
            srcs.append(src)
        stacked.append(np.stack(srcs).astype(np.int32))
        shapes.append((n_dest_j, cap_j))
        n_prev_padded = n_dest_j
    return stacked, shapes, n_prev_padded


def _pair_metadata(
    grid_cam: np.ndarray, num_cameras: int, iu, ju, cluster_of=None,
    cluster_band=False,
):
    """Per-point-row pair bookkeeping from a (Pn, kp) camera grid:
    (swap (Pn, npair) bool, valid (Pn, npair) bool, pair_id (Pn*npair,)
    with -1 for invalid). With ``cluster_of`` (a (num_cameras,) cluster id
    per camera), pairs whose cameras live in different clusters are
    dropped — the CLUSTER_JACOBI restriction; ``cluster_band=True`` also
    keeps ADJACENT-cluster pairs (the CLUSTER_TRIDIAGONAL band)."""
    npair = len(iu)
    ca = grid_cam[:, iu].reshape(-1)
    cb = grid_cam[:, ju].reshape(-1)
    pair_valid = (ca >= 0) & (cb >= 0)
    if cluster_of is not None:
        cl = np.asarray(cluster_of)
        dcl = np.abs(
            cl[np.clip(ca, 0, None)] - cl[np.clip(cb, 0, None)]
        )
        pair_valid &= dcl <= (1 if cluster_band else 0)
    swap = ca > cb
    lo = np.where(swap, cb, ca)
    hi = np.where(swap, ca, cb)
    pair_id = np.where(pair_valid, lo * num_cameras + hi, -1)
    pn = grid_cam.shape[0]
    return (
        swap.reshape(pn, npair),
        pair_valid.reshape(pn, npair),
        pair_id,
    )


class ExplicitSchurPlan:
    """Static plan for explicit-S assembly of ONE observation batch with a
    single retained slot (the BA case the camera-padded layout covers).

    ``mesh=None``: single-device plan (global point grid).
    ``mesh`` + ``n_shards > 1``: SPMD plan — per-shard grids/sums, one
    psum over the global unique-pair table, replicated straddle fixup.
    """

    def __init__(
        self,
        cam_idx: np.ndarray,  # (B,) camera block id per row (incl. padding)
        pt_idx: np.ndarray,  # (B,) point block id per row (incl. padding)
        num_cameras: int,
        num_points: int,
        f_size: int,
        e_size: int,
        n_valid: Optional[int] = None,  # real rows; tail rows are evaluator
        # padding (repeated row-0 indices, zero-weight) and get no slots
        pair_cap: int = 32,
        pad_waste: float = 1.5,
        mesh=None,
        n_shards: int = 1,
        chunk_value_budget: int = 1 << 26,  # bytes of unpadded pair values
        # a lax.map chunk may materialize (~64 MB), so transients stay
        # bounded even if XLA pads the layout of a chunk's intermediates
        cluster_of: Optional[np.ndarray] = None,  # (nc,) cluster id per
        # camera: restrict pairs to intra-cluster (CLUSTER_JACOBI plan —
        # the unique-pair table then stays tiny however many cameras)
        cluster_band: bool = False,  # also keep adjacent-cluster pairs
        # and build the (c, c+1) band block maps (CLUSTER_TRIDIAGONAL)
    ):
        B = len(cam_idx)
        if n_valid is None:
            n_valid = B
        self.nc = num_cameras
        self.np_ = num_points
        self.f = f_size
        self.e = e_size
        self.pair_cap = pair_cap
        self.mesh = mesh if n_shards > 1 else None
        self.n_shards = n_shards if self.mesh is not None else 1
        self.cluster_of = (
            None if cluster_of is None
            else np.asarray(cluster_of, dtype=np.int64)
        )
        self.cluster_band = bool(cluster_band)

        # -- global point grid stats + skew gate --------------------------
        pt_v = pt_idx[:n_valid]
        counts = np.bincount(pt_v, minlength=num_points)
        kp = int(counts.max()) if num_points else 0
        self.kp = kp
        if num_points * kp > pad_waste * n_valid * 2.0:
            raise ValueError("point-degree skew too high for explicit S")

        iu, ju = np.triu_indices(kp, k=1)
        self.pair_k = jnp.asarray(iu.astype(np.int32))
        self.pair_l = jnp.asarray(ju.astype(np.int32))
        npairs = len(iu)
        self.npairs = npairs
        # chunk size over point rows: bound the per-chunk pair-value bytes
        self.chunk_points = max(
            256, chunk_value_budget // max(1, npairs * f_size * f_size * 4)
        )

        # global grid (also the source of the global unique-pair table)
        order = np.argsort(pt_v, kind="stable")
        sorted_pt = pt_v[order]
        starts = np.searchsorted(sorted_pt, np.arange(num_points))
        pos = np.arange(n_valid) - starts[sorted_pt]
        grid_src = np.full(num_points * kp, B, dtype=np.int64)  # sentinel
        grid_src[sorted_pt * kp + pos] = order
        grid_cam = np.full(num_points * kp, -1, dtype=np.int64)
        gvalid = grid_src < B
        grid_cam[gvalid] = cam_idx[grid_src[gvalid]]
        grid_cam = grid_cam.reshape(num_points, kp)
        swap_g, valid_g, pair_id_g = _pair_metadata(
            grid_cam, num_cameras, iu, ju, self.cluster_of,
            self.cluster_band,
        )
        uniq = np.unique(pair_id_g[pair_id_g >= 0])
        self.n_uniq = n_uniq = len(uniq)

        if self.mesh is None:
            # uniform point-sorted case: the grid is the identity
            # reshape of the VALID row prefix (evaluator pad-tail rows
            # are never grid slots, so chunk/shard padding does not
            # break this — build_grid slices them off)
            self.grid_is_reshape = bool(
                num_points * kp == n_valid
                and (counts == kp).all()
                and (grid_src == np.arange(n_valid)).all()
            )
            self.grid_src = (
                None
                if self.grid_is_reshape
                else jnp.asarray(grid_src.astype(np.int32))
            )
            self.swap_mask = jnp.asarray(swap_g)
            self.pair_valid = jnp.asarray(valid_g)
            rows = np.nonzero(pair_id_g >= 0)[0]
            self.n_pair_rows = len(pair_id_g)
            levels, uniq_l = _hierarchical_sum_plan(
                pair_id_g[rows], rows, self.n_pair_rows, cap=pair_cap,
                adaptive=True,
            )
            assert len(uniq_l) == n_uniq
            _check_level0_waste(levels, self.n_pair_rows)
            self.levels = _freeze_levels(levels)
        else:
            self._plan_sharded(
                cam_idx, pt_idx, n_valid, B, uniq, pad_waste, iu, ju
            )

        # -- dense-S gather map: block position (ci, cj) -> unique pair ---
        # NOTE on diagonal unique pairs (a == b, the same camera observing
        # a point through two rows): the true contribution to S[a,a] is
        # sum_{k<l}(T + T^T); the combined map routes diagonal positions
        # to an appended per-camera region where BOTH reads are pre-folded
        # (see dense_s_full / dense_s_offdiag).
        pos2u = np.full(num_cameras * num_cameras, n_uniq, dtype=np.int64)
        pos2u[uniq] = np.arange(n_uniq)
        lo_all = uniq // num_cameras
        hi_all = uniq % num_cameras
        pos2u_t = np.full(num_cameras * num_cameras, n_uniq, dtype=np.int64)
        pos2u_t[hi_all * num_cameras + lo_all] = np.arange(n_uniq)
        dd = np.arange(num_cameras)
        # SAME-CAMERA pairs (a point observed twice by one camera) store
        # a real uniq row at the diagonal position; the dense builds fold
        # it into the appended region so the diagonal overwrite loses
        # nothing
        self.diag_pair_idx = jnp.asarray(
            pos2u[dd * num_cameras + dd].astype(np.int32)
        )
        # static column permutation transposing a flat (f, f) block —
        # EVERY pair-block array stays in flat-81 2D form, so no layout
        # pads tiny trailing (f, f)=(9,9) dims at nc^2 rows
        ij = np.arange(f_size * f_size).reshape(f_size, f_size)
        self.perm_t = jnp.asarray(ij.T.reshape(-1).astype(np.int32))
        # single-gather map into the COMBINED table
        # [uniq | uniq^T | per-camera diag region | zero]: every dense-S
        # position needs exactly ONE read (off-diagonal positions have at
        # most one real pair side; diagonal positions read the appended
        # region, which pre-folds both reads of a same-camera pair). This
        # replaces the two full (nc*nc, 81) gathers + column-permute + add
        # with one gather from a table small enough to stay cache-resident.
        comb = np.full(
            num_cameras * num_cameras, 2 * n_uniq + num_cameras, np.int64
        )
        has_up = pos2u < n_uniq
        comb[has_up] = pos2u[has_up]
        has_low = (pos2u_t < n_uniq) & ~has_up
        comb[has_low] = n_uniq + pos2u_t[has_low]
        comb[dd * num_cameras + dd] = 2 * n_uniq + dd
        self.pos2u_combined = jnp.asarray(comb.astype(np.int32))

        # -- cluster block maps (CLUSTER_JACOBI): slot (c, i, j) -> uniq --
        if self.cluster_of is not None:
            ncl = int(self.cluster_of.max()) + 1 if num_cameras else 0
            members = [
                np.nonzero(self.cluster_of == c)[0] for c in range(ncl)
            ]
            cs = max((len(m) for m in members), default=1)
            cam_of = np.full((ncl, cs), -1, dtype=np.int64)
            for c, m in enumerate(members):
                cam_of[c, : len(m)] = m
            a = np.broadcast_to(cam_of[:, :, None], (ncl, cs, cs))
            b = np.broadcast_to(cam_of[:, None, :], (ncl, cs, cs))
            ok = (a >= 0) & (b >= 0)
            flatpos = np.where(
                ok, np.clip(a, 0, None) * num_cameras + np.clip(b, 0, None), 0
            ).reshape(-1)
            map_u = np.where(ok.reshape(-1), pos2u[flatpos], n_uniq)
            map_l = np.where(ok.reshape(-1), pos2u_t[flatpos], n_uniq)
            self.cluster_map_u = jnp.asarray(map_u.astype(np.int32))
            self.cluster_map_l = jnp.asarray(map_l.astype(np.int32))
            self.n_clusters = ncl
            self.cluster_slot_size = cs
            self.cluster_cam_of = cam_of  # (ncl, cs) host-side, -1 = pad
            if self.cluster_band and ncl > 1:
                # (c, c+1) band block maps (CLUSTER_TRIDIAGONAL): slot
                # (c, i, j) -> uniq index of the pair (cam_of[c, i],
                # cam_of[c+1, j]); unobserved pairs hit the sentinel and
                # read a zero block. Both orientations are mapped (like
                # the intra-cluster maps) so the build is correct for any
                # cluster_of, not just contiguous ranges.
                a = np.broadcast_to(
                    cam_of[:-1, :, None], (ncl - 1, cs, cs)
                )
                b = np.broadcast_to(
                    cam_of[1:, None, :], (ncl - 1, cs, cs)
                )
                ok = (a >= 0) & (b >= 0)
                flatpos = np.where(
                    ok,
                    np.clip(a, 0, None) * num_cameras
                    + np.clip(b, 0, None),
                    0,
                ).reshape(-1)
                self.band_map_u = jnp.asarray(
                    np.where(ok.reshape(-1), pos2u[flatpos], n_uniq)
                    .astype(np.int32)
                )
                self.band_map_l = jnp.asarray(
                    np.where(ok.reshape(-1), pos2u_t[flatpos], n_uniq)
                    .astype(np.int32)
                )
            else:
                self.band_map_u = None
                self.band_map_l = None

    # -- sharded planning --------------------------------------------------

    def _plan_sharded(
        self, cam_idx, pt_idx, n_valid, B, uniq, pad_waste, iu, ju
    ):
        """Per-shard grids + per-shard hierarchical sums ending in a
        placement level onto the global unique-pair table; straddle points
        go to a small replicated fixup grid."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        ns = self.n_shards
        nc, kp, npairs = self.nc, self.kp, self.npairs
        cap = self.pair_cap
        assert B % ns == 0, (B, ns)
        bs = B // ns
        self.bs = bs
        shard_valid = np.clip(n_valid - bs * np.arange(ns), 0, bs)

        pt_v = pt_idx[:n_valid].astype(np.int64)
        cam_v = cam_idx[:n_valid].astype(np.int64)
        rows = np.arange(n_valid)
        shard_of = rows // bs
        # straddle detection: per point, does it touch >1 shard?
        order = np.argsort(pt_v, kind="stable")
        sp = pt_v[order]
        sh = shard_of[order]
        starts = np.searchsorted(sp, np.arange(self.np_))
        ends = np.append(starts[1:], n_valid)
        first_sh = np.full(self.np_, -1, dtype=np.int64)
        last_sh = np.full(self.np_, -1, dtype=np.int64)
        nonempty = ends > starts
        first_sh[nonempty] = sh[starts[nonempty]]
        last_sh[nonempty] = sh[ends[nonempty] - 1]
        straddle = np.nonzero(nonempty & (first_sh != last_sh))[0]
        if len(straddle) > max(4 * ns, 64):
            # rows not point-clustered: per-shard pair locality is gone
            raise ValueError(
                "too many shard-straddling points for sharded explicit S"
            )
        straddle_set = set(straddle.tolist())

        # per-shard whole point lists (straddlers excluded)
        pts_per_shard = []
        for s in range(ns):
            in_s = nonempty & (first_sh == s) & (last_sh == s)
            pts_per_shard.append(np.nonzero(in_s)[0])
        p_max = max((len(p) for p in pts_per_shard), default=0)
        p_max = max(p_max, 1)
        self.p_max = p_max
        if ns * p_max * kp > 1.5 * pad_waste * 2.0 * max(n_valid, 1):
            raise ValueError("shard point imbalance too high for explicit S")

        grid_srcs = np.full((ns, p_max * kp), bs, dtype=np.int64)  # sentinel
        local_pt = np.zeros((ns, p_max), dtype=np.int64)
        swap_sh = np.zeros((ns, p_max, npairs), dtype=bool)
        valid_sh = np.zeros((ns, p_max, npairs), dtype=bool)
        per_shard_plans = []
        n_rows0 = p_max * npairs
        for s in range(ns):
            pts = pts_per_shard[s]
            local_pt[s, : len(pts)] = pts
            # rows of these points, in global sorted-by-point order
            grid_cam_s = np.full((p_max, kp), -1, dtype=np.int64)
            for j, p in enumerate(pts):
                rr = order[starts[p] : ends[p]]  # global row ids
                grid_srcs[s, j * kp : j * kp + len(rr)] = rr - s * bs
                grid_cam_s[j, : len(rr)] = cam_v[rr]
            swap_s, valid_s, pair_id_s = _pair_metadata(
                grid_cam_s, nc, iu, ju, self.cluster_of
            )
            swap_sh[s] = swap_s
            valid_sh[s] = valid_s
            rr = np.nonzero(pair_id_s >= 0)[0]
            per_shard_plans.append(
                _hierarchical_sum_plan(pair_id_s[rr], rr, n_rows0, cap=cap)
            )

        for lv, _ in per_shard_plans:
            _check_level0_waste(lv, n_rows0)
        stacked, shapes, n_last = _uniformize_shard_levels(
            per_shard_plans, n_rows0, cap
        )
        # placement level: global uniq row u <- this shard's local uniq row
        place = np.full((ns, self.n_uniq), n_last, dtype=np.int64)
        for s in range(ns):
            _, uniq_s = per_shard_plans[s]
            gpos = np.searchsorted(uniq, uniq_s)
            place[s, gpos] = np.arange(len(uniq_s))
        stacked.append(place.astype(np.int32))
        shapes.append((self.n_uniq, 1))

        axis = self.mesh.axis_names[0]
        shard2 = NamedSharding(self.mesh, P(axis))
        put = lambda a: jax.device_put(jnp.asarray(a), shard2)
        self.shard_level_srcs = [put(s_) for s_ in stacked]
        self.shard_level_shapes = shapes
        self.shard_grid_src = put(grid_srcs.astype(np.int32))
        self.shard_local_pt = put(local_pt.astype(np.int32))
        self.shard_swap = put(swap_sh)
        self.shard_valid = put(valid_sh)

        # -- straddle fixup (replicated, tiny) ------------------------------
        self.n_straddle = len(straddle)
        if self.n_straddle:
            st = straddle
            fix_rows = np.full((len(st), kp), n_valid, dtype=np.int64)
            grid_cam_f = np.full((len(st), kp), -1, dtype=np.int64)
            for j, p in enumerate(st):
                rr = order[starts[p] : ends[p]]
                fix_rows[j, : len(rr)] = rr
                grid_cam_f[j, : len(rr)] = cam_v[rr]
            swap_f, valid_f, pair_id_f = _pair_metadata(
                grid_cam_f, nc, iu, ju, self.cluster_of
            )
            rr = np.nonzero(pair_id_f >= 0)[0]
            levels_f, uniq_f = _hierarchical_sum_plan(
                pair_id_f[rr], rr, len(st) * npairs, cap=cap
            )
            # placement of fixup local uniq onto the global table
            n_last_f = levels_f[-1][1] if levels_f else 0
            place_f = np.full(self.n_uniq, n_last_f, dtype=np.int64)
            place_f[np.searchsorted(uniq, uniq_f)] = np.arange(len(uniq_f))
            levels_f.append((place_f, self.n_uniq, 1))
            self.fix_levels = _freeze_levels(levels_f)
            self.fix_swap = jnp.asarray(swap_f)
            self.fix_valid = jnp.asarray(valid_f)
            self.fix_pt = jnp.asarray(st.astype(np.int32))
            # per-shard local row index of each fixup grid slot (sentinel
            # bs): the fixup A-rows are collected INSIDE shard_map (each
            # shard contributes the rows it owns; psum combines) so no
            # cross-shard gather of the big sharded A array is ever needed
            fix_local = np.full((ns, len(st) * kp), bs, dtype=np.int64)
            fr = fix_rows.reshape(-1)
            own = fr < n_valid
            fsh = np.where(own, fr // bs, -1)
            for s in range(ns):
                mine = fsh == s
                fix_local[s, mine] = fr[mine] - s * bs
            self.fix_local_src = put(fix_local.astype(np.int32))

    # -- runtime -----------------------------------------------------------

    def build_grid(self, a_flat, chunk_points: Optional[int] = None):
        """mu-independent prep: lay the per-row A = F^T E rows onto the
        point grid(s). ``a_flat``: (B, f*e), row-sharded under a mesh.
        Returns a pytree consumed by :meth:`correction_offdiag` — hoist
        this to once-per-linearization (SchurSolver.prepare); rejected-step
        re-solves then pay only the cinv-dependent pair contraction."""
        d = a_flat.shape[1]
        if self.mesh is None:
            if self.grid_is_reshape:
                grid = a_flat[: self.np_ * self.kp].reshape(
                    self.np_, self.kp * d
                )
            else:
                zero = jnp.zeros((1, d), a_flat.dtype)
                grid = jnp.concatenate([a_flat, zero])[self.grid_src].reshape(
                    self.np_, self.kp * d
                )
            return {"grid": grid}

        from jax.sharding import PartitionSpec as P

        axis = self.mesh.axis_names[0]
        kp = self.kp

        if self.n_straddle:

            def body(a_l, src_l, fix_l):
                # a_l: this shard's (bs, d) rows; src/fix arrive (1, ...)
                z = jnp.zeros((1, d), a_l.dtype)
                padded = jnp.concatenate([a_l, z])
                g = padded[src_l[0]].reshape(self.p_max, kp * d)[None]
                fx = jax.lax.psum(padded[fix_l[0]], axis)
                return g, fx

            grid, fix = jax.shard_map(
                body,
                mesh=self.mesh,
                in_specs=(P(axis), P(axis), P(axis)),
                out_specs=(P(axis), P()),
            )(a_flat, self.shard_grid_src, self.fix_local_src)
            return {
                "grid": grid,
                "fix": fix.reshape(self.n_straddle, kp * d),
            }

        def body(a_l, src_l):
            z = jnp.zeros((1, d), a_l.dtype)
            padded = jnp.concatenate([a_l, z])
            return padded[src_l[0]].reshape(self.p_max, kp * d)[None]

        grid = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=P(axis),
        )(a_flat, self.shard_grid_src)
        return {"grid": grid}

    def _chunk_vals(self, args):
        """One chunk of the pair-product pipeline: point-grid A rows +
        per-point C^-1 -> flat-81 pair-product value rows. Flat 2D at every
        BOUNDARY: a materialized array with tiny trailing dims like (9, 3)
        may get a padded layout."""
        g_c, cinv_c, swap_c, valid_c = args
        f, e, kp = self.f, self.e, self.kp
        c = g_c.shape[0]
        a_c = g_c.reshape(c, kp, f, e)
        y_c = vpu_einsum("pkfe,peg->pkfg", a_c, cinv_c.reshape(c, e, e))
        ya = y_c[:, self.pair_k]  # (p, npair, f, e)
        ab = a_c[:, self.pair_l]
        t = vpu_einsum("pnfe,pnge->pnfg", ya, ab)
        # canonical (lo, hi) storage: transpose where cam_k > cam_l
        t = jnp.where(swap_c[:, :, None, None], jnp.swapaxes(t, 2, 3), t)
        t = jnp.where(valid_c[:, :, None, None], t, 0.0)
        return t.reshape(-1, f * f)

    def _pair_values(self, grid, cinv_rows, swap, valid):
        """(Pn, kp*f*e) grid -> (Pn*npairs, f*f) f-major pair values, streamed in
        bounded point chunks (lax.map) so transients cannot balloon even if
        XLA materializes a chunk's intermediates."""
        f = self.f
        pn = grid.shape[0]
        cp = self.chunk_points
        if pn <= cp:
            return self._chunk_vals((grid, cinv_rows, swap, valid))
        nch = -(-pn // cp)
        pad = nch * cp - pn
        grid = jnp.pad(grid, ((0, pad), (0, 0)))
        cinv_rows = jnp.pad(cinv_rows, ((0, pad), (0, 0)))
        swap = jnp.pad(swap, ((0, pad), (0, 0)))
        valid = jnp.pad(valid, ((0, pad), (0, 0)))
        vals = jax.lax.map(
            self._chunk_vals,
            (
                grid.reshape(nch, cp, -1),
                cinv_rows.reshape(nch, cp, -1),
                swap.reshape(nch, cp, -1),
                valid.reshape(nch, cp, -1),
            ),
        ).reshape(-1, f * f)
        return vals[: pn * self.npairs]

    def correction_offdiag(self, grid, cinv_flat):
        """sum over points of Y_pk A_pl^T for k < l, reduced to the unique
        camera-pair blocks: returns flat (n_uniq, f*f) rows.

        grid:      pytree from :meth:`build_grid` (mu-independent);
        cinv_flat: (P, e*e) flat (replicated under a mesh).
        """
        if self.n_uniq == 0 or self.npairs == 0:
            return jnp.zeros((self.n_uniq, self.f * self.f), cinv_flat.dtype)
        if self.mesh is None:
            vals = self._pair_values(
                grid["grid"],
                cinv_flat,
                self.swap_mask,
                self.pair_valid,
            )
            return _apply_hierarchical_sum(self.levels, vals)

        from jax.sharding import PartitionSpec as P

        axis = self.mesh.axis_names[0]
        f = self.f

        def body(g_l, pt_l, swap_l, valid_l, cinv, *srcs):
            cinv_rows = cinv[pt_l[0]]
            vals = self._pair_values(
                g_l[0], cinv_rows, swap_l[0], valid_l[0]
            )
            cur = vals
            for src, (n_dest, cap) in zip(srcs, self.shard_level_shapes):
                zero = jnp.zeros((1, cur.shape[1]), cur.dtype)
                g = jnp.concatenate([cur, zero])[src[0]]
                cur = g.reshape(n_dest, cap, -1).sum(axis=1)
            return jax.lax.psum(cur, axis)

        uniq = jax.shard_map(
            body,
            mesh=self.mesh,
            in_specs=(P(axis),) * 4 + (P(),) + (P(axis),) * len(
                self.shard_level_srcs
            ),
            out_specs=P(),
        )(
            grid["grid"],
            self.shard_local_pt,
            self.shard_swap,
            self.shard_valid,
            cinv_flat,
            *self.shard_level_srcs,
        )

        if self.n_straddle:
            vals = self._pair_values(
                grid["fix"],
                cinv_flat[self.fix_pt],
                self.fix_swap,
                self.fix_valid,
            )
            uniq = uniq + _apply_hierarchical_sum(self.fix_levels, vals)
        return uniq

    def cluster_offdiag(self, uniq_flat, chunk_cams: int = 1024):
        """Batched (n_clusters, cs*f, cs*f) off-diagonal correction blocks
        from the (intra-cluster-restricted) unique-pair table — the
        CLUSTER_JACOBI preconditioner's matrices. Same gather-build idiom
        as :meth:`dense_s_offdiag`, rearranged per cluster; rows/cols of
        padded cluster slots are zero."""
        ncl, cs, f = self.n_clusters, self.cluster_slot_size, self.f
        zero = jnp.zeros((1, f * f), uniq_flat.dtype)
        padded = jnp.concatenate([uniq_flat, zero])
        b81 = padded[self.cluster_map_u] + padded[self.cluster_map_l][
            :, self.perm_t
        ]  # (ncl*cs*cs, f*f), 2D throughout

        rows = ncl * cs
        g = b81.reshape(rows, cs * f * f)
        cch = min(chunk_cams, rows)
        nch = -(-rows // cch)
        pad = nch * cch - rows
        if pad:
            g = jnp.pad(g, ((0, pad), (0, 0)))

        def rearr(blk):  # (cch, cs*f*f) -> (cch*f, cs*f)
            return (
                blk.reshape(cch, cs, f, f)
                .swapaxes(1, 2)
                .reshape(cch * f, cs * f)
            )

        out = jax.lax.map(rearr, g.reshape(nch, cch, cs * f * f))
        out = out.reshape(nch * cch * f, cs * f)[: rows * f]
        return out.reshape(ncl, cs * f, cs * f)

    def cluster_band_offdiag(self, uniq_flat, chunk_cams: int = 1024):
        """Batched (n_clusters-1, cs*f, cs*f) CORRECTION blocks coupling
        cluster c (rows) to cluster c+1 (cols) — the CLUSTER_TRIDIAGONAL
        band. Same gather-build idiom as :meth:`cluster_offdiag` over the
        band block maps; requires the plan built with
        ``cluster_band=True``."""
        assert self.band_map_u is not None, "plan built without cluster_band"
        ncl, cs, f = self.n_clusters, self.cluster_slot_size, self.f
        zero = jnp.zeros((1, f * f), uniq_flat.dtype)
        padded = jnp.concatenate([uniq_flat, zero])
        b81 = padded[self.band_map_u] + padded[self.band_map_l][
            :, self.perm_t
        ]  # ((ncl-1)*cs*cs, f*f)

        rows = (ncl - 1) * cs
        g = b81.reshape(rows, cs * f * f)
        cch = min(chunk_cams, rows)
        nch = -(-rows // cch)
        pad = nch * cch - rows
        if pad:
            g = jnp.pad(g, ((0, pad), (0, 0)))

        def rearr(blk):  # (cch, cs*f*f) -> (cch*f, cs*f)
            return (
                blk.reshape(cch, cs, f, f)
                .swapaxes(1, 2)
                .reshape(cch * f, cs * f)
            )

        out = jax.lax.map(rearr, g.reshape(nch, cch, cs * f * f))
        out = out.reshape(nch * cch * f, cs * f)[: rows * f]
        return out.reshape(ncl - 1, cs * f, cs * f)

    def dense_s_full(self, uniq_flat, diag_flat, chunk_cams: int = 127):
        """One-pass gather-build of the FULL (nc*f, nc*f) correction-plus-
        diagonal matrix: the per-camera diagonal blocks ride as an
        appended table region, so the caller needs neither a
        scatter-add for the diagonal nor a full-matrix symmetrize pass
        (the off-diagonal is exactly symmetric by construction — entry
        (a, b) and (b, a) read the SAME table row, one statically
        permuted). The combined table [uniq | uniq^T | diag | zero] +
        ``pos2u_combined`` makes it ONE gather per position — the block
        transpose is paid once on the small table, not on the (nc*nc, 81)
        position array — and the gather is folded into the chunked
        rearrange so the block-row intermediate never materializes."""
        zero = jnp.zeros((1, self.f * self.f), uniq_flat.dtype)
        up = jnp.concatenate([uniq_flat, zero])
        # fold same-camera pair corrections (both read directions) into
        # the appended diagonal region
        cc = up[self.diag_pair_idx]
        diag_region = cc + cc[:, self.perm_t] + diag_flat
        combined = jnp.concatenate(
            [uniq_flat, uniq_flat[:, self.perm_t], diag_region, zero]
        )
        return self._rearrange_dense(combined, chunk_cams)

    def dense_s_offdiag(self, uniq_flat, chunk_cams: int = 127):
        """Gather-build the (nc*f, nc*f) off-diagonal correction from the
        unique pair blocks (``uniq_flat``: (n_uniq, f*f) flat rows) via
        the same single-gather combined table as :meth:`dense_s_full`,
        with a zero diagonal contribution beyond the same-camera pair
        fold."""
        zero = jnp.zeros((1, self.f * self.f), uniq_flat.dtype)
        up = jnp.concatenate([uniq_flat, zero])
        cc = up[self.diag_pair_idx]
        diag_region = cc + cc[:, self.perm_t]
        combined = jnp.concatenate(
            [uniq_flat, uniq_flat[:, self.perm_t], diag_region, zero]
        )
        return self._rearrange_dense(combined, chunk_cams)

    def _rearrange_dense(self, table, chunk_cams):
        """Combined-table rows -> the dense (nc*f, nc*f) matrix, in
        camera chunks (the full (nc, nc, f, f) intermediate is 1 GB at
        venice before any layout padding). The per-position gather happens
        INSIDE each chunk so the (nc*nc, f*f) block-row array never
        materializes: per chunk, read the (cache-resident) table, write
        the final layout."""
        nc, f = self.nc, self.f
        cch = min(chunk_cams, nc)
        nch = -(-nc // cch)
        pad = nch * cch - nc
        pm = self.pos2u_combined.reshape(nc, nc)
        if pad:
            zrow = jnp.full(
                (pad, nc), table.shape[0] - 1, self.pos2u_combined.dtype
            )
            pm = jnp.concatenate([pm, zrow])

        def rearr(idx):  # (cch, nc) position ids -> (cch*f, nc*f)
            g = table[idx.reshape(-1)]  # (cch*nc, f*f)
            return (
                g.reshape(cch, nc, f, f)
                .swapaxes(1, 2)
                .reshape(cch * f, nc * f)
            )

        s = jax.lax.map(rearr, pm.reshape(nch, cch, nc))
        return s.reshape(nch * cch * f, nc * f)[: nc * f]
