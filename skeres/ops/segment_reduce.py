"""Scatter-free segment reduction plans.

All normal-equation assembly in this framework is "sum per-row block
contributions by destination block id" (the reference does it with
lock-guarded scatter into a BlockSparseMatrix /
BlockRandomAccessDenseMatrix; see ``internal/ceres/block_jacobian_writer.cc``,
``schur_eliminator_impl.h``). ``.at[idx].add`` lowers to a scatter whose
cost depends on the backend and on index collisions. The destination
index arrays are **static** (they come from the problem
structure, frozen at compile), so the reduction strategy can be planned on
the host once:

  'onehot'  — few destination blocks: one-hot matmul.
  'gather'  — many destinations with bounded fan-in: precompute the
              CSR-by-destination layout ``slots (n_dest, K)`` and reduce by
              gather + masked sum (no write collisions).
  'scatter' — fallback.

Values rows must already be zero for padded/invalid rows; every plan then
produces identical results to the scatter.

Under SPMD (mesh set), a *sharded* plan keeps the scatter-free strategy:
inside ``shard_map`` each shard runs its own LOCAL gather plan — the plan
arrays are stacked per shard and sharded along with the values, so every
shard gathers only its local rows into a windowed [lo, lo+R) slice of the
destination range — then the windowed partials are placed with
``dynamic_update_slice`` and combined with ONE ``psum`` (the SURVEY §3.8
"psum of J^T J contributions" design; this is what the reference's
lock-guarded scatter becomes on a device mesh). Which plan is fastest on
the GPU has not been measured yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ReducePlan",
    "build_reduce_plan",
    "apply_reduce_plan",
    "ShardedReducePlan",
    "build_sharded_reduce_plan",
    "apply_sharded_reduce_plan",
]

# one-hot transient is (B, n_dest): cap its element count
ONEHOT_LIMIT = 1 << 24
# padded gather layout is (n_dest, K): cap the padding blow-up vs B rows
GATHER_WASTE = 4.0


class ReducePlan(NamedTuple):
    kind: str  # 'contig' | 'onehot' | 'gather' | 'scatter'
    n_dest: int
    idx: Optional[jnp.ndarray]  # (B,) destination ids ('onehot'/'scatter')
    slots: Optional[jnp.ndarray]  # (n_dest, K) row ids ('gather')
    mask: Optional[jnp.ndarray]  # (n_dest, K) 1/0 ('gather')
    k: int = 0  # uniform rows-per-destination ('contig')


def build_reduce_plan(
    idx_np: np.ndarray,
    n_dest: int,
    force_scatter: bool = False,
    onehot_limit: int = ONEHOT_LIMIT,
    gather_waste: float = GATHER_WASTE,
    n_valid: Optional[int] = None,
) -> ReducePlan:
    """``n_valid``: number of REAL rows; rows >= n_valid are evaluator
    padding whose values are guaranteed zero (``jac * weight`` /
    ``r * weight`` in evaluator.py), so a plan may drop them."""
    idx_np = np.asarray(idx_np, dtype=np.int64)
    b = len(idx_np)
    if n_valid is None:
        n_valid = b
    if force_scatter or b == 0:
        return ReducePlan("scatter", n_dest, jnp.asarray(idx_np, jnp.int32), None, None)
    counts = np.bincount(idx_np, minlength=n_dest)
    k = int(counts.max()) if n_dest else 0
    # 'contig': the valid rows' destination ids are exactly
    # repeat(arange(n_dest), k) (zero-value pad tail dropped — exact). The
    # reduction becomes reshape+sum, which XLA fuses into the producer:
    # no gather, and the (B, D) operand is never materialized in a
    # padded layout for its tiny trailing dim. This is the common BAL shape
    # (observations grouped by point).
    if n_dest > 0 and n_valid > 0 and n_valid % n_dest == 0:
        kc = n_valid // n_dest
        if np.array_equal(
            idx_np[:n_valid],
            np.repeat(np.arange(n_dest, dtype=np.int64), kc),
        ):
            return ReducePlan("contig", n_dest, None, None, None, kc)
    if b * n_dest <= onehot_limit:
        return ReducePlan("onehot", n_dest, jnp.asarray(idx_np, jnp.int32), None, None)
    if n_dest * max(k, 1) <= gather_waste * b:
        order = np.argsort(idx_np, kind="stable")
        sorted_idx = idx_np[order]
        starts = np.searchsorted(sorted_idx, np.arange(n_dest))
        pos = np.arange(b) - starts[sorted_idx]
        slots = np.zeros((n_dest, k), np.int32)
        mask = np.zeros((n_dest, k), np.float32)
        slots[sorted_idx, pos] = order
        mask[sorted_idx, pos] = 1.0
        return ReducePlan(
            "gather", n_dest, None, jnp.asarray(slots), jnp.asarray(mask)
        )
    return ReducePlan("scatter", n_dest, jnp.asarray(idx_np, jnp.int32), None, None)


def apply_reduce_plan(plan: ReducePlan, values) -> jnp.ndarray:
    """``values (B, D)`` summed by destination -> ``(n_dest, D)``."""
    if plan.kind == "contig":
        valid = plan.n_dest * plan.k
        return values[:valid].reshape(plan.n_dest, plan.k, -1).sum(axis=1)
    if plan.kind == "onehot":
        oh = (
            plan.idx[:, None] == jnp.arange(plan.n_dest, dtype=plan.idx.dtype)
        ).astype(values.dtype)
        return jnp.einsum("bg,bd->gd", oh, values)
    if plan.kind == "gather":
        gathered = values[plan.slots] * plan.mask[..., None].astype(values.dtype)
        return jnp.sum(gathered, axis=1)
    return jnp.zeros((plan.n_dest, values.shape[1]), values.dtype).at[plan.idx].add(
        values
    )


# ---------------------------------------------------------------------------
# SPMD (shard_map) plans
# ---------------------------------------------------------------------------


class ShardedReducePlan(NamedTuple):
    kind: str  # 'spmd_contig' | 'spmd_onehot' | 'spmd_gather'
    n_dest: int
    n_shards: int
    window: int  # R: destination-window width each shard reduces into
    lo: jnp.ndarray  # (n_shards,) window start per shard
    idx: Optional[jnp.ndarray]  # (B,) window-local dest ids ('spmd_onehot')
    slots: Optional[jnp.ndarray]  # (n_shards, R, K) local row ids ('spmd_gather')
    mask: Optional[jnp.ndarray]  # (n_shards, R, K)
    k: int = 0  # uniform rows-per-destination ('spmd_contig')


def build_sharded_reduce_plan(
    idx_np: np.ndarray,
    n_dest: int,
    n_shards: int,
    onehot_limit: int = ONEHOT_LIMIT,
    n_valid: Optional[int] = None,
) -> ShardedReducePlan:
    """Plan a per-shard local reduction. Rows are split contiguously into
    ``n_shards`` equal shards (the evaluator pads batches to a multiple of
    the shard count). Each shard reduces its rows into the window
    [lo_s, lo_s + R) of destination ids it actually touches — R is the max
    window over shards, so when destination ids are clustered (BAL points:
    observations are grouped by point) per-shard work stays ~local even
    though the accumulator is replicated."""
    idx_np = np.asarray(idx_np, dtype=np.int64)
    b = len(idx_np)
    assert b % n_shards == 0, (b, n_shards)
    bs = b // n_shards
    parts = idx_np.reshape(n_shards, bs)

    # 'spmd_contig': unpadded uniform repeat pattern whose per-shard row
    # slice covers a contiguous aligned destination window — each shard's
    # reduction is a fused reshape+sum into its window, no gather.
    if (
        (n_valid is None or n_valid == b)
        and n_dest > 0
        and b % n_dest == 0
    ):
        kc = b // n_dest
        if bs % kc == 0 and np.array_equal(
            idx_np, np.repeat(np.arange(n_dest, dtype=np.int64), kc)
        ):
            window = bs // kc
            los = np.arange(n_shards, dtype=np.int64) * window
            return ShardedReducePlan(
                "spmd_contig",
                n_dest,
                n_shards,
                window,
                jnp.asarray(los, jnp.int32),
                None,
                None,
                None,
                kc,
            )

    los = parts.min(axis=1)
    his = parts.max(axis=1)
    window = int((his - los + 1).max())
    window = min(window, n_dest)
    # clamp so lo + window <= n_dest (windows may then overlap; psum sums)
    los = np.minimum(los, n_dest - window)

    local_ids = parts - los[:, None]  # (n_shards, bs) in [0, window)

    if bs * window <= onehot_limit:
        return ShardedReducePlan(
            "spmd_onehot",
            n_dest,
            n_shards,
            window,
            jnp.asarray(los, jnp.int32),
            jnp.asarray(local_ids.reshape(-1), jnp.int32),
            None,
            None,
        )

    # per-shard CSR-by-destination gather layout, padded to the max fan-in
    k = 1
    slot_list, mask_list = [], []
    ks = []
    for s in range(n_shards):
        counts = np.bincount(local_ids[s], minlength=window)
        ks.append(int(counts.max()) if window else 0)
    k = max(1, max(ks))
    for s in range(n_shards):
        ids = local_ids[s]
        order = np.argsort(ids, kind="stable")
        sorted_ids = ids[order]
        starts = np.searchsorted(sorted_ids, np.arange(window))
        pos = np.arange(bs) - starts[sorted_ids]
        slots = np.zeros((window, k), np.int32)
        mask = np.zeros((window, k), np.float32)
        slots[sorted_ids, pos] = order
        mask[sorted_ids, pos] = 1.0
        slot_list.append(slots)
        mask_list.append(mask)
    return ShardedReducePlan(
        "spmd_gather",
        n_dest,
        n_shards,
        window,
        jnp.asarray(los, jnp.int32),
        None,
        jnp.asarray(np.stack(slot_list)),
        jnp.asarray(np.stack(mask_list)),
    )


def apply_sharded_reduce_plan(plan: ShardedReducePlan, values, mesh, axis: str):
    """``values (B, D)`` (sharded over rows) summed by destination ->
    replicated ``(n_dest, D)``: local windowed reduce + one psum."""
    from jax.sharding import PartitionSpec as P

    d = values.shape[-1]

    if plan.kind == "spmd_contig":

        def body(vals, lo):
            local = vals.reshape(plan.window, plan.k, d).sum(axis=1)
            out = jnp.zeros((plan.n_dest, d), vals.dtype)
            out = jax.lax.dynamic_update_slice(
                out, local, (lo[0], jnp.zeros((), lo.dtype))
            )
            return jax.lax.psum(out, axis)

        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=P(),
        )(values, plan.lo)

    if plan.kind == "spmd_onehot":

        def body(vals, ids, lo):
            oh = (
                ids[:, None] == jnp.arange(plan.window, dtype=ids.dtype)
            ).astype(vals.dtype)
            local = jnp.einsum("bg,bd->gd", oh, vals)  # (R, D)
            out = jnp.zeros((plan.n_dest, d), vals.dtype)
            out = jax.lax.dynamic_update_slice(
                out, local, (lo[0], jnp.zeros((), lo.dtype))
            )
            return jax.lax.psum(out, axis)

        return jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis)),
            out_specs=P(),
        )(values, plan.idx, plan.lo)

    def body(vals, slots, mask, lo):
        gathered = vals[slots[0]] * mask[0][..., None].astype(vals.dtype)
        local = jnp.sum(gathered, axis=1)  # (R, D)
        out = jnp.zeros((plan.n_dest, d), vals.dtype)
        out = jax.lax.dynamic_update_slice(
                out, local, (lo[0], jnp.zeros((), lo.dtype))
            )
        return jax.lax.psum(out, axis)

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
    )(values, plan.slots, plan.mask, plan.lo)
