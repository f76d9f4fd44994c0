"""Reduce-plan equivalence: every plan kind must produce the identical
segment sum. The 'contig' kinds (reshape+sum for repeat(arange(n), k)
destination ids — the BAL observations-grouped-by-point shape) are pinned
against the generic gather plan, including the zero-value evaluator pad
tail and the SPMD variant.

Reference: the lock-guarded scatter in ``internal/ceres/
block_jacobian_writer.cc`` that all of these replace.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from skeres.ops.segment_reduce import (
    ReducePlan,
    ShardedReducePlan,
    apply_reduce_plan,
    apply_sharded_reduce_plan,
    build_reduce_plan,
    build_sharded_reduce_plan,
)


def _oracle(idx, values, n_dest):
    out = np.zeros((n_dest, values.shape[1]), np.float64)
    np.add.at(out, idx, np.asarray(values, np.float64))
    return out


def test_contig_plan_selected_and_exact():
    n_dest, k, d = 1000, 5, 15
    idx = np.repeat(np.arange(n_dest), k)
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(n_dest * k, d)).astype(np.float32)
    # force past the onehot limit so contig is tested on its own merits
    plan = build_reduce_plan(idx, n_dest, onehot_limit=1)
    assert plan.kind == "contig" and plan.k == k
    got = apply_reduce_plan(plan, jnp.asarray(vals))
    np.testing.assert_allclose(got, _oracle(idx, vals, n_dest), rtol=1e-5, atol=1e-5)


def test_contig_plan_drops_zero_pad_tail():
    n_dest, k, d, pad = 64, 3, 4, 7
    idx_valid = np.repeat(np.arange(n_dest), k)
    # evaluator padding replicates row 0's idx; values there are zeroed
    idx = np.concatenate([idx_valid, np.full(pad, idx_valid[0])])
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(len(idx), d)).astype(np.float32)
    vals[n_dest * k :] = 0.0
    plan = build_reduce_plan(
        idx, n_dest, onehot_limit=1, n_valid=n_dest * k
    )
    assert plan.kind == "contig" and plan.k == k
    got = apply_reduce_plan(plan, jnp.asarray(vals))
    np.testing.assert_allclose(got, _oracle(idx, vals, n_dest), rtol=1e-5, atol=1e-5)


def test_contig_not_selected_without_n_valid_on_padded_idx():
    """Without the pad-row guarantee the pattern check must fail closed."""
    n_dest, k = 64, 3
    idx_valid = np.repeat(np.arange(n_dest), k)
    idx = np.concatenate([idx_valid, np.full(5, idx_valid[0])])
    plan = build_reduce_plan(idx, n_dest, onehot_limit=1)
    assert plan.kind != "contig"


def test_contig_not_selected_for_unsorted_idx():
    n_dest, k = 64, 3
    idx = np.repeat(np.arange(n_dest), k)
    rng = np.random.default_rng(2)
    rng.shuffle(idx)
    plan = build_reduce_plan(idx, n_dest, onehot_limit=1)
    assert plan.kind != "contig"
    vals = rng.normal(size=(len(idx), 6)).astype(np.float32)
    got = apply_reduce_plan(plan, jnp.asarray(vals))
    np.testing.assert_allclose(got, _oracle(idx, vals, n_dest), rtol=1e-5, atol=1e-5)


def test_spmd_contig_matches_oracle():
    n_devices = len(jax.devices())
    if n_devices < 2:
        pytest.skip("needs a multi-device mesh")
    from jax.sharding import Mesh

    n_shards = n_devices
    n_dest, k, d = 16 * n_shards, 4, 5
    idx = np.repeat(np.arange(n_dest), k)
    plan = build_sharded_reduce_plan(
        idx, n_dest, n_shards, onehot_limit=1, n_valid=len(idx)
    )
    assert plan.kind == "spmd_contig" and plan.k == k
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(len(idx), d)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()), ("obs",))
    got = jax.jit(
        lambda v: apply_sharded_reduce_plan(plan, v, mesh, "obs")
    )(jnp.asarray(vals))
    np.testing.assert_allclose(got, _oracle(idx, vals, n_dest), rtol=1e-5, atol=1e-5)


def test_spmd_contig_rejected_when_shard_straddles_dest():
    """bs % k != 0 would split one destination across shards — must fall
    back to a windowed plan, which stays exact."""
    n_devices = len(jax.devices())
    if n_devices < 2:
        pytest.skip("needs a multi-device mesh")
    from jax.sharding import Mesh

    n_shards = n_devices
    k = 3
    n_dest = 8 * n_shards + 1  # total rows not divisible cleanly
    idx = np.repeat(np.arange(n_dest), k)
    pad = (-len(idx)) % n_shards
    idx = np.concatenate([idx, np.full(pad, idx[0])])
    plan = build_sharded_reduce_plan(idx, n_dest, n_shards, n_valid=len(idx) - pad)
    assert plan.kind != "spmd_contig"
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(len(idx), 4)).astype(np.float32)
    vals[len(idx) - pad :] = 0.0
    mesh = Mesh(np.array(jax.devices()), ("obs",))
    got = jax.jit(
        lambda v: apply_sharded_reduce_plan(plan, v, mesh, "obs")
    )(jnp.asarray(vals))
    np.testing.assert_allclose(got, _oracle(idx, vals, n_dest), rtol=1e-5, atol=1e-5)
