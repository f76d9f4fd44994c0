"""Tiny-contraction einsums as broadcast-multiply-sum.

The block dimensions of a NLLS problem are tiny (residual m=2, point e=3,
camera f=9-12). ``jnp.einsum`` lowers contractions to batched
dot_generals sized for matrix units, which the tiny dims cannot fill.
``vpu_einsum`` computes the same contraction as a broadcast multiply +
axis sum, which XLA fuses into one elementwise loop over the big batch
axis.

Use it when every CONTRACTED dimension is tiny and the batch axis is
large; keep ``jnp.einsum`` when the contraction itself is deep (e.g. the
dense-W correction contracting over all points).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["vpu_einsum"]


def vpu_einsum(spec: str, a, b):
    """Two-operand einsum via broadcast-multiply-sum (no dot_general).

    Restrictions (all satisfied by this codebase's block algebra): exactly
    two operands, no repeated index within one operand, no ellipsis.
    """
    ins, out = spec.replace(" ", "").split("->")
    ia, ib = ins.split(",")
    order = []
    for ch in ia + ib:
        if ch not in order:
            order.append(ch)

    def expand(x, idx):
        perm = sorted(range(len(idx)), key=lambda i: order.index(idx[i]))
        if perm != list(range(len(idx))):
            x = jnp.transpose(x, perm)
        present = [idx[i] for i in perm]
        shape = []
        k = 0
        for ch in order:
            if ch in present:
                shape.append(x.shape[k])
                k += 1
            else:
                shape.append(1)
        return x.reshape(shape)

    prod = expand(a, ia) * expand(b, ib)
    sum_axes = tuple(i for i, ch in enumerate(order) if ch not in out)
    res = jnp.sum(prod, axis=sum_axes) if sum_axes else prod
    rem = [ch for ch in order if ch in out]
    perm = [rem.index(ch) for ch in out]
    if perm != list(range(len(rem))):
        res = jnp.transpose(res, perm)
    return res
