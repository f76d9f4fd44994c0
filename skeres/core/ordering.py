"""Schur elimination-ordering discovery.

Counterpart of the reference lineage's ordering machinery
(``internal/ceres/reorder_program.cc`` ComputeStableSchurOrdering,
``parameter_block_ordering.cc`` ComputeSchurOrdering /
IndependentSetOrdering, ``graph_algorithms.h``): when the user has not
declared which parameter blocks to eliminate, find them automatically.

The batched structure makes this *group-level*: parameter blocks live in
typed group arrays, and residual batches connect groups through slots
(SURVEY.md §3.3 "declared, not discovered" is the preferred path — this
module is the automatic fallback for reference parity). A group is an
**independent set** exactly when

  1. no residual batch has two slots in the group (no residual couples two
     of its blocks directly), and
  2. within every batch touching the group, each block of the group is
     referenced by rows that reference it alone among the group (true by
     construction: one slot -> one block per row).

Condition 1 is the per-row counterpart of the reference's pairwise
independence (the greedy maximum-independent-set over the Hessian graph);
rows ARE the hyperedges of that graph here. Among independent groups we
eliminate the one with the most parameter blocks — the same heuristic as
the reference (points vastly outnumber cameras).
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["independent_groups", "compute_schur_ordering", "apply_schur_ordering"]


def independent_groups(program) -> List[int]:
    """Indices of groups that form independent sets (eliminable)."""
    out = []
    for gi in range(len(program.groups)):
        ok = True
        touched = False
        for b in program.batches:
            slots = [s for s, g in enumerate(b.slot_groups) if g == gi]
            if len(slots) > 1:
                ok = False
                break
            if slots:
                touched = True
        if ok and touched:
            out.append(gi)
    return out


def compute_schur_ordering(program) -> Optional[int]:
    """The group to eliminate: the largest independent group by block
    count, or None when no group qualifies (reference:
    ComputeStableSchurOrdering's independent set first, everything else
    second)."""
    candidates = independent_groups(program)
    if not candidates:
        return None
    # never eliminate everything: at least one group must be retained —
    # retain the SMALLEST candidate (cameras), keep the rest eliminable
    if len(candidates) == len(program.groups):
        candidates = sorted(
            candidates, key=lambda gi: program.groups[gi].num_blocks
        )[1:]
        if not candidates:
            return None
    return max(candidates, key=lambda gi: program.groups[gi].num_blocks)


def apply_schur_ordering(program) -> Optional[int]:
    """Tag the discovered group as eliminated (schur_group=0) and the rest
    as retained; returns the eliminated group index or None."""
    gi = compute_schur_ordering(program)
    if gi is None:
        return None
    for j, g in enumerate(program.groups):
        g.schur_group = 0 if j == gi else 1
    return gi
