"""Problem construction and the compiled Program.

JAX re-design of the reference lineage's Problem/Program layer
(``internal/ceres/problem_impl.cc``, ``program.cc``): instead of a
pointer-keyed registry of heap parameter blocks and a per-block virtual
``ResidualBlock::Evaluate``, parameters live in typed arrays (one
``(num_blocks, block_size)`` array per *parameter group*) and residual
blocks are grouped by ``(residual_fn, loss, param-group signature)`` into
homogeneous *batches* that evaluate as single vmapped jitted programs.

A residual function is a pure JAX function

    fn(params: tuple[jnp.ndarray, ...], data) -> jnp.ndarray  # (m,)

where ``params`` holds one ambient-space vector per parameter slot and
``data`` is an arbitrary pytree of per-residual-block constants (e.g. an
observation). Jacobians are never written by the user: the evaluator
differentiates ``fn(manifold.plus(x, delta), ...)`` at ``delta = 0`` with
``jax.linearize``, which yields tangent-space Jacobians directly.

``Problem.compile()`` freezes everything into a ``Program``: contiguous
tangent offsets per block, per-batch gather indices, constancy masks — the
counterpart of the reference's reduced-program/preprocess step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import jax

from skeres.models.manifolds import EuclideanManifold, Manifold
from skeres.ops.loss import LossFunction

__all__ = [
    "Problem",
    "ParameterBlock",
    "ParameterBlockArray",
    "Program",
    "ResidualBlockId",
]


class ParameterBlockArray:
    """A homogeneous array of parameter blocks: values (n, size), one manifold."""

    def __init__(self, problem: "Problem", group_index: int):
        self._problem = problem
        self.group_index = group_index

    @property
    def _group(self):
        return self._problem._groups[self.group_index]

    @property
    def values(self) -> np.ndarray:
        return self._group.values

    @values.setter
    def values(self, v):
        g = self._group
        v = np.asarray(v, dtype=np.float64)
        assert v.shape == g.values.shape
        g.values = v

    @property
    def size(self) -> int:
        return self._group.size

    def __len__(self):
        return self._group.values.shape[0]

    def __getitem__(self, i: int) -> "ParameterBlock":
        n = len(self)
        if not -n <= i < n:
            raise IndexError(i)
        return ParameterBlock(self._problem, self.group_index, i % n)


class ParameterBlock:
    """Handle to one parameter block: a row of a group's value array."""

    def __init__(self, problem: "Problem", group_index: int, row: int):
        self._problem = problem
        self.group_index = group_index
        self.row = row

    @property
    def _group(self):
        return self._problem._groups[self.group_index]

    @property
    def value(self) -> np.ndarray:
        return self._group.values[self.row]

    @value.setter
    def value(self, v):
        self._group.values[self.row] = np.asarray(v, dtype=np.float64)

    @property
    def size(self) -> int:
        return self._group.size

    @property
    def array(self) -> "ParameterBlockArray":
        """The group this block belongs to, as an array handle (for bulk
        residual adds referencing this block by row index)."""
        return ParameterBlockArray(self._problem, self.group_index)


@dataclasses.dataclass
class _Group:
    """Internal: one parameter group = typed array of blocks sharing a manifold."""

    name: str
    size: int
    manifold: Manifold
    values: np.ndarray  # (n, size) float64 master copy (host)
    constant: List[bool] = dataclasses.field(default_factory=list)
    lower: Optional[np.ndarray] = None  # (n, size) or None
    upper: Optional[np.ndarray] = None
    # elimination group for Schur ordering: 0 = eliminated (points),
    # 1 = retained (cameras); None = not set
    schur_group: Optional[int] = None

    @property
    def tangent_size(self) -> int:
        return self.manifold.tangent_size

    @property
    def num_blocks(self) -> int:
        return self.values.shape[0]


@dataclasses.dataclass
class _BatchSpec:
    """Internal: residual blocks grouped by (fn, loss, group signature)."""

    fn: Callable
    loss: Optional[LossFunction]
    slot_groups: Tuple[int, ...]  # group index per parameter slot
    slot_indices: List[List[int]]  # per slot: block row per residual block
    data_rows: List[Any]  # per residual block: data pytree (or None)
    name: str = ""
    # per residual block: the id handed out by add_residual_block (None for
    # bulk batches, which are not individually removable)
    row_ids: Optional[List[int]] = None
    # differentiate by central differences instead of jax.linearize
    # (reference: NumericDiffCostFunction) — for residual fns whose AD
    # derivative is wrong/undefined (custom_jvp-less external calls via
    # pure_callback, table lookups, stop_gradient'ed terms)
    numeric_diff: bool = False
    numeric_diff_step: float = 1e-6
    # "central" | "forward" | "ridders" (reference: NumericDiffMethodType)
    numeric_diff_method: str = "central"


class ResidualBlockId:
    """Opaque handle returned by ``add_residual_block`` (reference:
    ``Problem::ResidualBlockId``); pass to ``remove_residual_block``."""

    __slots__ = ("_rid",)

    def __init__(self, rid: int):
        self._rid = rid

    def __repr__(self):
        return f"ResidualBlockId({self._rid})"


@dataclasses.dataclass
class CompiledBatch:
    """One homogeneous residual batch, frozen for the evaluator."""

    fn: Callable
    loss: Optional[LossFunction]
    slot_groups: Tuple[int, ...]
    slot_indices: Tuple[np.ndarray, ...]  # per slot (B,) int32
    data: Any  # pytree stacked along axis 0 (leaves (B, ...)) or None
    num_blocks: int
    residual_dim: int
    tangent_sizes: Tuple[int, ...]  # per slot
    block_tangent_size: int  # sum of tangent sizes
    # (B, T_block) int32: global tangent index of each local tangent coord
    tangent_index: np.ndarray
    name: str = ""
    numeric_diff: bool = False
    numeric_diff_step: float = 1e-6
    numeric_diff_method: str = "central"
    # per row: the ResidualBlockId handed out by add_residual_block (None
    # for bulk batches) — lets solver components map user-tagged residual
    # blocks (e.g. residual_blocks_for_subset_preconditioner) to rows
    row_ids: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass
class Program:
    """The frozen problem: counterpart of the reference's reduced Program."""

    groups: List[_Group]
    batches: List[CompiledBatch]
    tangent_offset: List[int]  # per group, offset of block 0's tangent span
    num_tangent: int  # N: total tangent dimension (incl. constant blocks)
    free_mask: np.ndarray  # (N,) 1.0 free / 0.0 constant coordinate
    num_parameters: int
    num_effective_parameters: int
    num_parameter_blocks: int
    num_residual_blocks: int
    num_residuals: int
    num_parameters_reduced: int
    num_effective_parameters_reduced: int
    num_parameter_blocks_reduced: int
    has_bounds: bool

    def initial_state(self, dtype) -> tuple:
        """State pytree: tuple of (n, size) device arrays, one per group."""
        import jax.numpy as jnp

        return tuple(jnp.asarray(g.values, dtype=dtype) for g in self.groups)

    def write_back(self, state) -> None:
        """Copy device state back into the host-side master values."""
        for g, arr in zip(self.groups, state):
            g.values = np.asarray(arr, dtype=np.float64)

    def bounds_arrays(self, dtype):
        """Per-group (lower, upper) arrays (broadcast -inf/+inf when unset)."""
        import jax.numpy as jnp

        lowers, uppers = [], []
        for g in self.groups:
            lo = g.lower if g.lower is not None else np.full_like(g.values, -np.inf)
            hi = g.upper if g.upper is not None else np.full_like(g.values, np.inf)
            lowers.append(jnp.asarray(lo, dtype=dtype))
            uppers.append(jnp.asarray(hi, dtype=dtype))
        return tuple(lowers), tuple(uppers)


class Problem:
    """User-facing problem registry (reference: ``include/ceres/problem.h``)."""

    def __init__(self):
        self._groups: List[_Group] = []
        self._batches: dict[tuple, _BatchSpec] = {}
        self._default_manifolds: dict[int, Manifold] = {}
        self._num_residual_blocks = 0
        self._next_residual_id = 0
        self._residual_registry: dict[int, tuple] = {}  # rid -> batch key

    # -- parameter blocks ------------------------------------------------------

    def _default_manifold(self, size: int) -> Manifold:
        if size not in self._default_manifolds:
            self._default_manifolds[size] = EuclideanManifold(size)
        return self._default_manifolds[size]

    def add_parameter_block_array(
        self,
        values,
        manifold: Optional[Manifold] = None,
        name: Optional[str] = None,
    ) -> ParameterBlockArray:
        """Register n homogeneous parameter blocks at once (SoA, batched)."""
        values = np.atleast_2d(np.asarray(values, dtype=np.float64)).copy()
        n, size = values.shape
        manifold = manifold or self._default_manifold(size)
        if manifold.ambient_size != size:
            raise ValueError(
                f"manifold ambient size {manifold.ambient_size} != block size {size}"
            )
        g = _Group(
            name=name or f"group{len(self._groups)}",
            size=size,
            manifold=manifold,
            values=values,
            constant=[False] * n,
        )
        self._groups.append(g)
        return ParameterBlockArray(self, len(self._groups) - 1)

    def add_parameter_block(
        self, values, manifold: Optional[Manifold] = None
    ) -> ParameterBlock:
        """Register a single parameter block.

        Blocks of the same size sharing the same manifold object coalesce
        into one group so they batch together.
        """
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        size = values.shape[0]
        manifold = manifold or self._default_manifold(size)
        if manifold.ambient_size != size:
            raise ValueError(
                f"manifold ambient size {manifold.ambient_size} != block size {size}"
            )
        # find an existing coalescable group
        for gi, g in enumerate(self._groups):
            if g.size == size and g.manifold is manifold and g.name.startswith("_scalar"):
                g.values = np.concatenate([g.values, values[None]], axis=0)
                g.constant.append(False)
                if g.lower is not None:
                    g.lower = np.concatenate(
                        [g.lower, np.full((1, size), -np.inf)], axis=0
                    )
                if g.upper is not None:
                    g.upper = np.concatenate(
                        [g.upper, np.full((1, size), np.inf)], axis=0
                    )
                return ParameterBlock(self, gi, g.values.shape[0] - 1)
        g = _Group(
            name=f"_scalar{len(self._groups)}_s{size}",
            size=size,
            manifold=manifold,
            values=values[None].copy(),
            constant=[False],
        )
        self._groups.append(g)
        return ParameterBlock(self, len(self._groups) - 1, 0)

    def set_manifold(self, block_or_array, manifold: Manifold) -> None:
        g = block_or_array._group
        if isinstance(block_or_array, ParameterBlock) and g.num_blocks > 1:
            raise ValueError(
                "cannot change the manifold of one block of a shared group; "
                "use add_parameter_block_array for per-array manifolds"
            )
        if manifold.ambient_size != g.size:
            raise ValueError("manifold ambient size mismatch")
        g.manifold = manifold

    def set_parameter_block_constant(self, block: ParameterBlock) -> None:
        block._group.constant[block.row] = True

    def set_parameter_block_variable(self, block: ParameterBlock) -> None:
        block._group.constant[block.row] = False

    def set_parameter_block_array_constant(self, arr: ParameterBlockArray) -> None:
        g = arr._group
        g.constant = [True] * g.num_blocks

    def is_parameter_block_constant(self, block: ParameterBlock) -> bool:
        return block._group.constant[block.row]

    def _ensure_bounds(self, g: _Group):
        if g.lower is None:
            g.lower = np.full_like(g.values, -np.inf)
        if g.upper is None:
            g.upper = np.full_like(g.values, np.inf)

    def set_parameter_lower_bound(self, block: ParameterBlock, index: int, value: float):
        g = block._group
        self._ensure_bounds(g)
        g.lower[block.row, index] = value

    def set_parameter_upper_bound(self, block: ParameterBlock, index: int, value: float):
        g = block._group
        self._ensure_bounds(g)
        g.upper[block.row, index] = value

    def set_schur_elimination_group(self, arr: ParameterBlockArray, group: int):
        """Declare Schur structure: 0 = eliminated (points), 1 = retained
        (cameras). Counterpart of ParameterBlockOrdering group 0/1 in the
        reference lineage (``include/ceres/ordered_groups.h``) — for BA the
        bipartite structure is declared, not discovered."""
        arr._group.schur_group = int(group)

    # -- residual blocks --------------------------------------------------------

    def add_residual_block(
        self,
        fn: Callable,
        loss: Optional[LossFunction],
        params: Sequence[ParameterBlock],
        data: Any = None,
        name: str = "",
        numeric_diff: bool = False,
        numeric_diff_relative_step_size: float = 1e-6,
        numeric_diff_method: str = "central",
    ) -> ResidualBlockId:
        """Add one residual block. Blocks with the same (fn, loss, group
        signature) batch together at compile time.

        ``numeric_diff=True`` differentiates this block's residual by
        central differences in the tangent space instead of forward-mode AD
        (reference: ``NumericDiffCostFunction`` — use for residuals whose
        AD derivative is unavailable or wrong: external functions wrapped
        in ``jax.pure_callback``, table lookups, ``stop_gradient`` terms).
        """
        slot_groups = tuple(p.group_index for p in params)
        key = (id(fn), id(loss), slot_groups, name, numeric_diff, numeric_diff_method)
        spec = self._batches.get(key)
        if spec is None:
            spec = _BatchSpec(
                fn=fn,
                loss=loss,
                slot_groups=slot_groups,
                slot_indices=[[] for _ in params],
                data_rows=[],
                name=name or getattr(fn, "__name__", "residual"),
                row_ids=[],
                numeric_diff=numeric_diff,
                numeric_diff_step=numeric_diff_relative_step_size,
                numeric_diff_method=numeric_diff_method,
            )
            self._batches[key] = spec
        for slot, p in enumerate(params):
            spec.slot_indices[slot].append(p.row)
        spec.data_rows.append(data)
        self._num_residual_blocks += 1
        rid = self._next_residual_id
        self._next_residual_id += 1
        spec.row_ids.append(rid)
        self._residual_registry[rid] = key
        return ResidualBlockId(rid)

    def remove_residual_block(self, rbid: ResidualBlockId) -> None:
        """Remove one residual block added with ``add_residual_block``
        (reference: ``Problem::RemoveResidualBlock``). Bulk batches from
        ``add_residual_blocks`` are not individually removable."""
        rid = rbid._rid
        key = self._residual_registry.pop(rid, None)
        if key is None:
            raise KeyError(f"unknown or already-removed residual block {rbid}")
        spec = self._batches[key]
        i = spec.row_ids.index(rid)
        for slot_rows in spec.slot_indices:
            del slot_rows[i]
        del spec.data_rows[i]
        del spec.row_ids[i]
        self._num_residual_blocks -= 1
        if not spec.row_ids:
            del self._batches[key]

    def remove_parameter_block(self, block: ParameterBlock) -> None:
        """Remove a parameter block and every residual block referencing it
        (reference: ``Problem::RemoveParameterBlock``).

        SoA deviation: the group's storage row is kept (so other handles
        stay valid) but marked constant and stripped of residuals — it no
        longer participates in the solve, matching the reference semantics
        for the reduced program.
        """
        gi, row = block.group_index, block.row
        doomed = []
        for key, spec in self._batches.items():
            refs = [
                i
                for slot, g in enumerate(spec.slot_groups)
                if g == gi
                for i, r in enumerate(spec.slot_indices[slot])
                if r == row
            ]
            if not refs:
                continue
            if spec.row_ids is None:
                raise NotImplementedError(
                    "remove_parameter_block: block is referenced by a bulk "
                    "batch (add_residual_blocks); rebuild the problem instead"
                )
            doomed.extend(ResidualBlockId(spec.row_ids[i]) for i in sorted(set(refs)))
        for rbid in doomed:
            self.remove_residual_block(rbid)
        block._group.constant[row] = True

    def add_residual_blocks(
        self,
        fn: Callable,
        loss: Optional[LossFunction],
        params: Sequence[Tuple[ParameterBlockArray, Any]],
        data: Any = None,
        num_blocks: Optional[int] = None,
        name: str = "",
        numeric_diff: bool = False,
        numeric_diff_relative_step_size: float = 1e-6,
        numeric_diff_method: str = "central",
    ) -> None:
        """Bulk-add B homogeneous residual blocks (the batched path).

        Args:
          params: per slot, ``(array_handle, indices)`` where indices is a
            (B,) int array selecting the block for each residual, or an
            ``array_handle`` alone / ``(handle, None)`` meaning block b uses
            row b.
          data: pytree whose leaves are stacked along axis 0 with length B.
        """
        norm_params = []
        for p in params:
            if isinstance(p, ParameterBlockArray):
                norm_params.append((p, None))
            else:
                norm_params.append((p[0], p[1]))
        # infer B
        bs = set()
        for _, idx in norm_params:
            if idx is not None:
                bs.add(len(np.asarray(idx)))
        if data is not None:
            leaves = jax.tree_util.tree_leaves(data)
            if leaves:
                bs.add(int(np.asarray(leaves[0]).shape[0]))
        if num_blocks is not None:
            bs.add(int(num_blocks))
        if len(bs) != 1:
            if not bs:
                bs = {len(norm_params[0][0])}
            else:
                raise ValueError(f"inconsistent batch sizes: {bs}")
        B = bs.pop()

        slot_groups = tuple(arr.group_index for arr, _ in norm_params)
        key = (id(fn), id(loss), slot_groups, name, "bulk", self._num_residual_blocks)
        spec = _BatchSpec(
            fn=fn,
            loss=loss,
            slot_groups=slot_groups,
            # kept as numpy arrays (not per-row lists): bulk batches are
            # venice-scale (~5M rows) and are never appended to row-wise
            slot_indices=[
                np.arange(B, dtype=np.int64)
                if idx is None
                else np.asarray(idx, dtype=np.int64)
                for _, idx in norm_params
            ],
            data_rows=[("bulk", data, B)],
            name=name or getattr(fn, "__name__", "residual"),
            numeric_diff=numeric_diff,
            numeric_diff_step=numeric_diff_relative_step_size,
            numeric_diff_method=numeric_diff_method,
        )
        self._batches[key] = spec
        self._num_residual_blocks += B

    # -- compile -------------------------------------------------------------------

    def _infer_residual_dim(self, batch: _BatchSpec, data_example) -> int:
        import jax.numpy as jnp

        xs = tuple(
            jnp.zeros((self._groups[gi].size,), dtype=jnp.float32)
            + jnp.asarray(self._groups[gi].values[0], dtype=jnp.float32)
            for gi in batch.slot_groups
        )
        out = jax.eval_shape(batch.fn, xs, data_example)
        shape = out.shape
        if len(shape) != 1:
            raise ValueError(
                f"residual fn {batch.name} must return a rank-1 array, got {shape}"
            )
        return int(shape[0])

    def compile(self) -> Program:
        """Freeze into a Program: stack batches, assign tangent offsets."""
        groups = self._groups
        tangent_offset: List[int] = []
        off = 0
        for g in groups:
            tangent_offset.append(off)
            off += g.num_blocks * g.tangent_size
        num_tangent = off

        free_mask = np.ones((num_tangent,), dtype=np.float64)
        for g, o in zip(groups, tangent_offset):
            t = g.tangent_size
            for i, const in enumerate(g.constant):
                if const:
                    free_mask[o + i * t : o + (i + 1) * t] = 0.0

        compiled: List[CompiledBatch] = []
        total_residuals = 0
        for spec in self._batches.values():
            if len(spec.data_rows) == 1 and (
                isinstance(spec.data_rows[0], tuple)
                and len(spec.data_rows[0]) == 3
                and spec.data_rows[0][0] == "bulk"
            ):
                _, data, B = spec.data_rows[0]
                data_stacked = data
                data_example = (
                    None
                    if data is None
                    else jax.tree_util.tree_map(lambda a: np.asarray(a)[0], data)
                )
            else:
                B = len(spec.data_rows)
                if spec.data_rows[0] is None:
                    data_stacked = None
                    data_example = None
                else:
                    data_stacked = jax.tree_util.tree_map(
                        lambda *rows: np.stack([np.asarray(r) for r in rows], axis=0),
                        *spec.data_rows,
                    )
                    data_example = spec.data_rows[0]

            m = self._infer_residual_dim(spec, data_example)
            tangent_sizes = tuple(
                groups[gi].tangent_size for gi in spec.slot_groups
            )
            t_block = sum(tangent_sizes)

            slot_idx = tuple(
                np.asarray(ix, dtype=np.int32) for ix in spec.slot_indices
            )
            # global tangent index map (B, T_block)
            tangent_index = np.zeros((B, t_block), dtype=np.int32)
            col = 0
            for slot, gi in enumerate(spec.slot_groups):
                t = tangent_sizes[slot]
                o = tangent_offset[gi]
                base = o + slot_idx[slot].astype(np.int64) * t  # (B,)
                tangent_index[:, col : col + t] = base[:, None] + np.arange(t)[None, :]
                col += t

            compiled.append(
                CompiledBatch(
                    fn=spec.fn,
                    loss=spec.loss,
                    slot_groups=spec.slot_groups,
                    slot_indices=slot_idx,
                    data=data_stacked,
                    num_blocks=B,
                    residual_dim=m,
                    tangent_sizes=tangent_sizes,
                    block_tangent_size=t_block,
                    tangent_index=tangent_index,
                    name=spec.name,
                    numeric_diff=spec.numeric_diff,
                    numeric_diff_step=spec.numeric_diff_step,
                    numeric_diff_method=spec.numeric_diff_method,
                    row_ids=(
                        tuple(spec.row_ids)
                        if spec.row_ids is not None
                        else None
                    ),
                )
            )
            total_residuals += B * m

        num_parameters = sum(g.num_blocks * g.size for g in groups)
        num_effective = sum(g.num_blocks * g.tangent_size for g in groups)
        num_blocks_total = sum(g.num_blocks for g in groups)
        n_const_blocks = sum(sum(g.constant) for g in groups)
        num_parameters_reduced = num_parameters - sum(
            g.size * sum(g.constant) for g in groups
        )
        num_effective_reduced = num_effective - sum(
            g.tangent_size * sum(g.constant) for g in groups
        )
        has_bounds = any(g.lower is not None or g.upper is not None for g in groups)

        return Program(
            groups=groups,
            batches=compiled,
            tangent_offset=tangent_offset,
            num_tangent=num_tangent,
            free_mask=free_mask,
            num_parameters=num_parameters,
            num_effective_parameters=num_effective,
            num_parameter_blocks=num_blocks_total,
            num_residual_blocks=self._num_residual_blocks,
            num_residuals=total_residuals,
            num_parameters_reduced=num_parameters_reduced,
            num_effective_parameters_reduced=num_effective_reduced,
            num_parameter_blocks_reduced=num_blocks_total - n_const_blocks,
            has_bounds=has_bounds,
        )

    def _subset_problem(self, residual_blocks) -> "Problem":
        """Shadow Problem sharing this one's parameter groups but holding
        only the selected residual blocks (reference:
        ``EvaluateOptions::residual_blocks``)."""
        wanted = set()
        for rbid in residual_blocks:
            if rbid._rid not in self._residual_registry:
                raise KeyError(
                    f"unknown or removed residual block {rbid}"
                )
            wanted.add(rbid._rid)
        sub = Problem.__new__(Problem)
        sub._groups = self._groups  # shared parameter storage
        sub._default_manifolds = self._default_manifolds
        sub._batches = {}
        sub._num_residual_blocks = 0
        sub._next_residual_id = self._next_residual_id
        sub._residual_registry = {}
        for key, spec in self._batches.items():
            if spec.row_ids is None:
                continue  # bulk batches carry no ids
            rows = [i for i, r in enumerate(spec.row_ids) if r in wanted]
            if not rows:
                continue
            sub._batches[key] = _BatchSpec(
                fn=spec.fn,
                loss=spec.loss,
                slot_groups=spec.slot_groups,
                slot_indices=[
                    [sl[i] for i in rows] for sl in spec.slot_indices
                ],
                data_rows=[spec.data_rows[i] for i in rows],
                name=spec.name,
                row_ids=[spec.row_ids[i] for i in rows],
                numeric_diff=spec.numeric_diff,
                numeric_diff_step=spec.numeric_diff_step,
                numeric_diff_method=spec.numeric_diff_method,
            )
            sub._num_residual_blocks += len(rows)
        return sub

    # -- evaluation convenience (reference: Problem::Evaluate) ----------------

    def evaluate(
        self,
        residuals: bool = False,
        gradient: bool = False,
        jacobian: bool = False,
        dtype=None,
        residual_blocks: Optional[Sequence[ResidualBlockId]] = None,
        apply_loss_function: bool = True,
    ):
        """Evaluate at the current parameter values
        (reference: ``Problem::Evaluate(EvaluateOptions, ...)``).

        Returns ``cost`` alone by default, else a dict with any of
        ``cost`` (float), ``residuals`` ((M,), loss-corrected, batch order),
        ``gradient`` ((N_tangent,) = J^T r), ``jacobian`` ((M, N_tangent)
        dense — small problems only).

        ``residual_blocks`` restricts the evaluation to the given subset
        (the reference's ``EvaluateOptions::residual_blocks``; bulk batches
        from ``add_residual_blocks`` have no ids and are not selectable).
        ``apply_loss_function=False`` evaluates without the robustifier
        (``EvaluateOptions::apply_loss_function``).
        """
        import jax
        import jax.numpy as jnp

        from skeres.core.evaluator import Evaluator

        target = self
        if residual_blocks is not None:
            target = self._subset_problem(residual_blocks)
        program = target.compile()
        ev = Evaluator(
            program, dtype=dtype, apply_loss_function=apply_loss_function
        )
        state = program.initial_state(ev.dtype)
        if not (residuals or gradient or jacobian):
            return float(jax.jit(ev.cost)(state))

        cost, blocks = jax.jit(ev.blocks)(state)
        out = {"cost": float(cost)}
        if residuals or jacobian:
            jd, rd = ev.jacobian_dense(blocks)
            if residuals:
                out["residuals"] = np.asarray(rd)
            if jacobian:
                out["jacobian"] = np.asarray(jd)
        if gradient:
            g, _ = ev.gradient_and_diag(blocks)
            out["gradient"] = np.asarray(g)
        return out
