#!/usr/bin/env python
"""Fit a curve to noisy points sampled from an ellipse (counterpart of the
reference lineage's ``examples/ellipse_approximation.cc``): each data point
gets a preimage parameter t on the curve, and the curve control points +
all preimages are optimized jointly — a problem whose Hessian has the
bipartite structure of bundle adjustment (t's are the "points", control
vertices the "cameras"), so DENSE_SCHUR applies.

    python -m examples.ellipse_approximation
"""

import jax.numpy as jnp
import numpy as np

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType


def main(num_points: int = 100, num_segments: int = 12, seed: int = 5):
    rng = np.random.default_rng(seed)
    theta = np.sort(rng.uniform(0.0, 2.0 * np.pi, num_points))
    pts = np.stack([3.0 * np.cos(theta), 1.0 * np.sin(theta)], axis=1)
    pts += rng.normal(0.0, 0.02, pts.shape)

    problem = st.Problem()
    # closed uniform piecewise-linear curve with num_segments vertices,
    # initialized on a circle
    phi = 2.0 * np.pi * np.arange(num_segments) / num_segments
    verts = problem.add_parameter_block_array(
        np.stack([2.0 * np.cos(phi), 2.0 * np.sin(phi)], axis=1), name="verts"
    )
    # one preimage parameter per data point (the eliminated group)
    t0 = theta / (2.0 * np.pi) * num_segments
    pre = problem.add_parameter_block_array(t0[:, None].copy(), name="pre")
    problem.set_schur_elimination_group(pre, 0)
    problem.set_schur_elimination_group(verts, 1)

    seg = np.minimum(t0.astype(np.int32), num_segments - 1)
    nxt = (seg + 1) % num_segments

    def resid(params, data):
        v0, v1, t = params
        point, base = data
        w = jnp.clip(t[0] - base, 0.0, 1.0)
        curve = (1.0 - w) * v0 + w * v1
        return curve - point

    problem.add_residual_blocks(
        resid,
        None,
        [(verts, seg), (verts, nxt), (pre, np.arange(num_points, dtype=np.int32))],
        data=(jnp.asarray(pts), jnp.asarray(seg.astype(np.float64))),
    )

    summary = st.solve(
        SolverOptions(
            linear_solver_type=LinearSolverType.DENSE_SCHUR,
            max_num_iterations=100,
        ),
        problem,
    )
    print(summary.brief_report())
    return summary


if __name__ == "__main__":
    main()
