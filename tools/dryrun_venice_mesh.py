#!/usr/bin/env python
"""Sharded venice-path dryrun on the virtual CPU mesh: build a large synthetic BAL problem, shard it over 8
virtual devices, and execute ONE full sharded LM step (linearize + damped
ITERATIVE_SCHUR solve + candidate eval) end-to-end.

Scale is reduced from full venice (the point is that the sharded
program COMPILES AND EXECUTES with the shard_map windowed
reductions at a venice-shaped problem, not CPU throughput).

    python tools/dryrun_venice_mesh.py --num_points 40000
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

from skeres.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_cameras", type=int, default=222)  # venice/8
    ap.add_argument("--num_points", type=int, default=40_000)
    ap.add_argument("--obs_per_point", type=int, default=5)
    ap.add_argument(
        "--linear_solver",
        default="schur_dense",
        choices=["schur_dense", "schur_iterative"],
        help="schur_dense runs the SHARDED EXPLICIT-S flagship path",
    )
    args = ap.parse_args()

    import numpy as np
    from jax.sharding import Mesh

    import skeres as st
    from skeres.core.options import SolverOptions
    from skeres.core.types import LinearSolverType, TerminationType
    from skeres.io.bal import build_bal_problem, synthetic_bal

    t0 = time.time()
    bal = synthetic_bal(
        num_cameras=args.num_cameras,
        num_points=args.num_points,
        observations_per_point=args.obs_per_point,
    )
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("obs",))
    problem, _, _ = build_bal_problem(bal)
    solver = (
        LinearSolverType.DENSE_SCHUR
        if args.linear_solver == "schur_dense"
        else LinearSolverType.ITERATIVE_SCHUR
    )
    summary = st.solve(
        SolverOptions(
            linear_solver_type=solver,
            max_num_iterations=2,
            max_linear_solver_iterations=20,
            mesh=mesh,
        ),
        problem,
    )
    assert summary.termination_type in (
        TerminationType.CONVERGENCE,
        TerminationType.NO_CONVERGENCE,
    ), summary.message
    assert summary.final_cost < summary.initial_cost
    print(
        json.dumps(
            {
                "metric": "venice_mesh_dryrun",
                "linear_solver": args.linear_solver,
                "ok": True,
                "obs": bal.num_observations,
                "devices": 8,
                "initial_cost": summary.initial_cost,
                "final_cost": summary.final_cost,
                "wall_seconds": round(time.time() - t0, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
