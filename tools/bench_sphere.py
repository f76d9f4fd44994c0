#!/usr/bin/env python
"""sphere2500-class pose-graph benchmark (BASELINE.md config 3) on the
chip: solve the synthetic sphere (2500 SE(3) poses, odometry + loop
closures — structurally the reference's sphere2500) with CGNR and record
iter/s + final chi^2.

    python tools/bench_sphere.py [--num_poses 2500] [--iters 30]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_poses", type=int, default=2500)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()

    import jax

    from skeres.utils.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    dev = require_gpu()

    import skeres as st
    from skeres.core.options import SolverOptions
    from skeres.core.types import LinearSolverType
    from skeres.io.g2o import build_pose_graph_problem, synthetic_sphere

    print(f"device: {dev.device_kind} x {len(jax.devices())}", flush=True)
    graph = synthetic_sphere(num_poses=args.num_poses)

    def run(n_iters):
        problem, poses = build_pose_graph_problem(graph)
        options = SolverOptions(
            linear_solver_type=LinearSolverType.CGNR,
            max_num_iterations=n_iters,
            function_tolerance=0.0,
            gradient_tolerance=0.0,
            parameter_tolerance=0.0,
        )
        return st.solve(options, problem)

    run(args.iters)  # warm the jit cache
    t0 = time.time()
    summary = run(args.iters)
    steps = summary.num_successful_steps + summary.num_unsuccessful_steps
    secs = summary.minimizer_time_in_seconds
    out = {
        "metric": "sphere_pose_graph_lm_steps_per_sec",
        "value": round(steps / secs, 3) if secs else None,
        "unit": "iter/s",
        "extra": {
            "poses": args.num_poses,
            "edges": len(graph.edges),
            "steps": int(steps),
            "minimizer_seconds": round(secs, 2),
            "initial_chi2": float(2 * summary.initial_cost),
            "final_chi2": float(2 * summary.final_cost),
            "termination": str(summary.termination_type),
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
