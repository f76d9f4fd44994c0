#!/usr/bin/env python
"""Sharding-overhead harness: LM-step time on a FIXED problem at 1/2/4/8
shards (SURVEY.md §5.6).

Runs on the virtual CPU mesh (virtual devices time-slice the host's
cores, so *weak* scaling in device count is unmeasurable here). With the total problem fixed, total FLOPs
are constant across mesh sizes, so the ideal trace is FLAT step time; any
growth is the cost of the sharded windowed reductions + psums. The pass
criterion used by the sharding design review: 8-shard step time within
~1.5x of single-device on equal total load.

    python tools/bench_scaling.py --points 16000
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# CPU-only by design: 8 virtual devices on the host's cores
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
    ap.add_argument("--points", type=int, default=16000)
    ap.add_argument("--cameras", type=int, default=64)
    ap.add_argument("--obs_per_point", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()

    import numpy as np
    from jax.sharding import Mesh

    import skeres as st
    from skeres.core.options import SolverOptions
    from skeres.core.types import LinearSolverType
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(
        num_cameras=args.cameras,
        num_points=args.points,
        observations_per_point=args.obs_per_point,
    )

    results = []
    for n in args.shards:
        mesh = (
            None
            if n == 1
            else Mesh(np.array(jax.devices()[:n]), axis_names=("obs",))
        )

        def run():
            problem, _, _ = build_bal_problem(bal)
            options = SolverOptions(
                linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
                max_num_iterations=args.iters,
                mesh=mesh,
                function_tolerance=0.0,
                gradient_tolerance=0.0,
                parameter_tolerance=0.0,
            )
            return st.solve(options, problem)

        run()  # warm the jit cache for this mesh size
        summary = run()
        steps = summary.num_successful_steps + summary.num_unsuccessful_steps
        secs = summary.minimizer_time_in_seconds
        results.append(
            {
                "shards": n,
                "steps": int(steps),
                "sec_per_step": round(secs / max(steps, 1), 4),
                "final_cost": float(summary.final_cost),
            }
        )
        print(json.dumps(results[-1]), flush=True)

    base = results[0]["sec_per_step"]
    out = {
        "metric": "strong_scaling_step_time_ratio",
        "value": round(results[-1]["sec_per_step"] / base, 3),
        "unit": "x (8-shard/1-shard, fixed problem; 1.0 = no sharding overhead)",
        "extra": {
            "rows": results,
            "obs": bal.num_observations,
            "backend": jax.default_backend(),
            "physical_cpus": os.cpu_count(),
        },
    }
    print(json.dumps(out))

    # -- weak-scaling proxy (the meaningful overhead measure when virtual
    # devices outnumber physical cores): one device solving a 1/8-size
    # problem vs 8 shards solving the full problem. With equal PER-SHARD
    # load, the ratio isolates the sharded program's collective/windowed-
    # reduction overhead from plain time-slicing contention.
    ns = args.shards[-1]
    small = synthetic_bal(
        num_cameras=args.cameras,
        num_points=args.points // ns,
        observations_per_point=args.obs_per_point,
    )

    def run_small():
        problem, _, _ = build_bal_problem(small)
        options = SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            max_num_iterations=args.iters,
            function_tolerance=0.0,
            gradient_tolerance=0.0,
            parameter_tolerance=0.0,
        )
        return st.solve(options, problem)

    run_small()
    summary = run_small()
    steps = summary.num_successful_steps + summary.num_unsuccessful_steps
    small_per_step = summary.minimizer_time_in_seconds / max(steps, 1)
    out2 = {
        "metric": "weak_scaling_step_time_ratio",
        "value": round(results[-1]["sec_per_step"] / small_per_step, 3),
        "unit": (
            f"x ({ns}-shard full problem / 1-device 1/{ns} problem; equal "
            "per-shard load; 1.0 = free sharding)"
        ),
        "extra": {
            "small_sec_per_step": round(small_per_step, 4),
            "sharded_sec_per_step": results[-1]["sec_per_step"],
            "small_obs": small.num_observations,
        },
    }
    print(json.dumps(out2))


if __name__ == "__main__":
    main()
