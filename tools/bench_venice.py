#!/usr/bin/env python
"""Venice-scale bundle adjustment on one chip (BASELINE.md config 5).

Synthetic BAL at venice-1778 scale (1778 cameras, ~1M points, ~5M
observations, identical Snavely camera model), solved with
ITERATIVE_SCHUR + SCHUR_JACOBI and streamed (chunked) evaluation.
Records LM steps/s and peak device memory.

    python tools/bench_venice.py                      # full venice scale
    python tools/bench_venice.py --num_cameras 200 --num_points 100000
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_cameras", type=int, default=1778)
    ap.add_argument("--num_points", type=int, default=1_000_000)
    ap.add_argument("--obs_per_point", type=int, default=5)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--chunk", type=int, default=262_144)
    ap.add_argument("--max_cg_iterations", type=int, default=100)
    ap.add_argument("--device_loop", action="store_true")
    ap.add_argument("--linear_solver", default="ITERATIVE_SCHUR")
    ap.add_argument("--preconditioner", default="SCHUR_JACOBI")
    ap.add_argument("--explicit_schur", action="store_true",
                    help="use_explicit_schur_complement (ITERATIVE_SCHUR)")
    ap.add_argument("--function_tolerance", type=float, default=0.0,
                    help="nonzero: run to convergence instead of the fixed "
                         "step budget")
    args = ap.parse_args()

    import jax

    from skeres.utils.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    dev = require_gpu()

    import skeres as st
    from skeres.core.options import SolverOptions
    from skeres.core.types import LinearSolverType
    from skeres.io.bal import build_bal_problem, synthetic_bal

    print(f"device: {dev.device_kind} x {len(jax.devices())}", flush=True)
    t0 = time.time()
    bal = synthetic_bal(
        num_cameras=args.num_cameras,
        num_points=args.num_points,
        observations_per_point=args.obs_per_point,
    )
    print(
        f"generated {bal.num_cameras} cams / {bal.num_points} pts / "
        f"{bal.num_observations} obs in {time.time()-t0:.1f}s",
        flush=True,
    )

    t0 = time.time()
    problem, _, _ = build_bal_problem(bal)
    from skeres.core.types import PreconditionerType

    options = SolverOptions(
        linear_solver_type=LinearSolverType[args.linear_solver],
        preconditioner_type=PreconditionerType[args.preconditioner],
        max_num_iterations=args.iters,
        evaluation_chunk_size=args.chunk,
        max_linear_solver_iterations=args.max_cg_iterations,
        use_device_loop=args.device_loop,
        device_loop_chunk_iterations=args.iters,
        function_tolerance=args.function_tolerance,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
        # fixed-step-budget mode: with ftol zeroed this is a throughput
        # run — disable every termination test so the denominator is the
        # full budget (see bench.py / run_full_iteration_budget)
        run_full_iteration_budget=(args.function_tolerance == 0.0),
        use_explicit_schur_complement=args.explicit_schur,
        minimizer_progress_to_stdout=not args.device_loop,
        # throughput run: let solve/try dispatches pipeline instead of
        # synchronizing after every phase
        detailed_step_timings=False,
    )
    summary = st.solve(options, problem)
    total = time.time() - t0
    steps = summary.num_successful_steps + summary.num_unsuccessful_steps
    secs = summary.minimizer_time_in_seconds

    stats = dev.memory_stats()
    mem = {
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
    }

    out = {
        "metric": "venice_lm_steps_per_sec",
        "value": round(steps / secs, 4) if secs else None,
        "unit": "iter/s",
        "extra": {
            "platform": dev.platform,
            "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "cams": bal.num_cameras,
            "points": bal.num_points,
            "obs": bal.num_observations,
            "steps": int(steps),
            "minimizer_seconds": round(secs, 2),
            "wall_seconds_incl_compile": round(total, 2),
            "initial_cost": float(summary.initial_cost),
            "final_cost": float(summary.final_cost),
            "termination": str(summary.termination_type),
            "memory": mem,
        },
    }
    # config-5 denominator: the measured scipy stand-in at 1/3 venice,
    # extrapolated O(obs) to this run's scale (weak, clearly labeled —
    # see BASELINE_MEASURED_VENICE_THIRD.json)
    base_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "BASELINE_MEASURED_VENICE_THIRD.json",
    )
    if os.path.exists(base_path) and out["value"]:
        with open(base_path) as f:
            base = json.load(f)
        base_sps = base["steps_per_sec"] * (
            base["scale_vs_venice"] * 5_000_000.0 / max(bal.num_observations, 1)
        )
        out["vs_baseline"] = round(out["value"] / base_sps, 1)
        out["extra"]["baseline"] = {
            "solver": base["solver"] + " [extrapolated O(obs) from 1/3 scale]",
            "steps_per_sec": base_sps,
        }
    print(json.dumps(out))
    print(summary.full_report())


if __name__ == "__main__":
    main()
