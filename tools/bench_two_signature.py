#!/usr/bin/env python
"""Multi-signature Schur benchmark: quantify the cost
of the realistic BA variants that do NOT hit the single-signature
camera-padded fast path.

Three problems at the same observation count:

  plain       one signature (camera, point) — camera-padded matvec
  +prior      plain + a per-camera prior batch (second signature; the
              observation batch KEEPS its padded layout, priors ride the
              generic gather-plan path)
  split       pose (6) and intrinsics (3) as separate blocks — the
              observation batch has TWO retained slots, which disables the
              padded layout entirely (core/schur.py sorted_info gate) and
              exercises the generic fallback at full scale

    python tools/bench_two_signature.py --num_points 200000
    python tools/bench_two_signature.py --num_cameras 1778 \
        --num_points 1000000   # venice scale
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_cameras", type=int, default=49)
    ap.add_argument("--num_points", type=int, default=200_000)
    ap.add_argument("--obs_per_point", type=int, default=5)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--chunk", type=int, default=262_144)
    ap.add_argument("--variants", nargs="+",
                    default=["plain", "prior", "split"])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from skeres.utils.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    dev = require_gpu()

    import skeres as st
    from skeres.core.options import SolverOptions
    from skeres.core.problem import Problem
    from skeres.core.types import LinearSolverType, PreconditionerType
    from skeres.io.bal import build_bal_problem, synthetic_bal
    import skeres.ops.rotation as rot

    print(f"device: {dev.device_kind} x {len(jax.devices())}", flush=True)
    bal = synthetic_bal(
        num_cameras=args.num_cameras,
        num_points=args.num_points,
        observations_per_point=args.obs_per_point,
    )
    print(f"{bal.num_cameras} cams / {bal.num_points} pts / "
          f"{bal.num_observations} obs", flush=True)

    def make_plain():
        problem, _, _ = build_bal_problem(bal)
        return problem

    def make_prior():
        problem, cameras, _ = build_bal_problem(bal)

        def camera_prior(params, data):
            (cam,) = params
            return 0.1 * (cam - data)

        problem.add_residual_blocks(
            camera_prior,
            None,
            [(cameras, np.arange(bal.num_cameras, dtype=np.int32))],
            data=bal.cameras.copy(),
            name="camera_prior",
        )
        return problem

    def make_split():
        # pose (angle-axis + translation) and intrinsics (f, k1, k2) as
        # separate parameter blocks -> 2 retained slots per observation row
        problem = Problem()
        poses = problem.add_parameter_block_array(
            bal.cameras[:, :6].copy(), name="poses"
        )
        intr = problem.add_parameter_block_array(
            bal.cameras[:, 6:].copy(), name="intrinsics"
        )
        points = problem.add_parameter_block_array(bal.points, name="points")
        problem.set_schur_elimination_group(points, 0)
        problem.set_schur_elimination_group(poses, 1)
        problem.set_schur_elimination_group(intr, 1)

        def split_reproj(params, observation):
            pose, k, point = params
            p = rot.angle_axis_rotate_point(pose[0:3], point) + pose[3:6]
            xp = -p[0] / p[2]
            yp = -p[1] / p[2]
            r2 = xp * xp + yp * yp
            distortion = 1.0 + r2 * (k[1] + k[2] * r2)
            return jnp.stack([
                k[0] * distortion * xp - observation[0],
                k[0] * distortion * yp - observation[1],
            ])

        problem.add_residual_blocks(
            split_reproj,
            None,
            [
                (poses, bal.camera_index),
                (intr, bal.camera_index),
                (points, bal.point_index),
            ],
            data=bal.observations,
            name="split_snavely",
        )
        return problem

    makers = {"plain": make_plain, "prior": make_prior, "split": make_split}
    results = {}
    for name in args.variants:
        t0 = time.time()
        problem = makers[name]()
        options = SolverOptions(
            linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
            preconditioner_type=PreconditionerType.SCHUR_JACOBI,
            max_num_iterations=args.iters,
            evaluation_chunk_size=args.chunk,
            function_tolerance=0.0,
            gradient_tolerance=0.0,
            parameter_tolerance=0.0,
        )
        summary = st.solve(options, problem)
        steps = summary.num_successful_steps + summary.num_unsuccessful_steps
        secs = summary.minimizer_time_in_seconds
        results[name] = {
            "sec_per_step": round(secs / max(steps, 1), 4),
            "linear_solver_sec": round(
                summary.linear_solver_time_in_seconds / max(steps, 1), 4
            ),
            "final_cost": float(summary.final_cost),
            "wall_incl_compile": round(time.time() - t0, 1),
        }
        print(json.dumps({name: results[name]}), flush=True)

    base = results.get("plain", {}).get("sec_per_step")
    out = {
        "metric": "two_signature_step_time",
        "value": results.get("split", {}).get("sec_per_step"),
        "unit": "sec/step (split-intrinsics generic fallback)",
        "extra": {"results": results, "vs_plain": (
            round(results["split"]["sec_per_step"] / base, 2)
            if base and "split" in results else None
        )},
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
