#!/usr/bin/env python
"""Times the DENSE_SCHUR kernels on one NVIDIA GPU at venice widths.

  - Cholesky factor + solve (``SchurSolver._factor_solve``: XLA's
    cuSOLVER potrf/potrs) at n=441 (BAL-49's S) and n=16002 (venice's S),
    in ms and TFLOP/s against the card's f32 and TF32 peaks;
  - the explicit-Schur pair products over the venice point grid, alone
    and followed by the unique-pair reduction (``correction_offdiag``);
  - the venice damped solve (assembly + factor + back-substitution).

Every number is printed with the card's name and power limit. Fails
without a GPU.

    python tools/bench_kernels.py
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published dense peaks (NVIDIA H100 SXM data sheet), keyed by the prefix
# of jax's device_kind. A card missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100": {"f32": 67e12, "tf32": 495e12, "hbm": 3.35e12},
}


CHOLESKY_SIZES = (441, 16002)  # S of BAL-49 and of venice


def peaks_for(kind):
    for prefix, p in PEAKS.items():
        if kind.startswith(prefix):
            return p
    raise SystemExit(f"no peak table entry for device kind {kind!r}")


def timed(fn, *args, reps):
    """Median wall time of ``reps`` calls, each ended by
    block_until_ready; the first (compiling) call is not counted."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times


def bench_cholesky(jax, jnp, peaks, reps):
    from skeres.core.schur import SchurSolver

    solve = jax.jit(lambda a, b: SchurSolver._factor_solve(a, b)[0])
    for n in CHOLESKY_SIZES:
        g = jax.random.normal(jax.random.PRNGKey(n), (n, n), jnp.float32)
        a = jnp.matmul(g, g.T, precision="highest") / n + jnp.eye(n)
        b = jnp.ones((n,), jnp.float32)
        t, _ = timed(solve, a, b, reps=reps)
        flops = n**3 / 3.0 + 2.0 * n * n
        rate = flops / t
        print(
            f"cholesky factor+solve n={n}: {t * 1e3:.3f} ms, "
            f"{rate / 1e12:.3f} TFLOP/s = {rate / peaks['f32']:.1%} of f32 "
            f"peak, {rate / peaks['tf32']:.2%} of TF32 peak",
            flush=True,
        )


def venice_problem(args):
    from skeres.io.bal import build_bal_problem, synthetic_bal

    bal = synthetic_bal(
        num_cameras=args.num_cameras, num_points=args.num_points,
        observations_per_point=args.obs,
    )
    problem, _, _ = build_bal_problem(bal)
    return problem.compile()


def bench_pairs(jax, jnp, program, peaks, reps):
    from skeres.core.evaluator import Evaluator
    from skeres.core.schur import SchurSolver

    ev = Evaluator(program, dtype=jnp.float32)
    plan = SchurSolver(ev, iterative=False).explicit_plan
    rng = np.random.default_rng(0)
    p, d = plan.np_, plan.kp * plan.f * plan.e
    grid = jnp.asarray(rng.standard_normal((p, d), np.float32))
    cinv = jnp.asarray(rng.standard_normal((p, plan.e**2), np.float32))
    out_bytes = p * plan.npairs * plan.f**2 * 4

    def values(grid, cinv):
        return plan._pair_values(grid, cinv, plan.swap_mask, plan.pair_valid)

    def reduced(grid, cinv):
        return plan.correction_offdiag({"grid": grid}, cinv)

    t, _ = timed(jax.jit(values), grid, cinv, reps=reps)
    print(
        f"pair products {p} points: {t * 1e3:.3f} ms, writes "
        f"{out_bytes / 2**30:.2f} GiB = {out_bytes / t / peaks['hbm']:.1%} "
        f"of HBM peak",
        flush=True,
    )
    t, _ = timed(jax.jit(reduced), grid, cinv, reps=reps)
    print(f"pair products + unique-pair reduction: {t * 1e3:.3f} ms",
          flush=True)


def bench_damped_solve(jax, jnp, program, reps):
    from skeres.core.evaluator import Evaluator
    from skeres.core.schur import SchurSolver

    ev = Evaluator(program, dtype=jnp.float32, chunk_size=262_144)
    schur = SchurSolver(ev, iterative=False)
    state = ev.prepare_state(program.initial_state(ev.dtype))

    def linearize(consts, state):
        with ev.bind(consts):
            _, blocks = ev.blocks(state)
            if schur.sorted_info:
                g, diag, cam_raw = schur.gradient_and_diag_padded(
                    blocks, state=state
                )
            else:
                (g, diag), cam_raw = ev.gradient_and_diag(blocks), None
            scale = 1.0 / (1.0 + jnp.sqrt(jnp.maximum(diag, 0.0)))
            data = tuple((b.r, b.jac) for b in blocks)
            prep = schur.prepare(
                schur.scale_data(data, scale), cam_raw=cam_raw, scale=scale
            )
            return prep, g * scale, diag * scale * scale

    def solve(consts, prep, gs, diag_s):
        with ev.bind(consts):
            return schur.solve_damped(prep, gs, diag_s, 1e-4, 1e-6, 1e32)[0]

    prep, gs, diag_s = jax.jit(linearize)(ev.device_consts, state)
    t, ts = timed(jax.jit(solve), ev.device_consts, prep, gs, diag_s,
                  reps=reps)
    print(
        f"venice damped solve (assembly + factor + back-substitution): "
        f"median {t * 1e3:.3f} ms over {[round(x * 1e3, 3) for x in ts]}",
        flush=True,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_cameras", type=int, default=1778)
    ap.add_argument("--num_points", type=int, default=1_000_000)
    ap.add_argument("--obs", type=int, default=5)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from skeres.utils.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    dev = require_gpu()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device: {dev.device_kind} x {len(jax.devices())}; nvidia-smi: "
          f"{card}", flush=True)
    peaks = peaks_for(dev.device_kind)
    bench_cholesky(jax, jnp, peaks, args.reps)
    program = venice_problem(args)
    bench_pairs(jax, jnp, program, peaks, args.reps)
    bench_damped_solve(jax, jnp, program, args.reps)


if __name__ == "__main__":
    main()
