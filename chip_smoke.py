#!/usr/bin/env python
"""Bring-up check of the solver on NVIDIA GPUs.

Drives the main path a user runs, bundle adjustment through ``st.solve``
with DENSE_SCHUR, on the card, and checks each phase against a plain
reference:

  a. device: JAX's first device must be a GPU (no CPU fallback); prints
     its kind, the JAX version and nvidia-smi's name and power limit.
  b. BAL-49 shape (synthetic: 49 cameras, 7776 points, 4 observations per
     point), device loop, 10 LM steps in f32 on the card against the same
     10 steps in f64 on the in-process CPU backend.
  c. venice-1778 shape (synthetic: 1778 cameras, 1M points, 5M
     observations), host loop, chunked evaluation: the explicit Schur
     complement path is taken, the cost is finite and falls, the final
     cost matches an independent float64 numpy Snavely model, and the
     damped normal-equation residual at the first linearization is
     bounded.
  d. kernels at real widths: the Cholesky factor+solve at n=441 (BAL-49)
     and n=16002 (venice), and the explicit-Schur pair products at kp=5,
     f=9, e=3 over 65,536 points, each against numpy float64.
  e. ``--four``: the venice-shape solve sharded over a 4-GPU mesh against
     the same solve on one GPU, in this process. Runs nothing else.

Any failure prints ``FAIL`` and exits non-zero. The last line of a run
that passes is ``{"ok": true, "device": {...}}``.

    python chip_smoke.py            # one GPU: phases a-d
    python chip_smoke.py --four     # four GPUs: phases a and e
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

VENICE = dict(num_cameras=1778, num_points=1_000_000, observations_per_point=5)
BAL49 = dict(num_cameras=49, num_points=7776, observations_per_point=4)
VENICE_CHUNK = 262_144  # evaluation_chunk_size of tools/bench_venice.py
VENICE_STEPS = 5
CHOLESKY_SIZES = (441, 16002)  # S of BAL-49 and of venice
PAIR_POINTS = 65_536

# Tolerances. The card runs f32 at precision "highest" (no TF32), so every
# f32-vs-f64 gap below is f32 rounding carried through an LM trajectory.
BAL49_COST_RTOL = 1e-3  # final cost after 10 steps, f32 card vs f64 CPU
BAL49_RESOLVABLE = 1e-5  # cost gap to the minimum f32 still resolves
VENICE_F64_RTOL = 1e-4  # device f32 cost vs numpy f64 at the same params
# ||S dx - rhs|| / ||rhs|| at the first linearization. Where the plain f32
# factor of this gauge-free problem fails, the solver's jitter ladder
# solves (S + delta diag(S)) dx = rhs with delta <= 0.1, so the plain
# residual is bounded by the jitter term; the residual of the system
# actually solved is bounded by the f32 Cholesky's backward error.
NORMAL_EQ_SOLVED_RTOL = 1e-3
NORMAL_EQ_PLAIN_RTOL = 2e-1
CHOLESKY_RTOL = 1e-3  # f32 solve, cond(A) <= 4e3 by construction
PAIR_RTOL = 1e-4  # f32 products of O(1) data, 3-term sums
FOUR_INITIAL_RTOL = 1e-5  # same f32 sums in another order
# S and rhs of the first damped system: the same f32 sums in another order
# (per-shard partial sums + psum); a shard's missing share moves them O(1)
FOUR_SYSTEM_RTOL = 1e-4
# a few f32 LM steps from the same start; accept/reject may part ways once
# a step's gain nears f32 rounding, so this bounds only gross divergence
FOUR_FINAL_RTOL = 5e-2


class PhaseFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailure(msg)


def nvidia_smi_name_power():
    """``name, power.limit`` of every card, read by a child off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def snavely_cost(bal, cameras, points):
    """0.5 * sum of squared BAL reprojection residuals, by bench.py's
    independent float64 numpy Snavely model."""
    from bench import _np_residuals

    x = np.concatenate([np.ravel(cameras), np.ravel(points)]).astype(np.float64)
    r = _np_residuals(x, bal)
    return 0.5 * float(r @ r)


def peak_bytes(dev):
    return dev.memory_stats()["peak_bytes_in_use"]


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def _options(**kw):
    from skeres.core.options import SolverOptions
    from skeres.core.types import LinearSolverType

    base = dict(
        linear_solver_type=LinearSolverType.DENSE_SCHUR,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
        run_full_iteration_budget=True,
    )
    base.update(kw)
    return SolverOptions(**base)


def solve_bal(bal, **kw):
    """``st.solve`` on a fresh problem; returns (summary, cams, pts, s)."""
    import skeres as st
    from skeres.io.bal import build_bal_problem

    problem, cams, pts = build_bal_problem(bal)
    t0 = time.time()
    summary = st.solve(_options(**kw), problem)
    return summary, cams.values.copy(), pts.values.copy(), time.time() - t0


def steps_taken(summary):
    return summary.num_successful_steps + summary.num_unsuccessful_steps


# -- phases ---------------------------------------------------------------


def phase_bal49(jax):
    import jax.numpy as jnp

    from skeres.io.bal import synthetic_bal

    bal = synthetic_bal(**BAL49)
    common = dict(
        max_num_iterations=10, use_device_loop=True,
        device_loop_chunk_iterations=10,
    )
    s_gpu, _, _, secs = solve_bal(bal, dtype=jnp.float32, **common)
    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        s_ref, _, _, _ = solve_bal(bal, dtype=jnp.float64, **common)
    print(
        f"  gpu f32: cost {s_gpu.initial_cost:.9e} -> {s_gpu.final_cost:.9e}, "
        f"{s_gpu.num_successful_steps} accepted, {secs:.1f} s incl. compile"
    )
    print(
        f"  cpu f64: cost {s_ref.initial_cost:.9e} -> {s_ref.final_cost:.9e}, "
        f"{s_ref.num_successful_steps} accepted"
    )
    check(steps_taken(s_gpu) == 10, f"gpu took {steps_taken(s_gpu)} steps")
    check(np.isfinite(s_gpu.final_cost), "non-finite final cost")
    r = rel(s_gpu.final_cost, s_ref.final_cost)
    print(f"  final cost rel diff {r:.3e} (tolerance {BAL49_COST_RTOL:g})")
    check(r <= BAL49_COST_RTOL, "final cost off the f64 reference")
    # accept/reject must agree while the reference is still far enough
    # from its final cost that f32 can resolve the decrease; past that
    # point both loops sit at the minimum and f32 rejects steps whose gain
    # is below its rounding
    flags = [
        (g.step_is_successful, r.step_is_successful)
        for g, r, before in zip(
            s_gpu.iterations[1:], s_ref.iterations[1:], s_ref.iterations
        )
        if rel(before.cost, s_ref.final_cost) > BAL49_RESOLVABLE
    ]
    print(f"  accept/reject (gpu, cpu) on the resolvable steps: {flags}")
    check(flags and all(g == r for g, r in flags), "accept/reject differ")


def damped_system(bal, jax, mesh=None):
    """The damped reduced camera system at the initial linearization, from
    the solver's own DENSE_SCHUR path under default options. Returns the
    Schur solver and, on the host in float64, S, rhs, the solved dx, and
    the jitter the ladder used."""
    import jax.numpy as jnp

    from skeres.core.evaluator import Evaluator
    from skeres.core.linear_solvers import lm_diagonal
    from skeres.core.schur import SchurSolver
    from skeres.io.bal import build_bal_problem

    o = _options()
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program, dtype=jnp.float32, chunk_size=VENICE_CHUNK,
                   mesh=mesh)
    state = ev.prepare_state(program.initial_state(ev.dtype))
    schur = SchurSolver(ev, iterative=False)
    mu = 1.0 / o.initial_trust_region_radius
    lo, hi = o.min_lm_diagonal, o.max_lm_diagonal

    def run(consts, state):
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
            gs, diag_s = g * scale, diag * scale * scale
            dx, _, jitter = schur.solve_damped(prep, gs, diag_s, mu, lo, hi)
            asm = schur._assemble(prep, gs, lm_diagonal(diag_s, mu, lo, hi))
            return (
                schur._dense_s(asm), schur._schur_rhs(asm),
                dx[schur._ret_index_dev], jitter,
            )

    s, rhs, dx, jitter = jax.device_get(jax.jit(run)(ev.device_consts, state))
    s, rhs, dx = (np.asarray(a, np.float64) for a in (s, rhs, dx))
    return schur, s, rhs, dx, float(jitter)


def normal_equation_residuals(s, rhs, dx, jitter):
    """||S dx - rhs|| / ||rhs||, plain and with the jitter term: the ladder
    solves (S + jitter diag(S)) dx = rhs."""
    r_plain = s @ dx - rhs
    r_solved = r_plain + jitter * np.diag(s) * dx
    n = np.linalg.norm(rhs)
    return np.linalg.norm(r_plain) / n, np.linalg.norm(r_solved) / n


def rel_norm(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def phase_venice(jax, dev):
    import jax.numpy as jnp

    from skeres.io.bal import synthetic_bal

    t0 = time.time()
    bal = synthetic_bal(**VENICE)
    print(
        f"  {bal.num_cameras} cameras / {bal.num_points} points / "
        f"{bal.num_observations} observations, made in {time.time() - t0:.1f} s"
    )
    summary, cams, pts, secs = solve_bal(
        bal, dtype=jnp.float32, max_num_iterations=VENICE_STEPS,
        evaluation_chunk_size=VENICE_CHUNK,
    )
    steps = steps_taken(summary)
    print(
        f"  schur path {summary.schur_complement_path!r}; cost "
        f"{summary.initial_cost:.9e} -> {summary.final_cost:.9e} in {steps} "
        f"steps ({summary.num_successful_steps} accepted)"
    )
    print(
        f"  solve {secs:.1f} s, of which preprocessing (plans + compile) "
        f"{summary.preprocessor_time_in_seconds:.1f} s; minimizer "
        f"{summary.minimizer_time_in_seconds:.2f} s = "
        f"{summary.minimizer_time_in_seconds / max(steps, 1):.3f} s/step; "
        f"peak device memory {peak_bytes(dev) / 2**30:.2f} GiB"
    )
    check(summary.schur_complement_path == "explicit", "not the explicit path")
    check(steps == VENICE_STEPS, f"took {steps} steps")
    check(np.isfinite(summary.final_cost), "non-finite final cost")
    check(summary.final_cost < summary.initial_cost, "cost did not fall")
    ref = snavely_cost(bal, cams, pts)
    r = rel(summary.final_cost, ref)
    print(
        f"  numpy f64 cost at the final parameters {ref:.9e}: rel diff "
        f"{r:.3e} (tolerance {VENICE_F64_RTOL:g})"
    )
    check(r <= VENICE_F64_RTOL, "final cost off the float64 recomputation")
    _, s_mat, rhs, dx, jitter = damped_system(bal, jax)
    plain, solved = normal_equation_residuals(s_mat, rhs, dx, jitter)
    print(
        f"  normal equations at the first linearization: jitter {jitter:g}; "
        f"||S dx - rhs||/||rhs|| = {plain:.3e} (bound "
        f"{NORMAL_EQ_PLAIN_RTOL:g} when jitter > 0); with the jitter term "
        f"{solved:.3e} (bound {NORMAL_EQ_SOLVED_RTOL:g})"
    )
    check(solved <= NORMAL_EQ_SOLVED_RTOL, "solved-system residual too large")
    if jitter > 0:
        check(plain <= NORMAL_EQ_PLAIN_RTOL, "normal-equation residual too large")


def phase_kernels(jax):
    import jax.numpy as jnp
    import scipy.linalg

    from skeres.core.explicit_schur import ExplicitSchurPlan
    from skeres.core.schur import SchurSolver

    for n in CHOLESKY_SIZES:
        key = jax.random.PRNGKey(n)
        g = jax.random.normal(key, (n, n), jnp.float32)
        a = (
            jnp.matmul(g, g.T, precision="highest") / n
            + 1e-3 * jnp.eye(n, dtype=jnp.float32)
        )
        b = jax.random.normal(jax.random.PRNGKey(n + 1), (n,), jnp.float32)
        x = jax.jit(lambda a, b: SchurSolver._factor_solve(a, b)[0])(a, b)
        a64 = np.asarray(a, np.float64)
        b64 = np.asarray(b, np.float64)
        want = scipy.linalg.cho_solve(scipy.linalg.cho_factor(a64), b64)
        err = np.linalg.norm(np.asarray(x, np.float64) - want) / np.linalg.norm(
            want
        )
        print(
            f"  cholesky factor+solve n={n}: rel error vs f64 {err:.3e} "
            f"(tolerance {CHOLESKY_RTOL:g})"
        )
        check(err <= CHOLESKY_RTOL, f"cholesky n={n} off the f64 oracle")

    kp, f, e, nc, npts = 5, 9, 3, VENICE["num_cameras"], PAIR_POINTS
    rng = np.random.default_rng(0)
    cam = (np.arange(npts)[:, None] * 7 + np.arange(kp)[None, :] * 3) % nc
    cam = rng.permuted(cam, axis=1).reshape(-1)  # mixed pair orientations
    pt = np.repeat(np.arange(npts), kp)
    plan = ExplicitSchurPlan(
        cam_idx=cam, pt_idx=pt, num_cameras=nc, num_points=npts,
        f_size=f, e_size=e,
    )
    a_rows = rng.standard_normal((npts * kp, f * e)).astype(np.float32)
    cinv = rng.standard_normal((npts, e, e)).astype(np.float32)
    cinv = cinv + cinv.transpose(0, 2, 1)
    swap = np.asarray(plan.swap_mask)
    valid = np.asarray(plan.pair_valid)

    def values(a_rows, cinv_flat):
        grid = plan.build_grid(a_rows)["grid"]
        return plan._pair_values(grid, cinv_flat, plan.swap_mask,
                                 plan.pair_valid)

    got = np.asarray(
        jax.jit(values)(jnp.asarray(a_rows), jnp.asarray(cinv.reshape(npts, -1)))
    ).reshape(npts, -1, f, f)
    a64 = a_rows.astype(np.float64).reshape(npts, kp, f, e)
    y = np.einsum("pkfe,peg->pkfg", a64, cinv.astype(np.float64))
    iu, ju = np.triu_indices(kp, 1)
    t = np.einsum("pnfe,pnge->pnfg", y[:, iu], a64[:, ju])
    t = np.where(swap[:, :, None, None], t.transpose(0, 1, 3, 2), t)
    t = np.where(valid[:, :, None, None], t, 0.0)
    err = np.abs(got - t).max() / np.abs(t).max()
    print(
        f"  pair products kp={kp} f={f} e={e} over {npts} points: max rel "
        f"error vs f64 {err:.3e} (tolerance {PAIR_RTOL:g})"
    )
    check(err <= PAIR_RTOL, "pair products off the f64 oracle")


def phase_four(jax):
    import jax.numpy as jnp

    from skeres.io.bal import synthetic_bal
    from skeres.parallel.mesh import make_obs_mesh

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} GPUs, need 4")
    mesh = make_obs_mesh(4)
    bal = synthetic_bal(**VENICE)
    common = dict(
        dtype=jnp.float32, max_num_iterations=VENICE_STEPS,
        evaluation_chunk_size=VENICE_CHUNK,
    )
    s4, cams4, pts4, secs4 = solve_bal(bal, mesh=mesh, **common)
    peaks = [peak_bytes(d) for d in mesh.devices.flat]
    s1, cams1, pts1, secs1 = solve_bal(bal, **common)
    for name, s, secs in (("4 GPUs", s4, secs4), ("1 GPU ", s1, secs1)):
        print(
            f"  {name}: cost {s.initial_cost:.9e} -> {s.final_cost:.9e}, "
            f"{s.num_successful_steps} accepted, minimizer "
            f"{s.minimizer_time_in_seconds:.2f} s, {secs:.1f} s incl. compile"
        )
    print(
        "  peak memory per GPU of the sharded solve (GiB): "
        + ", ".join(f"{p / 2**30:.2f}" for p in peaks)
    )
    check(s4.schur_complement_path == "explicit", "sharded: not explicit")
    schur4, s_4, rhs4, dx4, jitter4 = damped_system(bal, jax, mesh)
    check(schur4.explicit_plan.mesh is not None, "the explicit plan is not sharded")
    _, s_1, rhs1, dx1, jitter1 = damped_system(bal, jax)
    r_s, r_rhs = rel_norm(s_4, s_1), rel_norm(rhs4, rhs1)
    cross = normal_equation_residuals(s_1, rhs1, dx4, jitter4)[1]
    print(
        f"  first damped system, 4 GPUs vs 1: ||S4 - S1||/||S1|| {r_s:.3e}, "
        f"||rhs4 - rhs1||/||rhs1|| {r_rhs:.3e} (tolerance "
        f"{FOUR_SYSTEM_RTOL:g}); jitter {jitter4:g} vs {jitter1:g}; "
        f"||dx4 - dx1||/||dx1|| {rel_norm(dx4, dx1):.3e}; residual of dx4 "
        f"in the 1-GPU system {cross:.3e}"
    )
    check(r_s <= FOUR_SYSTEM_RTOL, "sharded S differs from one GPU's")
    check(r_rhs <= FOUR_SYSTEM_RTOL, "sharded rhs differs from one GPU's")
    check(cross <= NORMAL_EQ_SOLVED_RTOL, "sharded step off the 1-GPU system")
    r0 = rel(s4.initial_cost, s1.initial_cost)
    r1 = rel(s4.final_cost, s1.final_cost)
    print(
        f"  initial cost rel diff {r0:.3e} (tolerance {FOUR_INITIAL_RTOL:g}); "
        f"final {r1:.3e} (sanity bound {FOUR_FINAL_RTOL:g})"
    )
    check(r0 <= FOUR_INITIAL_RTOL, "initial costs differ")
    check(r1 <= FOUR_FINAL_RTOL, "final costs differ")
    check(s4.final_cost < s4.initial_cost, "sharded cost did not fall")
    for cams, pts, s in ((cams4, pts4, s4), (cams1, pts1, s1)):
        r = rel(s.final_cost, snavely_cost(bal, cams, pts))
        check(r <= VENICE_F64_RTOL, f"final cost off numpy f64 by {r:.3e}")
    check(
        min(peaks) >= 0.25 * max(peaks),
        "not every GPU holds a share of the work",
    )


def phase_device(jax):
    from skeres.utils.runtime import require_gpu

    dev = require_gpu()
    print(f"  jax {jax.__version__}; {len(jax.devices())} x {dev.device_kind}")
    print(f"  nvidia-smi: {nvidia_smi_name_power()}")
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four", action="store_true",
        help="run only the 4-GPU sharded phase and its 1-GPU comparison",
    )
    args = ap.parse_args(argv)
    # phase b's reference runs on the in-process CPU backend
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    try:
        import jax

        from skeres.utils.runtime import enable_compile_cache
    except ImportError as exc:
        print(f"FAIL setup: {exc}", flush=True)
        return 1

    name = "setup"

    def run(phase, fn, *fn_args):
        nonlocal name
        name = phase
        print(f"phase {phase}", flush=True)
        t0 = time.time()
        out = fn(*fn_args)
        print(f"  ok ({time.time() - t0:.1f} s)", flush=True)
        return out

    print(f"compile cache {enable_compile_cache()}")
    try:
        dev = run("a device", phase_device, jax)
        if args.four:
            run("e four-GPU sharded venice", phase_four, jax)
        else:
            run("b BAL-49 device loop", phase_bal49, jax)
            run("c venice host loop", phase_venice, jax, dev)
            run("d kernels", phase_kernels, jax)
    except Exception as exc:  # any failure ends the run with FAIL
        traceback.print_exc()
        print(f"FAIL phase {name}: {type(exc).__name__}: {exc}", flush=True)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
