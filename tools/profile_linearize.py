#!/usr/bin/env python
"""Phase split of the venice-scale LM step via CUMULATIVE-PREFIX timing.

Profiling the linearize pipeline's pieces in ISOLATION is misleading at
venice scale: XLA fuses differently without the surrounding program
(e.g. the per-row A = F^T E intermediate may materialize in a padded 3D
layout when ``prepare`` is compiled alone, while the full program streams
it; see ``_explicit_a_flat``'s docstring). Instead
this tool times PREFIXES of the real pipeline, each compiled as one
fused program, and reports marginal (differenced) phase costs:

    P1  blocks                         -> residual+J evaluation
    P2  + gradient_and_diag            -> g/diag assembly
    P3  + scale + scale_data + prepare -> scaling + per-linearization prep
    P4  + solve_damped                 -> the damped Schur solve
    P5  + jtj_quadratic + plus + cost  -> model cost + candidate eval

Every prefix returns what the real minimizer program returns (the prep
stays resident for rejected-step re-solves), so the marginal numbers
match the real per-step cost of an ACCEPTED step:
P1..P3 = relinearize, P4 = solve, P5 = try.

    python tools/profile_linearize.py --num_cameras 1778 \
        --num_points 1000000 --obs 5
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_cameras", type=int, default=1778)
    ap.add_argument("--num_points", type=int, default=1_000_000)
    ap.add_argument("--obs", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--n", type=int, default=5)
    ap.add_argument("--mu", type=float, default=1e-4)
    ap.add_argument(
        "--stages",
        default=None,
        help="comma-separated stage ids to run, each matching a stage's "
        "first word exactly (e.g. 'P1,P2,P4b1'); default all. Marginals "
        "are only meaningful between adjacent selected stages.",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from skeres.utils.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    dev = require_gpu()

    from skeres.core.evaluator import Evaluator
    from skeres.core.linear_solvers import lm_diagonal
    from skeres.core.schur import SchurSolver
    from skeres.io.bal import build_bal_problem, synthetic_bal

    print(f"device: {dev.device_kind} x {len(jax.devices())}", flush=True)
    bal = synthetic_bal(
        num_cameras=args.num_cameras,
        num_points=args.num_points,
        observations_per_point=args.obs,
    )
    print(
        f"cams={bal.num_cameras} pts={bal.num_points} "
        f"obs={bal.num_observations}",
        flush=True,
    )
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program, chunk_size=args.chunk)
    state = program.initial_state(ev.dtype)
    schur = SchurSolver(ev, iterative=False)
    consts = ev.device_consts
    mu = args.mu

    def upto_blocks(c, state):
        with ev.bind(c):
            return ev.blocks(state)

    def _gdiag(blocks, state):
        # mirror the minimizer: camera slots ride the padded layout when
        # the sorted copies are on, and prepare() reuses the placement
        if schur.sorted_info:
            return schur.gradient_and_diag_padded(blocks, state=state)
        g, diag = ev.gradient_and_diag(blocks)
        return g, diag, None

    def upto_place(c, state):
        # blocks + the padded-copy production alone (dual-eval when the
        # placed constants exist, else the (jac|r) placement gather) —
        # isolates the placement cost within the g/diag phase
        with ev.bind(c):
            cost, blocks = ev.blocks(state)
            placed = {}
            for bi in schur.sorted_info:
                if schur.sorted_info[bi].get("placed"):
                    placed[bi] = schur._placed_eval(bi, state)
                    continue
                b = blocks[bi]
                bsz, m, T = b.jac.shape
                placed[bi] = schur._place_rows(
                    bi,
                    jnp.concatenate(
                        [b.jac.reshape(bsz, m * T), b.r], axis=1
                    ),
                )
            return cost, placed

    def upto_gdiag(c, state):
        with ev.bind(c):
            cost, blocks = ev.blocks(state)
            g, diag, cam_raw = _gdiag(blocks, state)
            return cost, blocks, g, diag

    def upto_prep(c, state):
        with ev.bind(c):
            cost, blocks = ev.blocks(state)
            g, diag, cam_raw = _gdiag(blocks, state)
            scale = 1.0 / (1.0 + jnp.sqrt(jnp.maximum(diag, 0.0)))
            data = tuple((b.r, b.jac) for b in blocks)
            prep = schur.prepare(
                schur.scale_data(data, scale), cam_raw=cam_raw, scale=scale
            )
            return cost, g, diag, scale, prep

    def upto_solve(c, state):
        with ev.bind(c):
            cost, g, diag, scale, prep = upto_prep(c, state)
            gs = g * scale
            diag_s = diag * scale * scale
            dx_s, iters, jit_used = schur.solve_damped(
                prep, gs, diag_s, mu, 1e-6, 1e32
            )
            return cost, g, diag, scale, prep, dx_s

    def upto_try(c, state):
        with ev.bind(c):
            cost, g, diag, scale, prep, dx_s = upto_solve(c, state)
            dx = dx_s * scale
            quad = schur.jtj_quadratic(prep, dx_s)
            mcc = -(jnp.dot(g, dx) + 0.5 * quad)
            cand = ev.plus(state, dx)
            new_cost = ev.cost(cand)
            return cost, g, diag, scale, prep, dx_s, mcc, new_cost

    def timeit(name, fn):
        jitted = jax.jit(fn)
        t0 = time.time()
        out = jitted(consts, state)
        jax.block_until_ready(out)
        print(f"  [{name}] first call (compile+run): "
              f"{time.time()-t0:.1f}s", flush=True)
        t0 = time.time()
        for _ in range(args.n):
            out = None  # free the previous outputs before re-running —
            # holding two stages' prep (+ solve transients) may exceed
            # device memory
            out = jitted(consts, state)
            jax.block_until_ready(out)
        dt = (time.time() - t0) / args.n
        out = None
        return dt

    from skeres.core.linear_solvers import lm_diagonal as _lmd

    def upto_scaledata(c, state):
        with ev.bind(c):
            cost, blocks = ev.blocks(state)
            g, diag, cam_raw = _gdiag(blocks, state)
            scale = 1.0 / (1.0 + jnp.sqrt(jnp.maximum(diag, 0.0)))
            data = tuple((b.r, b.jac) for b in blocks)
            return cost, g, diag, scale, schur.scale_data(data, scale), cam_raw

    def _prep_parts(c, state, with_grid):
        cost, blocks = ev.blocks(state)
        g, diag, cam_raw = _gdiag(blocks, state)
        scale = 1.0 / (1.0 + jnp.sqrt(jnp.maximum(diag, 0.0)))
        data = tuple((b.r, b.jac) for b in blocks)
        old = schur.hoist_explicit_grid
        schur.hoist_explicit_grid = with_grid
        try:
            prep = schur.prepare(
                schur.scale_data(data, scale), cam_raw=cam_raw, scale=scale
            )
        finally:
            schur.hoist_explicit_grid = old
        return cost, g, diag, scale, prep

    def upto_prep_nogrid(c, state):
        with ev.bind(c):
            return _prep_parts(c, state, False)

    def upto_assemble(c, state):
        with ev.bind(c):
            cost, g, diag, scale, prep = _prep_parts(c, state, True)
            gs = g * scale
            d = _lmd(diag * scale * scale, mu, 1e-6, 1e32)
            asm = schur._assemble(prep, gs, d)
            rhs = schur._schur_rhs(asm)
            return cost, g, diag, scale, prep, rhs

    def upto_pairs(c, state):
        with ev.bind(c):
            cost, g, diag, scale, prep = _prep_parts(c, state, True)
            gs = g * scale
            d = _lmd(diag * scale * scale, mu, 1e-6, 1e32)
            asm = schur._assemble(prep, gs, d)
            rhs = schur._schur_rhs(asm)
            plan = schur.explicit_plan
            cinv_flat = asm["cinv"].reshape(-1, schur.e_size * schur.e_size)
            uniq = plan.correction_offdiag(asm["explicit_grid"], cinv_flat)
            return cost, g, diag, scale, prep, rhs, uniq

    def upto_offdiag(c, state):
        with ev.bind(c):
            out = upto_pairs(c, state)
            uniq = out[-1]
            s_off = schur.explicit_plan.dense_s_offdiag(uniq)
            return out[:-1] + (s_off,)

    def upto_dense_s(c, state):
        with ev.bind(c):
            cost, g, diag, scale, prep = _prep_parts(c, state, True)
            gs = g * scale
            d = _lmd(diag * scale * scale, mu, 1e-6, 1e32)
            asm = schur._assemble(prep, gs, d)
            rhs = schur._schur_rhs(asm)
            s_mat = schur._dense_s(asm)
            return cost, g, diag, scale, prep, rhs, s_mat

    stages = [
        ("P1 blocks (eval)", upto_blocks),
        ("P1b +placement only", upto_place),
        ("P2 +g/diag", upto_gdiag),
        ("P3a +scale_data", upto_scaledata),
        ("P3b +prep-sans-grid", upto_prep_nogrid),
        ("P3 +scale+prep", upto_prep),
        ("P4a +assemble+rhs", upto_assemble),
        ("P4b1 +pair contraction", upto_pairs),
        ("P4b2 +offdiag build", upto_offdiag),
        ("P4b +dense_s", upto_dense_s),
        ("P4 +damped solve", upto_solve),
        ("P5 +try (quad+plus+cost)", upto_try),
    ]
    if args.stages:
        want = [w.strip() for w in args.stages.split(",") if w.strip()]
        stages = [
            (name, fn)
            for name, fn in stages
            if any(name.split()[0] == w for w in want)
        ]
    times = []
    for name, fn in stages:
        dt = timeit(name, fn)
        times.append((name, dt))
        print(f"{name:<22}{dt*1e3:>10.1f} ms cumulative", flush=True)

    print()
    print(f"{'phase':<26}{'marginal ms':>12}")
    prev = 0.0
    for name, dt in times:
        print(f"{name:<26}{(dt-prev)*1e3:>12.1f}")
        prev = dt
    print(f"{'TOTAL accepted step':<26}{times[-1][1]*1e3:>12.1f}")


if __name__ == "__main__":
    main()
