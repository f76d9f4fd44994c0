#!/usr/bin/env python
"""Venice-scale CPU baseline: scipy least_squares (TRF + sparse LSMR).

CLEARLY LABELED WEAK STAND-IN. The reference lineage publishes no
benchmark numbers and neither ceres/pyceres is installable offline
(BASELINE.md), so — as with the BAL-49 headline bench — the denominator
for the venice config-5 throughput claim is scipy's sparse trust-region
solver on the SAME synthetic scene, residual and Jacobian-sparsity
structure (bench.py's vectorized numpy Snavely model).

Default runs 1/3-venice (600 cams / 333k pts / 1.67M obs) to a bounded
outer-iteration budget and reports steps/sec; ``--full`` attempts a few
full-venice iterations. Writes tools/../BASELINE_MEASURED_VENICE.json.

    python tools/baseline_venice_scipy.py            # 1/3 scale
    python tools/baseline_venice_scipy.py --full     # full venice (slow)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"  # CPU-only by design


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_cameras", type=int, default=600)
    ap.add_argument("--num_points", type=int, default=333_333)
    ap.add_argument("--obs_per_point", type=int, default=5)
    ap.add_argument("--max_nfev", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="full venice-1778 scale (1778/1M/5M), max_nfev 3")
    args = ap.parse_args()
    if args.full:
        args.num_cameras, args.num_points, args.max_nfev = 1778, 1_000_000, 3

    import numpy as np
    from scipy.optimize import least_squares

    import bench  # repo-root bench.py: numpy Snavely + sparsity pattern
    from skeres.io.bal import synthetic_bal

    t0 = time.time()
    bal = synthetic_bal(
        num_cameras=args.num_cameras,
        num_points=args.num_points,
        observations_per_point=args.obs_per_point,
    )
    x0 = np.concatenate([bal.cameras.ravel(), bal.points.ravel()])
    sp = bench._jac_sparsity(bal)
    print(
        f"scene {args.num_cameras}/{args.num_points}/{bal.num_observations} "
        f"built in {time.time()-t0:.1f}s; nnz={sp.nnz}",
        flush=True,
    )

    t0 = time.time()
    result = least_squares(
        bench._np_residuals,
        x0,
        jac_sparsity=sp,
        method="trf",
        tr_solver="lsmr",
        max_nfev=args.max_nfev,
        verbose=2,
        args=(bal,),
    )
    secs = time.time() - t0
    iters = max(int(result.njev), 1)
    out = {
        "solver": "scipy.least_squares(trf,lsmr) [weak CPU stand-in]",
        "workload": (
            f"synthetic-venice-{args.num_cameras}-{args.num_points}"
        ),
        "scale_vs_venice": round(
            bal.num_observations / 5_000_000.0, 4
        ),
        "iterations": iters,
        "seconds": float(secs),
        "steps_per_sec": float(iters / secs),
        "final_cost": float(result.cost),
        "note": (
            "weak CPU stand-in (no reference numbers exist; pyceres not "
            "installable offline). Extrapolate full-venice steps/sec as "
            "steps_per_sec * scale_vs_venice assuming O(obs) per-iteration "
            "cost (LSMR matvec dominated), and label the result "
            "extrapolated."
        ),
    }
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "BASELINE_MEASURED_VENICE.json"
        if args.full
        else "BASELINE_MEASURED_VENICE_THIRD.json",
    )
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
