#!/usr/bin/env python
"""2D pose-graph SLAM (reference: ``examples/slam/pose_graph_2d``).

Reads a 2D g2o file and optimizes SE(2) poses with the wraparound angle
manifold; the first pose is held constant to fix the gauge.
"""

import argparse

import numpy as np

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType
from skeres.io.g2o import build_pose_graph_problem, load_g2o


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True, help="g2o file (2D)")
    ap.add_argument("--linear_solver", default="CGNR")
    ap.add_argument("--max_iterations", type=int, default=100)
    ap.add_argument("--output", default=None)
    args = ap.parse_args()

    graph = load_g2o(args.input)
    print(f"pose graph: {len(graph.poses)} poses, {len(graph.edges)} constraints")
    problem, poses = build_pose_graph_problem(graph)
    options = SolverOptions(
        linear_solver_type=LinearSolverType[args.linear_solver],
        max_num_iterations=args.max_iterations,
        minimizer_progress_to_stdout=True,
    )
    summary = st.solve(options, problem)
    print(summary.full_report())
    if args.output:
        np.savetxt(args.output, poses.values)


if __name__ == "__main__":
    main()
