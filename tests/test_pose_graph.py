"""Pose-graph (config 3) tests: SE(2)/SE(3) residuals, g2o round-trip,
synthetic sphere convergence. Counterpart of the reference lineage's
pose-graph example acceptance (BASELINE.md config 3)."""

import os
import tempfile

import numpy as np
import pytest

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType, TerminationType
from skeres.io.g2o import (
    PoseGraph2D,
    build_pose_graph_problem,
    load_g2o,
    synthetic_sphere,
)


def _simple_2d_graph():
    """Square loop: 4 poses, odometry + 1 loop closure, noisy initial."""
    # ground truth: unit square, yaw turning 90deg each step
    gt = np.array(
        [
            [0.0, 0.0, 0.0],
            [1.0, 0.0, np.pi / 2],
            [1.0, 1.0, np.pi],
            [0.0, 1.0, -np.pi / 2],
        ]
    )
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0]], dtype=np.int32)

    def rel(a, b):
        d = gt[b, :2] - gt[a, :2]
        c, s = np.cos(gt[a, 2]), np.sin(gt[a, 2])
        local = np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1]])
        dyaw = gt[b, 2] - gt[a, 2]
        dyaw = np.arctan2(np.sin(dyaw), np.cos(dyaw))
        return np.array([local[0], local[1], dyaw])

    meas = np.stack([rel(a, b) for a, b in edges])
    info = np.broadcast_to(np.eye(3) * 100.0, (len(edges), 3, 3)).copy()
    sqrt_info = np.transpose(np.linalg.cholesky(info), (0, 2, 1))

    rng = np.random.default_rng(0)
    noisy = gt.copy()
    noisy[1:, :2] += rng.normal(0, 0.2, (3, 2))
    noisy[1:, 2] += rng.normal(0, 0.15, 3)
    return PoseGraph2D(
        poses=noisy,
        ids=np.arange(4),
        edges=edges,
        measurements=meas,
        sqrt_information=sqrt_info,
    )


def test_pose_graph_2d_converges_to_ground_truth():
    graph = _simple_2d_graph()
    problem, poses = build_pose_graph_problem(graph)
    options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_NORMAL_CHOLESKY,
        max_num_iterations=50,
    )
    summary = st.solve(options, problem)
    assert summary.termination_type == TerminationType.CONVERGENCE, summary.message
    # exact measurements + gauge fixed at pose 0 -> recover the square
    gt = np.array(
        [[0, 0, 0], [1, 0, np.pi / 2], [1, 1, np.pi], [0, 1, -np.pi / 2]]
    )
    sol = poses.values
    np.testing.assert_allclose(sol[:, :2], gt[:, :2], atol=1e-6)
    dyaw = np.arctan2(np.sin(sol[:, 2] - gt[:, 2]), np.cos(sol[:, 2] - gt[:, 2]))
    np.testing.assert_allclose(dyaw, 0.0, atol=1e-6)


def test_g2o_2d_roundtrip(tmp_path):
    graph = _simple_2d_graph()
    path = os.path.join(tmp_path, "g.g2o")
    with open(path, "w") as f:
        for i, p in enumerate(graph.poses):
            f.write(f"VERTEX_SE2 {i} {p[0]} {p[1]} {p[2]}\n")
        for (a, b), m, L in zip(
            graph.edges, graph.measurements, graph.sqrt_information
        ):
            info = L.T @ L
            f.write(
                f"EDGE_SE2 {a} {b} {m[0]} {m[1]} {m[2]} "
                f"{info[0,0]} {info[0,1]} {info[0,2]} "
                f"{info[1,1]} {info[1,2]} {info[2,2]}\n"
            )
    loaded = load_g2o(path)
    np.testing.assert_allclose(loaded.poses, graph.poses)
    np.testing.assert_array_equal(loaded.edges, graph.edges)
    np.testing.assert_allclose(loaded.measurements, graph.measurements)
    np.testing.assert_allclose(
        loaded.sqrt_information, graph.sqrt_information, rtol=1e-10
    )


def test_g2o_3d_roundtrip(tmp_path):
    graph = synthetic_sphere(num_poses=20, loops_every=7)
    path = os.path.join(tmp_path, "s.g2o")
    with open(path, "w") as f:
        for i, p in enumerate(graph.poses):
            f.write(
                f"VERTEX_SE3:QUAT {i} "
                + " ".join(f"{v:.17g}" for v in p)
                + "\n"
            )
        for (a, b), t, q, L in zip(
            graph.edges, graph.t_ab, graph.q_ab, graph.sqrt_information
        ):
            info = L.T @ L
            iu = np.triu_indices(6)
            f.write(
                f"EDGE_SE3:QUAT {a} {b} "
                + " ".join(f"{v:.17g}" for v in t)
                + " "
                + " ".join(f"{v:.17g}" for v in q)
                + " "
                + " ".join(f"{v:.17g}" for v in info[iu])
                + "\n"
            )
    loaded = load_g2o(path)
    np.testing.assert_allclose(loaded.poses, graph.poses, rtol=1e-12)
    np.testing.assert_allclose(loaded.t_ab, graph.t_ab, rtol=1e-12)
    np.testing.assert_allclose(loaded.q_ab, graph.q_ab, rtol=1e-9)
    np.testing.assert_allclose(
        loaded.sqrt_information, graph.sqrt_information, rtol=1e-8, atol=1e-8
    )


@pytest.fixture(scope="module")
def sphere_graph():
    return synthetic_sphere(num_poses=120, loops_every=15)


def test_pose_graph_3d_sphere_converges(sphere_graph):
    problem, poses = build_pose_graph_problem(sphere_graph)
    options = SolverOptions(
        linear_solver_type=LinearSolverType.CGNR,
        max_num_iterations=50,
    )
    summary = st.solve(options, problem)
    assert summary.termination_type == TerminationType.CONVERGENCE, summary.message
    assert summary.final_cost < 0.5 * summary.initial_cost
    # all quaternions stay unit under the manifold
    qn = np.linalg.norm(poses.values[:, 3:7], axis=1)
    np.testing.assert_allclose(qn, 1.0, atol=1e-9)


def test_pose_graph_3d_gradient_check(sphere_graph):
    from skeres.core.evaluator import Evaluator
    from skeres.core.gradient_checker import check_program_gradients

    graph = synthetic_sphere(num_poses=12, loops_every=5)
    problem, _ = build_pose_graph_problem(graph)
    program = problem.compile()
    ev = Evaluator(program)
    ok, msg = check_program_gradients(program, ev)
    assert ok, msg
