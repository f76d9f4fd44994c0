"""Smoke tests for the breadth examples (reference lineage:
``examples/sampled_function``, ``examples/ellipse_approximation.cc``)."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def test_sampled_function_finds_interior_minimum():
    from examples.sampled_function import main

    x = main()
    assert abs(x - 4.5) < 1e-3


def test_robot_pose_mle_beats_dead_reckoning(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["robot_pose_mle"])
    from examples.robot_pose_mle import main

    rmse_dead, rmse_mle = main()
    # range readings are 10x tighter than odometry: the MLE must beat
    # dead reckoning by a wide margin (reference: robot_pose_mle.cc)
    assert rmse_mle < 0.3 * rmse_dead


def test_denoising_reduces_noise_preserves_edges(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["denoising", "--side", "32"])
    from examples.denoising import main

    err_noisy, err_restored = main()
    assert err_restored < 0.7 * err_noisy


def test_ellipse_approximation_converges():
    from examples.ellipse_approximation import main
    from skeres.core.types import TerminationType

    summary = main(num_points=60, num_segments=10)
    assert summary.termination_type == TerminationType.CONVERGENCE
    # the piecewise-linear fit lands near the noisy ellipse samples
    assert summary.final_cost < 0.1 * summary.initial_cost


def test_rosenbrock_gradient_problem_example():
    from examples.rosenbrock import main

    summary, solution = main()
    assert summary.final_cost < 1e-10
    np.testing.assert_allclose(solution, [1.0, 1.0], atol=1e-4)


def test_mgh_scoreboard_example(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["more_garbow_hillstrom",
                                      "--problem", "5"])
    from examples.more_garbow_hillstrom import main

    ok, total = main()
    assert (ok, total) == (1, 1)


def test_nist_scoreboard_example(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["nist", "--difficulty", "lower"])
    from examples.nist import main

    successes, total = main()
    # lower-difficulty ladder: every embedded (problem, start) certifies
    assert successes == total
