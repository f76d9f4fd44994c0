"""2-process ``jax.distributed`` smoke test (SURVEY.md §5.6): spawn two CPU processes through ``initialize_distributed``'s
underlying path, build a global 8-device mesh spanning both, and assert
the sharded, psum-reduced cost/gradient equal the single-process values.

Marked ``distributed`` (slow: two cold JAX processes); included in the
default run but skippable with ``-m 'not distributed'``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.distributed
def test_two_process_sharded_eval(tmp_path):
    import jax

    from skeres.core.evaluator import Evaluator
    from skeres.io.bal import build_bal_problem, synthetic_bal

    # single-process reference (this pytest process: CPU, f64)
    bal = synthetic_bal(num_cameras=4, num_points=30, observations_per_point=3)
    problem, _, _ = build_bal_problem(bal)
    program = problem.compile()
    ev = Evaluator(program)
    state = program.initial_state(ev.dtype)
    cost, blocks = jax.jit(ev.blocks)(state)
    g, diag = jax.jit(ev.gradient_and_diag)(blocks)

    # single-process LM trajectory reference for the full-solve check
    import skeres as st
    from skeres.core.options import SolverOptions
    from skeres.core.types import LinearSolverType, PreconditionerType

    bal2 = synthetic_bal(num_cameras=4, num_points=30, observations_per_point=3)
    problem2, _, _ = build_bal_problem(bal2)
    options = SolverOptions(
        linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
        preconditioner_type=PreconditionerType.SCHUR_JACOBI,
        max_num_iterations=5,
        function_tolerance=0.0,
        gradient_tolerance=0.0,
        parameter_tolerance=0.0,
    )
    summary = st.solve(options, problem2)
    traj = np.array([it.cost for it in summary.iterations])

    ref = tmp_path / "ref.npz"
    np.savez(
        ref, cost=float(cost), g=np.asarray(g), diag=np.asarray(diag),
        traj=traj,
    )

    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)  # the worker puts the repo on sys.path
    procs = [
        subprocess.Popen(
            [
                sys.executable,
                os.path.join(HERE, "distributed_worker.py"),
                str(i),
                "2",
                str(port),
                str(ref),
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert "OK cost=" in out
        assert "OK traj" in out
