"""Worker for the 2-process jax.distributed smoke test
(tests/test_distributed.py). Each process owns 4 virtual CPU devices; the
global 8-device mesh spans both processes. Computes the sharded cost and
gradient of a small BAL problem and checks them against the single-process
reference values precomputed by the parent.

Usage: python distributed_worker.py <proc_id> <n_proc> <port> <ref_npz>
"""

import os
import sys

proc_id, n_proc, port, ref_path = (
    int(sys.argv[1]),
    int(sys.argv[2]),
    sys.argv[3],
    sys.argv[4],
)

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

jax.distributed.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=n_proc,
    process_id=proc_id,
)
assert jax.process_count() == n_proc
assert len(jax.devices()) == 4 * n_proc, len(jax.devices())

import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from skeres.core.evaluator import Evaluator  # noqa: E402
from skeres.io.bal import build_bal_problem, synthetic_bal  # noqa: E402

bal = synthetic_bal(num_cameras=4, num_points=30, observations_per_point=3)
problem, _, _ = build_bal_problem(bal)
program = problem.compile()

mesh = Mesh(np.array(jax.devices()), axis_names=("obs",))
ev = Evaluator(program, mesh=mesh)
state = ev.prepare_state(program.initial_state(ev.dtype))


# jit may not close over globally-sharded arrays: pass ev.device_consts as
# an argument and rebind during tracing (same pattern as the minimizer)
@jax.jit
def blocks_fn(state, consts):
    with ev.bind(consts):
        return ev.blocks(state)


@jax.jit
def gd_fn(blocks, consts):
    with ev.bind(consts):
        return ev.gradient_and_diag(blocks)


cost, blocks = blocks_fn(state, ev.device_consts)
g, diag = gd_fn(blocks, ev.device_consts)

ref = np.load(ref_path)
np.testing.assert_allclose(float(cost), ref["cost"], rtol=1e-12)
g_local = np.asarray(jax.device_get(g.addressable_data(0)))
diag_local = np.asarray(jax.device_get(diag.addressable_data(0)))
np.testing.assert_allclose(g_local, ref["g"], rtol=1e-10)
np.testing.assert_allclose(diag_local, ref["diag"], rtol=1e-10)
print(f"proc {proc_id}: OK cost={float(cost):.6e}")

# -- full LM solve: trajectory must equal the single-process reference ----
# (the smoke extended to a short full solve). Exercises
# the sharded evaluator + sharded windowed reductions + sharded Schur PCG
# across two REAL processes, not just one eval.
import skeres as st  # noqa: E402
from skeres.core.options import SolverOptions  # noqa: E402
from skeres.core.types import LinearSolverType, PreconditionerType  # noqa: E402

bal2 = synthetic_bal(num_cameras=4, num_points=30, observations_per_point=3)
problem2, _, _ = build_bal_problem(bal2)
options = SolverOptions(
    linear_solver_type=LinearSolverType.ITERATIVE_SCHUR,
    preconditioner_type=PreconditionerType.SCHUR_JACOBI,
    max_num_iterations=5,
    function_tolerance=0.0,
    gradient_tolerance=0.0,
    parameter_tolerance=0.0,
    mesh=mesh,
)
summary = st.solve(options, problem2)
traj = np.array([it.cost for it in summary.iterations])
np.testing.assert_allclose(traj, ref["traj"], rtol=1e-6)
print(f"proc {proc_id}: OK traj n={len(traj)} final={traj[-1]:.6e}")
