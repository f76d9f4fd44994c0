"""NIST StRD nonlinear regression certification — the full 27-problem
ladder.

Counterpart of the reference lineage's ``examples/nist.cc``: fit every
NIST Statistical Reference Dataset model from BOTH certified starting
points and require the reached sum-of-squared-residuals to match the
certified value. Problems whose (large, measured) datasets cannot be
embedded are gated on ``data/nist/*.dat`` (DRIVER_REQUESTS.md) and skip
with a clear message until staged; their models/starts/certified values
are already registered (skeres/io/nist_strd.py).

Hard starting points that LM cannot certify from are kept VISIBLE as
xfail entries with analysis, mirroring how ``nist.cc`` reports per-start
success counts rather than hiding failures.
"""

import numpy as np
import pytest

import skeres as st
from skeres.core.options import SolverOptions
from skeres.core.types import LinearSolverType

from skeres.io.nist_strd import EMBEDDED, FILE_GATED, PROBLEMS

# (problem, start_index) pairs where the certified minimum is NOT reached
# from that certified start, with the reason. Mirrors nist.cc's scoreboard:
# these starts are *designed* to defeat naive solvers; Ceres itself does
# not certify all 54 (problem, start) combinations with its default
# trust-region config.
HARD_STARTS = {
    # measured: LM converges to the KNOWN local minimum of the
    # Kowalik-Osborne function, SSR = 1.02734e-3 (documented as the
    # second minimum in More-Garbow-Hillstrom, problem 15)
    ("MGH09", 0): "converges to the documented local minimum 1.02734e-3",
    # Meyer-problem far start (b2/b3 off by 2 orders of magnitude);
    # measured: terminates on a plateau at SSR ~3.9e9 with b1 < 0
    ("MGH10", 0): "terminates on a distant plateau (SSR ~3.9e9)",
    # Osborne-1 far start; measured: invalid-step FAILURE at a stationary
    # plateau where the two exponentials collapse onto each other
    ("MGH17", 0): "stalls at a non-certified stationary plateau",
    # from b=(1,1) the curve is ~saturated for all x: the Jacobian w.r.t.
    # b2 is ~0; measured: LM cannot leave the start (FAILURE)
    ("BoxBOD", 0): "rank-deficient Jacobian at the start; LM stalls",
    # measured: LM rides the degenerate b2->0, b1->inf ridge (y ~ b1*b2*x,
    # SSR 2.0162e4). Cross-checked: scipy least_squares (MINPACK lm AND
    # trf) lands on the SAME ridge from this certified start, as does our
    # DOGLEG and every initial trust-region radius tried — a genuinely
    # deceptive basin, not a solver regression.
    ("BoxBOD", 1): "degenerate b2->0 ridge (scipy lm/trf land there too)",
}


def _fit(prob, b0, max_iterations=1500):
    data = prob.data()
    assert data is not None
    y, X = data
    if prob.log_response:
        y = np.log(y)

    problem = st.Problem()
    b = problem.add_parameter_block(np.asarray(b0, dtype=np.float64))

    def resid(params, data):
        (p,) = params
        return data[0:1] - prob.model(p, data[None, 1:])

    problem.add_residual_blocks(
        resid,
        None,
        [(b.array, np.zeros(len(y), dtype=np.int32))],
        data=np.concatenate([y.reshape(-1, 1), X], axis=1),
    )
    options = SolverOptions(
        linear_solver_type=LinearSolverType.DENSE_QR,
        max_num_iterations=max_iterations,
        use_nonmonotonic_steps=True,
        function_tolerance=1e-16,
        gradient_tolerance=1e-16,
        parameter_tolerance=1e-16,
    )
    summary = st.solve(options, problem)
    return summary, np.asarray(b.value)


def _certify(prob, start_idx):
    summary, b = _fit(prob, prob.starts[start_idx])
    ssr = 2.0 * summary.final_cost
    cert = prob.certified_ssr
    if cert < 1e-20:
        # Lanczos1: data generated to 14 digits, certified SSR 1.4e-25 is
        # at the f64 noise floor; certify by absolute SSR instead
        assert ssr < 1e-20, f"SSR {ssr:.3e} not at noise floor"
    else:
        np.testing.assert_allclose(ssr, cert, rtol=1e-6)


_cases = [
    (name, si)
    for name in EMBEDDED
    for si in range(len(PROBLEMS[name].starts))
]


@pytest.mark.parametrize("name,start_idx", _cases)
def test_nist_embedded(name, start_idx):
    if (name, start_idx) in HARD_STARTS:
        pytest.xfail(HARD_STARTS[(name, start_idx)])
    _certify(PROBLEMS[name], start_idx)


_gated_cases = [
    (name, si)
    for name in FILE_GATED
    for si in range(len(PROBLEMS[name].starts))
]


@pytest.mark.parametrize("name,start_idx", _gated_cases)
def test_nist_file_gated(name, start_idx):
    prob = PROBLEMS[name]
    if prob.data() is None:
        pytest.skip(
            f"dataset data/nist/{prob.data_file} not staged "
            "(zero-egress; see DRIVER_REQUESTS.md)"
        )
    if (name, start_idx) in HARD_STARTS:
        pytest.xfail(HARD_STARTS[(name, start_idx)])
    _certify(prob, start_idx)
