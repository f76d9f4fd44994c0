"""Host-side pieces of the root ``chip_smoke.py`` and the compile-cache
helper every entry point uses, checked on the CPU."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_snavely_reference_cost_matches_solver(smoke):
    """The numpy f64 Snavely model that checks the venice phase must give
    ``st.solve``'s own costs, before and after the solve."""
    from skeres.io.bal import synthetic_bal

    bal = synthetic_bal(num_cameras=6, num_points=60, observations_per_point=3)
    initial = smoke.snavely_cost(bal, bal.cameras, bal.points)
    summary, cams, pts, _ = smoke.solve_bal(bal, max_num_iterations=5)
    assert smoke.steps_taken(summary) == 5
    np.testing.assert_allclose(summary.initial_cost, initial, rtol=1e-10)
    np.testing.assert_allclose(
        summary.final_cost, smoke.snavely_cost(bal, cams, pts), rtol=1e-10
    )
    assert summary.final_cost < 1e-3 * summary.initial_cost


def test_device_check_refuses_cpu():
    from skeres.utils.runtime import require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def _run(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_smoke_fails_without_a_gpu():
    out = _run(REPO)
    assert out.returncode != 0
    assert "FAIL phase a device" in out.stdout
    assert '"ok"' not in out.stdout


def test_smoke_fails_alone(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "FAIL" in out.stdout
    assert '"ok"' not in out.stdout


def test_cache_helper_honours_env(monkeypatch, tmp_path):
    from skeres.utils import runtime

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_helper_defaults_to_repo(monkeypatch):
    from skeres.utils import runtime

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
