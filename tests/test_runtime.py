"""Process set-up of the measurement scripts (utils/runtime.py) and the
host-side helpers of chip_smoke.py: compile-cache placement, the refusal
to measure without a GPU, and the f64 reference the smoke test trusts."""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

from vec_ode_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import benchmarks  # noqa: E402
import chip_smoke  # noqa: E402


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of applying them."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_cache_dir_follows_environment_variable(tmp_path):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")}
    assert runtime.compile_cache_dir(env) == str(tmp_path / "cc")


@pytest.mark.parametrize("env", [{}, {"JAX_COMPILATION_CACHE_DIR": ""}])
def test_cache_dir_defaults_to_repo(env):
    assert runtime.compile_cache_dir(env) == os.path.join(REPO, ".jax_cache")


def test_enable_cache_sets_nothing_when_variable_is_set(tmp_path,
                                                       config_updates):
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
    assert runtime.enable_compile_cache(env) == str(tmp_path)
    assert config_updates == []


def test_enable_cache_points_jax_at_repo_default(config_updates):
    path = runtime.enable_compile_cache({})
    assert config_updates == [("jax_compilation_cache_dir", path)]
    assert path == os.path.join(REPO, ".jax_cache")


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu()


def test_device_record_reports_jax_devices():
    rec = runtime.device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


@pytest.mark.parametrize("main", [chip_smoke.main, bench.main,
                                  benchmarks.main],
                         ids=["chip_smoke", "bench", "benchmarks"])
def test_scripts_refuse_without_gpu(main, config_updates, capsys):
    with pytest.raises(SystemExit, match="no GPU"):
        main([])
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_refuses_four_card_flag_without_gpu(config_updates,
                                                      capsys):
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.main(["--four-cards"])
    assert capsys.readouterr().out == ""


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repo the script cannot import the package:
    it must exit non-zero and print no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_collective_counts():
    hlo = ("%ar = f32[4] all-reduce(f32[4] %x), replica_groups={}\n"
           "%ag.1 = f32[8] all-gather(f32[4] %y)\n"
           "%ag.2 = f32[8] all-gather-start(f32[4] %z)\n"
           "%w = (s32[]) while(%c)\n")
    counts = chip_smoke.collective_counts(hlo)
    assert counts["all-reduce"] == 1
    assert counts["all-gather"] == 2
    assert sum(counts.values()) == 3


def test_scipy_reference_matches_closed_form():
    """With V = 0 the driven system is exp(-i H0 t) psi0."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    H0 = (X + X.conj().T) / 2
    model = types.SimpleNamespace(H0=H0, V=np.zeros((4, 4)), w=3.0)
    psi0 = rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4))
    evals, evecs = np.linalg.eigh(H0)
    U = evecs @ np.diag(np.exp(-1j * evals * 0.7)) @ evecs.conj().T
    ref = chip_smoke.scipy_reference(model, psi0, 0.7)
    np.testing.assert_allclose(ref, psi0 @ U.T, atol=1e-10)


def test_bench_summary_counts_steps():
    """bench._summary turns a Solution's counters into the JSON detail."""
    sol = types.SimpleNamespace(
        path="xla-driver", status=np.ones(3, np.int32),
        n_accept=np.asarray([10, 20, 30]), n_reject=np.asarray([1, 0, 2]),
        n_iters=np.asarray([11, 20, 32]))
    r = bench._summary(sol, [0.3, 0.1, 0.2], 5.0)
    assert r["wall_s_median"] == 0.2
    assert r["accepted_steps"] == 60 and r["rejected_steps"] == 3
    assert r["max_iters"] == 32 and r["all_done"]
    assert abs(r["accepted_steps_per_s"] - 300.0) < 1e-9
    json.dumps(r)
