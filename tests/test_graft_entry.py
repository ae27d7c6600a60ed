"""Driver entry-point robustness.

``dryrun_multichip`` must force the CPU platform and its virtual device
count itself. These tests exercise the entry in-process and, as a fresh
process with NO platform/env preparation, so the self-containment cannot
regress.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_flags_rewrites_existing_count():
    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    assert g._cpu_flags(8, "") == "--xla_force_host_platform_device_count=8"
    assert (
        g._cpu_flags(4, "--foo --xla_force_host_platform_device_count=2")
        == "--foo --xla_force_host_platform_device_count=4"
    )


def test_dryrun_inline_on_test_mesh():
    """Inline path: this process already has a CPU backend with 8 virtual
    devices (conftest), so the dry run must execute in-process."""
    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    g.dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_fresh_process_no_env_prep():
    """Fresh interpreter, no XLA_FLAGS, no JAX_PLATFORMS —
    dryrun_multichip must force the CPU mesh itself."""
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
    }
    out = subprocess.run(
        [
            sys.executable,
            "-c",
            "import __graft_entry__ as g; g.dryrun_multichip(8)",
        ],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=560,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dryrun_multichip ok" in out.stdout
