"""Driver-entry contract tests.

`dryrun_multichip` must pass in a bare environment: no XLA_FLAGS (so
no pre-provisioned virtual CPU devices), where the entry itself has to
set --xla_force_host_platform_device_count before jax initializes.
These tests run the entry in a clean subprocess to reproduce that
environment.
"""

import os
import subprocess
import sys

import pytest

from btcs_pnes_optical_flow.utils.compile_cache import DEFAULT_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env):
    return subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=900,
    )


def test_dryrun_multichip_clean_env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # nothing provisions devices up front
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", DEFAULT_DIR)
    r = _run(
        "import __graft_entry__ as g; g.dryrun_multichip(8); print('DRYRUN_OK')",
        env,
    )
    assert r.returncode == 0, r.stderr[-4000:]
    assert "DRYRUN_OK" in r.stdout


def test_dryrun_multichip_jax_already_initialized():
    """If the driver process initialized jax first (flags frozen, 1 CPU
    device), the dryrun must self-heal via its subprocess fallback."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("JAX_COMPILATION_CACHE_DIR", DEFAULT_DIR)
    code = (
        "import jax; jax.devices(); "  # freeze the backend at 1 CPU device
        "import __graft_entry__ as g; g.dryrun_multichip(8); print('DRYRUN_OK')"
    )
    r = _run(code, env)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "DRYRUN_OK" in r.stdout
