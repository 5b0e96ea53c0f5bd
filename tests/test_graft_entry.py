"""Contract tests for ``__graft_entry__``.

``dryrun_multichip(8)`` is called from a FRESH interpreter (no conftest, the
machine's default backend).  The in-suite mesh tests cannot catch a
regression on that path because ``conftest.py`` pins the whole test process to
CPU — so these tests replicate that call pattern in a subprocess with the
conftest's environment overrides stripped.

The regression this pins: a cpu-platform pin gated on a child-only env var
left the default backend on the accelerator in the caller's process.
"""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh_env() -> dict:
    """A fresh process's environment: no CPU-forcing overrides from conftest."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("JAX_NUM_CPU_DEVICES", None)
    env.pop("STORAGE_TPU_DRYRUN_CHILD", None)
    flags = env.get("XLA_FLAGS", "")
    flags = " ".join(
        f for f in flags.split()
        if "xla_force_host_platform_device_count" not in f
    )
    if flags:
        env["XLA_FLAGS"] = flags
    else:
        env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.slow
def test_dryrun_multichip_driver_pattern():
    """The fresh-process invocation must exit 0, quickly, with no output."""
    code = (
        f"import sys; sys.path.insert(0, {REPO!r}); "
        "from __graft_entry__ import dryrun_multichip; dryrun_multichip(8)"
    )
    result = subprocess.run(
        [sys.executable, "-c", code],
        env=_fresh_env(), cwd=REPO, capture_output=True, text=True,
        timeout=600,
    )
    assert result.returncode == 0, (
        f"dryrun_multichip(8) failed in a fresh default-backend process:\n"
        f"stdout: {result.stdout[-2000:]}\nstderr: {result.stderr[-4000:]}"
    )


@pytest.mark.slow
def test_dryrun_multichip_after_backend_init():
    """Pre-initialising the default backend must fall back to the subprocess
    route and still succeed (the caller may call jax.device_count() first)."""
    code = (
        f"import sys; sys.path.insert(0, {REPO!r}); "
        "import jax; jax.device_count(); "
        "from __graft_entry__ import dryrun_multichip; dryrun_multichip(8)"
    )
    result = subprocess.run(
        [sys.executable, "-c", code],
        env=_fresh_env(), cwd=REPO, capture_output=True, text=True,
        timeout=600,
    )
    assert result.returncode == 0, (
        f"dryrun_multichip(8) failed after backend init:\n"
        f"stdout: {result.stdout[-2000:]}\nstderr: {result.stderr[-4000:]}"
    )
