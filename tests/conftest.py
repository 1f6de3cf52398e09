"""Test harness config: CPU backend, 8 virtual devices, float64 enabled.

Tests run on the CPU and validate numerics against numpy float64 oracles at
tight tolerance (the reference C++ is all double). Multi-device sharding
logic is exercised on 8 virtual CPU devices (SURVEY.md §4). The backend is
chosen through jax.config before any backend is initialized, since
something on the pytest import chain may import jax before this file runs.

Tests that can run only on an NVIDIA card carry the ``gpu`` marker and take
the ``gpu_card`` fixture, which decides at run time (never at import) and
skips when no card is present.
"""

import os
import shutil
import subprocess

import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from decentralized_ekf_mhe_tpu.utils.runtime import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent compile cache: reruns skip the XLA:CPU LLVM backend entirely
# (the suite compiles >100 programs; beyond speed, live LLVM compiles late in
# a long-lived process have been observed to segfault — cache hits avoid them).
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

assert jax.devices()[0].platform == "cpu", "tests must run on CPU"
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"


@pytest.fixture
def gpu_card():
    """The ``name, power.limit`` line of the machine's first NVIDIA card;
    skips the test when there is none. This process itself stays on the
    CPU, so a card test drives the card from a subprocess."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA card: nvidia-smi not found")
    from decentralized_ekf_mhe_tpu.utils.runtime import gpu_query

    try:
        return gpu_query()
    except (subprocess.SubprocessError, OSError, IndexError) as e:
        pytest.skip(f"no NVIDIA card: {e}")


def run_example(script: str, *args: str, timeout: int = 900):
    """Run an examples/ CLI driver in a fresh subprocess on the CPU backend.

    Example drivers are real entry points; exercising them via subprocess
    tests the CLI surface itself and isolates their (large) XLA compilations
    from the test process — the XLA:CPU compiler has been observed to
    segfault on big programs compiled late in a long-lived session.
    Returns the completed process; asserts rc == 0 with the output attached.
    """
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "examples", script), *args],
        capture_output=True, text=True, timeout=timeout, cwd=repo, env=env,
    )
    assert proc.returncode == 0, (
        f"{script} rc={proc.returncode}\nstdout:\n{proc.stdout}\n"
        f"stderr:\n{proc.stderr}"
    )
    return proc
