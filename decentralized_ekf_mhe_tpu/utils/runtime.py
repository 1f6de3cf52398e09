"""Backend choice and the persistent compile cache, in one place.

Every entry point (bench.py, chip_smoke.py, examples/, tools/) starts with
``init_backend``. The platform is the GPU unless the caller asks for the
CPU: a run that finds no card stops with a message instead of quietly
measuring the CPU.

The compile cache lives where ``JAX_COMPILATION_CACHE_DIR`` says (JAX reads
that variable itself, so nothing is set), else at ``<repo>/.jax_cache``. The
path is part of the cache key, so it is fixed: never a temporary name, a
process id or a time.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=None) -> str:
    """The compile-cache directory under the rule above."""
    env = os.environ if environ is None else environ
    return env.get(CACHE_ENV) or os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache(environ=None) -> str:
    """Point JAX's persistent compile cache at ``compile_cache_dir``; set
    nothing when the environment already names the directory."""
    env = os.environ if environ is None else environ
    path = compile_cache_dir(env)
    if not env.get(CACHE_ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def init_backend(cpu: bool = False):
    """Select the platform and enable the compile cache; return the devices.

    ``cpu=True`` forces the CPU backend (call before any other JAX use).
    Otherwise JAX's default device must be a GPU, else SystemExit.
    """
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    devices = jax.devices()
    if not cpu and devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's default device is {devices[0].platform!r}. "
            f"This run needs an NVIDIA card; scripts with a --cpu option "
            f"run on the CPU when given it.")
    return devices


GPU_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def gpu_query() -> str:
    """The first card's ``name, power.limit`` line as nvidia-smi prints it.
    Numbers taken on a card are reported beside this line: a card set
    below its maximum power limit runs slower under load."""
    import subprocess

    out = subprocess.run(GPU_QUERY, capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def parse_gpu_query(line: str) -> tuple[str, str]:
    """Split a ``name, power.limit`` line into (name, power limit)."""
    name, sep, limit = line.rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line {line!r}")
    return name.strip(), limit.strip()
