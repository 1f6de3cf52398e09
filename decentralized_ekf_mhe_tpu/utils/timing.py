"""Timing probes: tic/toc scoped timers + jax profiler integration.

The reference instruments with static-timepoint tic/toc pairs duplicated in
two classes (MheSrb.cpp:763-777, DecentralEst.cpp:1031-1044), a per-callback
rate print (EstSub.cpp:88-90) and microsecond probes around the VO replay
(orien_ekf.cpp:167-210). Equivalents here:

- ``tic/toc`` / ``scoped_timer``: host-side wall timers for the replay driver
  (same "<name> elapsed time: ... seconds" report format);
- ``rate_probe``: best-of-reps wall time of a call, fenced with
  ``jax.block_until_ready``;
- ``trace``: context manager around ``jax.profiler`` for kernel-level traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

_TIC_STACK: Dict[str, float] = {}


def tic(name: str = ""):
    _TIC_STACK[name] = time.perf_counter()


def toc(name: str = "", quiet: bool = False) -> float:
    elapsed = time.perf_counter() - _TIC_STACK.get(name, time.perf_counter())
    if not quiet:
        print(f"{name} elapsed time: {elapsed} seconds")
    return elapsed


@contextlib.contextmanager
def scoped_timer(name: str, results: dict | None = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if results is not None:
        results[name] = dt
    else:
        print(f"{name} elapsed time: {dt} seconds")


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace scope (view with tensorboard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def rate_probe(fn, *args, reps: int = 3):
    """Return (best wall seconds, result) over reps calls, each waited for
    with ``jax.block_until_ready`` — the EstSub.cpp:88-90 cycle-rate probe
    generalized."""
    import jax

    best = float("inf")
    out = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out
