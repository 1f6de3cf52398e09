"""Matmul-precision control.

On NVIDIA cards XLA may run a float32 matrix product in TF32, which keeps
about ten mantissa bits. That destroys the SPD structure of the estimator's
information matrices (NaN or wildly wrong elimination pivots in the window
solve) and breaks the 1e-3 velocity-RMSE gate against the float64 oracle.
Every public kernel entry point is wrapped in ``full_precision`` so the
traced computation always multiplies and accumulates in full float32,
regardless of global config. These are (B, s≤21, s≤21) contractions, far
too small for the tensor cores to pay.
"""

from __future__ import annotations

import functools

import jax


def full_precision(fn):
    """Trace ``fn`` under jax.default_matmul_precision('highest')."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
