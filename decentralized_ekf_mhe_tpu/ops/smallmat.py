"""Small-matrix linear algebra: unrolled, batch-vectorized.

The (B, s, s) matrices this framework inverts (s ∈ {3,...,21}) are far too
small for XLA's LAPACK-style `cholesky`/`triangular_solve`/`lu` HLOs, which
launch per call and iterate; unrolled Gauss-Jordan elimination is plain
elementwise arithmetic that XLA fuses into the surrounding ops. All
estimator matrices needing inversion are SPD (covariance / information
matrices), so pivot-free elimination is numerically safe.

These routines broadcast over arbitrary leading batch axes and unroll over
the static trailing (s, s) dims.
"""

from __future__ import annotations

import jax.numpy as jnp


def gj_inv(A: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a batched SPD (or safely pivoted) (..., n, n) matrix via
    pivot-free Gauss-Jordan elimination, unrolled over n."""
    n = A.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)
    aug = jnp.concatenate([A, eye], axis=-1)
    for i in range(n):
        piv = aug[..., i, i][..., None]
        row = aug[..., i, :] / piv
        col = aug[..., :, i][..., None]
        aug = aug - col * row[..., None, :]
        aug = aug.at[..., i, :].set(row)
    return aug[..., n:]


def solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b for SPD A: (..., n, n) @ (..., n) -> (..., n)."""
    return jnp.einsum("...ij,...j->...i", gj_inv(A), b)


def solve_mat(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Solve A X = B for SPD A with matrix right-hand side (..., n, m)."""
    return gj_inv(A) @ B


def inv3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form inverse of batched (..., 3, 3) matrices (adjugate)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    adj = jnp.stack([A11, A12, A13, A21, A22, A23, A31, A32, A33], axis=-1)
    return adj.reshape(A.shape) / det[..., None, None]


def inv(A: jnp.ndarray) -> jnp.ndarray:
    """Dispatch: closed-form for 3x3, Gauss-Jordan otherwise."""
    return inv3(A) if A.shape[-1] == 3 else gj_inv(A)
