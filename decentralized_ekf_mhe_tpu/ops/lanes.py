"""Instance-on-lanes small-matrix algebra — the fleet-layout math kernel.

These helpers keep the instance batch B on the minor (lane) axis: matrices
are (..., s, s, B), vectors (..., s, B), so every scalar matrix entry is a
dense, contiguous (B,) vector and each small-matrix product is an
elementwise multiply-add over whole fleet rows, which XLA fuses. The
standard (B, s, s) layout instead puts the tiny s dims minor-most.

All helpers accept arbitrary leading window/batch axes via einsum ellipsis;
`b` is the single trailing instance axis. The unrolled Gauss-Jordan inverse
mirrors ops/smallmat.py (same pivot-free SPD assumption).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# All contractions below are broadcast-multiply + sum over the small static
# dim k (≤ 21) rather than einsum/dot_general: XLA fuses elementwise chains
# and reductions into single kernels, whereas every dot_general is its own
# kernel launch — at these sizes per-launch overhead dominates the math.


def mm(A, B):
    """(..., i, k, b) @ (..., k, j, b) -> (..., i, j, b)."""
    return jnp.sum(A[..., :, :, None, :] * B[..., None, :, :, :], axis=-3)


def mm_tn(A, B):
    """Aᵀ @ B: (..., k, i, b), (..., k, j, b) -> (..., i, j, b)."""
    return jnp.sum(A[..., :, :, None, :] * B[..., :, None, :, :], axis=-4)


def mm_nt(A, B):
    """A @ Bᵀ: (..., i, k, b), (..., j, k, b) -> (..., i, j, b)."""
    return jnp.sum(A[..., :, None, :, :] * B[..., None, :, :, :], axis=-2)


def cmm(C, A):
    """Const @ lanes: (i, k) @ (..., k, j, b) -> (..., i, j, b)."""
    return jnp.sum(C[:, :, None, None] * A[..., None, :, :, :], axis=-3)


def cmm_t(C, A):
    """Constᵀ @ lanes: (k, i) @ (..., k, j, b) -> (..., i, j, b)."""
    return jnp.sum(C[:, :, None, None] * A[..., :, None, :, :], axis=-4)


def mmc(A, C):
    """Lanes @ const: (..., i, k, b) @ (k, j) -> (..., i, j, b)."""
    return jnp.sum(A[..., :, :, None, :] * C[:, :, None], axis=-3)


def mv(A, v):
    """(..., i, k, b) @ (..., k, b) -> (..., i, b)."""
    return jnp.sum(A * v[..., None, :, :], axis=-2)


def mv_t(A, v):
    """Aᵀ v: (..., k, i, b), (..., k, b) -> (..., i, b)."""
    return jnp.sum(A * v[..., :, None, :], axis=-3)


def cmv(C, v):
    """Const @ lanes vector: (i, k) @ (..., k, b) -> (..., i, b)."""
    return jnp.sum(C[:, :, None] * v[..., None, :, :], axis=-2)


def transpose(A):
    """Matrix transpose in lanes layout: swap the two core axes."""
    return jnp.swapaxes(A, -3, -2)


def eye(n, dtype, like=None):
    """(n, n, 1) identity, broadcastable against any (..., n, n, B)."""
    return jnp.eye(n, dtype=dtype)[:, :, None]


def const(M):
    """Lift a constant (..., i, j) matrix into lanes layout (..., i, j, 1)."""
    return jnp.asarray(M)[..., None]


def to_lanes(a):
    """Standard batch-leading (B, ...) -> lanes (..., B)."""
    return jnp.moveaxis(a, 0, -1)


def from_lanes(a):
    """Lanes (..., B) -> standard batch-leading (B, ...)."""
    return jnp.moveaxis(a, -1, 0)


def skew(v):
    """(..., 3, b) -> (..., 3, 3, b) skew-symmetric (EigenUtils.hpp:91-97)."""
    x, y, z = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    o = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([o, -z, y], axis=-2),
            jnp.stack([z, o, -x], axis=-2),
            jnp.stack([-y, x, o], axis=-2),
        ],
        axis=-3,
    )


def cross(a, b):
    """(..., 3, b) x (..., 3, b) -> (..., 3, b)."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return jnp.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], axis=-2
    )


def gj_inv(A):
    """Pivot-free Gauss-Jordan inverse of (..., n, n, b) SPD matrices,
    unrolled over n (ops/smallmat.py semantics in lanes layout)."""
    n = A.shape[-2]
    ident = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype)[:, :, None], A.shape)
    aug = jnp.concatenate([A, ident], axis=-2)  # (..., n, 2n, b)
    row_ids = jax.lax.broadcasted_iota(jnp.int32, (n, 1, 1), 0)
    for i in range(n):
        piv = aug[..., i, i, :][..., None, :]
        row = aug[..., i, :, :] / piv
        col = aug[..., :, i, :][..., :, None, :]
        # eliminating row i against itself zeroes it; re-insert by mask
        aug = jnp.where(
            row_ids == i, row[..., None, :, :], aug - col * row[..., None, :, :]
        )
    return aug[..., :, n:, :]


def inv3(A):
    """Closed-form adjugate inverse of (..., 3, 3, b) matrices."""
    a, b, c = A[..., 0, 0, :], A[..., 0, 1, :], A[..., 0, 2, :]
    d, e, f = A[..., 1, 0, :], A[..., 1, 1, :], A[..., 1, 2, :]
    g, h, i = A[..., 2, 0, :], A[..., 2, 1, :], A[..., 2, 2, :]
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
    adj = jnp.stack(
        [
            jnp.stack([A11, A12, A13], axis=-2),
            jnp.stack([A21, A22, A23], axis=-2),
            jnp.stack([A31, A32, A33], axis=-2),
        ],
        axis=-3,
    )
    return adj / det[..., None, None, :]


def inv(A):
    """Dispatch: closed-form for 3x3, Gauss-Jordan otherwise."""
    return inv3(A) if A.shape[-2] == 3 else gj_inv(A)


def thomas_factor(D, U):
    """Precompute the block-Thomas factorization in lanes layout.

    Returns ``(Sinv (N,s,s,B), U)`` for ``thomas_solve_factored`` — the lanes
    twin of ops/tridiag.factor. Amortizes the Gauss-Jordan inverses across
    many right-hand sides (the ADMM x-update re-solves the same σ/ρ-augmented
    matrix every iteration within a ρ-epoch).
    """
    N = D.shape[0]
    Sinv = [None] * N
    Sinv[0] = gj_inv(D[0])
    for j in range(1, N):
        W = mm(Sinv[j - 1], U[j - 1])
        S_j = D[j] - mm_tn(U[j - 1], W)
        Sinv[j] = gj_inv(S_j)
    return jnp.stack(Sinv, axis=0), U


def thomas_solve_factored(fac, r):
    """Solve with a precomputed ``thomas_factor`` result — matvec sweeps only.

    Args: fac from thomas_factor; r (N, s, B). Returns x (N, s, B).
    """
    Sinv, U = fac
    N = r.shape[0]
    y = [None] * N
    y[0] = r[0]
    for j in range(1, N):
        y[j] = r[j] - mv_t(U[j - 1], mv(Sinv[j - 1], y[j - 1]))
    x = [None] * N
    x[N - 1] = mv(Sinv[N - 1], y[N - 1])
    for j in range(N - 2, -1, -1):
        x[j] = mv(Sinv[j], y[j] - mv(U[j], x[j + 1]))
    return jnp.stack(x, axis=0)


def thomas_solve(D, U, r):
    """Block-Thomas sweep on a lanes-layout SPD block-tridiagonal system,
    unrolled over the static window length.

    Args:
      D: (N, s, s, B) diagonal blocks (warmup-masked by the caller).
      U: (N-1, s, s, B) super-diagonal couplings.
      r: (N, s, B) right-hand side.
    Returns x: (N, s, B).
    """
    N = D.shape[0]
    Sinv = [None] * N
    y = [None] * N
    Sinv[0] = gj_inv(D[0])
    y[0] = r[0]
    for j in range(1, N):
        W = mm(Sinv[j - 1], U[j - 1])
        S_j = D[j] - mm_tn(U[j - 1], W)
        y[j] = r[j] - mv_t(U[j - 1], mv(Sinv[j - 1], y[j - 1]))
        Sinv[j] = gj_inv(S_j)
    x = [None] * N
    x[N - 1] = mv(Sinv[N - 1], y[N - 1])
    for j in range(N - 2, -1, -1):
        x[j] = mv(Sinv[j], y[j] - mv(U[j], x[j + 1]))
    return jnp.stack(x, axis=0)
