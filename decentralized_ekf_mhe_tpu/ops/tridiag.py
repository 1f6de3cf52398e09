"""Batched symmetric block-tridiagonal solver — the MHE's exact QP kernel.

The reference solves its MHE as a sparse OSQP problem (MheSrb.cpp:340-349)
whose Hessian is block-banded with one-timestep coupling (SURVEY.md §5
long-context analysis). Because every constraint in the formulation is an
equality in slack variables (measurement v, process w, camera vcam —
DecentralEst.cpp:460-488, 574-581), the slacks eliminate analytically and the
optimal states solve an unconstrained normal-equation system

    D_0 x_0 + U_0 x_1                = r_0
    U_{j-1}ᵀ x_{j-1} + D_j x_j + U_j x_{j+1} = r_j
    U_{K-2}ᵀ x_{K-2} + D_{K-1} x_{K-1}       = r_{K-1}

— block tridiagonal, SPD. This module solves it with a block-Thomas /
block-Cholesky forward-backward sweep under `lax.scan` (O(K) sequential steps
of (s,s) batched ops), giving the *exact* minimizer OSQP iterates toward
(within its 1e-6 tolerance), in one shot, batched over instances.

Warmup masking: `valid` marks live states; invalid slots get D=I, U=0, r=0 so
they solve to zero without touching the live block.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def solve(D: jnp.ndarray, U: jnp.ndarray, r: jnp.ndarray, valid=None) -> jnp.ndarray:
    """Solve the block-tridiagonal SPD system.

    Args:
      D: (K, ..., s, s) diagonal blocks (symmetric).
      U: (K-1, ..., s, s) super-diagonal blocks (coupling j -> j+1).
      r: (K, ..., s) right-hand side.
      valid: optional (K, ...) mask of live slots (True = live).

    Returns: x of shape (K, ..., s).
    """
    K, s = D.shape[0], D.shape[-1]
    eye = jnp.eye(s, dtype=D.dtype)

    if valid is not None:
        v = valid[..., None, None].astype(D.dtype)
        D = D * v + eye * (1.0 - v)
        r = r * valid[..., None].astype(r.dtype)
        # coupling between any pair with an invalid member is dropped
        vU = (valid[:-1] & valid[1:])[..., None, None].astype(U.dtype)
        U = U * vU

    # Factorization uses unrolled Gauss-Jordan inverses (ops/smallmat.py);
    # the Schur complements S_j are SPD so pivoting is unnecessary.
    # forward sweep: S_j = D_j − U_{j-1}ᵀ S_{j-1}⁻¹ U_{j-1},
    #                y_j = r_j − U_{j-1}ᵀ S_{j-1}⁻¹ y_{j-1}
    from decentralized_ekf_mhe_tpu.ops import smallmat

    def fwd(carry, inp):
        Sinv_prev, y_prev = carry
        D_j, U_prev, r_j = inp
        SinvU = Sinv_prev @ U_prev
        Ut = jnp.swapaxes(U_prev, -1, -2)
        S_j = D_j - Ut @ SinvU
        y_j = r_j - jnp.einsum(
            "...ij,...j->...i", Ut, jnp.einsum("...ij,...j->...i", Sinv_prev, y_prev)
        )
        Sinv_j = smallmat.gj_inv(S_j)
        return (Sinv_j, y_j), (Sinv_j, y_j)

    Sinv0 = smallmat.gj_inv(D[0])
    y0 = r[0]
    (_, _), (Sinv_rest, y_rest) = jax.lax.scan(fwd, (Sinv0, y0), (D[1:], U, r[1:]))
    Sinv = jnp.concatenate([Sinv0[None], Sinv_rest], axis=0)
    y = jnp.concatenate([y0[None], y_rest], axis=0)

    # backward sweep: x_{K-1} = S⁻¹y; x_j = S_j⁻¹ (y_j − U_j x_{j+1})
    x_last = jnp.einsum("...ij,...j->...i", Sinv[-1], y[-1])

    def bwd(x_next, inp):
        Sinv_j, y_j, U_j = inp
        rhs = y_j - jnp.einsum("...ij,...j->...i", U_j, x_next)
        x_j = jnp.einsum("...ij,...j->...i", Sinv_j, rhs)
        return x_j, x_j

    _, x_rest = jax.lax.scan(bwd, x_last, (Sinv[:-1], y[:-1], U), reverse=True)
    return jnp.concatenate([x_rest, x_last[None]], axis=0)


def factor(D: jnp.ndarray, U: jnp.ndarray, valid=None):
    """Precompute the block-Thomas factorization of the system matrix.

    Returns ``(Sinv (K,...,s,s), U_masked (K-1,...,s,s))`` for
    ``solve_factored``. Amortizes the Gauss-Jordan inverses when one matrix
    is solved against many right-hand sides — e.g. the ADMM x-update
    (ops/admm.solve_box_tridiag), whose σ/ρ-augmented matrix only changes at
    adaptive-ρ updates: iterations between updates become substitution-only
    (matvec) sweeps.
    """
    K, s = D.shape[0], D.shape[-1]
    eye = jnp.eye(s, dtype=D.dtype)
    if valid is not None:
        v = valid[..., None, None].astype(D.dtype)
        D = D * v + eye * (1.0 - v)
        vU = (valid[:-1] & valid[1:])[..., None, None].astype(U.dtype)
        U = U * vU

    from decentralized_ekf_mhe_tpu.ops import smallmat

    def fwd(Sinv_prev, inp):
        D_j, U_prev = inp
        S_j = D_j - jnp.swapaxes(U_prev, -1, -2) @ (Sinv_prev @ U_prev)
        Sinv_j = smallmat.gj_inv(S_j)
        return Sinv_j, Sinv_j

    Sinv0 = smallmat.gj_inv(D[0])
    _, Sinv_rest = jax.lax.scan(fwd, Sinv0, (D[1:], U))
    return jnp.concatenate([Sinv0[None], Sinv_rest], axis=0), U


def solve_factored(fac, r: jnp.ndarray, valid=None) -> jnp.ndarray:
    """Solve with a precomputed ``factor`` result — matvec sweeps only."""
    Sinv, U = fac
    if valid is not None:
        r = r * valid[..., None].astype(r.dtype)

    def mv(M, v):
        return jnp.einsum("...ij,...j->...i", M, v)

    def fwd(y_prev, inp):
        U_prev, Sinv_prev, r_j = inp
        y_j = r_j - mv(jnp.swapaxes(U_prev, -1, -2), mv(Sinv_prev, y_prev))
        return y_j, y_j

    y0 = r[0]
    _, y_rest = jax.lax.scan(fwd, y0, (U, Sinv[:-1], r[1:]))
    y = jnp.concatenate([y0[None], y_rest], axis=0)

    x_last = mv(Sinv[-1], y[-1])

    def bwd(x_next, inp):
        Sinv_j, y_j, U_j = inp
        x_j = mv(Sinv_j, y_j - mv(U_j, x_next))
        return x_j, x_j

    _, x_rest = jax.lax.scan(bwd, x_last, (Sinv[:-1], y[:-1], U), reverse=True)
    return jnp.concatenate([x_rest, x_last[None]], axis=0)


def solve_dense_check(D, U, r):
    """Reference: assemble the full (K·s, K·s) system and solve densely.

    For tests and small problems only.
    """
    K, s = D.shape[0], D.shape[-1]
    H = jnp.zeros(D.shape[1:-2] + (K * s, K * s), D.dtype)
    rhs = jnp.zeros(r.shape[1:-1] + (K * s,), r.dtype)
    for j in range(K):
        H = H.at[..., j * s:(j + 1) * s, j * s:(j + 1) * s].set(D[j])
        rhs = rhs.at[..., j * s:(j + 1) * s].set(r[j])
        if j < K - 1:
            H = H.at[..., j * s:(j + 1) * s, (j + 1) * s:(j + 2) * s].set(U[j])
            H = H.at[..., (j + 1) * s:(j + 2) * s, j * s:(j + 1) * s].set(
                jnp.swapaxes(U[j], -1, -2)
            )
    x = jnp.linalg.solve(H, rhs[..., None])[..., 0]
    assert x.ndim == 1, "solve_dense_check is unbatched (tests only)"
    return x.reshape(K, s)
