"""Batched dense SPD factorization and triangular solves — the dense core of
the partitioned (v3) linear solver's dense-frame path.

``chol_batched`` factors with XLA's batched Cholesky (cuSOLVER on the GPU,
LAPACK on the CPU) and keeps the FROZEN-PIVOT contract of the solver: a pivot
at or below ``clamp`` is replaced by a huge value, so its column's
multipliers go to ~0 and that variable's update is ~0 (instead of being
amplified by 1/sqrt(clamp), which cascades to inf/NaN on near-singular f32
systems).  The caller's f64 refinement absorbs the frozen component.  The
library factorization cannot freeze a pivot, so a frame whose factor shows a
pivot at or below ``clamp`` (or failed outright) is refactored by
``_chol_panel``, an 8-wide panel loop that freezes as it goes.  The panel
loop runs only when some frame of the batch needs it (one ``lax.cond``
over the batch).

Capability parity: the dense factorization/backsubstitution roles of the
reference's Cholesky_Dense (include/slam/BlockMatrix.h:3617) and the dense
Schur-complement solvers CLinearSolver_DenseEigen / CLinearSolver_DenseGPU
(include/slam/LinearSolver_Schur.h:1046,1219).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

PB = 8  # panel width (columns factored per loop step); frame sizes pad to it

_BIG = 1e20  # frozen-pivot value


def _chol_small(D, clamp: float):
    """Lower Cholesky of (..., PB, PB) blocks with frozen pivots, one column
    per loop step.  A loop, not unrolled: with the unrolled form,
    ``chol_batched`` on a (40, 320, 320) f64 batch took 55 s to compile on an
    NVIDIA H100 (700 W), against 1.5 s with the loop."""
    n = D.shape[-1]
    idx = jnp.arange(n)

    def column(j, L):
        Lj = L[..., j, :]  # row j: the columns < j are final
        d = D[..., j, j] - jnp.sum(Lj * Lj, -1)
        Ljj = jnp.sqrt(jnp.where(d > clamp, d, _BIG))[..., None]
        v = D[..., :, j] - jnp.einsum("...ik,...k->...i", L, Lj)
        col = jnp.where(idx > j, v / Ljj, jnp.where(idx == j, Ljj, 0.0))
        return L.at[..., :, j].set(col)

    return lax.fori_loop(0, n, column, jnp.zeros_like(D))


def _chol_panel(A: jnp.ndarray, clamp: float) -> jnp.ndarray:
    """Right-looking panel Cholesky of (K, M, M) with frozen pivots: per
    PB-wide panel, factor the diagonal block, solve the sub-diagonal panel,
    and subtract its outer product from the trailing matrix."""
    K, M, _ = A.shape
    rows = jnp.arange(M)[:, None]

    def panel(j, O):
        j0 = j * PB
        Ljj = _chol_small(lax.dynamic_slice(O, (0, j0, j0), (K, PB, PB)), clamp)
        C = lax.dynamic_slice(O, (0, 0, j0), (K, M, PB))
        W = lax.linalg.triangular_solve(
            Ljj, C, left_side=False, lower=True, transpose_a=True
        )
        W = jnp.where(rows >= j0 + PB, W, 0.0)
        O = lax.dynamic_update_slice(O, W, (0, 0, j0))
        O = lax.dynamic_update_slice(O, Ljj, (0, j0, j0))
        return O - jnp.einsum("kis,kjs->kij", W, W)

    return jnp.tril(lax.fori_loop(0, M // PB, panel, A))


def chol_batched(A: jnp.ndarray, clamp: float = 1e-8) -> jnp.ndarray:
    """Batched lower Cholesky of (K, M, M) SPD matrices (pivot-frozen, see
    the module docstring).  Reads the lower triangle only.  M must be a
    multiple of PB (pad with identity)."""
    L = lax.linalg.cholesky(A, symmetrize_input=False)
    d = jnp.diagonal(L, axis1=-2, axis2=-1)
    ok = jnp.all(d * d > clamp, axis=-1)  # False on NaN (failed factor)
    return lax.cond(
        jnp.all(ok),
        lambda: L,
        lambda: jnp.where(ok[:, None, None], L, _chol_panel(A, clamp)),
    )


def trsm_lower_batched(L: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Batched X = L^-1 B; L (K, M, M) lower from chol_batched, B (K, M, S)."""
    return lax.linalg.triangular_solve(L, B, left_side=True, lower=True)


def trsm_lower_t_batched(L: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Batched X = L^-T B; same layout as trsm_lower_batched."""
    return lax.linalg.triangular_solve(
        L, B, left_side=True, lower=True, transpose_a=True
    )
