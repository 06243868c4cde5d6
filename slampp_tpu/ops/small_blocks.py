"""Unrolled batched kernels for tiny SPD blocks (3x3, 6x6, ...).

Unrolled forms are straight-line element-wise math over the batch dimension
(the role of the reference's compile-time fixed-block-size FBS kernels,
include/slam/BlockMatrixFBS.h) in place of batched ``lax.linalg.cholesky``/
``triangular_solve`` calls on tiny blocks.  Whether they still beat the
library calls on the GPU is unmeasured (ROADMAP re-decide list).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def cholesky_small(A: jnp.ndarray, clamp: float = 0.0) -> jnp.ndarray:
    """Batched lower Cholesky of (..., bs, bs) SPD blocks, unrolled over bs.

    With ``clamp`` > 0, pivots are floored at ``clamp`` (static pivoting —
    the factorization of a numerically indefinite block stays finite and the
    error is absorbed by iterative refinement, core/sparse_chol.py).
    """
    bs = A.shape[-1]
    L = [[None] * bs for _ in range(bs)]
    for j in range(bs):
        d = A[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        if clamp > 0.0:
            d = jnp.maximum(d, clamp)
        Ljj = jnp.sqrt(d)
        L[j][j] = Ljj
        inv = 1.0 / Ljj
        for i in range(j + 1, bs):
            v = A[..., i, j]
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            L[i][j] = v * inv
    rows = []
    zero = jnp.zeros_like(A[..., 0, 0])
    for i in range(bs):
        rows.append(jnp.stack([L[i][j] if j <= i else zero for j in range(bs)], axis=-1))
    return jnp.stack(rows, axis=-2)


def cholesky_blocked(A: jnp.ndarray, clamp: float = 0.0, blk: int = 8) -> jnp.ndarray:
    """Batched lower Cholesky for larger panels via ``blk``-column blocking:
    each diagonal sub-block uses the unrolled clamped kernel, off-diagonal
    panels use unrolled TRSM + one batched GEMM update.  Keeps the traced
    program small (O((bs/blk)^2) ops) while staying NaN-free under clamping.
    """
    bs = A.shape[-1]
    if bs <= blk:
        return cholesky_small(A, clamp)
    nb = (bs + blk - 1) // blk
    out = jnp.zeros_like(A)
    for j in range(nb):
        j0, j1 = j * blk, min((j + 1) * blk, bs)
        Ajj = A[..., j0:j1, j0:j1]
        # subtract prior panels
        if j > 0:
            Lleft = out[..., j0:j1, 0:j0]
            Ajj = Ajj - jnp.einsum("...ik,...jk->...ij", Lleft, Lleft, precision=lax.Precision.HIGHEST)
        Ljj = cholesky_small(Ajj, clamp)
        out = out.at[..., j0:j1, j0:j1].set(Ljj)
        if j1 < bs:
            W = A[..., j1:bs, j0:j1]
            if j > 0:
                W = W - jnp.einsum(
                    "...ik,...jk->...ij", out[..., j1:bs, 0:j0], out[..., j0:j1, 0:j0],
                    precision=lax.Precision.HIGHEST,
                )
            X = solve_triangular_right_transpose_small(W, Ljj)
            out = out.at[..., j1:bs, j0:j1].set(X)
    return out


def solve_triangular_right_transpose_small(W: jnp.ndarray, L: jnp.ndarray) -> jnp.ndarray:
    """Batched X = W @ L^-T for lower-triangular L: X L^T = W, unrolled.

    W: (..., m, bs); L: (..., bs, bs) lower. Column j of X:
      X[:, j] = (W[:, j] - sum_{k<j} X[:, k] L[j, k]) / L[j, j]
    """
    bs = L.shape[-1]
    X = [None] * bs
    for j in range(bs):
        v = W[..., :, j]
        for k in range(j):
            v = v - X[k] * L[..., j, k][..., None]
        X[j] = v / L[..., j, j][..., None]
    return jnp.stack(X, axis=-1)


def solve_triangular_right_transpose_blocked(
    W: jnp.ndarray, L: jnp.ndarray, blk: int = 8
) -> jnp.ndarray:
    """Batched X = W @ L^-T for larger lower-triangular L via column-panel
    blocking (pairs with :func:`cholesky_blocked`)."""
    bs = L.shape[-1]
    if bs <= blk:
        return solve_triangular_right_transpose_small(W, L)
    nb = (bs + blk - 1) // blk
    X = jnp.zeros_like(W)
    for j in range(nb):
        j0, j1 = j * blk, min((j + 1) * blk, bs)
        Wj = W[..., :, j0:j1]
        if j > 0:
            Wj = Wj - jnp.einsum(
                "...mk,...jk->...mj", X[..., :, 0:j0], L[..., j0:j1, 0:j0],
                precision=lax.Precision.HIGHEST,
            )
        Xj = solve_triangular_right_transpose_small(Wj, L[..., j0:j1, j0:j1])
        X = X.at[..., :, j0:j1].set(Xj)
    return X


def solve_lower_blocked(L: jnp.ndarray, b: jnp.ndarray, blk: int = 8) -> jnp.ndarray:
    """Batched y = L^-1 b via column-panel blocking."""
    bs = L.shape[-1]
    if bs <= blk:
        return solve_lower_small(L, b)
    nb = (bs + blk - 1) // blk
    y = jnp.zeros_like(b)
    for j in range(nb):
        j0, j1 = j * blk, min((j + 1) * blk, bs)
        bj = b[..., j0:j1]
        if j > 0:
            bj = bj - jnp.einsum("...ik,...k->...i", L[..., j0:j1, 0:j0], y[..., 0:j0], precision=lax.Precision.HIGHEST)
        y = y.at[..., j0:j1].set(solve_lower_small(L[..., j0:j1, j0:j1], bj))
    return y


def solve_lower_transpose_blocked(L: jnp.ndarray, b: jnp.ndarray, blk: int = 8) -> jnp.ndarray:
    """Batched x = L^-T b via column-panel blocking (reverse order)."""
    bs = L.shape[-1]
    if bs <= blk:
        return solve_lower_transpose_small(L, b)
    nb = (bs + blk - 1) // blk
    x = jnp.zeros_like(b)
    for j in reversed(range(nb)):
        j0, j1 = j * blk, min((j + 1) * blk, bs)
        bj = b[..., j0:j1]
        if j1 < bs:
            bj = bj - jnp.einsum("...ki,...k->...i", L[..., j1:bs, j0:j1], x[..., j1:bs], precision=lax.Precision.HIGHEST)
        x = x.at[..., j0:j1].set(solve_lower_transpose_small(L[..., j0:j1, j0:j1], bj))
    return x


def solve_lower_small(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched y = L^-1 b for lower-triangular L; b: (..., bs)."""
    bs = L.shape[-1]
    y = [None] * bs
    for i in range(bs):
        v = b[..., i]
        for k in range(i):
            v = v - L[..., i, k] * y[k]
        y[i] = v / L[..., i, i]
    return jnp.stack(y, axis=-1)


def solve_lower_transpose_small(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched x = L^-T b; b: (..., bs)."""
    bs = L.shape[-1]
    x = [None] * bs
    for i in reversed(range(bs)):
        v = b[..., i]
        for k in range(i + 1, bs):
            v = v - L[..., k, i] * x[k]
        x[i] = v / L[..., i, i]
    return jnp.stack(x, axis=-1)


def inverse_spd_small(A: jnp.ndarray) -> jnp.ndarray:
    """Batched SPD inverse via unrolled Cholesky (for block-diag inverses,
    reference InverseOf_BlockDiag_FBS_Parallel, BlockMatrix.h:3165)."""
    bs = A.shape[-1]
    L = cholesky_small(A)
    cols = []
    for j in range(bs):
        e = jnp.zeros(A.shape[:-1], A.dtype).at[..., j].set(1.0)
        y = solve_lower_small(L, e)
        cols.append(solve_lower_transpose_small(L, y))
    return jnp.stack(cols, axis=-1)
