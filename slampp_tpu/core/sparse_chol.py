"""Device-side block-sparse Cholesky: numeric factorization and triangular
solves as fixed-shape jitted programs.

Capability parity with the reference's native block Cholesky
(``CUberBlockMatrix::CholeskyOf`` src/slam/BlockMatrix.cpp:9547) and block
triangular solves (BlockMatrix.h:3284-3580).  The device design: the host
symbolic plan (core/symbolic.py) levels the elimination tree; one
``lax.scan`` over levels performs, per level, (a) all pending outer-product
updates as one batched GEMM + scatter-add, (b) all diagonal factorizations as
one batched Cholesky, (c) all column solves as one batched TRSM.  Every level
touches padded fixed-size index arrays, so the whole factorization compiles
once per graph structure regardless of values.

Padding convention: slot index ``nnzb`` is a dummy block (an extra slot
appended to the value array, kept = I so batched cholesky/trsm stay finite);
block-column index ``n`` is a dummy RHS row.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from slampp_tpu.ops import small_blocks


class DevicePlan(NamedTuple):
    """CholeskyPlan index arrays as device arrays (a pytree)."""

    n: int
    nnzb: int
    diag_slot: jnp.ndarray
    rows: jnp.ndarray  # (nnzb,) block-row of each slot (for SpMV/refinement)
    cols: jnp.ndarray  # (nnzb,) block-col of each slot
    upd_dst: jnp.ndarray
    upd_a: jnp.ndarray
    upd_b: jnp.ndarray
    lvl_diag: jnp.ndarray
    lvl_offd: jnp.ndarray
    lvl_offd_diag: jnp.ndarray
    fwd_slot: jnp.ndarray
    fwd_src: jnp.ndarray
    fwd_dst: jnp.ndarray
    lvl_cols: jnp.ndarray
    bwd_slot: jnp.ndarray
    bwd_src: jnp.ndarray
    bwd_dst: jnp.ndarray


_DP_STATIC = ("n", "nnzb")


def _dp_flatten(p):
    leaves = tuple(getattr(p, f) for f in DevicePlan._fields if f not in _DP_STATIC)
    return leaves, (p.n, p.nnzb)


def _dp_unflatten(aux, leaves):
    kw = dict(zip(_DP_STATIC, aux))
    kw.update(zip([f for f in DevicePlan._fields if f not in _DP_STATIC], leaves))
    return DevicePlan(**kw)


jax.tree_util.register_pytree_node(DevicePlan, _dp_flatten, _dp_unflatten)


def device_plan(plan) -> DevicePlan:
    return DevicePlan(
        n=int(plan.n),
        nnzb=int(plan.nnzb),
        diag_slot=jnp.asarray(plan.diag_slot, jnp.int32),
        rows=jnp.asarray(plan.rows, jnp.int32),
        cols=jnp.asarray(plan.cols, jnp.int32),
        upd_dst=jnp.asarray(plan.upd_dst, jnp.int32),
        upd_a=jnp.asarray(plan.upd_a, jnp.int32),
        upd_b=jnp.asarray(plan.upd_b, jnp.int32),
        lvl_diag=jnp.asarray(plan.lvl_diag, jnp.int32),
        lvl_offd=jnp.asarray(plan.lvl_offd, jnp.int32),
        lvl_offd_diag=jnp.asarray(plan.lvl_offd_diag, jnp.int32),
        fwd_slot=jnp.asarray(plan.fwd_slot, jnp.int32),
        fwd_src=jnp.asarray(plan.fwd_src, jnp.int32),
        fwd_dst=jnp.asarray(plan.fwd_dst, jnp.int32),
        lvl_cols=jnp.asarray(plan.lvl_cols, jnp.int32),
        bwd_slot=jnp.asarray(plan.bwd_slot, jnp.int32),
        bwd_src=jnp.asarray(plan.bwd_src, jnp.int32),
        bwd_dst=jnp.asarray(plan.bwd_dst, jnp.int32),
    )


def factorize(dp: DevicePlan, vals: jnp.ndarray, clamp: float = 0.0) -> jnp.ndarray:
    """Numeric block Cholesky.

    ``vals``: (nnzb, bs, bs) — the lower-triangular blocks of A scattered
    into the L slot structure (fill slots zero).  Returns L values in the
    same layout (diagonal blocks lower-triangular Cholesky factors).
    ``clamp`` > 0 floors pivots (static pivoting for low-precision factors).
    """
    bs = vals.shape[-1]
    eye = jnp.eye(bs, dtype=vals.dtype)
    # dummy slot: identity so cholesky/trsm of padding is well-defined
    vals = jnp.concatenate([vals, eye[None]], axis=0)

    def level_step(vals, idx):
        upd_dst, upd_a, upd_b, lvl_diag, lvl_offd, lvl_offd_diag = idx
        # (a) pending outer-product updates: dst -= A @ B^T, batched
        a = vals[upd_a]
        b = vals[upd_b]
        upd = jnp.einsum("eij,ekj->eik", a, b, precision=lax.Precision.HIGHEST)
        mask = (upd_dst < dp.nnzb)[:, None, None]
        # triples are pre-sorted by destination (core/symbolic.py) — the
        # sorted hint lets XLA lower a cheaper scatter-add
        vals = vals.at[upd_dst].add(
            jnp.where(mask, -upd, 0.0), indices_are_sorted=True
        )
        # (b) diagonal factorization — unrolled/blocked clamped kernels (the
        # FBS analog; avoids XLA's loop-bound batched cholesky and stays
        # NaN-free under static pivoting); reads only the lower triangle
        D = vals[lvl_diag]
        Dq = jnp.where((lvl_diag < dp.nnzb)[:, None, None], D, eye[None])
        Lj = small_blocks.cholesky_blocked(Dq, clamp=clamp)
        vals = vals.at[lvl_diag].set(Lj)
        # (c) column solve: L[i,j] = W[i,j] @ Lj^-T
        W = vals[lvl_offd]
        Dj = vals[lvl_offd_diag]
        Djq = jnp.where((lvl_offd_diag < dp.nnzb)[:, None, None], Dj, eye[None])
        X = small_blocks.solve_triangular_right_transpose_blocked(W, Djq)
        vals = vals.at[lvl_offd].set(X)
        # keep the dummy slot = I
        vals = vals.at[dp.nnzb].set(eye)
        return vals, None

    vals, _ = lax.scan(
        level_step,
        vals,
        (dp.upd_dst, dp.upd_a, dp.upd_b, dp.lvl_diag, dp.lvl_offd, dp.lvl_offd_diag),
    )
    return vals[:-1]


def solve(dp: DevicePlan, Lvals: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L L^T x = b given factorize() output.

    ``b``: (n, bs) block RHS; returns (n, bs).
    Reference analogs: UpperTriangularTranspose_Solve / UpperTriangular_Solve
    (BlockMatrix.h:3454, :3528) — here level-scheduled batched ops.
    """
    bs = b.shape[-1]
    eye = jnp.eye(bs, dtype=Lvals.dtype)
    Lp = jnp.concatenate([Lvals, eye[None]], axis=0)
    y = jnp.concatenate([b, jnp.zeros((1, bs), b.dtype)], axis=0)  # dummy row n

    diag_for_col = jnp.concatenate(
        [dp.diag_slot.astype(jnp.int32), jnp.asarray([dp.nnzb], jnp.int32)]
    )

    # forward: y_j = Lj^-1 (b_j - sum L[j,k] y_k), by level
    def fwd_step(y, idx):
        slots, srcs, dsts, cols = idx
        contrib = jnp.einsum("eij,ej->ei", Lp[slots], y[srcs], precision=lax.Precision.HIGHEST)
        contrib = jnp.where((dsts < dp.n)[:, None], contrib, 0.0)
        y = y.at[dsts].add(-contrib)
        # triangular solve on this level's columns
        cs = jnp.where(cols < dp.n, cols, dp.n)
        Dj = Lp[diag_for_col[cs]]
        yj = small_blocks.solve_lower_blocked(Dj, y[cs])
        y = y.at[cs].set(yj)
        return y, None

    y, _ = lax.scan(fwd_step, y, (dp.fwd_slot, dp.fwd_src, dp.fwd_dst, dp.lvl_cols))

    # backward: x_j = Lj^-T (y_j - sum_{i>j} L[i,j]^T x_i), by REVERSE level
    x = y

    # entries (i, j) are grouped by level(j); the sources x_i live at higher
    # levels, so processing levels in DESCENDING order we subtract each
    # column's incoming contributions first, then solve that column.
    def bwd_step(x, idx):
        slots, srcs, dsts, cols = idx
        contrib = jnp.einsum("eji,ej->ei", Lp[slots], x[srcs], precision=lax.Precision.HIGHEST)
        contrib = jnp.where((dsts < dp.n)[:, None], contrib, 0.0)
        x = x.at[dsts].add(-contrib)
        cs = jnp.where(cols < dp.n, cols, dp.n)
        Dj = Lp[diag_for_col[cs]]
        xj = small_blocks.solve_lower_transpose_blocked(Dj, x[cs])
        x = x.at[cs].set(xj)
        return x, None

    rev = lambda a: jnp.flip(a, axis=0)
    x, _ = lax.scan(
        bwd_step,
        x,
        (rev(dp.bwd_slot), rev(dp.bwd_src), rev(dp.bwd_dst), rev(dp.lvl_cols)),
    )
    return x[:-1]


def spmv_symmetric(dp: DevicePlan, vals: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """y = A x for the symmetric block matrix whose LOWER blocks are packed
    in ``vals`` (A layout, pre-factorization).  Used by iterative refinement
    and by matrix-free operators (eigen-analysis, PCG).

    NOTE: diagonal blocks must be stored with their full lower triangle and a
    symmetric upper part is assumed; for panel layouts the diagonal panels
    only carry the lower triangle, so we symmetrize them on the fly.
    """
    n, bs = x.shape
    # symmetrize diagonal panels (cheap; only lower is populated)
    D = vals[dp.diag_slot]
    Dlow = jnp.tril(D, -1)
    Dsym = Dlow + jnp.swapaxes(Dlow, 1, 2) + jnp.eye(bs, dtype=vals.dtype) * D
    y = jnp.einsum("nij,nj->ni", Dsym, x, precision=lax.Precision.HIGHEST)
    # off-diagonal blocks: y[r] += B x[c]; y[c] += B^T x[r]
    offd = dp.rows != dp.cols
    B = jnp.where(offd[:, None, None], vals, 0.0)
    contrib_r = jnp.einsum("eij,ej->ei", B, x[dp.cols], precision=lax.Precision.HIGHEST)
    contrib_c = jnp.einsum("eji,ej->ei", B, x[dp.rows], precision=lax.Precision.HIGHEST)
    y = y.at[dp.rows].add(contrib_r)
    y = y.at[dp.cols].add(contrib_c)
    return y


def solve_refined(
    dp: DevicePlan,
    vals64: jnp.ndarray,
    b64: jnp.ndarray,
    refine_iters: int = 2,
    damping_rel: float = 1e-6,
):
    """Mixed-precision solve: f32 factorization with static relative damping,
    followed by f64 iterative refinement against the exact f64 operator.

    The damping makes the f32 Cholesky robust far from convergence (static
    pivoting); refinement removes both the damping bias and the f32 rounding,
    recovering f64-accurate solutions at f32 speed (SURVEY.md §7 hard
    part 3).
    """
    bs = vals64.shape[-1]
    d = jnp.arange(bs)
    # Jacobi equilibration: scale to unit diagonal before the f32 factor.
    # SLAM systems mix units (angles vs meters, information 1 vs 1e4) and the
    # weak gauge anchor makes kappa(H) >> 1/eps32; symmetric diagonal scaling
    # compresses the spectrum enough for the f32 factor to precondition well.
    diag_entries = vals64[dp.diag_slot][:, d, d]  # (n, bs)
    s = 1.0 / jnp.sqrt(jnp.maximum(diag_entries, 1e-30))
    sr = s[dp.rows]  # (nnzb, bs)
    sc = s[dp.cols]
    vals_s = vals64 * sr[:, :, None] * sc[:, None, :]
    # static relative damping on the (now unit) diagonal
    vals_s = vals_s.at[dp.diag_slot[:, None], d[None, :], d[None, :]].add(damping_rel)
    # clamped pivots: the f32 factor of an ill-conditioned system stays
    # finite even when rounding makes a pivot non-positive
    L32 = factorize(dp, vals_s.astype(jnp.float32), clamp=1e-8)

    def solve32(r64):
        y = solve(dp, L32, (s * r64).astype(jnp.float32))
        return s * y.astype(jnp.float64)

    x = solve32(b64)
    for _ in range(refine_iters):
        r = b64 - spmv_symmetric(dp, vals64, x)
        x = x + solve32(r)
    return x
