"""Symmetric eigenvalue analysis of system matrices.

Capability parity with ``CSymEigsSolver`` (include/slam/Eigenvalues.h:179,
364; src/slam/Eigenvalues.cpp) — the Spectra-like implicitly-restarted
solver used for condition-number/observability analysis
(scripts/eigenvalues/): largest-magnitude eigenpairs, and smallest
eigenpairs via the shift-invert mode backed by the framework's own
factorization (the reference uses its block LDLT).

On the device: Lanczos with full reorthogonalization as a jitted fixed-iteration
loop over the operator (dense matvec or user-supplied matvec); LOBPCG from
jax.experimental for blocks of extremal eigenpairs where applicable.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp


def lanczos_extremal(
    matvec: Callable,
    n: int,
    k: int = 6,
    iters: int = 60,
    seed: int = 0,
    dtype=jnp.float64,
):
    """Lanczos with full reorthogonalization; returns (ritz_values,
    ritz_vectors) approximating the extremal spectrum of the symmetric
    operator.  ``iters`` >= k; cost is iters matvecs."""
    iters = max(iters, k + 2)
    key = jax.random.PRNGKey(seed)
    v0 = jax.random.normal(key, (n,), dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    V = jnp.zeros((iters + 1, n), dtype).at[0].set(v0)
    alphas = jnp.zeros(iters, dtype)
    betas = jnp.zeros(iters, dtype)

    def body(carry, j):
        V, alphas, betas = carry
        v = V[j]
        w = matvec(v)
        a = jnp.dot(v, w)
        w = w - a * v - jnp.where(j > 0, betas[j - 1], 0.0) * V[jnp.maximum(j - 1, 0)]
        # full reorthogonalization (stability; problem sizes are moderate)
        w = w - V.T @ (V @ w)
        b = jnp.linalg.norm(w)
        V = V.at[j + 1].set(jnp.where(b > 1e-12, w / b, 0.0))
        alphas = alphas.at[j].set(a)
        betas = betas.at[j].set(b)
        return (V, alphas, betas), None

    (V, alphas, betas), _ = jax.lax.scan(body, (V, alphas, betas), jnp.arange(iters))
    T = jnp.diag(alphas) + jnp.diag(betas[:-1], 1) + jnp.diag(betas[:-1], -1)
    evals, evecs = jnp.linalg.eigh(T)
    ritz = V[:iters].T @ evecs  # (n, iters)
    return evals, ritz


def largest_eigenvalues(H: jnp.ndarray, k: int = 6, iters: int = 60):
    """k largest-magnitude eigenvalues of a symmetric matrix (the reference's
    largest-magnitude mode)."""
    n = H.shape[0]
    evals, ritz = lanczos_extremal(lambda v: H @ v, n, k, iters)
    idx = jnp.argsort(-jnp.abs(evals))[:k]
    return evals[idx], ritz[:, idx]


def smallest_eigenvalues_shift_invert(
    H: jnp.ndarray, k: int = 6, shift: float = 0.0, iters: int = 60
):
    """k smallest eigenvalues via shift-invert Lanczos (reference
    SpSym_Eigenvalues smallest-eig mode, Eigenvalues.h:60): runs Lanczos on
    (H - shift I)^-1 using a cached Cholesky."""
    from jax import lax

    n = H.shape[0]
    Hs = H - shift * jnp.eye(n, dtype=H.dtype)
    L = lax.linalg.cholesky(Hs)

    def inv_mv(v):
        y = lax.linalg.triangular_solve(L, v[:, None], left_side=True, lower=True)
        x = lax.linalg.triangular_solve(
            L, y, left_side=True, lower=True, transpose_a=True
        )
        return x[:, 0]

    evals_inv, ritz = lanczos_extremal(inv_mv, n, k, iters)
    idx = jnp.argsort(-evals_inv)[:k]  # largest of inverse = smallest of H
    lam = shift + 1.0 / evals_inv[idx]
    return lam, ritz[:, idx]


def condition_number(H: jnp.ndarray, iters: int = 80) -> float:
    """Spectral condition estimate (observability analysis use case)."""
    lmax, _ = largest_eigenvalues(H, 1, iters)
    lmin, _ = smallest_eigenvalues_shift_invert(H, 1, 0.0, iters)
    return float(jnp.abs(lmax[0]) / jnp.maximum(jnp.abs(lmin[0]), 1e-300))


# ------------------------------------------------------------- sparse operator
#
# The reference operates on the sparse block matrix at full problem size
# (CSymEigsSolver over CUberBlockMatrix, Eigenvalues.h:179; shift-invert
# through the block LDLT, :364).  The device analog: a matvec over the
# assembled fine-block lambda (never densified) and shift-invert through the
# partitioned (v3) factorization.


class SparseSystemOperator:
    """Symmetric operator over a GraphSystem's block lambda.

    ``matvec(x)`` with x in the GLOBAL scalar layout; the Hessian is held as
    fine (nnzb, bs, bs) blocks of the v3 plan — O(nnz), never (N, N).
    """

    def __init__(self, system, target: int = 64):
        from slampp_tpu.core import block_assembly
        from slampp_tpu.linear.partitioned import PartitionedSolver

        self._ps = PartitionedSolver(
            system, target=target, mixed_precision=False, refine_iters=0
        )
        self._ps.symbolic()
        graph = system.snapshot()
        self.n = graph.state_dim
        bp, p = self._ps.block_plan, self._ps.plan
        vals, rhs, _ = jax.jit(
            lambda g: block_assembly.assemble_blocks_sorted(g, bp)
        )(graph)
        self._vals = vals
        self._bp, self._p = bp, p
        self._factor_cache = {}

    def _to_fine(self, x):
        pad = max(self._bp.P, self._p.bs)
        xg = jnp.concatenate([x, jnp.zeros(pad, x.dtype)])
        return xg[self._bp.dx_offsets]  # (n, P) permuted fine layout

    def matvec(self, x):
        from slampp_tpu.core import block_assembly
        from slampp_tpu.linear.partitioned import _spmv_fine

        xf = self._to_fine(x)
        yf = _spmv_fine(self._p, self._vals[: self._p.nnzb], xf)
        return block_assembly.scatter_dx(self._bp, yf, self._p.bs)

    def solve_shifted(self, x, shift: float = 0.0):
        """(H - shift I)^-1 x through the partitioned factorization."""
        from slampp_tpu.core import block_assembly
        from slampp_tpu.linear.partitioned import _backsolve, _factor32, _solve_with

        key = float(shift)
        fac = self._factor_cache.get(key)
        p = self._p
        if fac is None:
            d = jnp.arange(p.bs)
            vals = self._vals[: p.nnzb]
            vals = vals.at[: p.n, d, d].add(-shift)
            zrhs = jnp.zeros((p.n + 1, p.bs), vals.dtype)
            L, WU, y, Ls, rhs_s = _factor32(p, vals, zrhs)
            fac = (L, WU, Ls)
            self._factor_cache[key] = fac
        L, WU, Ls = fac
        xf = self._to_fine(x)
        xf1 = jnp.concatenate([xf, jnp.zeros((1, p.bs), xf.dtype)], 0)
        zf = _solve_with(p, L, WU, Ls, xf1, None)
        return block_assembly.scatter_dx(self._bp, zf, p.bs)


def sparse_largest_eigenvalues(system, k: int = 6, iters: int = 60,
                               target: int = 64):
    """k largest-magnitude eigenpairs of the system lambda WITHOUT
    densifying (reference largest-magnitude mode at full problem size)."""
    op = SparseSystemOperator(system, target=target)
    mv = jax.jit(op.matvec)
    evals, ritz = lanczos_extremal(mv, op.n, k, iters)
    idx = jnp.argsort(-jnp.abs(evals))[:k]
    return evals[idx], ritz[:, idx]


def sparse_smallest_eigenvalues_shift_invert(system, k: int = 6,
                                             shift: float = 0.0,
                                             iters: int = 60,
                                             target: int = 64):
    """k smallest eigenvalues via shift-invert Lanczos through the v3
    factorization (reference Eigenvalues.h:364 block-LDLT shift-invert)."""
    op = SparseSystemOperator(system, target=target)
    inv = jax.jit(lambda v: op.solve_shifted(v, shift))
    evals_inv, ritz = lanczos_extremal(inv, op.n, k, iters)
    idx = jnp.argsort(-evals_inv)[:k]
    lam = shift + 1.0 / evals_inv[idx]
    return lam, ritz[:, idx]


def sparse_condition_number(system, iters: int = 80, target: int = 64) -> float:
    """Spectral condition estimate on the sparse operator (observability
    analysis at full problem size)."""
    lmax, _ = sparse_largest_eigenvalues(system, 1, iters, target)
    lmin, _ = sparse_smallest_eigenvalues_shift_invert(system, 1, 0.0, iters, target)
    return float(jnp.abs(lmax[0]) / jnp.maximum(jnp.abs(lmin[0]), 1e-300))
