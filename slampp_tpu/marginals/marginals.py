"""Marginal covariance recovery.

Capability parity with ``CMarginals`` (include/slam/Marginals.h:70):
  * dense reference algorithm (Calculate_DenseMarginals_Ref :81) — full
    Sigma = lambda^-1 via Cholesky;
  * selected columns / block diagonal (the -dm policy masks,
    IncrementalPolicy.h:398 EBlockMatrixPart) — solves against unit columns;
  * incremental block-diagonal update from new-edge information (IJRR'17,
    Update_BlockDiagonalMarginals_FBS :4548) — here the exact Woodbury
    downdate, with the b_PreferIncremental-style cost model (:5073) choosing
    between the rank-update and a batch recompute;
  * the CMarginalCovariance cache (:6914) — edge-count watermark + can-update
    flag.

On the device the dense solve path is one library factorization; the sparse recursive (Golub/
Plemmons) algorithm on the block factor is a planned optimization on the
same level-schedule machinery as core/sparse_chol.py.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from slampp_tpu.core import assembly
from slampp_tpu.graph.system import GraphArrays, GraphSystem
from slampp_tpu.graph.types import get_vertex_type


@jax.jit
def dense_marginals(H: jnp.ndarray) -> jnp.ndarray:
    """Full covariance Sigma = H^-1 (reference Calculate_DenseMarginals_Ref)."""
    N = H.shape[0]
    L = lax.linalg.cholesky(H)
    eye = jnp.eye(N, dtype=H.dtype)
    Y = lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    return lax.linalg.triangular_solve(L, Y, left_side=True, lower=True, transpose_a=True)


@jax.jit
def marginals_columns(H: jnp.ndarray, cols: jnp.ndarray) -> jnp.ndarray:
    """Selected columns of Sigma (reference _Fast_ColumnBand family):
    solves H X = I[:, cols]; returns (N, len(cols))."""
    N = H.shape[0]
    E = jnp.zeros((N, cols.shape[0]), H.dtype).at[cols, jnp.arange(cols.shape[0])].set(1.0)
    L = lax.linalg.cholesky(H)
    Y = lax.linalg.triangular_solve(L, E, left_side=True, lower=True)
    return lax.linalg.triangular_solve(L, Y, left_side=True, lower=True, transpose_a=True)


@jax.jit
def woodbury_blockdiag_downdate(H, Sigma_cols, J, W):
    """Exact block update of Sigma after H' = H + J^T W J (new edges).

    Sigma' = Sigma - U S^-1 U^T with U = Sigma J^T, S = W^-1 + J Sigma J^T.
    ``Sigma_cols``: (N, m) = Sigma J^T precomputed columns; ``J``: (m, N)
    stacked new-edge Jacobian rows; ``W``: (m, m).  Returns the (N, m) U and
    (m, m) S factors so callers can downdate any block they track.
    """
    S = jnp.linalg.inv(W) + J @ Sigma_cols
    return Sigma_cols, S


class MarginalCovariance:
    """Marginals cache bound to a system (reference CMarginalCovariance,
    Marginals.h:6914): holds the block-diagonal covariance, an edge-count
    watermark, and a can-update flag cleared when the linearization point
    moves (NonlinearSolver_Lambda.h:655 DisableUpdate)."""

    def __init__(self, system: GraphSystem):
        self.system = system
        self.block_diag: Dict[int, np.ndarray] = {}
        self.edge_watermark = 0
        self.can_update = False
        self._H = None

    def update_batch(self) -> None:
        """Full recompute (reference batch path: marginals tail §3.4)."""
        graph = self.system.snapshot()
        H, g, _ = jax.jit(assembly.assemble_dense)(graph)
        Sigma = dense_marginals(H)
        self._H = np.asarray(H)
        Sigma = np.asarray(Sigma)
        offsets, total = self.system._layout()
        self.block_diag = {}
        for vid, off in offsets.items():
            t, _ = self.system.vertex_index[vid]
            d = get_vertex_type(t).dim
            self.block_diag[vid] = Sigma[off : off + d, off : off + d]
        self.edge_watermark = self.system.n_edges
        self.can_update = True

    def update_batch_sparse(self, panel: int = 1) -> None:
        """Recompute block-diagonal marginals by the RECURSIVE sparse
        algorithm on the factor (the ICRA'15 path,
        Calculate_DenseMarginals_Recurrent_FBS) — O(pattern) instead of
        O(N^2); requires a uniform-block graph.  Does not populate the dense
        cache needed by update_incremental."""
        from slampp_tpu.core import block_assembly, sparse_chol2
        from slampp_tpu.linear.native import NativeBlockSolver
        from slampp_tpu.marginals.sparse_marginals import (
            sparse_marginals,
            takahashi_plan,
        )

        graph = self.system.snapshot()
        ns = NativeBlockSolver(self.system, panel=panel, engine="v2")
        ns.symbolic()
        vals, rhs, _ = jax.jit(
            lambda g: block_assembly.assemble_blocks(g, ns.block_plan)
        )(graph)
        p2 = ns.plan2
        Ld, Lo = sparse_chol2.factorize2(p2, vals[: p2.n], vals[p2.n : p2.n + p2.n_off])
        tk = takahashi_plan(p2)
        Sd, _ = sparse_marginals(p2, tk, Ld, Lo)
        Sd = np.asarray(Sd)
        offs = np.asarray(ns.block_plan.dx_offsets)
        state_dim = ns.block_plan.state_dim
        offsets, _ = self.system._layout()
        by_offset = {off: vid for vid, off in offsets.items()}
        self.block_diag = {}
        for j in range(p2.n):
            o = offs[j]
            for w in range(0, ns.block_plan.P, ns.block_plan.bs):
                if o[w] >= state_dim:
                    continue
                vid = by_offset.get(int(o[w]))
                if vid is None:
                    continue
                d = get_vertex_type(self.system.vertex_index[vid][0]).dim
                self.block_diag[vid] = Sd[j][w : w + d, w : w + d]
        self.edge_watermark = self.system.n_edges
        self.can_update = False  # no dense cache for Woodbury updates

    def prefer_incremental(self, n_new_edge_rows: int) -> bool:
        """Cost model (reference b_PreferIncremental, Marginals.h:5073):
        the Woodbury update costs O(N^2 m + m^3), batch costs O(N^3)."""
        if not self.can_update or not self.block_diag:
            return False
        N = self.system.state_dim
        m = n_new_edge_rows
        return (N * N * m + m**3) < N**3 / 3

    def update_incremental(self, J: np.ndarray, W: np.ndarray) -> None:
        """Rank update after adding edges with stacked Jacobians J (m, N)
        and information W (m, m) at an UNCHANGED linearization point.

        On a numerical failure (non-SPD cache, non-finite update) this falls
        back to the batch recompute — the reference's
        Update_BlockDiagonalMarginals_FBS failure path
        (NonlinearSolver_Lambda.h:731-741)."""
        if self._H is None:
            raise RuntimeError("update_batch must run before incremental updates")
        try:
            # Sigma J^T via the cached H: one batched solve H X = J^T
            L = np.linalg.cholesky(self._H)
            X = np.linalg.solve(L.T, np.linalg.solve(L, J.T))  # (N, m)
            S = np.linalg.inv(W) + J @ X
            Sinv = np.linalg.inv(S)
            if not (np.all(np.isfinite(X)) and np.all(np.isfinite(Sinv))):
                raise np.linalg.LinAlgError("non-finite incremental update")
        except np.linalg.LinAlgError:
            import sys

            print(
                "warning: incremental marginals update had a numerical issue: "
                "restarting with the batch recompute instead",
                file=sys.stderr,
            )
            self.update_batch()
            return
        offsets, _ = self.system._layout()
        for vid, off in offsets.items():
            t, _ = self.system.vertex_index[vid]
            d = get_vertex_type(t).dim
            Ub = X[off : off + d]
            self.block_diag[vid] = self.block_diag[vid] - Ub @ Sinv @ Ub.T
        self._H = self._H + J.T @ W @ J
        self.edge_watermark = self.system.n_edges

    def disable_update(self) -> None:
        """Linearization point changed — incremental updates invalid
        (reference marginals.DisableUpdate)."""
        self.can_update = False
