"""Schur-complement-based covariance recovery for bundle adjustment.

Capability parity with BAMarginals.h (3DV'17, ``CBlockVectorMAD_Impl``
:43, ``CUTTSolve_Bases_Impl`` :238): camera marginals from the inverse Schur
complement, landmark block-diagonal marginals recovered from them:

  Sigma_cc       = SC^-1
  Sigma_ll(diag) = C^-1 + C^-1 U^T Sigma_cc U C^-1   (per-landmark blocks)

On the device both terms are batched dense contractions over landmark blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from slampp_tpu.linear.schur import SchurPlan


@jax.jit
def schur_marginals(H: jnp.ndarray, plan: SchurPlan, alpha=0.0):
    """Returns (Sigma_cc, Sigma_ll_blocks) — the dense covariance of the
    reduced (camera) system and the (n_l, d, d) landmark diagonal blocks."""
    d = plan.lm_dim
    cam = plan.cam_idx
    rows = plan.lm_offsets[:, None] + jnp.arange(d)[None, :]

    D = H[rows[:, :, None], rows[:, None, :]] + alpha * jnp.eye(d, dtype=H.dtype)
    B = H[cam[:, None, None], rows[None, :, :]]  # (n_c, n_l, d)
    A = H[cam[:, None], cam[None, :]] + alpha * jnp.eye(cam.shape[0], dtype=H.dtype)

    Dinv = jnp.linalg.inv(D)
    BDinv = jnp.einsum("cld,lde->cle", B, Dinv)
    SC = A - jnp.einsum("cld,kld->ck", BDinv, B)

    L = lax.linalg.cholesky(SC)
    eye = jnp.eye(SC.shape[0], dtype=H.dtype)
    Y = lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    Sigma_cc = lax.linalg.triangular_solve(
        L, Y, left_side=True, lower=True, transpose_a=True
    )

    # landmark diag: C^-1 + (C^-1 U^T) Sigma_cc (U C^-1), batched per landmark
    G = jnp.einsum("cle,led->cld", B, Dinv)  # U C^-1 rows per camera
    T = jnp.einsum("ck,kld->cld", Sigma_cc, G)
    Sigma_ll = Dinv + jnp.einsum("cld,cle->lde", G, T)
    return Sigma_cc, Sigma_ll
