"""Dense SPD Cholesky solver.

Reference analog: ``CLinearSolver_DenseEigen`` (LinearSolver_Schur.h:1046) and
the dense-block fallback ``Cholesky_Dense`` (BlockMatrix.h:3617).  On the
device the dense factorization of small/medium systems (pose-graph cores,
Schur-reduced camera systems) is one library call (XLA's Cholesky: cuSOLVER on
the GPU), which is why this is a first-class solver here rather than a
fallback.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def solve_spd(H: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """x = H^-1 b for symmetric positive definite H via Cholesky."""
    L = lax.linalg.cholesky(H)
    y = lax.linalg.triangular_solve(L, b[:, None], left_side=True, lower=True)
    x = lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True
    )
    return x[:, 0]


def solve_dense(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Gauss-Newton step dx = -H^-1 g (see core.assembly sign convention)."""
    return solve_spd(H, -g)
