"""Block-Jacobi preconditioned conjugate gradient on the dense-assembled
Gauss-Newton system.

Capability parity with the reference's experimental ``CNonlinearSolver_SPCG``
(include/slam/NonlinearSolver_SPCG.h:61, subgraph-preconditioned CG on A).
On the device, CG is the latency-friendly incremental-mode workhorse: every
iteration is one dense matvec + vector ops, with no sequential
elimination-tree dependency, and the whole solve is one ``lax.while_loop``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def pcg_solve(
    H: jnp.ndarray,
    b: jnp.ndarray,
    block_size: int = 0,
    tol: float = 1e-10,
    max_iters: int = 250,
) -> jnp.ndarray:
    """Solve H x = b by PCG with a (block-)Jacobi preconditioner.

    ``block_size`` 0 or 1 selects scalar Jacobi; otherwise H's leading
    dimension must be a multiple of ``block_size`` and the preconditioner is
    the inverse of the block diagonal (the reference's landmark/pose block
    structure).
    """
    N = H.shape[0]
    if block_size and block_size > 1 and N % block_size == 0:
        nb = N // block_size
        blocks = H.reshape(nb, block_size, nb, block_size)
        diag = blocks[jnp.arange(nb), :, jnp.arange(nb), :]
        Minv = jnp.linalg.inv(diag)

        def precond(r):
            return jnp.einsum("bij,bj->bi", Minv, r.reshape(nb, block_size)).reshape(-1)

    else:
        d = jnp.diagonal(H)
        dinv = jnp.where(jnp.abs(d) > 1e-300, 1.0 / d, 0.0)

        def precond(r):
            return dinv * r

    b2 = jnp.dot(b, b)

    def cond(state):
        x, r, z, p, rz, k = state
        return jnp.logical_and(k < max_iters, jnp.dot(r, r) > tol * tol * b2)

    def body(state):
        x, r, z, p, rz, k = state
        Hp = H @ p
        alpha = rz / jnp.maximum(jnp.dot(p, Hp), 1e-300)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = jnp.dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-300)
        p = z + beta * p
        return (x, r, z, p, rz_new, k + 1)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    state = (x0, r0, z0, z0, jnp.dot(r0, z0), jnp.zeros((), jnp.int32))
    x, r, *_ = lax.while_loop(cond, body, state)
    return x
