"""Sharded windowed-incremental support: mesh-parallel chunk elimination.

SURVEY §2.12 stage 8 mandates a distributed story for the incremental mode.
The windowed/FastL solvers' expensive periodic events are chunk (re)freezes
— eliminating each frozen chunk's interior at its current linearization and
caching its Schur complement onto the separator
(solvers/incremental_windowed.py, solvers/fastl.py;
reference economics: NonlinearSolver_FastL.h:954).  Chunks are mutually
independent, so a relinearization sweep that refreezes many chunks is an
embarrassingly parallel batch: this module shards the chunk batch over a
device mesh and eliminates every chunk with ONE batched
Cholesky/TRSM program per shard — the multi-host analog of the reference's
OpenMP block factorizations.

The same code runs on the virtual CPU mesh (tests, driver dry-run) and on
real cards.  Solvers can route their ``_freeze_chunk`` batches here
when a mesh is available; the sequential NumPy path remains the default on
a single host (latency-bound, see solvers/fastl.py).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


@functools.lru_cache(maxsize=16)
def _eliminate_fn(mesh: Mesh, axis: str):
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        check_vma=False,
    )
    def eliminate(H, g, ni, reg):
        """Per-shard batched chunk elimination.

        H: (c, D, D) padded dense chunk systems (interior-first layout),
        g: (c, D), ni: (c,) interior scalar dims.  Padded rows/cols must be
        identity-regularized by the caller.  Returns per chunk
        (L, WU, y, contrib_sc, contrib_rhs) with boundary rows beyond
        D - ni zero."""
        c, D, _ = H.shape
        r = jnp.arange(D)
        # mask: interior-interior block gets H_ii, elsewhere identity so one
        # batched Cholesky of shape (c, D, D) factors every chunk interior
        im = r[None, :] < ni[:, None]                 # (c, D) interior mask
        ii = im[:, :, None] & im[:, None, :]
        eye = jnp.eye(D, dtype=H.dtype)[None]
        A = jnp.where(ii, H, eye) + reg * eye
        L = jax.lax.linalg.cholesky(A)
        # U = H[interior, boundary]; boundary cols masked into place
        bm = ~im
        U = jnp.where(im[:, :, None] & bm[:, None, :], H, 0.0)
        WU = jax.lax.linalg.triangular_solve(
            L, U, left_side=True, lower=True
        )
        y = jax.lax.linalg.triangular_solve(
            L, jnp.where(im, g, 0.0)[..., None], left_side=True, lower=True
        )[..., 0]
        Hss = jnp.where(bm[:, :, None] & bm[:, None, :], H, 0.0)
        contrib_sc = Hss - jnp.einsum("cds,cdt->cst", WU, WU)
        contrib_rhs = jnp.where(bm, g, 0.0) - jnp.einsum("cds,cd->cs", WU, y)
        return L, WU, y, contrib_sc, contrib_rhs

    return jax.jit(eliminate)


def eliminate_chunks_mesh(
    Hs: np.ndarray, gs: np.ndarray, ni: np.ndarray, mesh: Mesh,
    axis: str = "chunks", reg: float = 1e-12,
) -> Tuple[np.ndarray, ...]:
    """Eliminate a batch of frozen chunks over the mesh.

    Hs (C, D, D), gs (C, D), ni (C,): padded chunk systems in
    interior-first layout (identity on padding).  The batch is padded to a
    multiple of the mesh axis and sharded; every device factors its chunks
    with one batched Cholesky.  Returns (L, WU, y, contrib_sc, contrib_rhs)
    as (C, ...) host arrays — the exact quantities the windowed/FastL
    freeze records cache (solvers/incremental_windowed.py _freeze_chunk).
    """
    C, D, _ = Hs.shape
    n_dev = mesh.shape[axis]
    pad = (-C) % n_dev
    if pad:
        eye = np.broadcast_to(np.eye(D), (pad, D, D))
        Hs = np.concatenate([Hs, eye])
        gs = np.concatenate([gs, np.zeros((pad, D))])
        ni = np.concatenate([ni, np.full(pad, D, ni.dtype)])
    fn = _eliminate_fn(mesh, axis)
    out = fn(
        jnp.asarray(Hs), jnp.asarray(gs), jnp.asarray(ni, jnp.int32),
        jnp.asarray(reg),
    )
    return tuple(np.asarray(o)[:C] for o in out)


def pack_chunks(
    chunks: List[Tuple[np.ndarray, np.ndarray, int]], bucket: int = 32
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad variable-size chunk systems (H, g, ni) to one bucketed D."""
    D = max(h.shape[0] for h, _, _ in chunks)
    D = ((D + bucket - 1) // bucket) * bucket
    C = len(chunks)
    Hs = np.tile(np.eye(D), (C, 1, 1))
    gs = np.zeros((C, D))
    nis = np.zeros(C, np.int32)
    for k, (h, g, ni) in enumerate(chunks):
        d = h.shape[0]
        Hs[k, :d, :d] = h
        gs[k, :d] = g
        nis[k] = ni
    return Hs, gs, nis, D
