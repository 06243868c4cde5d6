"""Schur-complement linear solver.

Capability parity with ``CLinearSolver_Schur`` (include/slam/
LinearSolver_Schur.h:1424) and its GPU backend (LinearSolver_Schur_GPU.cpp):
partition the system into landmark-like variables (eliminated) and the rest
(the reduced "camera" system), invert the block-diagonal landmark part in a
single batched kernel, form SC = A - B D^-1 B^T as batched dense GEMMs,
factor the dense SC, and back-substitute the landmarks.

The reference's guided ordering by vertex type/dimension
(schur_detail::CGuidedOrdering_Helper, LinearSolver_Schur.h:725) maps here to
the ``is_landmark`` flag on registered vertex types; the symbolic phase
(`build_schur_plan`) runs on host once per graph structure, the numeric phase
is a fixed-shape jitted program.  On the device this *is* the default BA
path — the role the CUDA/CULA offload plays in the reference (SURVEY.md §2.2).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

import jax
import jax.numpy as jnp

from slampp_tpu.core import assembly
from slampp_tpu.graph.system import GraphArrays, GraphSystem
from slampp_tpu.graph.types import get_vertex_type
from slampp_tpu.linear.dense import solve_spd


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class SchurPlan:
    """Host-precomputed elimination plan (the symbolic decomposition,
    reference SymbolicDecomposition_Blocky, LinearSolver_Schur.h:1553)."""

    cam_idx: jnp.ndarray  # (n_c,) scalar indices of the reduced system
    lm_offsets: jnp.ndarray  # (n_l,) scalar offsets of landmark blocks
    lm_dim: int  # uniform landmark block size

    def tree_flatten(self):
        return (self.cam_idx, self.lm_offsets), (self.lm_dim,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0])


def build_schur_plan(system: GraphSystem, allow_mis_fallback: bool = True) -> SchurPlan:
    """Derive the landmark/camera partition from vertex types (guided
    ordering).  Requires all landmark types present to share one block size
    (true for every reference problem: 3D points, 2D landmarks, inv-depth).

    When no vertex type is landmark-like (e.g. a pose-only graph), falls back
    to a greedy maximum-independent-set elimination ordering — the reference's
    CSchurOrdering::n_Calculate_Ordering MIS path
    (include/slam/LinearSolver_Schur.h:275,332): an independent set has a
    block-diagonal Hessian block by construction, so it Schur-eliminates the
    same way landmarks do."""
    offsets, total = system._layout()
    lm_offs = []
    lm_dims = set()
    for vid, (t, _) in system.vertex_index.items():
        vt = get_vertex_type(t)
        if vt.is_landmark and vid in offsets:
            lm_offs.append(offsets[vid])
            lm_dims.add(vt.dim)
    if not lm_offs:
        if not allow_mis_fallback:
            raise ValueError("no landmark-like vertices to eliminate")
        lm_offs, lm_dims = _mis_elimination_set(system, offsets)
    if len(lm_dims) > 1:
        raise ValueError(f"mixed landmark dims not yet supported: {lm_dims}")
    d = lm_dims.pop()
    lm_offs = np.sort(np.array(lm_offs, dtype=np.int32))
    lm_scalar = (lm_offs[:, None] + np.arange(d)[None, :]).reshape(-1)
    cam_idx = np.setdiff1d(np.arange(total, dtype=np.int32), lm_scalar)
    return SchurPlan(jnp.asarray(cam_idx), jnp.asarray(lm_offs), d)


def _mis_elimination_set(system: GraphSystem, offsets):
    """Greedy-MIS elimination set over the vertex graph (host symbolic).

    Candidates are restricted to the most common block dimension so the
    eliminated diagonal stays uniform (matching the batched D^-1 kernel).
    """
    from slampp_tpu.core.ordering import block_adjacency, mis_first_fit
    from slampp_tpu.graph.types import get_vertex_type as _gvt

    vids = sorted(v for v in system.vertex_index if v in offsets)
    pos = {v: i for i, v in enumerate(vids)}
    dims = np.array([_gvt(system.vertex_index[v][0]).dim for v in vids])
    modal_dim = np.bincount(dims).argmax()

    pairs = []
    for t in system.edge_type_names:
        for evids in system._edges[t]["vids"]:
            ev = [v for v in evids if v in pos]
            for a in range(len(ev)):
                for b in range(a + 1, len(ev)):
                    pairs.append((pos[ev[a]], pos[ev[b]]))
    adj = block_adjacency(len(vids), pairs)
    deg = np.diff(adj.indptr)
    candidates = np.flatnonzero(dims == modal_dim)
    order = candidates[np.argsort(deg[candidates], kind="stable")]
    mis = mis_first_fit(adj, order=order)
    if len(mis) == 0:
        raise ValueError("MIS fallback produced an empty elimination set")
    lm_offs = [offsets[vids[i]] for i in mis]
    return lm_offs, {int(modal_dim)}


def schur_solve(H: jnp.ndarray, g: jnp.ndarray, plan: SchurPlan, alpha=0.0):
    """Solve (H + alpha I) dx = -g by landmark elimination.

    Mirrors the reference solve pipeline (LinearSolver_Schur.h:1623-1770):
    C^-1 batched block inverse -> B C^-1 -> SC = A - B C^-1 B^T -> dense
    Cholesky of SC -> landmark back-substitution.
    """
    d = plan.lm_dim
    n_l = plan.lm_offsets.shape[0]
    cam = plan.cam_idx

    rows = plan.lm_offsets[:, None] + jnp.arange(d)[None, :]  # (n_l, d)
    # D: (n_l, d, d) landmark diagonal blocks (+ damping)
    D = H[rows[:, :, None], rows[:, None, :]] + alpha * jnp.eye(d, dtype=H.dtype)
    # B: (n_c, n_l, d) coupling blocks
    B = H[cam[:, None, None], rows[None, :, :]]
    A = H[cam[:, None], cam[None, :]] + alpha * jnp.eye(cam.shape[0], dtype=H.dtype)

    Dinv = jnp.linalg.inv(D)  # batched small inverses
    BDinv = jnp.einsum("cld,lde->cle", B, Dinv)
    # SC = A - B D^-1 B^T — one big contraction over (landmark, d)
    SC = A - jnp.einsum("cld,kld->ck", BDinv, B)

    g_c = g[cam]
    g_l = g[rows]  # (n_l, d)
    rhs = -(g_c - jnp.einsum("cld,ld->c", BDinv, g_l))
    x_c = solve_spd(SC, rhs)
    # landmarks: x_l = D^-1 (-g_l - B^T x_c)
    BTxc = jnp.einsum("cld,c->ld", B, x_c)
    x_l = jnp.einsum("lde,le->ld", Dinv, -g_l - BTxc)

    dx = jnp.zeros_like(g)
    dx = dx.at[cam].set(x_c)
    dx = dx.at[rows].set(x_l)
    return dx


# --- wrappers used by the nonlinear solvers (jitted at that level) -----------
def schur_solve_dense(graph: GraphArrays, H, g, plan: SchurPlan = None):
    if plan is None:
        raise ValueError("schur path requires a SchurPlan")
    return schur_solve(H, g, plan)


@jax.jit
def _damped_schur_step(graph: GraphArrays, H, g, alpha, plan: SchurPlan):
    dx = schur_solve(H, g, plan, alpha=alpha)
    new_states = assembly.apply_update(graph, dx)
    denom = jnp.dot(dx, alpha * dx - g)
    return new_states, dx, denom, jnp.linalg.norm(dx)


def schur_solve_dense_damped(graph: GraphArrays, H, g, alpha, plan: SchurPlan = None):
    if plan is None:
        raise ValueError("schur path requires a SchurPlan")
    return _damped_schur_step(graph, H, g, jnp.asarray(alpha, H.dtype), plan)
