"""Batched Jacobian evaluation and lambda (Hessian) / RHS assembly.

Reference analogs:
  * per-edge Jacobian evaluation: ``CLambdaOps::Refresh_Lambda`` driving
    ``Calculate_Hessians_v2`` over OpenMP (NonlinearSolver_Lambda_Base.h:1207,
    BaseTypes_Binary.h:759) — here one ``jax.vmap`` per edge type;
  * the matrix/vector reduction plans (``CMatrixReductionPlan``,
    ``CVectorReductionPlan``, NonlinearSolver_Lambda_Base.h:113,524) — here
    XLA scatter-add with host-precomputed scalar offsets;
  * chi-squared: sum over edges of the *unweighted* ``r^T Sigma^-1 r``
    (BaseTypes_Binary.h f_Chi_Squared_Error), the golden-value contract.

Sign convention: we differentiate the error function ``r(x)`` itself (not the
expectation ``h``), so the Gauss-Newton system is ``H dx = -g`` with
``H = J^T W J``, ``g = J^T W r``, ``W = Sigma^-1`` (robust-weighted where
applicable) — algebraically identical to the reference's
``lambda dx = eta`` with expectation-Jacobians.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from slampp_tpu.graph.system import EdgeArrays, GraphArrays
from slampp_tpu.graph.types import get_edge_type, get_vertex_type


def _edge_residual_and_jacobians(et, vts, states, meas):
    """Residual and per-slot retraction Jacobians for ONE edge.

    J_k = d/d delta_k [ r(retract(x_k, delta_k), ...) ] at delta=0 — the
    manifold Jacobian matching the reference's numerically-differentiated
    retraction Jacobians (3DSolverBase.h:1335-1370) in the analytic limit.
    """
    if et.jacobian_fn is not None:
        return et.jacobian_fn(states, meas)

    def err_of_deltas(deltas):
        xs = tuple(vt.retract(x, d) for vt, x, d in zip(vts, states, deltas))
        return et.error_fn(xs, meas)

    zeros = tuple(jnp.zeros(vt.dim, states[0].dtype) for vt in vts)  # DoF-sized deltas
    r = et.error_fn(states, meas)
    jacs = jax.jacfwd(err_of_deltas)(zeros)
    return r, jacs


def edge_residuals(et_name: str, ea: EdgeArrays, states: Dict[str, jnp.ndarray]):
    """(cap, res_dim) residuals for all edges of a type (padding rows garbage —
    mask with ``ea.valid``)."""
    et = get_edge_type(et_name)
    slot_states = tuple(
        states[et.vertex_types[s]][ea.local_idx[:, s]] for s in range(et.arity)
    )
    return jax.vmap(lambda *args: et.error_fn(args[:-1], args[-1]))(*slot_states, ea.meas)


def edge_chi2(et_name: str, ea: EdgeArrays, states: Dict[str, jnp.ndarray]):
    """Unweighted chi-squared contribution of one edge type (denormalized)."""
    r = edge_residuals(et_name, ea, states)
    v = jnp.einsum("ei,eij,ej->e", r, ea.sigma_inv, r)
    return jnp.sum(jnp.where(ea.valid, v, 0.0))


def graph_chi2(graph: GraphArrays):
    """Total denormalized chi-squared (the golden-value contract,
    reference f_Chi_Squared_Error summed in Main.h:1474-1478)."""
    total = jnp.zeros((), graph.states[next(iter(graph.states))].dtype)
    for name, ea in graph.edges.items():
        total = total + edge_chi2(name, ea, graph.states)
    return total


def _dmax(graph: GraphArrays) -> int:
    return max(
        (get_vertex_type(t).dim for t in graph.states.keys()),
        default=1,
    )


def assemble_dense(graph: GraphArrays) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Assemble the dense Gauss-Newton system (H, g, chi2).

    H is (N, N), g is (N,) where N = graph.state_dim.  Internally scatters into
    a padded (N + dmax) buffer so const/padding contributions land in dummy
    rows and are sliced off — the device version of the reference's "reduce into
    temp blocks keyed by pointer" plan.
    """
    N = graph.state_dim
    pad = _dmax(graph)
    dtype = graph.states[next(iter(graph.states))].dtype
    H = jnp.zeros((N + pad, N + pad), dtype)
    g = jnp.zeros((N + pad,), dtype)
    chi2 = jnp.zeros((), dtype)

    for name, ea in graph.edges.items():
        et = get_edge_type(name)
        vts = tuple(get_vertex_type(t) for t in et.vertex_types)
        slot_states = tuple(
            graph.states[et.vertex_types[s]][ea.local_idx[:, s]] for s in range(et.arity)
        )

        r, jacs = jax.vmap(lambda *a: _edge_residual_and_jacobians(et, vts, a[:-1], a[-1]))(
            *slot_states, ea.meas
        )
        # robust IRLS weight multiplies Sigma^-1 (reference BaseTypes_Binary.h:772)
        if et.robust_weight_fn is not None:
            w = jax.vmap(et.robust_weight_fn)(r, ea.sigma_inv)
            W = ea.sigma_inv * w[:, None, None]
        else:
            W = ea.sigma_inv

        chi2 = chi2 + jnp.sum(
            jnp.where(ea.valid, jnp.einsum("ei,eij,ej->e", r, ea.sigma_inv, r), 0.0)
        )

        WJ = tuple(jnp.einsum("eij,ejk->eik", W, jacs[b]) for b in range(et.arity))
        for a in range(et.arity):
            da = vts[a].dim  # DoF
            rows = ea.offsets[:, a, None] + jnp.arange(da)[None, :]  # (E, da)
            ga = jnp.einsum("eij,ei->ej", WJ[a], r)  # J_a^T W r
            g = g.at[rows].add(jnp.where(ea.valid[:, None], ga, 0.0))
            for b in range(et.arity):
                db = vts[b].dim  # DoF
                cols = ea.offsets[:, b, None] + jnp.arange(db)[None, :]
                Hab = jnp.einsum("eij,eik->ejk", jacs[a], WJ[b])  # J_a^T W J_b
                Hab = jnp.where(ea.valid[:, None, None], Hab, 0.0)
                H = H.at[rows[:, :, None], cols[:, None, :]].add(Hab)

    # automatic unary gauge factor: UF^T UF = information * I on the anchor
    # vertex diagonal (reference CBasicUnaryFactorFactory FlatSystem.h:432,
    # applied in NonlinearSolver_Lambda_Base.h:1368-1386); zero error.
    if graph.unary_dim > 0:
        idx = graph.unary_offset + jnp.arange(graph.unary_dim)
        H = H.at[idx, idx].add(graph.unary_information)

    # identity-regularize bucket-padding rows so the padded system stays SPD
    if graph.diag_reg is not None:
        d = jnp.arange(N)
        H = H.at[d, d].add(graph.diag_reg)

    return H[:N, :N], g[:N], chi2


def apply_update(graph: GraphArrays, dx: jnp.ndarray) -> Dict[str, jnp.ndarray]:
    """states <- retract(states, dx) per vertex type (the reference's
    PushValuesInGraphSystem + Operator_Plus, NonlinearSolver_Lambda_Base.h)."""
    pad = _dmax(graph)
    dxp = jnp.concatenate([dx, jnp.zeros((pad,), dx.dtype)])
    out = {}
    for t, st in graph.states.items():
        vt = get_vertex_type(t)
        idx = graph.vertex_offsets[t][:, None] + jnp.arange(vt.dim)[None, :]  # DoF-wide
        delta = dxp[idx]
        out[t] = jax.vmap(vt.retract)(st, delta)
    return out


def apply_update_gated(
    graph: GraphArrays, dx: jnp.ndarray, threshold
) -> Dict[str, jnp.ndarray]:
    """Threshold-gated vertex updates (fluid relinearization): a vertex only
    moves when the norm of its tangent update exceeds ``threshold``.

    This is the per-vertex update-threshold economy of the reference's dogleg
    solver (f_UpdateThreshold, NonlinearSolver_Lambda_DL.h:399,696; default
    1e-5) and of FastL's threshold-gated back-substituted updates
    (NonlinearSolver_FastL.h, SURVEY.md §3.2) — vertices that barely move keep
    their linearization point, so subsequent relinearizations are no-ops for
    them.  ``threshold=0`` degenerates to :func:`apply_update`.
    """
    pad = _dmax(graph)
    dxp = jnp.concatenate([dx, jnp.zeros((pad,), dx.dtype)])
    out = {}
    for t, st in graph.states.items():
        vt = get_vertex_type(t)
        idx = graph.vertex_offsets[t][:, None] + jnp.arange(vt.dim)[None, :]
        delta = dxp[idx]
        keep = jnp.linalg.norm(delta, axis=1) > threshold
        out[t] = jax.vmap(vt.retract)(st, jnp.where(keep[:, None], delta, 0.0))
    return out
