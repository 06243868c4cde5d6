"""Vertex/edge *type* registry — the JAX replacement for the reference's
compile-time typelists.

The reference (``include/slam/FlatSystem.h:1931-2010``) derives Jacobian/Hessian
block-size lists from C++ typelists at compile time.  Here a problem type is a
set of registered :class:`VertexType` / :class:`EdgeType` descriptors; the
solvers derive static shapes (block sizes, batch layouts, reduction plans) from
them at trace time, so each (problem type, capacity bucket) compiles to one
fixed-shape XLA program.

Conventions (matching the reference, see BaseTypes_Binary.h:759-846):
  * ``error_fn(states, meas) -> r`` is the residual ``z (-) h(x)``;
  * per-slot Jacobians are ``d error(retract(x_k, d_k)) / d d_k`` at ``d_k=0``
    (the reference computes d h / d delta and flips signs implicitly; the two
    formulations produce identical Gauss-Newton steps);
  * the lambda (Hessian) block for slots (a, b) is ``J_a^T Sigma^-1 J_b`` up to
    the uniform sign, the RHS is solved as ``H dx = -g`` with
    ``g = J^T Sigma^-1 r``, and states update by ``x <- retract(x, dx)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass(frozen=True)
class VertexType:
    """A vertex (variable) type; reference analog: CBaseVertexImpl subclasses.

    ``dim`` is the manifold/optimized dimension (DoF); ``state_dim`` is the
    stored width, defaulting to ``dim``.  They differ for e.g. cameras, which
    store 6-DoF pose plus 5 constant intrinsics (reference CVertexCam,
    BA_Types.h:54).  ``retract(state(state_dim,), delta(dim,)) -> state`` is
    Operator_Plus.
    """

    name: str
    dim: int
    retract: Callable
    # True for landmark-like types that the Schur complement should eliminate
    # (reference: guided Schur ordering by vertex dimension/degree,
    # LinearSolver_Schur.h:725).
    is_landmark: bool = False
    _state_dim: Optional[int] = None
    # boxminus: local_diff(cur_state, ref_state) -> delta (dim,) such that
    # retract(ref, delta) ~= cur.  Default (None): componentwise difference
    # of the first ``dim`` state entries (valid for vector spaces; manifold
    # types with wrapped/rotation components should register their own —
    # used by the windowed incremental solver's frozen-chunk refresh).
    local_diff: Optional[Callable] = None

    @property
    def state_dim(self) -> int:
        return self._state_dim if self._state_dim is not None else self.dim


@dataclasses.dataclass(frozen=True)
class EdgeType:
    """An edge (factor) type; reference analog: CBaseEdgeImpl subclasses.

    ``error_fn(states, meas) -> residual`` where ``states`` is a tuple of
    per-slot vertex states.  ``jacobian_fn`` optionally overrides autodiff with
    hand-derived Jacobians of the *error* w.r.t. retraction deltas; it must
    return ``(residual, (J_0, ..., J_{arity-1}))``.
    """

    name: str
    vertex_types: tuple  # tuple[str, ...] of VertexType names, slot order
    res_dim: int
    meas_dim: int
    error_fn: Callable
    jacobian_fn: Optional[Callable] = None
    # Robust loss: None or a callable w(r, sigma_inv, params)->scalar weight
    # applied multiplicatively to Sigma^-1 (IRLS; reference RobustUtils.h).
    robust_weight_fn: Optional[Callable] = None

    @property
    def arity(self) -> int:
        return len(self.vertex_types)


TYPE_REGISTRY: dict = {"vertex": {}, "edge": {}}


def register_vertex_type(vt: VertexType) -> VertexType:
    TYPE_REGISTRY["vertex"][vt.name] = vt
    return vt


def register_edge_type(et: EdgeType) -> EdgeType:
    TYPE_REGISTRY["edge"][et.name] = et
    return et


def get_vertex_type(name: str) -> VertexType:
    return TYPE_REGISTRY["vertex"][name]


def get_edge_type(name: str) -> EdgeType:
    return TYPE_REGISTRY["edge"][name]
