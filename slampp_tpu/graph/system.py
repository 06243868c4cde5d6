"""Host-side factor-graph container and device snapshots.

Capability parity with the reference's ``CFlatSystem`` (FlatSystem.h:1915):
typed vertex/edge pools with O(1) id access, lazy vertex auto-initialization
from the first referencing edge, const vertices, an automatic unary (gauge)
factor derived from the first edge, and derivation of the block-size structure
consumed by the solvers.

Device-first inversion: instead of pointer-rich pools of C++ objects, vertices and
edges live in per-type struct-of-arrays NumPy buffers on host; ``snapshot()``
freezes them into a :class:`GraphArrays` pytree of fixed-shape device arrays
(optionally padded to capacity buckets so that incremental runs reuse compiled
programs).  The insertion-order scalar offsets (the reference's vertex
``m_n_order``) become index arrays used by the gather/scatter reduction plans.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from slampp_tpu.graph.types import EdgeType, VertexType, get_edge_type, get_vertex_type


def _next_bucket(n: int, granularity: int = 256) -> int:
    """Round a count up to a capacity bucket so jit caches stay warm."""
    if n <= granularity:
        return max(granularity, 1)
    b = granularity
    while b < n:
        b *= 2
    return b


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class EdgeArrays:
    """Device-side SoA for one edge type (padded to capacity)."""

    # (cap, arity) int32: local index of each slot's vertex within its type pool
    local_idx: jnp.ndarray
    # (cap, arity) int32: scalar offset of each slot's vertex in the global
    # state vector (dummy row N for const/padding — reduction plans scatter
    # there and the row is dropped)
    offsets: jnp.ndarray
    # (cap, meas_dim) f64 measurements
    meas: jnp.ndarray
    # (cap, res_dim, res_dim) f64 information matrices (zero for padding)
    sigma_inv: jnp.ndarray
    # (cap,) bool validity mask
    valid: jnp.ndarray

    def tree_flatten(self):
        return (self.local_idx, self.offsets, self.meas, self.sigma_inv, self.valid), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def capacity(self) -> int:
        return self.meas.shape[0]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class GraphArrays:
    """Frozen device snapshot of the whole graph (a pytree).

    ``states[t]`` is (n_t, dim_t); ``vertex_offsets[t]`` is (n_t,) scalar
    offsets into the global state vector (or ``state_dim`` for const vertices,
    the dummy slot).  ``state_dim`` is the total number of free scalars.
    """

    states: Dict[str, jnp.ndarray]
    vertex_offsets: Dict[str, jnp.ndarray]
    edges: Dict[str, EdgeArrays]
    state_dim: int
    # unary gauge factor: (order offset of anchor vertex, dim, information)
    unary_offset: int
    unary_dim: int
    unary_information: float
    # (state_dim,) 1.0 on padding rows (identity-regularized so bucket-padded
    # dense solves stay SPD), 0.0 on real rows; None when unpadded
    diag_reg: Optional[jnp.ndarray] = None

    def tree_flatten(self):
        keys_v = sorted(self.states.keys())
        keys_e = sorted(self.edges.keys())
        children = (
            [self.states[k] for k in keys_v],
            [self.vertex_offsets[k] for k in keys_v],
            [self.edges[k] for k in keys_e],
            self.diag_reg,
        )
        aux = (keys_v, keys_e, self.state_dim, self.unary_offset, self.unary_dim, self.unary_information)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        keys_v, keys_e, state_dim, uo, ud, ui = aux
        states = dict(zip(keys_v, children[0]))
        offs = dict(zip(keys_v, children[1]))
        edges = dict(zip(keys_e, children[2]))
        return cls(states, offs, edges, state_dim, uo, ud, ui, children[3])

    def replace_states(self, new_states: Dict[str, jnp.ndarray]) -> "GraphArrays":
        return GraphArrays(
            new_states,
            self.vertex_offsets,
            self.edges,
            self.state_dim,
            self.unary_offset,
            self.unary_dim,
            self.unary_information,
            self.diag_reg,
        )


class GraphSystem:
    """The optimized graph (reference: CFlatSystem, FlatSystem.h:1915).

    Vertices are identified by integer ids (dataset ids); each belongs to one
    registered :class:`VertexType`.  Edges reference vertices by id and are
    stored per edge type in insertion order.
    """

    def __init__(self, unary_information: float = 1.0, bucket_granularity: int = 256):
        self._vstates: Dict[str, List[np.ndarray]] = {}
        self._vids: Dict[str, List[int]] = {}
        # vid -> (type_name, local_idx)
        self.vertex_index: Dict[int, Tuple[str, int]] = {}
        self._vconst: Dict[int, bool] = {}
        # insertion order of vertex ids (determines scalar offsets, like the
        # reference's m_n_order assigned at pool-append time)
        self._vorder: List[int] = []
        self._edges: Dict[str, dict] = {}
        self._edge_count = 0
        self.unary_information = unary_information
        self._unary_anchor: Optional[int] = None
        self.bucket_granularity = bucket_granularity
        self._dirty = True
        self._cached_layout = None

    # ------------------------------------------------------------------ build
    def add_vertex(self, type_name: str, vid: int, state, const: bool = False) -> int:
        if vid in self.vertex_index:
            t, i = self.vertex_index[vid]
            if t != type_name:
                raise ValueError(f"vertex {vid} already exists with type {t}, not {type_name}")
            return i
        vt = get_vertex_type(type_name)
        state = np.asarray(state, dtype=np.float64).reshape(vt.state_dim)
        lst = self._vstates.setdefault(type_name, [])
        ids = self._vids.setdefault(type_name, [])
        local = len(lst)
        lst.append(state)
        ids.append(vid)
        self.vertex_index[vid] = (type_name, local)
        self._vconst[vid] = const
        if not const:
            self._vorder.append(vid)
        self._dirty = True
        return local

    def has_vertex(self, vid: int) -> bool:
        return vid in self.vertex_index

    def vertex_state(self, vid: int) -> np.ndarray:
        t, i = self.vertex_index[vid]
        return self._vstates[t][i]

    def set_vertex_state(self, vid: int, state) -> None:
        t, i = self.vertex_index[vid]
        self._vstates[t][i] = np.asarray(state, dtype=np.float64).reshape(-1)
        self._dirty = True

    def add_edge(
        self,
        type_name: str,
        vertex_ids,
        meas,
        sigma_inv,
        initializers: Optional[Tuple[Optional[Callable], ...]] = None,
    ) -> None:
        """Append an edge, lazily auto-initializing missing vertices.

        ``initializers[slot]`` maps (known_states: dict slot->state, meas) to a
        new state for that slot; default zeros (CInitializeNullVertex,
        BaseTypes.h:119).  Models attach composition initializers analogous to
        the reference's CRelative_to_Absolute_*_Initializer functors.
        """
        et = get_edge_type(type_name)
        if len(vertex_ids) != et.arity:
            raise ValueError(f"edge {type_name} expects {et.arity} vertices")
        meas = np.asarray(meas, dtype=np.float64).reshape(et.meas_dim)
        sigma_inv = np.asarray(sigma_inv, dtype=np.float64).reshape(et.res_dim, et.res_dim)

        known = {
            s: self.vertex_state(v) for s, v in enumerate(vertex_ids) if self.has_vertex(v)
        }
        for slot, vid in enumerate(vertex_ids):
            if not self.has_vertex(vid):
                vt_name = et.vertex_types[slot]
                vt = get_vertex_type(vt_name)
                init = initializers[slot] if initializers else None
                state = init(known, meas) if init is not None else np.zeros(vt.state_dim)
                self.add_vertex(vt_name, vid, state)
                known[slot] = self.vertex_state(vid)

        rec = self._edges.setdefault(
            type_name, {"vids": [], "meas": [], "sigma_inv": []}
        )
        rec["vids"].append(list(vertex_ids))
        rec["meas"].append(meas)
        rec["sigma_inv"].append(sigma_inv)
        self._edge_count += 1
        if self._unary_anchor is None:
            # the reference derives the unary factor from the first edge
            # (FlatSystem.h:2653, CBasicUnaryFactorFactory :432) and, with the
            # default __AUTO_UNARY_FACTOR_ON_VERTEX_ZERO (:337), anchors it on
            # vertex id 0; fall back to the first edge's first vertex
            self._unary_anchor = 0 if 0 in vertex_ids else vertex_ids[0]
        self._dirty = True

    # ----------------------------------------------------------------- layout
    @property
    def n_vertices(self) -> int:
        return len(self.vertex_index)

    @property
    def n_edges(self) -> int:
        return self._edge_count

    def edge_count(self, type_name: str) -> int:
        rec = self._edges.get(type_name)
        return len(rec["vids"]) if rec else 0

    @property
    def edge_type_names(self) -> List[str]:
        return sorted(self._edges.keys())

    @property
    def vertex_type_names(self) -> List[str]:
        return sorted(self._vstates.keys())

    def _layout(self):
        """Scalar offsets per vertex (insertion order), total free dimension."""
        if not self._dirty and self._cached_layout is not None:
            return self._cached_layout
        offsets: Dict[int, int] = {}
        cursor = 0
        for vid in self._vorder:
            t, _ = self.vertex_index[vid]
            offsets[vid] = cursor
            cursor += get_vertex_type(t).dim
        self._cached_layout = (offsets, cursor)
        return self._cached_layout

    @property
    def state_dim(self) -> int:
        return self._layout()[1]

    def chi2_dof(self) -> int:
        """Degrees of freedom = sum of edge residual dims - state dim (for
        normalized chi2; the regression contract uses the denormalized sum)."""
        m = sum(
            get_edge_type(t).res_dim * len(rec["vids"]) for t, rec in self._edges.items()
        )
        return max(1, m - self.state_dim)

    # --------------------------------------------------------------- snapshot
    def snapshot(self, pad: bool = False) -> GraphArrays:
        """Freeze the graph into fixed-shape device arrays.

        With ``pad=True``, edge and vertex arrays are padded to capacity
        buckets (powers of two over ``bucket_granularity``) so that repeated
        snapshots of a growing graph hit the jit cache (SURVEY.md §7 hard
        part 4: dynamic growth vs static shapes).
        """
        offsets, total = self._layout()
        if pad:
            # bucket the scalar dimension too so dense-path shapes quantize;
            # padding rows get unit diagonal regularization (diag_reg)
            padded_total = _next_bucket(max(total, 1), self.bucket_granularity)
        else:
            padded_total = total
        dummy = padded_total  # scatter target row for const/padding contributions

        states: Dict[str, jnp.ndarray] = {}
        vertex_offsets: Dict[str, jnp.ndarray] = {}
        for t in self.vertex_type_names:
            vt = get_vertex_type(t)
            arr = np.stack(self._vstates[t]) if self._vstates[t] else np.zeros((0, vt.state_dim))
            offs = np.array(
                [offsets.get(v, dummy) for v in self._vids[t]], dtype=np.int32
            )
            n = arr.shape[0]
            cap = _next_bucket(n, self.bucket_granularity) if pad else max(n, 1)
            if cap > n:
                arr = np.concatenate([arr, np.zeros((cap - n, vt.state_dim))], axis=0)
                offs = np.concatenate([offs, np.full(cap - n, dummy, np.int32)])
            states[t] = jnp.asarray(arr)
            vertex_offsets[t] = jnp.asarray(offs)

        edges: Dict[str, EdgeArrays] = {}
        for t in self.edge_type_names:
            et = get_edge_type(t)
            rec = self._edges[t]
            n = len(rec["vids"])
            cap = _next_bucket(n, self.bucket_granularity) if pad else max(n, 1)
            local = np.zeros((cap, et.arity), np.int32)
            offs = np.full((cap, et.arity), dummy, np.int32)
            meas = np.zeros((cap, et.meas_dim))
            sig = np.zeros((cap, et.res_dim, et.res_dim))
            valid = np.zeros(cap, bool)
            for e, vids in enumerate(rec["vids"]):
                for s, vid in enumerate(vids):
                    _, li = self.vertex_index[vid]
                    local[e, s] = li
                    offs[e, s] = offsets.get(vid, dummy)
                meas[e] = rec["meas"][e]
                sig[e] = rec["sigma_inv"][e]
                valid[e] = True
            edges[t] = EdgeArrays(
                jnp.asarray(local),
                jnp.asarray(offs),
                jnp.asarray(meas),
                jnp.asarray(sig),
                jnp.asarray(valid),
            )

        if self._unary_anchor is not None and not self._vconst.get(self._unary_anchor, False):
            uo = offsets.get(self._unary_anchor, dummy)
            ud = get_vertex_type(self.vertex_index[self._unary_anchor][0]).dim
        else:
            uo, ud = dummy, 0
        diag_reg = None
        if pad and padded_total > total:
            dr = np.zeros(padded_total)
            dr[total:] = 1.0
            diag_reg = jnp.asarray(dr)
        return GraphArrays(
            states, vertex_offsets, edges, padded_total, uo, ud,
            self.unary_information, diag_reg,
        )

    def update_states(self, new_states: Dict[str, np.ndarray]) -> None:
        """Write back device states (e.g. after Optimize) into the host pools."""
        for t, arr in new_states.items():
            arr = np.asarray(arr)
            lst = self._vstates[t]
            for i in range(len(lst)):
                lst[i] = arr[i]
        self._dirty = True
