"""Fill-reducing block orderings (host-side symbolic phase).

Capability parity with ``CMatrixOrdering`` (include/slam/OrderingMagic.h:201):
block-level minimum-degree ordering with optional ordering constraints
(pin the last element / first+last — used by the marginals and incremental
solvers), plus identity and reverse-Cuthill-McKee alternatives.

The reference wraps the C AMD/CAMD libraries; ordering is a latency-tolerant
symbolic step that runs on host (SURVEY.md §2.2 note), so a NumPy/pure-Python
minimum-degree on the *block* graph (thousands of nodes, not scalars) is
adequate; a C++ implementation can substitute for very large graphs.
"""

from __future__ import annotations

import heapq
from typing import Optional, Sequence

import numpy as np
from scipy import sparse as sp


def block_adjacency(n: int, pairs: Sequence) -> sp.csr_matrix:
    """Symmetric block adjacency (no diagonal) from (i, j) block pairs."""
    if len(pairs) == 0:
        return sp.csr_matrix((n, n))
    a = np.asarray(pairs, dtype=np.int64)
    i, j = a[:, 0], a[:, 1]
    m = i != j
    i, j = i[m], j[m]
    data = np.ones(len(i) * 2, dtype=np.int8)
    adj = sp.csr_matrix(
        (data, (np.concatenate([i, j]), np.concatenate([j, i]))), shape=(n, n)
    )
    adj.data[:] = 1
    return adj


def identity_ordering(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.int64)


def rcm_ordering(adj: sp.csr_matrix) -> np.ndarray:
    """Reverse Cuthill-McKee (bandwidth-minimizing; good for chain-like SLAM
    graphs)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True), dtype=np.int64)


def min_degree_ordering(
    adj: sp.csr_matrix, constrained_last: Optional[Sequence[int]] = None
) -> np.ndarray:
    """Minimum-degree ordering on the block graph with elimination-graph
    updates (quotient-graph-free, so O(fill) memory — fine at block scale).

    ``constrained_last`` pins the given blocks to the end of the ordering —
    the reference's CLastElementOrderingConstraint (OrderingMagic.h:138) used
    for marginals (last pose last) and incremental updates.

    Uses the native C++ implementation (native/libslampp_native.so, the
    AMD-wrapper analog of OrderingMagic.cpp) when available.
    """
    n = adj.shape[0]
    from slampp_tpu.core import native_host

    native = native_host.min_degree_order(adj.indptr, adj.indices, constrained_last)
    if native is not None:
        return native
    last = set(int(x) for x in (constrained_last or ()))
    # adjacency sets
    nbrs = [set(adj.indices[adj.indptr[i] : adj.indptr[i + 1]].tolist()) for i in range(n)]
    for i in range(n):
        nbrs[i].discard(i)
    eliminated = np.zeros(n, bool)
    heap = [(len(nbrs[i]), i) for i in range(n) if i not in last]
    heapq.heapify(heap)
    order = []
    stamp = np.full(n, -1, np.int64)
    while heap:
        d, v = heapq.heappop(heap)
        if eliminated[v] or v in last:
            continue
        if d != len(nbrs[v]):
            heapq.heappush(heap, (len(nbrs[v]), v))
            continue
        eliminated[v] = True
        order.append(v)
        live = [u for u in nbrs[v] if not eliminated[u]]
        # connect the clique of v's live neighbors (elimination-graph update)
        for a in live:
            s = nbrs[a]
            s.discard(v)
            before = len(s)
            s.update(live)
            s.discard(a)
            if len(s) != before:
                heapq.heappush(heap, (len(s), a))
    # constrained blocks last, in their natural order
    order.extend(sorted(last))
    assert len(order) == n
    return np.asarray(order, dtype=np.int64)


def inverse_ordering(order: np.ndarray) -> np.ndarray:
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=order.dtype)
    return inv


def nested_dissection_ordering(
    adj: sp.csr_matrix,
    leaf_size: int = 32,
    constrained_last: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Nested-dissection ordering via recursive BFS bisection.

    The accelerator-motivated ordering: ND separator trees are shallow and wide, so
    the levelled factorization (core/sparse_chol.py) runs few, fat batched
    steps instead of the deep chains minimum-degree produces on trajectory
    graphs.  (The reference gets this from METIS inside CHOLMOD; here a
    BFS-peripheral bisection is adequate for SLAM graphs and dependency-free.)

    Leaves (< leaf_size) are ordered by local minimum degree.
    """
    n = adj.shape[0]
    indptr, indices = adj.indptr, adj.indices
    last = set(int(x) for x in (constrained_last or ()))
    order: list = []

    def nbrs(v):
        return indices[indptr[v] : indptr[v + 1]]

    def order_leaf(nodes):
        if len(nodes) <= 1:
            return list(nodes)
        sub = adj[np.ix_(nodes, nodes)].tocsr()
        sub_order = min_degree_ordering(sub)
        return [nodes[i] for i in sub_order]

    def bfs_far(nodes_set, start):
        """Return the BFS layering from start within nodes_set."""
        dist = {start: 0}
        frontier = [start]
        layers = [[start]]
        while frontier:
            nxt = []
            for v in frontier:
                for u in nbrs(v):
                    u = int(u)
                    if u in nodes_set and u not in dist:
                        dist[u] = dist[v] + 1
                        nxt.append(u)
            if nxt:
                layers.append(nxt)
            frontier = nxt
        return layers

    def dissect(nodes):
        if len(nodes) <= leaf_size:
            order.extend(order_leaf(list(nodes)))
            return
        nodes_set = set(nodes)
        start = next(iter(nodes))
        layers = bfs_far(nodes_set, start)
        # pseudo-peripheral restart for a better diameter
        layers = bfs_far(nodes_set, layers[-1][0])
        covered = {v for layer in layers for v in layer}
        rest = [v for v in nodes if v not in covered]  # disconnected pieces
        if len(layers) < 3:
            order.extend(order_leaf(list(nodes)))
            return
        # median BFS layer as separator
        sizes = np.cumsum([len(l) for l in layers])
        half = sizes[-1] // 2
        cut = int(np.searchsorted(sizes, half))
        cut = max(1, min(cut, len(layers) - 2))
        sep = layers[cut]
        A = [v for layer in layers[:cut] for v in layer] + rest
        B = [v for layer in layers[cut + 1 :] for v in layer]
        if not A or not B:
            order.extend(order_leaf(list(nodes)))
            return
        dissect(A)
        dissect(B)
        order.extend(order_leaf(sep))

    free = [v for v in range(n) if v not in last]
    # handle each connected component
    import sys

    rec = sys.getrecursionlimit()
    sys.setrecursionlimit(max(rec, 10000))
    seen = set()
    for v in free:
        if v in seen:
            continue
        comp = []
        stack = [v]
        seen.add(v)
        while stack:
            u = stack.pop()
            comp.append(u)
            for w in nbrs(u):
                w = int(w)
                if w not in seen and w not in last:
                    seen.add(w)
                    stack.append(w)
        dissect(comp)
    sys.setrecursionlimit(rec)
    order.extend(sorted(last))
    assert len(order) == n, (len(order), n)
    return np.asarray(order, dtype=np.int64)


def mis_first_fit(adj: sp.csr_matrix, order: Optional[np.ndarray] = None) -> np.ndarray:
    """Greedy maximal independent set, first-fit (capability parity with
    CSchurOrdering::t_MIS_FirstFit, include/slam/LinearSolver_Schur.h:332).

    Visits vertices in ``order`` (default: ascending degree, which empirically
    yields larger sets on SLAM graphs than natural order) and adds a vertex
    when none of its neighbours is already in the set.  Returns the sorted
    member indices.  The MIS is the Schur elimination set when no vertex type
    is landmark-like: mutual non-adjacency makes the eliminated Hessian block
    exactly block-diagonal.
    """
    n = adj.shape[0]
    indptr, indices = adj.indptr, adj.indices
    if order is None:
        deg = np.diff(indptr)
        order = np.argsort(deg, kind="stable")
    in_set = np.zeros(n, bool)
    blocked = np.zeros(n, bool)
    for v in order:
        if blocked[v] or in_set[v]:
            continue
        in_set[v] = True
        blocked[indices[indptr[v]:indptr[v + 1]]] = True
    return np.flatnonzero(in_set)
