"""Subgraph-preconditioned conjugate gradient (SPCG) nonlinear solver.

Role parity with the reference's ``CNonlinearSolver_SPCG``
(include/slam/NonlinearSolver_SPCG.h:61): Gauss-Newton where each linear
system is solved by CG preconditioned with a SPANNING-TREE subgraph
factorization (the reference computes a Jarnik/Prim spanning tree,
:395, splits A = [A1; A2] with A1 the tree edges, and preconditions with
A1's factorization, :573-668).

Device-first design (not a translation of the sparse-LU-on-A original):

* the spanning tree is eliminated CHILDREN-BEFORE-PARENTS, which has ZERO
  Cholesky fill and a level schedule equal to tree depth — the v2
  scatter-free factor engine (core/sparse_chol2.py) runs it as a handful of
  batched level sweeps of dense block products;
* the tree system is assembled from the SAME GraphArrays as the full
  Hessian via an edge-masked block plan (core/block_assembly.py
  ``edge_mask``) — no second edge evaluation, masked contributions just
  route to the dummy reduction slot;
* the full-H matvec rides the v3 fine-block spmv
  (linear/partitioned._spmv_fine), and the whole PCG loop is ONE
  ``lax.while_loop`` — a single device program per GN iteration.

Unlike the reference (square A1 from exactly n-1 tree edges,
NonlinearSolver_SPCG.h:577), the preconditioner here includes EVERY edge
whose endpoints all lie on tree links (parallel edges on a tree link
strengthen the preconditioner and keep it SPD; the square-A1 restriction is
an artifact of factorizing A1 itself rather than A1^T A1).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from slampp_tpu.core import block_assembly, sparse_chol2
from slampp_tpu.core.assembly import apply_update
from slampp_tpu.graph.system import GraphArrays, GraphSystem
from slampp_tpu.utils.timer import PhaseTimer

_step_cache: dict = {}


def _spanning_tree(system: GraphSystem, block_of_vid):
    """BFS spanning tree over the free-vertex block graph, rooted at the
    gauge anchor (reference roots at vertex 0, NonlinearSolver_SPCG.h:248).

    Returns (tree_links: set[(hi, lo)], edge_mask: {tname: bool[E]}).
    """
    n = len(block_of_vid)
    adj = [[] for _ in range(n)]
    link_seen = set()
    for tname in system.edge_type_names:
        rec = system._edges[tname]
        for e, vids in enumerate(rec["vids"]):
            bs_ = [block_of_vid.get(v, -1) for v in vids]
            for x in range(len(bs_)):
                for y in range(x + 1, len(bs_)):
                    if bs_[x] >= 0 and bs_[y] >= 0 and bs_[x] != bs_[y]:
                        a, b = sorted((bs_[x], bs_[y]))
                        if (b, a) not in link_seen:
                            link_seen.add((b, a))
                            adj[a].append(b)
                            adj[b].append(a)

    av = system._unary_anchor
    root = block_of_vid.get(av, 0) if av is not None else 0
    parent = np.full(n, -2, np.int64)
    order = []
    for start in ([root] + list(range(n))):
        if n == 0 or parent[start] != -2:
            continue
        parent[start] = -1
        queue = [start]
        while queue:
            nxt = []
            for u in queue:
                order.append(u)
                for v in adj[u]:
                    if parent[v] == -2:
                        parent[v] = u
                        nxt.append(v)
            queue = nxt
    tree_links = {
        (max(u, int(parent[u])), min(u, int(parent[u])))
        for u in range(n)
        if parent[u] >= 0
    }

    edge_mask = {}
    for tname in system.edge_type_names:
        rec = system._edges[tname]
        E = len(rec["vids"])
        mask = np.ones(E, bool)
        for e, vids in enumerate(rec["vids"]):
            bs_ = [block_of_vid.get(v, -1) for v in vids]
            for x in range(len(bs_)):
                for y in range(x + 1, len(bs_)):
                    if bs_[x] >= 0 and bs_[y] >= 0 and bs_[x] != bs_[y]:
                        a, b = sorted((bs_[x], bs_[y]))
                        if (b, a) not in tree_links:
                            mask[e] = False
        edge_mask[tname] = mask
    # BFS order: parents first; elimination order is the REVERSE
    return tree_links, edge_mask, order[::-1]


class SPCGSolver:
    """GN + spanning-tree-preconditioned CG (the -spcg CLI solver)."""

    name = "spcg"

    def __init__(
        self,
        system: GraphSystem,
        verbose: bool = False,
        cg_max_iters: int = 200,
        cg_tol: float = 1e-8,
        target: int = 64,
    ):
        self.system = system
        self.verbose = verbose
        self.cg_max_iters = cg_max_iters
        self.cg_tol = cg_tol
        self.target = target
        self.timer = PhaseTimer()
        self._symbolic_key = None
        self.n_iterations = 0
        self.tree_fraction = None  # diagnostics: |tree-kept edges| / |edges|

    # ------------------------------------------------------------- symbolic
    def symbolic(self) -> None:
        from slampp_tpu.linear.partitioned import PartitionedSolver

        system = self.system
        # full-H side: v3 fine-block plan for assembly + spmv
        self._ps = PartitionedSolver(
            system, target=self.target, mixed_precision=False, refine_iters=0
        )
        self._ps.symbolic()
        self._bp_full = self._ps.block_plan
        self._p_full = self._ps.plan

        # tree side: masked assembly + zero-fill v2 factorization
        block_of_vid = {}
        for b, vid in enumerate(system._vorder):
            block_of_vid[vid] = b
        n = len(block_of_vid)
        tree_links, edge_mask, elim = _spanning_tree(system, block_of_vid)
        kept = sum(int(m.sum()) for m in edge_mask.values())
        total = sum(len(m) for m in edge_mask.values())
        self.tree_fraction = kept / max(total, 1)

        inv = np.empty(n, np.int64)
        inv[np.asarray(elim, np.int64)] = np.arange(n)
        tpairs = sorted(
            {(int(max(inv[i], inv[j])), int(min(inv[i], inv[j]))) for i, j in tree_links}
        )
        plan2 = sparse_chol2.plan_v2(n, tpairs)
        # children-before-parents elimination of a tree adds no fill
        assert plan2.n_off == len(tpairs), "spanning tree factor has fill?"
        new_of = np.empty(n, np.int64)
        new_of[plan2.col_order] = np.arange(n)
        inv2 = new_of[inv]
        self._plan2 = plan2
        self._bp_tree = block_assembly.build_block_plan(
            system,
            plan2.slot_of,
            plan2.diag_slot,
            plan2.n + plan2.n_off,
            inv2,
            block_of_vid,
            panel=1,
            edge_mask=edge_mask,
        )
        self._symbolic_key = (system.n_vertices, system.n_edges)

    def ensure_symbolic(self):
        key = (self.system.n_vertices, self.system.n_edges)
        if self._symbolic_key != key:
            with self.timer.phase("symbolic"):
                self.symbolic()

    # ----------------------------------------------------------------- step
    def _step_fn(self):
        from slampp_tpu.linear.partitioned import _plan_key

        key = (_plan_key(self._bp_full), _plan_key(self._bp_tree),
               self.cg_max_iters, self.cg_tol)
        fn = _step_cache.get(key)
        if fn is not None:
            return fn
        bpf, pf = self._bp_full, self._p_full
        bpt, p2 = self._bp_tree, self._plan2
        cg_iters, cg_tol = self.cg_max_iters, self.cg_tol

        from slampp_tpu.linear.partitioned import _spmv_fine

        def to_fine(bp, x):
            pad = max(bp.P, 8)
            xg = jnp.concatenate([x, jnp.zeros(pad, x.dtype)])
            return xg[bp.dx_offsets]

        def step(graph: GraphArrays):
            vals_f, rhs_f, chi2 = block_assembly.assemble_blocks_sorted(graph, bpf)
            vals_t, _, _ = block_assembly.assemble_blocks_sorted(graph, bpt)
            Ld, Lo = sparse_chol2.factorize2(
                p2, vals_t[: p2.n], vals_t[p2.n : p2.n + p2.n_off]
            )

            b = -block_assembly.scatter_dx(bpf, rhs_f[:-1], bpf.bs)

            def matvec(x):
                yf = _spmv_fine(pf, vals_f[: pf.nnzb], to_fine(bpf, x))
                return block_assembly.scatter_dx(bpf, yf, pf.bs)

            def precond(r):
                zt = sparse_chol2.solve2(p2, Ld, Lo, to_fine(bpt, r))
                return block_assembly.scatter_dx(bpt, zt, bpt.bs)

            b2 = jnp.dot(b, b)

            def cond(st):
                x, r, z, pvec, rz, k = st
                return jnp.logical_and(
                    k < cg_iters, jnp.dot(r, r) > cg_tol * cg_tol * b2
                )

            def body(st):
                x, r, z, pvec, rz, k = st
                Hp = matvec(pvec)
                alpha = rz / jnp.maximum(jnp.dot(pvec, Hp), 1e-300)
                x = x + alpha * pvec
                r = r - alpha * Hp
                z = precond(r)
                rz_new = jnp.dot(r, z)
                beta = rz_new / jnp.maximum(rz, 1e-300)
                return (x, r, z, z + beta * pvec, rz_new, k + 1)

            x0 = jnp.zeros_like(b)
            z0 = precond(b)
            x, r, *_rest = lax.while_loop(
                cond, body, (x0, b, z0, z0, jnp.dot(b, z0), jnp.zeros((), jnp.int32))
            )
            new_states = apply_update(graph, x)
            return new_states, jnp.linalg.norm(x), chi2, _rest[-1]

        fn = jax.jit(step)
        _step_cache[key] = fn
        return fn

    # ------------------------------------------------------------ interface
    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        if self.system.n_edges == 0:
            return 0
        self.ensure_symbolic()
        step = self._step_fn()
        with self.timer.phase("snapshot"):
            graph = self.system.snapshot()
        applied = 0
        for _ in range(max_iterations):
            with self.timer.phase("gn_spcg_step"):
                new_states, dxn, chi2, cg_k = step(graph)
                dxn = float(dxn)
            self.n_iterations += 1
            if self.verbose:
                print(
                    f"iter {applied}: chi2={float(chi2):.4f} |dx|={dxn:.6f} "
                    f"cg_iters={int(cg_k)}"
                )
            if not np.isfinite(dxn):
                break
            if dxn <= min_dx_norm:
                break
            graph = graph.replace_states(new_states)
            applied += 1
        with self.timer.phase("writeback"):
            self.system.update_states(dict(graph.states))
        return applied

    def chi2(self) -> float:
        from slampp_tpu.core.assembly import graph_chi2

        return float(jax.jit(graph_chi2)(self.system.snapshot()))

    def dump(self) -> None:
        self.timer.dump()
