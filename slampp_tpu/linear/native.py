"""Native block-sparse Cholesky linear solver — the framework's default for
pose graphs, like the reference's ``CLinearSolver_UberBlock``
(include/slam/LinearSolver_UberBlock.h:45).

Pipeline (symbolic cached per graph structure, numeric jitted):
  host: block adjacency -> min-degree ordering -> symbolic factor + level
        schedule (core/symbolic.py) -> edge->slot routing (block reduction
        plan, core/block_assembly.py)
  device: batched block assembly -> level-scanned factorization ->
        level-scanned triangular solves -> un-permuted dx.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np

import jax
import jax.numpy as jnp

from slampp_tpu.core import block_assembly, ordering as ord_mod, sparse_chol, symbolic
from slampp_tpu.core.assembly import apply_update, graph_chi2
from slampp_tpu.graph.system import GraphArrays, GraphSystem
from slampp_tpu.graph.types import get_edge_type, get_vertex_type


class NativeBlockSolver:
    """Blockwise sparse Cholesky with cached symbolic decomposition
    (reference SymbolicDecomposition_Blocky, LinearSolver_UberBlock.h:272)."""

    def __init__(
        self,
        system: GraphSystem,
        ordering: str = "min_degree",
        panel: int = 1,
        mixed_precision: bool = False,
        refine_iters: int = 2,
        engine: str = "v1",
    ):
        """``panel`` > 1 enables supernodal panel amalgamation: groups of
        ``panel`` consecutive ordered block-columns factor as dense P x P
        panels (P = panel*bs) on a much shallower elimination tree.
        ``mixed_precision`` factors in f32 with static damping + f64
        iterative refinement (SURVEY.md §7 hard part 3; unmeasured against
        plain f64 on the GPU, ROADMAP 3.2).  ``engine``: "v1" (packed
        scatter-add levels) or "v2" (scatter-free level windows +
        prefix-sum segment reduction, core/sparse_chol2.py)."""
        self.system = system
        self.ordering_kind = ordering
        self.panel = panel
        self.mixed_precision = mixed_precision
        self.refine_iters = refine_iters
        self.engine = engine
        self._symbolic_key = None
        self.block_plan: Optional[block_assembly.BlockPlan] = None
        self.dplan: Optional[sparse_chol.DevicePlan] = None
        self.plan2 = None

    def symbolic(self, constrained_last=None) -> None:
        """(Re)build ordering + symbolic factor + routing for the current
        graph structure."""
        system = self.system
        # block index per free vertex, in insertion (order) sequence
        offsets, total = system._layout()
        block_of_vid = {}
        for b, vid in enumerate(system._vorder):
            block_of_vid[vid] = b
        n = len(block_of_vid)

        pairs = set()
        for tname in system.edge_type_names:
            et = get_edge_type(tname)
            for vids in system._edges[tname]["vids"]:
                bs_ = [block_of_vid.get(v, -1) for v in vids]
                for x in range(len(bs_)):
                    for y in range(x + 1, len(bs_)):
                        if bs_[x] >= 0 and bs_[y] >= 0 and bs_[x] != bs_[y]:
                            a, b = sorted((bs_[x], bs_[y]))
                            pairs.add((b, a))
        pairs = sorted(pairs)

        adj = ord_mod.block_adjacency(n, pairs)
        if self.ordering_kind == "min_degree":
            order = ord_mod.min_degree_ordering(adj, constrained_last)
        elif self.ordering_kind == "nested_dissection":
            order = ord_mod.nested_dissection_ordering(
                adj, constrained_last=constrained_last
            )
        elif self.ordering_kind == "rcm":
            order = ord_mod.rcm_ordering(adj)
        elif self.ordering_kind == "identity":
            order = ord_mod.identity_ordering(n)
        else:
            raise ValueError(self.ordering_kind)
        inv = ord_mod.inverse_ordering(order)

        # coarsen the permuted pairs to panel granularity (supernodal
        # amalgamation of `panel` consecutive ordered columns)
        p = self.panel
        n_panels = (n + p - 1) // p
        ppairs = sorted(
            {
                (int(inv[i]) // p, int(inv[j]) // p)
                for i, j in pairs
                if int(inv[i]) // p != int(inv[j]) // p
            }
        )
        if self.engine == "v2":
            from slampp_tpu.core import sparse_chol2

            plan2 = sparse_chol2.plan_v2(n_panels, ppairs)
            # compose the level-contiguous panel renumbering into the fine
            # block permutation: panel q (AMD space) sits at new position
            new_of = np.empty(n_panels, np.int64)
            new_of[plan2.col_order] = np.arange(n_panels)
            inv2 = np.empty_like(inv)
            for fb in range(n):
                pp = int(inv[fb])
                inv2[fb] = new_of[pp // p] * p + (pp % p)
            self.plan2 = plan2
            self.block_plan = block_assembly.build_block_plan(
                system,
                plan2.slot_of,
                plan2.diag_slot,
                plan2.n + plan2.n_off,
                inv2,
                block_of_vid,
                panel=p,
            )
            self.dplan = None
        else:
            plan = symbolic.symbolic_cholesky(n_panels, ppairs)
            self.dplan = sparse_chol.device_plan(plan)
            self.block_plan = block_assembly.build_block_plan(
                system, plan.slot_of, plan.diag_slot, plan.nnzb, inv, block_of_vid, panel=p
            )
        self._symbolic_key = (system.n_vertices, system.n_edges)

    def ensure_symbolic(self):
        key = (self.system.n_vertices, self.system.n_edges)
        if self._symbolic_key != key:
            self.symbolic()

    def gn_step(self, graph: GraphArrays):
        """One jitted GN iteration through the sparse path:
        (new_states, dx_norm, chi2_at_entry)."""
        self.ensure_symbolic()
        if self.engine == "v2":
            return _native_gn_step_v2(
                graph, self.block_plan, self.plan2, self.mixed_precision, self.refine_iters
            )
        return _native_gn_step(
            graph, self.block_plan, self.dplan, self.mixed_precision, self.refine_iters
        )

    def optimize_fused(self, graph: GraphArrays, n_iters: int = 5):
        """K chained GN iterations fused into one program (v2 engine):
        returns (final_states, last_dx_norm, chi2_initial, chi2_final)."""
        self.ensure_symbolic()
        if self.engine != "v2":
            raise ValueError("optimize_fused requires engine='v2'")
        return _native_optimize_fused(
            graph, self.block_plan, self.plan2, n_iters, self.mixed_precision, self.refine_iters
        )


def _native_gn_step_impl(graph: GraphArrays, bp, dp, mixed: bool, refine: int):
    vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(graph, bp)
    if mixed:
        x = sparse_chol.solve_refined(dp, vals[:-1], -rhs[:-1], refine_iters=refine)
    else:
        L = sparse_chol.factorize(dp, vals[:-1])
        x = sparse_chol.solve(dp, L, -rhs[:-1])
    dx = block_assembly.scatter_dx(bp, x, bp.bs)
    dx_norm = jnp.linalg.norm(dx)
    new_states = apply_update(graph, dx)
    return new_states, dx_norm, chi2


def _native_gn_step_v2_impl(graph: GraphArrays, bp, plan2, mixed: bool, refine: int):
    from slampp_tpu.core import sparse_chol2

    vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(graph, bp)
    n, n_off = plan2.n, plan2.n_off
    Dvals = vals[:n]
    OffVals = vals[n : n + n_off]
    b = -rhs[:-1]
    if mixed:
        x = sparse_chol2.solve_refined2(plan2, Dvals, OffVals, b, refine_iters=refine)
    else:
        Ld, Lo = sparse_chol2.factorize2(plan2, Dvals, OffVals)
        x = sparse_chol2.solve2(plan2, Ld, Lo, b)
    dx = block_assembly.scatter_dx(bp, x, bp.bs)
    dx_norm = jnp.linalg.norm(dx)
    new_states = apply_update(graph, dx)
    return new_states, dx_norm, chi2


def _native_gn_step_v2(graph: GraphArrays, bp, plan2, mixed: bool = False, refine: int = 1):
    from slampp_tpu.linear.partitioned import _plan_key

    key = ("v2", _plan_key(bp), mixed, refine)
    fn = _step_cache.get(key)
    if fn is None:
        fn = jax.jit(lambda g: _native_gn_step_v2_impl(g, bp, plan2, mixed, refine))
        _step_cache[key] = fn
    return fn(graph)


def _native_optimize_fused(
    graph: GraphArrays, bp, plan2, n_iters: int, mixed: bool, refine: int
):
    """K chained GN iterations in ONE jitted program (one dispatch + one
    fetch for a whole batch solve — reference `Optimize(5, ...)` semantics
    minus the early-exit, which Manhattan-class problems never trigger)."""
    from slampp_tpu.linear.partitioned import _plan_key

    key = ("v2fused", _plan_key(bp), n_iters, mixed, refine)
    fn = _step_cache.get(key)
    if fn is None:
        fn = jax.jit(lambda g: _fused_impl(g, bp, plan2, n_iters, mixed, refine))
        _step_cache[key] = fn
    return fn(graph)


def _fused_impl(g, bp, plan2, n_iters: int, mixed: bool, refine: int):
    chi0 = None
    dxn = None
    for _ in range(n_iters):
        states, dxn, chi2 = _native_gn_step_v2_impl(g, bp, plan2, mixed, refine)
        if chi0 is None:
            chi0 = chi2
        g = g.replace_states(states)
    from slampp_tpu.core.assembly import graph_chi2

    return g.states, dxn, chi0, graph_chi2(g)



# Pose-graph-scale plans compile FASTER as closure constants (XLA folds the
# index arrays and specializes the gathers; measured ~2x on the remote
# compiler), so the gn-step family closure-captures its plans with a
# per-plan jit cache.  Venice-scale plans (linear/ba_schur.py) are orders
# larger and MUST pass as arguments instead.
_step_cache: Dict[int, object] = {}


def _native_gn_step(graph: GraphArrays, bp, dp, mixed: bool = False, refine: int = 2):
    from slampp_tpu.linear.partitioned import _plan_key

    key = (_plan_key(bp), mixed, refine)
    fn = _step_cache.get(key)
    if fn is None:
        fn = jax.jit(lambda g: _native_gn_step_impl(g, bp, dp, mixed, refine))
        _step_cache[key] = fn
    return fn(graph)
