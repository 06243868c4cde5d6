"""Partitioned dense-core linear solver (the v3 engine).

An accelerator-first inversion of sparse Cholesky: instead of a level-scheduled
sparse factorization (deep sequential scan, core/sparse_chol2.py), partition
the block graph into K parts + a separator (core/partition.py), then

  1. assemble the fine block lambda scatter-free (core/block_assembly.py),
  2. gather part frames A_k (K, M, M), couplings U_k (K, M, S), and the
     dense separator system A_ss,
  3. eliminate every part interior with ONE batched Cholesky + TRSM
     (ops/dense_kernels.py) — all parts in parallel,
  4. form the separator Schur complement SC = A_ss - sum_k U_k^T A_k^-1 U_k
     with a batched GEMM + sorted segment reduction,
  5. factor SC with a single-instance Cholesky and back-substitute.

Serial depth is ~3 kernel launches instead of ~100 scan levels.  Numerics:
f32 frames with equilibration + pivot clamping, f64 iterative refinement on
the fine blocks (same contract as the v2 engine's solve_refined2).

Reference parity: this plays the role of the blockwise Cholesky solver
(include/slam/LinearSolver_UberBlock.h:45) and generalizes the Schur solver
(include/slam/LinearSolver_Schur.h:1424) from {cameras, landmarks} to
{separator, part interiors}; the GPU offload of the SC product
(src/slam/LinearSolver_Schur_GPU.cpp) is simply the default here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from slampp_tpu.core import block_assembly, partition as part_mod
from slampp_tpu.core.assembly import apply_update
from slampp_tpu.graph.system import GraphArrays, GraphSystem
from slampp_tpu.graph.types import get_edge_type, get_vertex_type
from slampp_tpu.ops import dense_kernels as dk

HI = jax.lax.Precision.HIGHEST

import os as _os

# chain mode's separator core is a SINGLE (Ms, Ms) factorization, done with
# XLA's cholesky/triangular_solve directly; SLAMPP_CHAIN_SEP_XLA=0 routes it
# through ops/dense_kernels (the frozen-pivot wrapper) instead.  Which is
# faster on the GPU is unmeasured (ROADMAP 1.6).
_CHAIN_SEP_XLA = _os.environ.get("SLAMPP_CHAIN_SEP_XLA", "1") == "1"

_CR_BASE = int(_os.environ.get("SLAMPP_CR_BASE", "8"))
# chain length at which cyclic reduction hands off to a dense batched
# factorization (see _cr_build)


def _small_inv(A):
    """Batched inverse of tiny SPD blocks (..., bs, bs).  Closed forms for
    bs <= 3 (and a blocked 2x2-of-3x3 form for bs = 6) fuse into the
    surrounding einsums instead of lowering to a batched LU; whether that
    still wins on the GPU is unmeasured (ROADMAP re-decide list)."""
    bs = A.shape[-1]
    if bs == 1:
        return 1.0 / A
    if bs == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        return jnp.stack(
            [jnp.stack([d, -b], -1), jnp.stack([-c, a], -1)], -2
        ) * inv_det[..., None, None]
    if bs == 3:
        a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
        d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
        g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
        A11 = e * i - f * h
        A12 = -(d * i - f * g)
        A13 = d * h - e * g
        det = a * A11 + b * A12 + c * A13
        inv_det = 1.0 / det
        adj = jnp.stack(
            [
                jnp.stack([A11, -(b * i - c * h), b * f - c * e], -1),
                jnp.stack([A12, a * i - c * g, -(a * f - c * d)], -1),
                jnp.stack([A13, -(a * h - b * g), a * e - b * d], -1),
            ],
            -2,
        )
        return adj * inv_det[..., None, None]
    if bs == 6:
        # blocked 2x2-of-3x3 Schur inversion (SE(3) pose blocks): stays in
        # fused closed-form territory instead of batched LU
        A11 = A[..., :3, :3]
        A12 = A[..., :3, 3:]
        A21 = A[..., 3:, :3]
        A22 = A[..., 3:, 3:]
        iA11 = _small_inv(A11)
        iA11_A12 = jnp.einsum("...ij,...jk->...ik", iA11, A12)
        S = A22 - jnp.einsum("...ij,...jk->...ik", A21, iA11_A12)
        iS = _small_inv(S)
        B12 = -jnp.einsum("...ij,...jk->...ik", iA11_A12, iS)
        B21 = -jnp.einsum("...ij,...jk->...ik", iS,
                          jnp.einsum("...ij,...jk->...ik", A21, iA11))
        B11 = iA11 - jnp.einsum("...ij,...jk->...ik", iA11_A12, B21)
        top = jnp.concatenate([B11, B12], -1)
        bot = jnp.concatenate([B21, iS], -1)
        return jnp.concatenate([top, bot], -2)
    return jnp.linalg.inv(A)


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class V3Plan(NamedTuple):
    # statics
    n: int  # fine blocks
    bs: int
    nnzb: int  # fine slots (n diag + n_off offd)
    K: int
    mB: int  # interior blocks per part (padded)
    sB: int  # boundary blocks per part (padded)
    SB: int  # total separator blocks
    M: int  # part frame scalars (mult of 8)
    S: int  # boundary scalars (sB*bs)
    Ms: int  # separator frame scalars (mult of 8)
    # device index arrays
    rows: jnp.ndarray  # (nnzb,) permuted block row per slot
    cols: jnp.ndarray  # (nnzb,)
    a_idx: jnp.ndarray  # (K, mB, mB) -> Gv row
    u_idx: jnp.ndarray  # (K, mB, sB) -> Gv row
    ss_idx: jnp.ndarray  # (SB, SB) -> Gv row
    gk_idx: jnp.ndarray  # (K, mB) -> rhs row (n = dummy)
    gs_idx: jnp.ndarray  # (SB,)
    a_pad_eye: jnp.ndarray  # (K, M) 1.0 where frame diagonal is padding
    ss_pad_eye: jnp.ndarray  # (Ms,)
    sc_grp: object  # GroupedSegments over SC block contributions
    sc_inv_map: jnp.ndarray  # (SB*SB,) -> F2 = zero
    scr_grp: object  # GroupedSegments over SC rhs contributions
    scr_inv_map: jnp.ndarray  # (SB,)
    xs_idx: jnp.ndarray  # (K, sB) -> separator block rank (SB = dummy)
    sol_gather: jnp.ndarray  # (n,) -> row in [x_int (K*mB) | xs (SB)]
    # spmv (f64 refinement) plan
    mv_grp: object  # GroupedSegments over matvec terms -> n rows
    # chain mode (round 5): when every part interior is a pure chain (all
    # loop closures live in the separator — true for pose graphs under the
    # contiguous partitioner), the part frames are block-TRIDIAGONAL and
    # factor via batched block cyclic reduction in log2(mB) levels instead
    # of a dense (K, M, M) Cholesky — see _chain_factor32
    ch_ok: int = 0
    ch_m: int = 1             # pow2-padded chain length
    ch_d_idx: object = None   # (K, ch_m) Gv rows of interior diagonal blocks
    ch_e_idx: object = None   # (K, ch_m) Gv rows of A[a+1, a] blocks
    ch_pad: object = None     # (K, ch_m) 1.0 where the chain is padding


class PartitionedSolver:
    """Same interface as NativeBlockSolver, v3 engine."""

    def __init__(
        self,
        system: GraphSystem,
        target: int = 64,
        mixed_precision: bool = True,
        refine_iters: int = 1,
        damping_rel: float = 1e-6,
        forced_separator=None,
    ):
        """``forced_separator``: vertex ids that must land in the dense
        separator core (enables gn_step_prior — the windowed incremental
        solver's frozen-chunk Schur prior attaches there)."""
        self.system = system
        self.target = target
        self.mixed_precision = mixed_precision
        self.refine_iters = refine_iters
        self.damping_rel = damping_rel
        self.forced_separator = forced_separator
        self.separator_blocks = None  # sorted block ids, set by symbolic()
        self._symbolic_key = None
        self.block_plan = None
        self.plan: V3Plan | None = None

    # ------------------------------------------------------------------ host
    def symbolic(self) -> None:
        system = self.system
        block_of_vid = {vid: b for b, vid in enumerate(system._vorder)}
        n = len(block_of_vid)

        pairs = set()
        for tname in system.edge_type_names:
            for vids in system._edges[tname]["vids"]:
                bs_ = [block_of_vid.get(v, -1) for v in vids]
                for x in range(len(bs_)):
                    for y in range(x + 1, len(bs_)):
                        if bs_[x] >= 0 and bs_[y] >= 0 and bs_[x] != bs_[y]:
                            a, b = sorted((bs_[x], bs_[y]))
                            pairs.add((b, a))
        pairs = sorted(pairs)

        vt_dims = {
            get_vertex_type(t).dim for t, _ in system.vertex_index.values()
        }
        if len(vt_dims) != 1:
            raise ValueError(f"uniform block size required, got dims {vt_dims}")
        bs = vt_dims.pop()

        forced = None
        if self.forced_separator is not None:
            forced = [block_of_vid[v] for v in self.forced_separator
                      if v in block_of_vid]
        extras = {}
        plan, slot_of, inv = build_v3_geometry(
            n, pairs, bs, self.target, forced_separator=forced, extras=extras
        )
        self.separator_blocks = extras["separator"]
        bp = block_assembly.build_block_plan(
            system, slot_of, np.arange(n, dtype=np.int64), plan.nnzb, inv,
            block_of_vid, panel=1,
        )
        assert bp.bs == bs
        self.block_plan = bp
        self.plan = plan
        self._symbolic_key = (system.n_vertices, system.n_edges)

    def ensure_symbolic(self):
        key = (self.system.n_vertices, self.system.n_edges)
        if self._symbolic_key != key:
            self.symbolic()

    # ---------------------------------------------------------------- device
    def gn_step(self, graph: GraphArrays):
        self.ensure_symbolic()
        return _v3_gn_step(
            graph, self.block_plan, self.plan, self.refine_iters, self.damping_rel,
            self.mixed_precision,
        )

    def optimize_fused(self, graph: GraphArrays, n_iters: int = 5):
        self.ensure_symbolic()
        return _v3_fused(
            graph, self.block_plan, self.plan, n_iters, self.refine_iters,
            self.damping_rel, self.mixed_precision,
        )

    def gn_step_prior(self, graph: GraphArrays, sc_prior, rhs_prior,
                      update_threshold=0.0):
        """One GN step on H + prior: H[sep,sep] += sc_prior, g[sep] +=
        rhs_prior, dx = -(H+P)^-1 (g+p) — the windowed incremental live
        solve, sparsely (the dense H[live] route this replaces allocated and
        factored the full padded live system every step).

        sc_prior: (Ms, Ms) in SEPARATOR-FRAME scalar coordinates (rank
        order of self.separator_blocks x block size, zero-padded to Ms);
        rhs_prior: (Ms,) in the same frame, g-sign convention.
        Returns (new_states, dx_norm, chi2)."""
        self.ensure_symbolic()
        key = ("v3prior", _plan_key(self.block_plan), self.damping_rel,
               self.mixed_precision, self.refine_iters)
        fn = _step_cache.get(key)
        if fn is None:
            bp, p = self.block_plan, self.plan
            dr, mixed = self.damping_rel, self.mixed_precision
            refine = self.refine_iters

            def impl(g, sc, rp, thr):
                vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(
                    g, bp, hessian_f32=mixed
                )
                # b64 = -g fine => separator rhs add is -rhs_prior
                x = _v3_solve_refined(
                    p, vals, -rhs, refine, dr, mixed,
                    sc_prior=sc, gs_prior=-rp,
                )
                dx = block_assembly.scatter_dx(bp, x, bp.bs)
                from slampp_tpu.core.assembly import apply_update_gated

                new_states = apply_update_gated(g, dx, thr)
                return new_states, jnp.linalg.norm(dx), chi2

            fn = jax.jit(impl)
            _step_cache[key] = fn
        return fn(graph, jnp.asarray(sc_prior, jnp.float64),
                  jnp.asarray(rhs_prior, jnp.float64),
                  jnp.asarray(update_threshold, jnp.float64))

    def damped_step(self, graph: GraphArrays, alpha: float):
        """One LM-damped step (lambda + alpha I) through the partitioned
        engine — the sparse route for LevenbergMarquardtSolver/DoglegSolver
        (reference ApplyDamping, NonlinearSolver_Lambda_LM.h:235-243).
        Returns (new_states, denom, dx_norm, chi2)."""
        self.ensure_symbolic()
        key = ("v3damped", _plan_key(self.block_plan), self.refine_iters,
               self.damping_rel, self.mixed_precision)
        fn = _step_cache.get(key)
        if fn is None:
            bp, p = self.block_plan, self.plan
            refine, dr, mixed = self.refine_iters, self.damping_rel, self.mixed_precision

            def impl(g, a):
                vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(
                    g, bp, hessian_f32=mixed
                )
                d = jnp.arange(bp.bs)
                vals = vals.at[: p.n, d, d].add(a.astype(vals.dtype))
                x = _v3_solve_refined(p, vals, -rhs, refine, dr, mixed)
                dx = block_assembly.scatter_dx(bp, x, bp.bs)
                new_states = apply_update(g, dx)
                # rho denominator dx.(alpha dx - g) with g in global layout
                gvec = block_assembly.scatter_dx(bp, rhs[: p.n], bp.bs)
                denom = jnp.dot(dx, a * dx - gvec)
                return new_states, denom, jnp.linalg.norm(dx), chi2

            fn = jax.jit(impl)
            _step_cache[key] = fn
        return fn(graph, jnp.asarray(alpha, jnp.float64))

    def dogleg_step(self, graph: GraphArrays, delta: float,
                    relin_threshold: float = 0.0):
        """One Powell-dogleg step through the partitioned engine (sparse
        route for DoglegSolver — reference CNonlinearSolver_Lambda_DL batch
        semantics).  Returns (new_states, pred_reduction, dx_norm, chi2)."""
        self.ensure_symbolic()
        key = ("v3dogleg", _plan_key(self.block_plan), self.refine_iters,
               self.damping_rel, self.mixed_precision)
        fn = _step_cache.get(key)
        if fn is None:
            bp, p = self.block_plan, self.plan
            refine, dr, mixed = self.refine_iters, self.damping_rel, self.mixed_precision

            def impl(g, delta, thr):
                from slampp_tpu.core.assembly import apply_update_gated

                vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(
                    g, bp, hessian_f32=mixed
                )
                grad = rhs[: p.n]  # permuted fine-layout gradient (n, bs)
                x_gn = _v3_solve_refined(p, vals, -rhs, refine, dr, mixed)
                Hg = _spmv_fine(p, vals, grad)
                gTg = jnp.sum(grad * grad)
                gHg = jnp.sum(grad * Hg)
                a = gTg / jnp.maximum(gHg, 1e-300)
                x_sd = -a * grad
                n_gn = jnp.sqrt(jnp.sum(x_gn * x_gn))
                n_sd = jnp.sqrt(jnp.sum(x_sd * x_sd))

                d_ = x_gn - x_sd
                aa = jnp.sum(d_ * d_)
                bb = 2.0 * jnp.sum(x_sd * d_)
                cc = jnp.sum(x_sd * x_sd) - delta * delta
                disc = jnp.sqrt(jnp.maximum(bb * bb - 4 * aa * cc, 0.0))
                t = jnp.clip((-bb + disc) / jnp.maximum(2 * aa, 1e-300), 0.0, 1.0)
                blend = x_sd + t * d_
                x = jnp.where(
                    n_gn <= delta,
                    x_gn,
                    jnp.where(
                        n_sd >= delta,
                        x_sd * (delta / jnp.maximum(n_sd, 1e-300)),
                        blend,
                    ),
                )
                Hx = _spmv_fine(p, vals, x)
                pred = -(jnp.sum(grad * x) + 0.5 * jnp.sum(x * Hx))
                dx = block_assembly.scatter_dx(bp, x, bp.bs)
                new_states = apply_update_gated(g, dx, thr)
                return new_states, pred, jnp.sqrt(jnp.sum(x * x)), chi2

            fn = jax.jit(impl)
            _step_cache[key] = fn
        return fn(graph, jnp.asarray(delta, jnp.float64),
                  jnp.asarray(relin_threshold, jnp.float64))


def build_v3_geometry(n, pairs, bs: int, target: int = 64,
                      max_sep_frac: float = 0.45, forced_separator=None,
                      extras: dict = None):
    """Build the partitioned-solver geometry for an arbitrary block-sparse
    SPD system: ``n`` blocks of uniform size ``bs``, off-diagonal pattern
    ``pairs`` (original block indices, orientation-free).

    Returns ``(V3Plan, slot_of, inv)`` where ``inv`` maps original block ->
    permuted fine position and ``slot_of`` maps PERMUTED ``(i, j)`` with
    ``i >= j`` to the fine value slot (diag slot j at index j, off-diagonals
    from ``n``).  Shared by :class:`PartitionedSolver` (graph systems) and
    the general sparse Schur solver (linear/schur_sparse.py), playing the
    role of the reference's symbolic decomposition
    (LinearSolver_UberBlock.h:272).

    ``forced_separator``: block ids that must land in the dense separator
    core (where a Schur prior can be injected — see gn_step_prior).
    ``extras``: optional dict filled with {"separator": sorted block ids}.
    """
    def _do_partition(forced):
        if forced:
            return part_mod.partition_graph_forced(
                n, sorted(pairs), sorted(forced), target=target,
                max_sep_frac=max_sep_frac)
        return part_mod.partition_graph(n, sorted(pairs), target=target,
                                        max_sep_frac=max_sep_frac)

    forced_set = set(forced_separator or [])
    part = _do_partition(forced_set)
    # chain-ification (round 5): promote one endpoint of every
    # interior-interior coupling that skips a chain position, so part
    # interiors become pure block tridiagonals and factor via batched
    # cyclic reduction (_chain_factor32).  Bounded: give up (dense-frame
    # path) rather than blow up the separator on non-chain-like graphs.
    budget = max(16, n // 8)
    for _ in range(4):
        offenders = set()
        for pk in part.parts:
            pos = {int(b): i for i, b in enumerate(pk)}
            for i, j in pairs:
                pi, pj = pos.get(int(i)), pos.get(int(j))
                if pi is not None and pj is not None and abs(pi - pj) >= 2:
                    offenders.add(int(max(i, j)))
        if not offenders:
            break
        if len(forced_set | offenders) - len(set(forced_separator or [])) > budget:
            part = _do_partition(set(forced_separator or []))
            break
        forced_set |= offenders
        part = _do_partition(forced_set)
    if extras is not None:
        extras["separator"] = np.asarray(part.separator, np.int64)
    # permuted order: part interiors (contiguous), then separator
    order = np.concatenate([*(part.parts or [np.zeros(0, np.int64)]), part.separator]).astype(np.int64)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    n_int = n - len(part.separator)

    # permuted off-diagonal pairs -> fine slot table
    ppairs = sorted({(max(int(inv[i]), int(inv[j])), min(int(inv[i]), int(inv[j]))) for i, j in pairs})
    slot_of = {(j, j): j for j in range(n)}
    rows_l, cols_l = [], []
    for k, (i, j) in enumerate(ppairs):
        slot_of[(i, j)] = n + k
        rows_l.append(i)
        cols_l.append(j)
    n_off = len(ppairs)
    nnzb = n + n_off

    K = part.K
    mB = part.max_interior
    sB = max(1, part.max_boundary)
    SB = len(part.separator)
    M = _pad_to(mB * bs, dk.PB)
    S = sB * bs
    Ms = _pad_to(max(SB, 1) * bs, dk.PB)

    ZERO = 2 * nnzb  # Gv rows: [vals | vals^T | zero]

    def look(i, j):
        """Gv row for block H_{ij} in permuted coords."""
        if i == j:
            return i
        if i > j:
            s = slot_of.get((i, j))
            return s if s is not None else ZERO
        s = slot_of.get((j, i))
        return (nnzb + s) if s is not None else ZERO

    # part frames
    p0 = np.zeros(K, np.int64)
    off = 0
    for k, p in enumerate(part.parts):
        p0[k] = off
        off += len(p)
    assert off == n_int

    a_idx = np.full((K, mB, mB), ZERO, np.int64)
    u_idx = np.full((K, mB, sB), ZERO, np.int64)
    gk_idx = np.full((K, mB), n, np.int64)
    xs_idx = np.full((K, sB), SB, np.int64)
    a_pad_eye = np.zeros((K, M))
    sep_rank = {int(b): r for r, b in enumerate(part.separator)}
    for k, p in enumerate(part.parts):
        m = len(p)
        for a in range(m):
            ia = int(p0[k] + a)
            gk_idx[k, a] = ia
            for b in range(m):
                a_idx[k, a, b] = look(ia, int(p0[k] + b))
        a_pad_eye[k, m * bs :] = 1.0
        bnd = part.boundary[k]
        for c, sb_orig in enumerate(bnd):
            r = sep_rank[int(sb_orig)]
            xs_idx[k, c] = r
            j = n_int + r
            for a in range(m):
                u_idx[k, a, c] = look(int(p0[k] + a), j)

    ss_idx = np.full((SB, SB), ZERO, np.int64)
    gs_idx = np.zeros(max(SB, 1), np.int64)
    for r in range(SB):
        gs_idx[r] = n_int + r
        for c in range(SB):
            ss_idx[r, c] = look(n_int + r, n_int + c)
    ss_pad_eye = np.zeros(Ms)
    ss_pad_eye[SB * bs :] = 1.0

    # SC contribution reduction: term t = (k, c, d) -> dest (xs_idx[k,c], xs_idx[k,d])
    kk, cc, dd = np.meshgrid(np.arange(K), np.arange(sB), np.arange(sB), indexing="ij")
    dr = xs_idx[kk, cc]
    dc = xs_idx[kk, dd]
    dest = np.where((dr < SB) & (dc < SB), dr * max(SB, 1) + dc, SB * SB + 1).ravel()
    sc_perm = np.argsort(dest, kind="stable")
    sdest = dest[sc_perm]
    kept = int(np.searchsorted(sdest, SB * SB + 1))
    uniq, starts = np.unique(sdest[:kept], return_index=True)
    ends = np.concatenate([starts[1:], [kept]]).astype(np.int64) if len(uniq) else np.zeros(0, np.int64)
    F2 = len(uniq)
    grid_ids = np.arange(max(SB, 1) * max(SB, 1), dtype=np.int64)
    if F2:
        posg = np.minimum(np.searchsorted(uniq, grid_ids), F2 - 1)
        sc_inv_map = np.where(uniq[posg] == grid_ids, posg, F2)
    else:
        sc_inv_map = np.full(grid_ids.shape, F2, np.int64)

    # SC rhs contributions: term (k, c) -> dest xs_idx[k, c]
    destr = np.where(xs_idx < SB, xs_idx, SB + 1).ravel()
    scr_perm = np.argsort(destr, kind="stable")
    sdr = destr[scr_perm]
    keptr = int(np.searchsorted(sdr, SB + 1))
    uniq_r, starts_r = np.unique(sdr[:keptr], return_index=True)
    ends_r = np.concatenate([starts_r[1:], [keptr]]).astype(np.int64) if len(uniq_r) else np.zeros(0, np.int64)
    Fr = len(uniq_r)
    rid = np.arange(max(SB, 1), dtype=np.int64)
    if Fr:
        posr = np.minimum(np.searchsorted(uniq_r, rid), Fr - 1)
        scr_inv_map = np.where(uniq_r[posr] == rid, posr, Fr)
    else:
        scr_inv_map = np.full(rid.shape, Fr, np.int64)

    # solution gather: permuted fine p -> row in [x_int (K*mB) | xs (SB)]
    sol = np.zeros(n, np.int64)
    for k, p in enumerate(part.parts):
        for a in range(len(p)):
            sol[p0[k] + a] = k * mB + a
    for r in range(SB):
        sol[n_int + r] = K * mB + r

    # spmv plan: terms = [all slots -> dest rows] + [offd slots -> dest cols]
    rows_arr = np.concatenate([np.arange(n), np.asarray(rows_l, np.int64)])
    cols_arr = np.concatenate([np.arange(n), np.asarray(cols_l, np.int64)])
    mv_dest = np.concatenate([rows_arr, cols_arr[n:]])
    mv_perm = np.argsort(mv_dest, kind="stable")
    smv = mv_dest[mv_perm]
    uniq_m, starts_m = np.unique(smv, return_index=True)
    assert len(uniq_m) == n  # every row has a diagonal term
    ends_m = np.concatenate([starts_m[1:], [len(smv)]]).astype(np.int64)

    # chain detection + tables: interiors are chains iff no interior
    # off-diagonal skips a position (closures are separator-forced)
    offd = a_idx != ZERO
    ai = np.arange(mB)
    skip = np.abs(ai[:, None] - ai[None, :]) >= 2
    ch_ok = int(not (offd & skip[None, :, :]).any())
    ch_m = 1
    while ch_m < max(mB, 1):
        ch_m *= 2
    ch_d_idx = np.full((K, ch_m), ZERO, np.int64)
    ch_e_idx = np.full((K, ch_m), ZERO, np.int64)
    ch_pad = np.zeros((K, ch_m))
    ch_d_idx[:, :mB] = a_idx[np.arange(K)[:, None], ai[None, :], ai[None, :]]
    if mB > 1:
        ch_e_idx[:, : mB - 1] = a_idx[
            np.arange(K)[:, None], ai[None, 1:], ai[None, :-1]
        ]
    ch_pad[ch_d_idx == ZERO] = 1.0

    dev = lambda a: jnp.asarray(a, jnp.int32)
    plan = V3Plan(
        n=n, bs=bs, nnzb=nnzb, K=K, mB=mB, sB=sB, SB=SB, M=M, S=S, Ms=Ms,
        rows=dev(rows_arr), cols=dev(cols_arr),
        a_idx=dev(a_idx), u_idx=dev(u_idx), ss_idx=dev(ss_idx),
        gk_idx=dev(gk_idx), gs_idx=dev(gs_idx),
        a_pad_eye=jnp.asarray(a_pad_eye, jnp.float32),
        ss_pad_eye=jnp.asarray(ss_pad_eye, jnp.float32),
        sc_grp=block_assembly._remapped_group_plan(starts, ends, sc_perm),
        sc_inv_map=dev(sc_inv_map),
        scr_grp=block_assembly._remapped_group_plan(starts_r, ends_r, scr_perm),
        scr_inv_map=dev(scr_inv_map),
        xs_idx=dev(xs_idx), sol_gather=dev(sol),
        mv_grp=block_assembly._remapped_group_plan(starts_m, ends_m, mv_perm),
        ch_ok=ch_ok, ch_m=ch_m, ch_d_idx=dev(ch_d_idx),
        ch_e_idx=dev(ch_e_idx), ch_pad=jnp.asarray(ch_pad, jnp.float32),
    )
    return plan, slot_of, inv


# --------------------------------------------------------------------- device


def _segsum(cum0, starts, ends):
    return cum0[ends] - cum0[starts]


def _frames(p: V3Plan, Gv, rhsf, dtype):
    """Gather the part frames, couplings, separator system, and rhs frames
    from the packed fine blocks Gv = [vals | vals^T | zero]."""
    bs = p.bs
    A = Gv[p.a_idx]  # (K, mB, mB, bs, bs)
    A = A.transpose(0, 1, 3, 2, 4).reshape(p.K, p.mB * bs, p.mB * bs)
    A = jnp.pad(A, ((0, 0), (0, p.M - p.mB * bs), (0, p.M - p.mB * bs)))
    A = A + jax.vmap(jnp.diag)(p.a_pad_eye.astype(dtype))
    U = Gv[p.u_idx]  # (K, mB, sB, bs, bs)
    U = U.transpose(0, 1, 3, 2, 4).reshape(p.K, p.mB * bs, p.S)
    U = jnp.pad(U, ((0, 0), (0, p.M - p.mB * bs), (0, 0)))
    Ass = Gv[p.ss_idx].transpose(0, 2, 1, 3).reshape(p.SB * bs, p.SB * bs)
    Ass = jnp.pad(Ass, ((0, p.Ms - p.SB * bs), (0, p.Ms - p.SB * bs)))
    Ass = Ass + jnp.diag(p.ss_pad_eye.astype(dtype))
    gk = rhsf[p.gk_idx].reshape(p.K, p.mB * bs)
    gk = jnp.pad(gk, ((0, 0), (0, p.M - p.mB * bs)))
    gs = rhsf[p.gs_idx].reshape(-1)[: p.SB * bs]
    gs = jnp.pad(gs, (0, p.Ms - p.SB * bs))
    return A, U, Ass, gk, gs


def _cr_build(D, Lw):
    """Batched block cyclic reduction hierarchy for SPD block-tridiagonal
    systems.  D (K, m, bs, bs) diagonal blocks, Lw (K, m, bs, bs) with
    Lw[:, i] = A[i+1, i] (Lw[:, m-1] = 0); m a power of two (identity/zero
    padding decouples).  log2(m) levels of BATCHED tiny-block einsums — a
    parallel substitute for a sequential banded factorization (parallel
    over parts AND over chain positions; reference economics:
    BlockMatrix.h:3663 CholeskyOf on the tridiagonal lambda)."""
    levels = []
    m = D.shape[1]
    # reduce until the remaining chain fits one batched DENSE factorization
    # (m <= _CR_BASE): halves the count of tiny sequential level ops, and a
    # (K, base*bs, base*bs) Cholesky is a single well-shaped batched kernel
    while m > _CR_BASE:
        DO = D[:, 1::2]
        DE = D[:, 0::2]
        P = Lw[:, 0::2]   # even -> odd coupling A[2t+1, 2t]
        Q = Lw[:, 1::2]   # odd -> even coupling A[2t+2, 2t+1]
        DOinv = _small_inv(DO)
        DiP = jnp.einsum("kmij,kmjl->kmil", DOinv, P, precision=HI)
        PtDiP = jnp.einsum("kmji,kmjl->kmil", P, DiP, precision=HI)
        QDi = jnp.einsum("kmij,kmjl->kmil", Q, DOinv, precision=HI)
        QDiQt = jnp.einsum("kmil,kmjl->kmij", QDi, Q, precision=HI)
        Dn = DE - PtDiP - jnp.pad(
            QDiQt[:, :-1], ((0, 0), (1, 0), (0, 0), (0, 0))
        )
        Ln = -jnp.einsum("kmil,kmlj->kmij", QDi, P, precision=HI)
        levels.append((DOinv, P, Q))
        D, Lw = Dn, Ln
        m //= 2
    # dense base case: assemble the remaining (K, m*bs, m*bs) tridiagonal
    K_, _, bs, _ = D.shape
    T = jnp.zeros((K_, m, bs, m, bs), D.dtype)
    ar = jnp.arange(m)
    T = T.at[:, ar, :, ar, :].set(jnp.swapaxes(D, 0, 1))
    if m > 1:
        T = T.at[:, ar[1:], :, ar[:-1], :].set(
            jnp.swapaxes(Lw[:, :-1], 0, 1)
        )
        T = T.at[:, ar[:-1], :, ar[1:], :].set(
            jnp.swapaxes(jnp.swapaxes(Lw[:, :-1], -1, -2), 0, 1)
        )
    T = T.reshape(K_, m * bs, m * bs)
    Lbase = jax.lax.linalg.cholesky(T, symmetrize_input=False)
    return levels, (Lbase, m, bs)


def _cr_solve(levels, root_inv, B):
    """Solve A X = B through a _cr_build hierarchy; B (K, m, bs, R)."""
    stack = []
    for DOinv, P, Q in levels:
        BO = B[:, 1::2]
        BE = B[:, 0::2]
        DiB = jnp.einsum("kmij,kmjr->kmir", DOinv, BO, precision=HI)
        PtDiB = jnp.einsum("kmji,kmjr->kmir", P, DiB, precision=HI)
        QDiB = jnp.einsum("kmij,kmjr->kmir", Q, DiB, precision=HI)
        B = BE - PtDiB - jnp.pad(
            QDiB[:, :-1], ((0, 0), (1, 0), (0, 0), (0, 0))
        )
        stack.append((DOinv, P, Q, BO))
    Lbase, mb, bs = root_inv
    K_ = B.shape[0]
    Bb = B.reshape(K_, mb * bs, -1)
    yb = jax.lax.linalg.triangular_solve(
        Lbase, Bb, left_side=True, lower=True
    )
    xb = jax.lax.linalg.triangular_solve(
        Lbase, yb, left_side=True, lower=True, transpose_a=True
    )
    x = xb.reshape(K_, mb, bs, -1)
    for DOinv, P, Q, BO in reversed(stack):
        xE = x
        xE_next = jnp.concatenate(
            [xE[:, 1:], jnp.zeros_like(xE[:, :1])], 1
        )
        t = (
            BO
            - jnp.einsum("kmij,kmjr->kmir", P, xE, precision=HI)
            - jnp.einsum("kmji,kmjr->kmir", Q, xE_next, precision=HI)
        )
        xO = jnp.einsum("kmij,kmjr->kmir", DOinv, t, precision=HI)
        K_, m2 = xE.shape[0], xE.shape[1]
        x = jnp.stack([xE, xO], 2).reshape((K_, 2 * m2) + xE.shape[2:])
    return x


def _chain_sep_frames(p: V3Plan, Gv, rhsf, dtype):
    """Ass / gs gathers shared with _frames (chain path skips A/U frames)."""
    bs = p.bs
    Ass = Gv[p.ss_idx].transpose(0, 2, 1, 3).reshape(p.SB * bs, p.SB * bs)
    Ass = jnp.pad(Ass, ((0, p.Ms - p.SB * bs), (0, p.Ms - p.SB * bs)))
    Ass = Ass + jnp.diag(p.ss_pad_eye.astype(dtype))
    gs = rhsf[p.gs_idx].reshape(-1)[: p.SB * bs]
    gs = jnp.pad(gs, (0, p.Ms - p.SB * bs))
    return Ass, gs


def _chain_gather_U(p: V3Plan, Gv, rhsf):
    bs = p.bs
    U5 = Gv[p.u_idx]  # (K, mB, sB, bs, bs)
    Ub = U5.transpose(0, 1, 3, 2, 4).reshape(p.K, p.mB, bs, p.S)
    Ub = jnp.pad(Ub, ((0, 0), (0, p.ch_m - p.mB), (0, 0), (0, 0)))
    gk = rhsf[p.gk_idx]  # (K, mB, bs)
    gk = jnp.pad(gk, ((0, 0), (0, p.ch_m - p.mB), (0, 0)))
    return Ub, gk


def _chain_flat(p: V3Plan, X):
    """(K, ch_m, bs, ...) node rows -> (K, M, ...) flat frame rows."""
    K = p.K
    flat = X.reshape((K, p.ch_m * p.bs) + X.shape[3:])[:, : p.mB * p.bs]
    pad = [(0, 0), (0, p.M - p.mB * p.bs)] + [(0, 0)] * (flat.ndim - 2)
    return jnp.pad(flat, pad)


def _chain_sc_reduce(p: V3Plan, C):
    """(K, S, S) boundary-pair contributions -> SC subtraction matrix."""
    from slampp_tpu.ops.segments import grouped_segsum_last

    bs = p.bs
    Cb = C.reshape(p.K, p.sB, bs, p.sB, bs).transpose(0, 1, 3, 2, 4).reshape(-1, bs * bs)
    red = grouped_segsum_last(Cb.T, p.sc_grp)
    redp = jnp.concatenate([red, jnp.zeros((bs * bs, 1), Cb.dtype)], -1)
    SBp = max(p.SB, 1)
    return (
        redp[:, p.sc_inv_map]
        .reshape(bs, bs, SBp, SBp)
        .transpose(2, 0, 3, 1)
        .reshape(SBp * bs, SBp * bs)[: p.SB * bs, : p.SB * bs]
    )


def _chain_rhs_reduce(p: V3Plan, v):
    from slampp_tpu.ops.segments import grouped_segsum_last

    bs = p.bs
    vb = v.reshape(p.K * p.sB, bs)
    redv = grouped_segsum_last(vb.T, p.scr_grp)
    redvp = jnp.concatenate([redv, jnp.zeros((bs, 1), vb.dtype)], -1)
    return redvp[:, p.scr_inv_map].T.reshape(-1)[: p.SB * bs]


def _chain_factor32(p: V3Plan, vals32, rhs32, sc_prior=None, gs_prior=None):
    """Chain-mode factorization: batched cyclic reduction over the part
    tridiagonals + the usual dense separator core.  Returns
    (levels, root_inv, Uflat, Xu, Xg, Ls, rhs_s) — the chain analog of
    _factor32's (L, WU, y, Ls, rhs_s)."""
    bs = p.bs
    valsT = jnp.swapaxes(vals32, 1, 2)
    Gv = jnp.concatenate([vals32, valsT, jnp.zeros((1, bs, bs), vals32.dtype)], 0)
    rhsf = jnp.concatenate([rhs32, jnp.zeros((1, bs), rhs32.dtype)], 0)
    dt = vals32.dtype
    D = Gv[p.ch_d_idx] + p.ch_pad.astype(dt)[..., None, None] * jnp.eye(bs, dtype=dt)
    E = Gv[p.ch_e_idx]
    Ub, gk = _chain_gather_U(p, Gv, rhsf)
    Ass, gs = _chain_sep_frames(p, Gv, rhsf, dt)
    if sc_prior is not None:
        Ass = Ass + sc_prior.astype(Ass.dtype)
    if gs_prior is not None:
        gs = gs + gs_prior.astype(gs.dtype)

    levels, root_inv = _cr_build(D, E)
    B = jnp.concatenate([Ub, gk[..., None]], -1)  # (K, ch_m, bs, S+1)
    X = _cr_solve(levels, root_inv, B)
    Xu = _chain_flat(p, X[..., : p.S])  # (K, M, S) = A^-1 U
    Xg = _chain_flat(p, X[..., p.S])    # (K, M)    = A^-1 b
    Uflat = _chain_flat(p, Ub)

    C = jnp.einsum("kms,kmt->kst", Uflat, Xu, preferred_element_type=dt, precision=HI)
    SCsub = _chain_sc_reduce(p, C)
    SC = Ass - jnp.pad(SCsub, ((0, p.Ms - p.SB * bs), (0, p.Ms - p.SB * bs)))
    if _CHAIN_SEP_XLA:
        Ls = jax.lax.linalg.cholesky(SC, symmetrize_input=False)[None]
    else:
        Ls = dk.chol_batched(SC[None])

    v = jnp.einsum("kms,km->ks", Uflat, Xg, preferred_element_type=dt, precision=HI)
    vsub = _chain_rhs_reduce(p, v)
    rhs_s = gs - jnp.pad(vsub, (0, p.Ms - p.SB * bs))
    return levels, root_inv, Uflat, Xu, Xg, Ls, rhs_s


def _chain_backsolve(p: V3Plan, Xu, Xg, Ls, rhs_s):
    """x_int = A^-1 b - (A^-1 U) x_s; no triangular solves on the parts."""
    bs = p.bs
    if _CHAIN_SEP_XLA:
        zs = jax.lax.linalg.triangular_solve(
            Ls[0], rhs_s[:, None], left_side=True, lower=True
        )
        xs = jax.lax.linalg.triangular_solve(
            Ls[0], zs, left_side=True, lower=True, transpose_a=True
        )[:, 0]
    else:
        rs = jnp.pad(rhs_s[None, :, None], ((0, 0), (0, 0), (0, 7)))
        zs = dk.trsm_lower_batched(Ls, rs)
        xs = dk.trsm_lower_t_batched(Ls, zs)[0, :, 0]
    xs_blocks = jnp.concatenate(
        [xs[: p.SB * bs].reshape(max(p.SB, 1) if p.SB else 1, -1)[: p.SB],
         jnp.zeros((1, bs), xs.dtype)], 0
    ) if p.SB else jnp.zeros((1, bs), xs.dtype)
    xsb = xs_blocks[p.xs_idx].reshape(p.K, p.S)
    xk = Xg - jnp.einsum("kms,ks->km", Xu, xsb, preferred_element_type=Xu.dtype, precision=HI)
    x_int = xk[:, : p.mB * bs].reshape(p.K * p.mB, bs)
    xs_all = xs[: p.SB * bs].reshape(-1, bs) if p.SB else jnp.zeros((0, bs), xs.dtype)
    x_rows = jnp.concatenate([x_int, xs_all], 0)
    return x_rows[p.sol_gather]


def _chain_solve_with(p: V3Plan, levels, root_inv, Uflat, Xu, Ls, gk_fine):
    """Repeated solve for a new fine rhs through the cached chain
    factorization (refinement path)."""
    bs = p.bs
    gk = gk_fine[p.gk_idx]  # (K, mB, bs)
    gk = jnp.pad(gk, ((0, 0), (0, p.ch_m - p.mB), (0, 0)))
    gs = gk_fine[p.gs_idx].reshape(-1)[: p.SB * bs]
    gs = jnp.pad(gs, (0, p.Ms - p.SB * bs))
    Yg = _chain_flat(p, _cr_solve(levels, root_inv, gk[..., None])[..., 0])
    v = jnp.einsum("kms,km->ks", Uflat, Yg, preferred_element_type=Yg.dtype, precision=HI)
    vsub = _chain_rhs_reduce(p, v)
    rhs_s = gs - jnp.pad(vsub, (0, p.Ms - p.SB * bs))
    return _chain_backsolve(p, Xu, Yg, Ls, rhs_s)


def _factor32(p: V3Plan, vals32, rhs32, sc_prior=None, gs_prior=None):
    """f32 factorization phase; returns everything the repeated solves need.

    ``sc_prior`` (Ms, Ms) / ``gs_prior`` (Ms,) add to the separator system /
    rhs frames (the windowed incremental solver's frozen-chunk Schur prior;
    must be pre-scaled to match the dtype/equilibration of vals32/rhs32)."""
    bs = p.bs
    valsT = jnp.swapaxes(vals32, 1, 2)
    Gv = jnp.concatenate([vals32, valsT, jnp.zeros((1, bs, bs), vals32.dtype)], 0)
    rhsf = jnp.concatenate([rhs32, jnp.zeros((1, bs), rhs32.dtype)], 0)
    A, U, Ass, gk, gs = _frames(p, Gv, rhsf, vals32.dtype)
    if sc_prior is not None:
        Ass = Ass + sc_prior.astype(Ass.dtype)
    if gs_prior is not None:
        gs = gs + gs_prior.astype(gs.dtype)

    L = dk.chol_batched(A)  # (K, M, M)
    B = jnp.concatenate([U, gk[..., None]], -1)
    B = jnp.pad(B, ((0, 0), (0, 0), (0, (-B.shape[-1]) % 8)))
    W = dk.trsm_lower_batched(L, B)  # (K, M, S+pad)
    WU = W[:, :, : p.S]
    y = W[:, :, p.S]

    # SC = Ass - sum_k place(WU^T WU); grouped padded-gather reduction
    # (ops/segments.py) in batch-last (bs*bs, T) layout
    from slampp_tpu.ops.segments import grouped_segsum_last

    C = jnp.einsum("kms,kmt->kst", WU, WU, preferred_element_type=WU.dtype, precision=HI)
    Cb = C.reshape(p.K, p.sB, bs, p.sB, bs).transpose(0, 1, 3, 2, 4).reshape(-1, bs * bs)
    red = grouped_segsum_last(Cb.T, p.sc_grp)  # (bs*bs, F2)
    redp = jnp.concatenate([red, jnp.zeros((bs * bs, 1), Cb.dtype)], -1)
    SBp = max(p.SB, 1)
    SCsub = (
        redp[:, p.sc_inv_map]
        .reshape(bs, bs, SBp, SBp)
        .transpose(2, 0, 3, 1)
        .reshape(SBp * bs, SBp * bs)[: p.SB * bs, : p.SB * bs]
    )
    SC = Ass - jnp.pad(SCsub, ((0, p.Ms - p.SB * bs), (0, p.Ms - p.SB * bs)))
    Ls = dk.chol_batched(SC[None])  # (1, Ms, Ms)

    # rhs_s = gs - sum_k place(WU^T y)
    v = jnp.einsum("kms,km->ks", WU, y, preferred_element_type=WU.dtype, precision=HI)
    vb = v.reshape(p.K * p.sB, bs)
    redv = grouped_segsum_last(vb.T, p.scr_grp)  # (bs, Fr)
    redvp = jnp.concatenate([redv, jnp.zeros((bs, 1), vb.dtype)], -1)
    vsub = redvp[:, p.scr_inv_map].T.reshape(-1)[: p.SB * bs]
    rhs_s = gs - jnp.pad(vsub, (0, p.Ms - p.SB * bs))
    return L, WU, y, Ls, rhs_s


def _solve_with(p: V3Plan, L, WU, Ls, gk_fine, gs_fine):
    """Solve for a new fine rhs given the cached factorization.

    gk_fine: (n+1, bs) scaled rhs in fine layout."""
    bs = p.bs
    gk = gk_fine[p.gk_idx].reshape(p.K, p.mB * bs)
    gk = jnp.pad(gk, ((0, 0), (0, p.M - p.mB * bs)))
    gs = gk_fine[p.gs_idx].reshape(-1)[: p.SB * bs]
    gs = jnp.pad(gs, (0, p.Ms - p.SB * bs))

    Bg = jnp.pad(gk[..., None], ((0, 0), (0, 0), (0, 7)))
    y = dk.trsm_lower_batched(L, Bg)[:, :, 0]  # (K, M)

    from slampp_tpu.ops.segments import grouped_segsum_last

    v = jnp.einsum("kms,km->ks", WU, y, preferred_element_type=WU.dtype, precision=HI)
    vb = v.reshape(p.K * p.sB, bs)
    redv = grouped_segsum_last(vb.T, p.scr_grp)
    redvp = jnp.concatenate([redv, jnp.zeros((bs, 1), vb.dtype)], -1)
    vsub = redvp[:, p.scr_inv_map].T.reshape(-1)[: p.SB * bs]
    rhs_s = gs - jnp.pad(vsub, (0, p.Ms - p.SB * bs))
    return _backsolve(p, L, WU, Ls, y, rhs_s)


def _backsolve(p: V3Plan, L, WU, Ls, y, rhs_s):
    bs = p.bs
    rs = jnp.pad(rhs_s[None, :, None], ((0, 0), (0, 0), (0, 7)))
    zs = dk.trsm_lower_batched(Ls, rs)
    xs = dk.trsm_lower_t_batched(Ls, zs)[0, :, 0]  # (Ms,)
    xs_blocks = jnp.concatenate(
        [xs[: p.SB * bs].reshape(max(p.SB, 1) if p.SB else 1, -1)[: p.SB], jnp.zeros((1, bs), xs.dtype)], 0
    ) if p.SB else jnp.zeros((1, bs), xs.dtype)
    xsb = xs_blocks[p.xs_idx].reshape(p.K, p.S)
    t = y - jnp.einsum("kms,ks->km", WU, xsb, preferred_element_type=WU.dtype, precision=HI)
    tb = jnp.pad(t[..., None], ((0, 0), (0, 0), (0, 7)))
    xk = dk.trsm_lower_t_batched(L, tb)[:, :, 0]  # (K, M)

    x_int = xk[:, : p.mB * bs].reshape(p.K * p.mB, bs)
    xs_all = xs[: p.SB * bs].reshape(-1, bs) if p.SB else jnp.zeros((0, bs), xs.dtype)
    x_rows = jnp.concatenate([x_int, xs_all], 0)
    return x_rows[p.sol_gather]  # (n, bs) permuted fine solution


def _spmv_fine(p: V3Plan, vals, x):
    """y = A x on fine blocks (lower + diag stored); x: (n, bs)."""
    from slampp_tpu.ops.segments import grouped_segsum_last

    n = p.n
    t1 = jnp.einsum("sij,sj->si", vals[: p.nnzb], x[p.cols], precision=HI)
    t2 = jnp.einsum("sji,sj->si", vals[n : p.nnzb], x[p.rows[n:]], precision=HI)
    terms = jnp.concatenate([t1, t2], 0)  # (T, bs) unpermuted
    return grouped_segsum_last(terms.T, p.mv_grp).T


def _v3_solve_refined(p: V3Plan, vals64, b64, refine: int, damping_rel: float,
                      mixed: bool = True, sc_prior=None, gs_prior=None):
    """Partitioned solve: equilibrated f32 + f64 refinement (``mixed``) or
    exact f64 end-to-end (``mixed=False`` — matches the dense oracle to
    ~1e-8 including the near-singular gauge mode, which the f32 path leaves
    inexact; that mode is invisible to chi2/ATE, see tests/test_partitioned).

    vals64: (nnzb+1, bs, bs) fine lambda blocks; b64: (n+1, bs).

    ``sc_prior`` (Ms, Ms) / ``gs_prior`` (Ms,) add to the separator system /
    rhs in the b64 sign convention (un-equilibrated; scaled here).  The f64
    refinement models the prior term: the full-system residual subtracts
    ``S^T (sc_prior x_sep - gs_prior)`` at the separator rows (round-4
    advisor/VERDICT item — refinement and the prior are no longer mutually
    exclusive).
    """
    bs = p.bs
    n = p.n
    if not mixed:
        vals_f = vals64[: p.nnzb]
        b_f = jnp.concatenate([b64[:n], jnp.zeros((1, bs), b64.dtype)], 0)
        L, WU, y, Ls, rhs_s = _factor32(p, vals_f, b_f, sc_prior, gs_prior)
        return _backsolve(p, L, WU, Ls, y, rhs_s)
    d = jnp.arange(bs)
    diag_entries = vals64[:n, d, d]  # (n, bs)
    s = 1.0 / jnp.sqrt(jnp.maximum(diag_entries, 1e-30))
    srow = s[p.rows]
    scol = s[p.cols]
    vs = vals64[: p.nnzb] * srow[:, :, None] * scol[:, None, :]
    vs = vs.at[jnp.arange(n)[:, None, None], d[None, :, None], d[None, None, :]].add(
        jnp.where(d[:, None] == d[None, :], damping_rel, 0.0)[None]
    )
    vals32 = vs.astype(jnp.float32)
    b_s = (s * b64[:n]).astype(jnp.float32)
    b32 = jnp.concatenate([b_s, jnp.zeros((1, bs), jnp.float32)], 0)

    scp = gsp = None
    if sc_prior is not None:
        # equilibrate the prior with the separator rows' scale factors
        sp = s[p.gs_idx].reshape(-1)[: p.SB * bs]
        sp = jnp.concatenate(
            [sp, jnp.ones(p.Ms - p.SB * bs, s.dtype)]
        )
        scp = (sp[:, None] * sc_prior * sp[None, :]).astype(jnp.float32)
        if gs_prior is not None:
            gsp = (sp * gs_prior).astype(jnp.float32)
    elif gs_prior is not None:
        raise ValueError("gs_prior requires sc_prior")

    if p.ch_ok:
        levels, root_inv, Uflat, Xu, Xg, Ls, rhs_s = _chain_factor32(
            p, vals32, b32, scp, gsp
        )
        z = _chain_backsolve(p, Xu, Xg, Ls, rhs_s)
    else:
        L, WU, y, Ls, rhs_s = _factor32(p, vals32, b32, scp, gsp)
        z = _backsolve(p, L, WU, Ls, y, rhs_s)
    x = s * z.astype(jnp.float64)

    for _ in range(refine):
        r = b64[:n] - _spmv_fine(p, vals64, x)
        if sc_prior is not None:
            # full system is (A + S sc S^T) x = b + S gs: subtract the
            # prior's contribution at the separator rows (f64,
            # un-equilibrated — sc_prior/gs_prior come in raw)
            xs = x[p.gs_idx].reshape(-1)[: p.SB * bs]
            xs = jnp.concatenate(
                [xs, jnp.zeros(p.Ms - p.SB * bs, x.dtype)]
            )
            pr = sc_prior.astype(x.dtype) @ xs
            if gs_prior is not None:
                pr = pr - gs_prior.astype(x.dtype)
            r = r.at[p.gs_idx].add(-pr[: p.SB * bs].reshape(p.SB, bs))
        rs = (s * r).astype(jnp.float32)
        rs1 = jnp.concatenate([rs, jnp.zeros((1, bs), jnp.float32)], 0)
        if p.ch_ok:
            z = _chain_solve_with(p, levels, root_inv, Uflat, Xu, Ls, rs1)
        else:
            z = _solve_with(p, L, WU, Ls, rs1, None)
        x = x + s * z.astype(jnp.float64)
    return x


def _v3_gn_step_impl(graph: GraphArrays, bp, p: V3Plan, refine: int,
                     damping_rel: float, mixed: bool = True):
    # mixed mode assembles the Hessian blocks directly in f32; rhs/chi2 stay
    # f64 so the GN fixed point is unchanged.  _v3_solve_refined handles f32 inputs transparently.
    vals, rhs, chi2 = block_assembly.assemble_blocks_sorted(
        graph, bp, hessian_f32=mixed
    )
    x = _v3_solve_refined(p, vals, -rhs, refine, damping_rel, mixed)
    dx = block_assembly.scatter_dx(bp, x, bp.bs)
    dx_norm = jnp.linalg.norm(dx)
    new_states = apply_update(graph, dx)
    return new_states, dx_norm, chi2


_step_cache: Dict = {}

_plan_serial_counter = [0]


def _plan_key(bp) -> int:
    """Stable cache key for a BlockPlan: a unique serial stamped at first
    use.  ``id()`` is NOT stable — a freed plan's address can be reused by a
    later plan, which would return a compiled closure over stale geometry
    (advisor round-4 finding on the windowed-incremental v3 path)."""
    k = getattr(bp, "_serial", None)
    if k is None:
        _plan_serial_counter[0] += 1
        k = _plan_serial_counter[0]
        object.__setattr__(bp, "_serial", k)
    return k


def _v3_gn_step(graph, bp, p, refine: int, damping_rel: float, mixed: bool = True):
    key = ("v3", _plan_key(bp), refine, damping_rel, mixed)
    fn = _step_cache.get(key)
    if fn is None:
        fn = jax.jit(lambda g: _v3_gn_step_impl(g, bp, p, refine, damping_rel, mixed))
        _step_cache[key] = fn
    return fn(graph)


def _v3_fused(graph, bp, p, n_iters: int, refine: int, damping_rel: float,
              mixed: bool = True):
    key = ("v3fused", _plan_key(bp), n_iters, refine, damping_rel, mixed)
    fn = _step_cache.get(key)
    if fn is None:

        def impl(g):
            # scan over iterations: ONE step is traced/compiled instead of
            # n_iters copies (the unrolled build compiled 5 programs' worth
            # of HLO -> minutes of XLA time)
            def body(carry, _):
                gc = g.replace_states(carry)
                states, dxn, chi2 = _v3_gn_step_impl(gc, bp, p, refine, damping_rel, mixed)
                return states, (dxn, chi2)

            states, (dxns, chi2s) = jax.lax.scan(
                body, g.states, None, length=n_iters
            )
            from slampp_tpu.core.assembly import graph_chi2

            return states, dxns[-1], chi2s[0], graph_chi2(g.replace_states(states))

        fn = jax.jit(impl)
        _step_cache[key] = fn
    return fn(graph)
