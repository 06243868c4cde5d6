"""Block-level lambda assembly: edge contributions -> packed L-slot values.

This is the direct analog of the reference's matrix reduction plan
(``CMatrixReductionPlan``, NonlinearSolver_Lambda_Base.h:524): each edge's
per-slot-pair Hessian block is routed to a precomputed destination (slot,
row-offset, col-offset) in the packed panel array (with a transpose flag when
the permuted order swaps the pair), and conflicting contributions are reduced
by scatter-add.  The host builds the routing once per graph structure
(:func:`build_block_plan`); the device function (:func:`assemble_blocks`) is
shape-static and jit-friendly.

Panel (supernodal) mode: ``panel`` consecutive permuted block-columns are
amalgamated into one P x P panel (P = panel * bs).  The factorization then
runs on the much shallower panel elimination tree with matmul-sized dense
blocks — the device replacement for the reference's supernodal backends
(CHOLMOD) and the key to cutting sequential level count (SURVEY.md §7 hard
part 1).  ``panel=1`` reduces to plain block granularity.

Uniform fine block size is required — mixed-size problems (BA, 2D landmarks)
eliminate the landmark types via the Schur solver first, exactly like the
reference's BA pipeline (SURVEY.md §3.3), leaving a uniform reduced system.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from jax import lax as _lax

from slampp_tpu.core.assembly import _edge_residual_and_jacobians
from slampp_tpu.graph.system import GraphArrays, GraphSystem
from slampp_tpu.graph.types import get_edge_type, get_vertex_type


_HI = _lax.Precision.HIGHEST


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class EdgeRouting:
    """Per-edge-type device index arrays (host-built)."""

    # diagonal contributions: slot + within-panel scalar offset, per slot
    diag_slots: jnp.ndarray  # (E, arity)
    diag_offs: jnp.ndarray  # (E, arity)
    # RHS: panel row + within-panel scalar offset
    rhs_rows: jnp.ndarray  # (E, arity)
    rhs_offs: jnp.ndarray  # (E, arity)
    # off-diagonal pair contributions
    pair_slots: jnp.ndarray  # (E, n_pairs)
    pair_roffs: jnp.ndarray  # (E, n_pairs)
    pair_coffs: jnp.ndarray  # (E, n_pairs)
    pair_transpose: jnp.ndarray  # (E, n_pairs) bool
    pairs: Tuple  # ((a, b), ...) slot-index pairs, a < b

    def tree_flatten(self):
        return (
            self.diag_slots, self.diag_offs, self.rhs_rows, self.rhs_offs,
            self.pair_slots, self.pair_roffs, self.pair_coffs, self.pair_transpose,
        ), (self.pairs,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BlockPlan:
    """Routing for one (graph structure, ordering, panel size)."""

    n: int  # panel columns
    bs: int  # fine block size
    P: int  # panel scalar size = panel * bs
    nnzb: int  # panel slots in L
    routing: Dict[str, EdgeRouting]
    anchor_diag_slot: int  # panel diag slot of the unary anchor (or nnzb)
    anchor_off: int
    anchor_dim: int
    unary_information: float
    # (n, P) global scalar offset per panel scalar (state_dim = dummy)
    dx_offsets: jnp.ndarray
    state_dim: int
    # (n,) diag slot per panel + (n, P) 1.0 where the panel scalar is unused
    panel_diag_slots: jnp.ndarray
    panel_diag_reg: jnp.ndarray
    # ---- sorted (scatter-free) assembly routing; see assemble_blocks_sorted.
    # GROUPED padded-gather reduction plans over the concatenated per-type
    # contribution terms (ops/segments.py — measured far cheaper to compile
    # and faster to run than the earlier prefix-sum formulation), and the
    # inverse maps that place reduced fine blocks into the packed panel grid.
    type_order: Tuple = ()
    asm_grp: Optional[object] = None  # GroupedSegments over T terms -> F
    asm_inv_map: Optional[jnp.ndarray] = None  # (nnzb*pn*pn,) in [0..F]
    rhs_grp: Optional[object] = None  # GroupedSegments over Tr terms -> Fr
    rhs_inv_map: Optional[jnp.ndarray] = None  # (n*pn,) in [0..Fr]

    def tree_flatten(self):
        keys = sorted(self.routing.keys())
        children = (
            [self.routing[k] for k in keys],
            self.dx_offsets,
            self.panel_diag_slots,
            self.panel_diag_reg,
            self.asm_grp, self.asm_inv_map,
            self.rhs_grp, self.rhs_inv_map,
        )
        aux = (
            tuple(keys), self.n, self.bs, self.P, self.nnzb,
            self.anchor_diag_slot, self.anchor_off, self.anchor_dim,
            self.unary_information, self.state_dim, self.type_order,
        )
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        keys, n, bs, P, nnzb, ads, ao, ad, ui, sd, torder = aux
        routing = dict(zip(keys, children[0]))
        return cls(
            n=n, bs=bs, P=P, nnzb=nnzb, routing=routing,
            anchor_diag_slot=ads, anchor_off=ao, anchor_dim=ad,
            unary_information=ui,
            dx_offsets=children[1], state_dim=sd,
            panel_diag_slots=children[2], panel_diag_reg=children[3],
            type_order=torder,
            asm_grp=children[4], asm_inv_map=children[5],
            rhs_grp=children[6], rhs_inv_map=children[7],
        )


def build_block_plan(
    system: GraphSystem,
    slot_of: Dict[Tuple[int, int], int],
    diag_slot: np.ndarray,
    nnzb: int,
    inv_order: np.ndarray,
    block_of_vid: Dict[int, int],
    panel: int = 1,
    edge_mask: Optional[Dict[str, np.ndarray]] = None,
) -> BlockPlan:
    """Build edge->(slot, offsets) routing given the PANEL-granularity
    symbolic factor's slot table.

    ``edge_mask`` (per-type boolean arrays) routes masked-OUT edges'
    contributions to the dummy slot — used to assemble SUBGRAPH systems
    (e.g. the SPCG spanning-tree preconditioner, linear/spcg.py) from the
    same GraphArrays without touching the numeric phase.

    ``block_of_vid`` maps vertex dataset id -> original fine block index;
    ``inv_order`` maps original fine block -> permuted fine position; the
    permuted fine position p maps to panel ``p // panel`` at within-offset
    ``(p % panel) * bs``.
    """
    offsets, total = system._layout()
    vt_names = {t for t, _ in system.vertex_index.values()}
    dims = {get_vertex_type(t).dim for t in vt_names}
    if len(dims) != 1:
        raise ValueError(f"uniform block size required, got dims {dims}")
    bs = dims.pop()
    P = panel * bs
    n_fine = len(block_of_vid)
    n_panels = (n_fine + panel - 1) // panel

    def loc(vid):
        """vertex id -> (panel, within scalar offset) in permuted coords."""
        p = int(inv_order[block_of_vid[vid]])
        return p // panel, (p % panel) * bs

    # fine-granularity destinations for the sorted (scatter-free) assembly:
    # one entry per contribution term, encoded fi*NF + fj (fi >= fj), in the
    # exact order the device concatenates terms (type, then diag a, then
    # pair k, each an (E,) chunk).  SENT marks dropped terms (const vertices).
    NF = n_panels * panel
    SENT = NF * NF + 1
    fine_dests: list = []
    rhs_dests: list = []

    routing: Dict[str, EdgeRouting] = {}
    for tname in system.edge_type_names:
        et = get_edge_type(tname)
        rec = system._edges[tname]
        E = len(rec["vids"])
        arity = et.arity
        pairs = tuple((a, b) for a in range(arity) for b in range(a + 1, arity))
        dslots = np.full((E, arity), nnzb, np.int64)
        doffs = np.zeros((E, arity), np.int64)
        rrows = np.full((E, arity), n_panels, np.int64)
        roffs = np.zeros((E, arity), np.int64)
        pslots = np.full((E, len(pairs)), nnzb, np.int64)
        proffs = np.zeros((E, len(pairs)), np.int64)
        pcoffs = np.zeros((E, len(pairs)), np.int64)
        ptrans = np.zeros((E, len(pairs)), bool)
        fd_diag = np.full((E, arity), SENT, np.int64)
        fd_pair = np.full((E, len(pairs)), SENT, np.int64)
        fd_rhs = np.full((E, arity), NF, np.int64)
        mask_t = edge_mask.get(tname) if edge_mask is not None else None
        for e, vids in enumerate(rec["vids"]):
            if mask_t is not None and not mask_t[e]:
                continue  # dropped edge: every destination stays at dummy
            locs = []
            for s, vid in enumerate(vids):
                if vid in block_of_vid:
                    pan, w = loc(vid)
                    locs.append((pan, w))
                    dslots[e, s] = diag_slot[pan]
                    doffs[e, s] = w
                    rrows[e, s] = pan
                    roffs[e, s] = w
                    pf = pan * panel + w // bs  # fine permuted index
                    fd_diag[e, s] = pf * NF + pf
                    fd_rhs[e, s] = pf
                else:
                    locs.append(None)  # const vertex
            for k, (a, b) in enumerate(pairs):
                if locs[a] is not None and locs[b] is not None:
                    (pa_, wa_), (pb_, wb_) = locs[a], locs[b]
                    fa = pa_ * panel + wa_ // bs
                    fb = pb_ * panel + wb_ // bs
                    fine_i, fine_j = max(fa, fb), min(fa, fb)
                    fd_pair[e, k] = fine_i * NF + fine_j
                if locs[a] is None or locs[b] is None:
                    continue
                (pa, wa), (pb, wb) = locs[a], locs[b]
                if pa == pb:
                    # within one diagonal panel: store in the LOWER triangle
                    # (the unrolled panel Cholesky reads only the lower part)
                    if wa >= wb:
                        pslots[e, k] = diag_slot[pa]
                        proffs[e, k], pcoffs[e, k] = wa, wb
                        ptrans[e, k] = False
                    else:
                        pslots[e, k] = diag_slot[pa]
                        proffs[e, k], pcoffs[e, k] = wb, wa
                        ptrans[e, k] = True
                elif pa > pb:
                    pslots[e, k] = slot_of[(pa, pb)]
                    proffs[e, k], pcoffs[e, k] = wa, wb
                    ptrans[e, k] = False
                else:
                    pslots[e, k] = slot_of[(pb, pa)]
                    proffs[e, k], pcoffs[e, k] = wb, wa
                    ptrans[e, k] = True
        routing[tname] = EdgeRouting(
            diag_slots=jnp.asarray(dslots, jnp.int32),
            diag_offs=jnp.asarray(doffs, jnp.int32),
            rhs_rows=jnp.asarray(rrows, jnp.int32),
            rhs_offs=jnp.asarray(roffs, jnp.int32),
            pair_slots=jnp.asarray(pslots, jnp.int32),
            pair_roffs=jnp.asarray(proffs, jnp.int32),
            pair_coffs=jnp.asarray(pcoffs, jnp.int32),
            pair_transpose=jnp.asarray(ptrans),
            pairs=pairs,
        )
        for a in range(arity):
            fine_dests.append(fd_diag[:, a])
        for k in range(len(pairs)):
            fine_dests.append(fd_pair[:, k])
        for a in range(arity):
            rhs_dests.append(fd_rhs[:, a])

    anchor = system._unary_anchor
    if anchor is not None and anchor in block_of_vid:
        pan, w = loc(anchor)
        anchor_slot, anchor_off = int(diag_slot[pan]), int(w)
    else:
        anchor_slot, anchor_off = nnzb, 0
    anchor_dim = bs

    # un-permutation of the solution + unused-scalar regularization mask
    order = np.empty_like(inv_order)
    order[inv_order] = np.arange(len(inv_order))
    vid_of_block = {b: v for v, b in block_of_vid.items()}
    dx_off = np.full((n_panels, P), total, np.int64)
    reg = np.ones((n_panels, P))
    for p in range(n_fine):
        pan, w = p // panel, (p % panel) * bs
        vid = vid_of_block[int(order[p])]
        o = offsets[vid]
        dx_off[pan, w : w + bs] = o + np.arange(bs)
        reg[pan, w : w + bs] = 0.0

    # ---- sorted (scatter-free) assembly plan: sort contribution terms by
    # fine destination, reduce with prefix-sum segment differences, place the
    # reduced blocks into panel cells with ONE gather (the same construction
    # the v2 factor engine uses; no scatter touches the numeric phase).
    dests_all = (
        np.concatenate(fine_dests) if fine_dests else np.zeros(0, np.int64)
    )
    asm_order = np.argsort(dests_all, kind="stable")
    sorted_d = dests_all[asm_order]
    n_kept = int(np.searchsorted(sorted_d, SENT))
    uniq, starts = np.unique(sorted_d[:n_kept], return_index=True)
    ends = np.concatenate([starts[1:], [n_kept]]).astype(np.int64) if len(uniq) else np.zeros(0, np.int64)
    F = len(uniq)
    # slot -> (i, j) panel coordinates (invert slot_of; diag slots from table)
    ij_of = {int(s_): (int(i_), int(j_)) for (i_, j_), s_ in slot_of.items()}
    for pan_ in range(n_panels):
        ij_of.setdefault(int(diag_slot[pan_]), (pan_, pan_))
    slot_i = np.empty(nnzb, np.int64)
    slot_j = np.empty(nnzb, np.int64)
    for s_ in range(nnzb):
        slot_i[s_], slot_j[s_] = ij_of[s_]
    br_ = np.arange(panel, dtype=np.int64)
    fi_grid = slot_i[:, None, None] * panel + br_[None, :, None]
    fj_grid = slot_j[:, None, None] * panel + br_[None, None, :]
    fid = (fi_grid * NF + fj_grid).ravel()
    if F:
        pos = np.minimum(np.searchsorted(uniq, fid), F - 1)
        inv_map = np.where(uniq[pos] == fid, pos, F)
    else:
        inv_map = np.full(fid.shape, F, np.int64)
    # rhs: same construction over (bs,) vectors keyed by fine row
    rdests_all = (
        np.concatenate(rhs_dests) if rhs_dests else np.zeros(0, np.int64)
    )
    r_order = np.argsort(rdests_all, kind="stable")
    sorted_r = rdests_all[r_order]
    n_kept_r = int(np.searchsorted(sorted_r, NF))
    uniq_r, starts_r = np.unique(sorted_r[:n_kept_r], return_index=True)
    ends_r = np.concatenate([starts_r[1:], [n_kept_r]]).astype(np.int64) if len(uniq_r) else np.zeros(0, np.int64)
    Fr = len(uniq_r)
    rid = np.arange(n_panels * panel, dtype=np.int64)
    if Fr:
        posr = np.minimum(np.searchsorted(uniq_r, rid), Fr - 1)
        rhs_inv_map = np.where(uniq_r[posr] == rid, posr, Fr)
    else:
        rhs_inv_map = np.full(rid.shape, Fr, np.int64)

    return BlockPlan(
        n=n_panels,
        bs=bs,
        P=P,
        nnzb=nnzb,
        routing=routing,
        anchor_diag_slot=anchor_slot,
        anchor_off=anchor_off,
        anchor_dim=anchor_dim,
        unary_information=system.unary_information,
        dx_offsets=jnp.asarray(dx_off, jnp.int32),
        state_dim=total,
        panel_diag_slots=jnp.asarray(diag_slot, jnp.int32),
        panel_diag_reg=jnp.asarray(reg),
        type_order=tuple(system.edge_type_names),
        asm_grp=_remapped_group_plan(starts, ends, asm_order),
        asm_inv_map=jnp.asarray(inv_map, jnp.int32),
        rhs_grp=_remapped_group_plan(starts_r, ends_r, r_order),
        rhs_inv_map=jnp.asarray(rhs_inv_map, jnp.int32),
    )


def _remapped_group_plan(starts, ends, order):
    """Grouped-segment plan whose index rows point DIRECTLY at the
    unpermuted term array: segment [starts, ends) positions in the sorted
    order are remapped through ``order`` (dummy -> T) ON THE HOST, so no
    device buckets are read back."""
    from slampp_tpu.ops.segments import plan_grouped_segments

    T = len(order)
    order_pad = np.concatenate([np.asarray(order, np.int64), [T]])
    return plan_grouped_segments(starts, ends, T, remap=order_pad)


def assemble_blocks(graph: GraphArrays, bp: BlockPlan):
    """Device: (vals (nnzb+1, P, P), rhs (n+1, P), chi2) — the packed
    lower-triangular lambda in the permuted panel structure, plus g and chi2.
    The +1 rows are scatter dummies (dropped by the caller via slicing)."""
    bs, P = bp.bs, bp.P
    dtype = graph.states[next(iter(graph.states))].dtype
    vals = jnp.zeros((bp.nnzb + 1, P, P), dtype)
    rhs = jnp.zeros((bp.n + 1, P), dtype)
    chi2 = jnp.zeros((), dtype)
    br = jnp.arange(bs)

    for name, ea in graph.edges.items():
        et = get_edge_type(name)
        rt = bp.routing[name]
        vts = tuple(get_vertex_type(t) for t in et.vertex_types)
        slot_states = tuple(
            graph.states[et.vertex_types[s]][ea.local_idx[:, s]] for s in range(et.arity)
        )
        r, jacs = jax.vmap(lambda *a: _edge_residual_and_jacobians(et, vts, a[:-1], a[-1]))(
            *slot_states, ea.meas
        )
        if et.robust_weight_fn is not None:
            w = jax.vmap(et.robust_weight_fn)(r, ea.sigma_inv)
            W = ea.sigma_inv * w[:, None, None]
        else:
            W = ea.sigma_inv
        chi2 = chi2 + jnp.sum(
            jnp.where(ea.valid, jnp.einsum("ei,eij,ej->e", r, ea.sigma_inv, r), 0.0)
        )
        WJ = tuple(jnp.einsum("eij,ejk->eik", W, jacs[b], precision=_HI) for b in range(et.arity))
        mask3 = ea.valid[:, None, None]
        mask2 = ea.valid[:, None]
        for a in range(et.arity):
            Haa = jnp.where(mask3, jnp.einsum("eij,eik->ejk", jacs[a], WJ[a], precision=_HI), 0.0)
            rr = rt.diag_offs[:, a, None] + br[None, :]
            vals = vals.at[
                rt.diag_slots[:, a, None, None], rr[:, :, None], rr[:, None, :]
            ].add(Haa)
            ga = jnp.where(mask2, jnp.einsum("eij,ei->ej", WJ[a], r, precision=_HI), 0.0)
            ro = rt.rhs_offs[:, a, None] + br[None, :]
            rhs = rhs.at[rt.rhs_rows[:, a, None], ro].add(ga)
        for k, (a, b) in enumerate(rt.pairs):
            Hab = jnp.einsum("eij,eik->ejk", jacs[a], WJ[b], precision=_HI)
            Hab = jnp.where(
                rt.pair_transpose[:, k][:, None, None], jnp.swapaxes(Hab, 1, 2), Hab
            )
            Hab = jnp.where(mask3, Hab, 0.0)
            rr = rt.pair_roffs[:, k, None] + br[None, :]
            cc = rt.pair_coffs[:, k, None] + br[None, :]
            vals = vals.at[
                rt.pair_slots[:, k, None, None], rr[:, :, None], cc[:, None, :]
            ].add(Hab)

    if bp.anchor_diag_slot < bp.nnzb:
        idx = bp.anchor_off + jnp.arange(bp.anchor_dim)
        vals = vals.at[bp.anchor_diag_slot, idx, idx].add(bp.unary_information)

    # unit-regularize unused scalars in partial panels so the panel Cholesky
    # stays SPD (their dx components solve to 0 and are dropped)
    dd = jnp.arange(P)
    vals = vals.at[bp.panel_diag_slots[:, None], dd[None, :], dd[None, :]].add(
        bp.panel_diag_reg
    )
    return vals, rhs, chi2


def _edge_type_terms(graph: GraphArrays, bp: BlockPlan, name: str,
                     hessian_f32: bool = False):
    """Shared per-type computation: per-edge Hessian contribution blocks in
    the canonical term order (diag a=0..arity-1, then pair k=0..), the RHS
    contribution vectors (one per slot), and the chi2 contribution.

    ``hessian_f32``: evaluate the Jacobians and Hessian blocks in f32 (the
    mixed-precision path; its speed against f64 is unmeasured on the GPU)
    while keeping the residual, RHS and chi2 in f64.  The Gauss-Newton FIXED POINT
    is set by the f64 RHS (g = 0 at the optimum regardless of H precision),
    so the converged chi2 is unchanged; only the transient step directions
    carry f32 error, absorbed by the iteration itself."""
    ea = graph.edges[name]
    et = get_edge_type(name)
    rt = bp.routing[name]
    vts = tuple(get_vertex_type(t) for t in et.vertex_types)
    slot_states = tuple(
        graph.states[et.vertex_types[s]][ea.local_idx[:, s]] for s in range(et.arity)
    )
    r, jacs = jax.vmap(lambda *a: _edge_residual_and_jacobians(et, vts, a[:-1], a[-1]))(
        *slot_states, ea.meas
    )
    if et.robust_weight_fn is not None:
        w = jax.vmap(et.robust_weight_fn)(r, ea.sigma_inv)
        W = ea.sigma_inv * w[:, None, None]
    else:
        W = ea.sigma_inv
    chi2 = jnp.sum(
        jnp.where(ea.valid, jnp.einsum("ei,eij,ej->e", r, ea.sigma_inv, r), 0.0)
    )
    if hessian_f32:
        # f32 Jacobian evaluation (the heavy autodiff path), f64 residual
        slot32 = tuple(s.astype(jnp.float32) for s in slot_states)
        _, jacs = jax.vmap(
            lambda *a: _edge_residual_and_jacobians(et, vts, a[:-1], a[-1])
        )(*slot32, ea.meas.astype(jnp.float32))
        W = W.astype(jnp.float32)
    WJ = tuple(jnp.einsum("eij,ejk->eik", W, jacs[b], precision=_HI) for b in range(et.arity))
    mask3 = ea.valid[:, None, None]
    mask2 = ea.valid[:, None]
    hblocks = []
    gvecs = []
    for a in range(et.arity):
        hblocks.append(jnp.where(mask3, jnp.einsum("eij,eik->ejk", jacs[a], WJ[a], precision=_HI), 0.0))
        # RHS stays f64: f32 WJ x f64 r promotes to an f64 contraction
        gvecs.append(jnp.where(mask2, jnp.einsum("eij,ei->ej", WJ[a], r, precision=_HI), 0.0))
    for k, (a, b) in enumerate(rt.pairs):
        Hab = jnp.einsum("eij,eik->ejk", jacs[a], WJ[b], precision=_HI)
        Hab = jnp.where(
            rt.pair_transpose[:, k][:, None, None], jnp.swapaxes(Hab, 1, 2), Hab
        )
        hblocks.append(jnp.where(mask3, Hab, 0.0))
    return hblocks, gvecs, chi2


def assemble_blocks_sorted(graph: GraphArrays, bp: BlockPlan,
                           hessian_f32: bool = False):
    """Scatter-free lambda assembly: identical contract to
    :func:`assemble_blocks` but conflicting contributions are reduced with
    host-sorted prefix-sum segment differences and placed into the packed
    panel array by a single gather: conflict-free grouped reductions in
    place of scatter-adds — the reduction-plan analog (CMatrixReductionPlan,
    NonlinearSolver_Lambda_Base.h:524).

    With ``hessian_f32`` the packed blocks come back in f32 (see
    _edge_type_terms) while rhs and chi2 stay f64."""
    bs, P = bp.bs, bp.P
    pn = P // bs
    dtype = graph.states[next(iter(graph.states))].dtype
    chi2 = jnp.zeros((), dtype)
    hchunks = []
    rchunks = []
    for name in bp.type_order:
        hb, gv, c2 = _edge_type_terms(graph, bp, name, hessian_f32)
        hchunks.extend(hb)
        rchunks.extend(gv)
        chi2 = chi2 + c2

    from slampp_tpu.ops.segments import grouped_segsum_last

    G = jnp.concatenate(hchunks, 0)  # (T, bs, bs) unpermuted term order
    hdt = G.dtype
    # batch-LAST (bs*bs, T) layout: the long axis is the minor one (a
    # tiled-layout choice, unmeasured on the GPU; ROADMAP re-decide list)
    Gl = G.reshape(G.shape[0], bs * bs).T
    red = grouped_segsum_last(Gl, bp.asm_grp)  # (bs*bs, F)
    redp = jnp.concatenate(
        [red, jnp.zeros((bs * bs, 1), hdt)], -1
    )
    vals = (
        redp[:, bp.asm_inv_map]
        .reshape(bs, bs, bp.nnzb, pn, pn)
        .transpose(2, 3, 0, 4, 1)
        .reshape(bp.nnzb, P, P)
    )
    vals = jnp.concatenate([vals, jnp.zeros((1, P, P), hdt)], 0)

    Gr = jnp.concatenate(rchunks, 0).T  # (bs, Tr)
    red_r = grouped_segsum_last(Gr, bp.rhs_grp)  # (bs, Fr)
    red_rp = jnp.concatenate([red_r, jnp.zeros((bs, 1), Gr.dtype)], -1)
    rhs = red_rp[:, bp.rhs_inv_map].T.reshape(bp.n, P)
    rhs = jnp.concatenate([rhs, jnp.zeros((1, P), dtype)], 0)

    if bp.anchor_diag_slot < bp.nnzb:
        idx = bp.anchor_off + jnp.arange(bp.anchor_dim)
        vals = vals.at[bp.anchor_diag_slot, idx, idx].add(
            jnp.asarray(bp.unary_information, hdt)
        )

    dd = jnp.arange(P)
    vals = vals.at[bp.panel_diag_slots[:, None], dd[None, :], dd[None, :]].add(
        bp.panel_diag_reg.astype(hdt)
    )
    return vals, rhs, chi2


def scatter_dx(bp: BlockPlan, x: jnp.ndarray, dmax: int) -> jnp.ndarray:
    """Un-permute the panel solution (n, P) into the global dx vector."""
    dx = jnp.zeros((bp.state_dim + max(dmax, bp.P)), x.dtype)
    dx = dx.at[bp.dx_offsets].set(x)
    return dx[: bp.state_dim]
