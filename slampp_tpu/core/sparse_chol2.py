"""Scatter-free level-windowed block Cholesky (the v2 engine).

The v1 engine (core/sparse_chol.py) spends its time in scatter-adds, which
serialize on conflicting indices.  v2 eliminates every scatter from the numeric
phase by construction:

  * block columns are renumbered so each elimination-tree level occupies a
    CONTIGUOUS range (legal: same-level columns are mutually independent);
  * diagonal blocks live in their own (n, P, P) array indexed by column;
    off-diagonal L slots are grouped by level, sorted by (column, row);
  * per level, all writes are `dynamic_update_slice` on contiguous windows;
  * conflicting update contributions are reduced with SORTED segment sums
    computed as differences of a prefix sum (cumsum), not scatter-adds;
  * reads remain gathers.

The same schedule drives the forward/backward triangular solves.  Host
planning lives in :func:`plan_v2`; the device functions are
:func:`factorize2` and :func:`solve2` plus the mixed-precision
:func:`solve_refined2` (equilibration + clamped f32 factor + f64 iterative
refinement, as in v1).

Reference parity: this is still the reference's blockwise Cholesky
(BlockMatrix.cpp:9547) — re-architected a second time around scatter-free
device memory access.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from slampp_tpu.core import symbolic
from slampp_tpu.ops import small_blocks


class PlanV2(NamedTuple):
    # static sizes
    n: int  # block columns
    n_off: int  # off-diagonal L slots
    n_levels: int
    max_cols: int  # max columns per level
    max_off: int  # max off-diag slots per level
    max_ud: int  # max diag-dst update sources per level
    max_uo: int  # max offd-dst update sources per level
    max_fw: int  # max forward-solve sources per level
    # host outputs for the caller
    col_order: np.ndarray  # (n,) level-contiguous column renumbering (old->?); see plan_v2
    slot_of: dict  # (i, j) -> packed slot id (diag j -> j; offd -> n + k)
    diag_slot: np.ndarray  # (n,) = arange(n)
    rows: np.ndarray  # (n + n_off,) block row of each packed slot
    cols: np.ndarray  # (n + n_off,) block col
    # device arrays (all int32)
    lvl_col_start: jnp.ndarray  # (n_levels,)
    lvl_ncols: jnp.ndarray  # (n_levels,)
    lvl_off_start: jnp.ndarray  # (n_levels,)
    lvl_noff: jnp.ndarray  # (n_levels,)
    # update sources, diag-dst (sorted by dst col) and offd-dst (sorted by dst slot)
    ud_a: jnp.ndarray  # (n_levels, max_ud) offd slot of L[i,k] (LOCAL offd id)
    ud_b: jnp.ndarray  # (n_levels, max_ud) offd slot of L[j,k]
    ud_starts: jnp.ndarray  # (n_levels, max_cols) segment starts into cumsum
    ud_ends: jnp.ndarray  # (n_levels, max_cols)
    uo_a: jnp.ndarray  # (n_levels, max_uo)
    uo_b: jnp.ndarray  # (n_levels, max_uo)
    uo_starts: jnp.ndarray  # (n_levels, max_off)
    uo_ends: jnp.ndarray  # (n_levels, max_off)
    # offd solve info: local column position of each offd slot within its level
    off_colpos: jnp.ndarray  # (n_levels, max_off)
    # forward solve: sources grouped by dst column
    fw_slot: jnp.ndarray  # (n_levels, max_fw) offd slot (local id)
    fw_src: jnp.ndarray  # (n_levels, max_fw) source block column k
    fw_starts: jnp.ndarray  # (n_levels, max_cols)
    fw_ends: jnp.ndarray  # (n_levels, max_cols)
    # backward solve: this level's offd slots give (row i) sources; segments
    # by column are the same boundaries as uo-style grouping of offd slots
    bw_row: jnp.ndarray  # (n_levels, max_off) block row i of each offd slot
    bw_starts: jnp.ndarray  # (n_levels, max_cols) segment starts into offd-local cumsum
    bw_ends: jnp.ndarray  # (n_levels, max_cols)


# pytree registration: device index arrays are LEAVES (so plans pass as jit
# arguments rather than closure constants); ints and host-only payloads
# (col_order, slot_of, rows, cols, diag_slot) are static aux.
_V2_STATIC = (
    "n", "n_off", "n_levels", "max_cols", "max_off", "max_ud", "max_uo", "max_fw",
)
_V2_HOST = ("col_order", "slot_of", "diag_slot", "rows", "cols")


def _v2_flatten(p: "PlanV2"):
    from slampp_tpu.utils.pytree import Static

    leaves = tuple(
        getattr(p, f) for f in PlanV2._fields if f not in _V2_STATIC + _V2_HOST
    )
    aux = (
        tuple(getattr(p, f) for f in _V2_STATIC),
        Static(tuple(getattr(p, f) for f in _V2_HOST)),
    )
    return leaves, aux


def _v2_unflatten(aux, leaves):
    statics, host = aux
    kw = dict(zip(_V2_STATIC, statics))
    kw.update(zip(_V2_HOST, host.v))
    kw.update(
        zip([f for f in PlanV2._fields if f not in _V2_STATIC + _V2_HOST], leaves)
    )
    return PlanV2(**kw)


jax.tree_util.register_pytree_node(PlanV2, _v2_flatten, _v2_unflatten)


def _pad_rows(rows: List[np.ndarray], width: int, fill: int) -> np.ndarray:
    out = np.full((len(rows), width), fill, np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def plan_v2(n: int, pairs: Sequence[Tuple[int, int]]) -> PlanV2:
    """Build the v2 plan.  ``pairs`` are off-diagonal block pairs in the
    PERMUTED (post-ordering) numbering; plan_v2 further renumbers columns so
    levels are contiguous and returns that refinement in ``col_order``
    (col_order[new] = old position)."""
    pattern, parent, level = symbolic.analyze(n, pairs)
    n_levels = int(level.max()) + 1 if n else 1

    # level-contiguous renumbering (stable within level)
    order = sorted(range(n), key=lambda j: (level[j], j))  # new -> old
    new_of = np.empty(n, np.int64)
    for newj, oldj in enumerate(order):
        new_of[oldj] = newj
    # re-express pattern in new numbering
    pat_new: List[set] = [set() for _ in range(n)]
    for j in range(n):
        pat_new[new_of[j]] = {int(new_of[i]) for i in pattern[j]}
    level_new = np.zeros(n, np.int64)
    for j in range(n):
        level_new[new_of[j]] = level[j]

    cols_by_level: List[List[int]] = [[] for _ in range(n_levels)]
    for j in range(n):
        cols_by_level[int(level_new[j])].append(j)
    for lv in range(n_levels):
        cols_by_level[lv].sort()
        # contiguity invariant
        cl = cols_by_level[lv]
        assert not cl or cl[-1] - cl[0] == len(cl) - 1

    # off-diagonal slots grouped by level, sorted by (col, row)
    slot_of = {}
    rows_l: List[int] = []
    cols_l: List[int] = []
    off_start = np.zeros(n_levels, np.int64)
    off_count = np.zeros(n_levels, np.int64)
    off_id = 0
    for lv in range(n_levels):
        off_start[lv] = off_id
        for j in cols_by_level[lv]:
            slot_of[(j, j)] = j
            for i in sorted(pat_new[j]):
                slot_of[(i, j)] = n + off_id
                rows_l.append(i)
                cols_l.append(j)
                off_id += 1
        off_count[lv] = off_id - off_start[lv]
    n_off = off_id
    col_start = np.array([cols_by_level[lv][0] if cols_by_level[lv] else n for lv in range(n_levels)], np.int64)
    ncols = np.array([len(cols_by_level[lv]) for lv in range(n_levels)], np.int64)

    # ---- update triples grouped by level(dst col), split diag/offd dst.
    # For column k: for j in pattern(k), for i in pattern(k) with i >= j:
    #   dst (i, j), sources L[i,k], L[j,k]  (both offd slots of column k)
    ud_by_level: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_levels)]  # (dstcol, a, b)
    uo_by_level: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_levels)]  # (dstslot, a, b)
    for k in range(n):
        pk = sorted(pat_new[k])
        for ji, j in enumerate(pk):
            lv = int(level_new[j])
            sb = slot_of[(j, k)] - n
            for i in pk[ji:]:
                sa = slot_of[(i, k)] - n
                if i == j:
                    ud_by_level[lv].append((j, sa, sb))
                else:
                    uo_by_level[lv].append((slot_of[(i, j)] - n, sa, sb))

    ud_a_rows, ud_b_rows, ud_st_rows, ud_en_rows = [], [], [], []
    uo_a_rows, uo_b_rows, uo_st_rows, uo_en_rows = [], [], [], []
    for lv in range(n_levels):
        # diag-dst: segment per column in level (by local col position)
        ud = sorted(ud_by_level[lv])
        ud_a_rows.append(np.array([a for _, a, _ in ud], np.int64))
        ud_b_rows.append(np.array([b for _, _, b in ud], np.int64))
        st = np.zeros(int(ncols[lv]), np.int64)
        en = np.zeros(int(ncols[lv]), np.int64)
        pos = 0
        for ci in range(int(ncols[lv])):
            col = int(col_start[lv]) + ci
            st[ci] = pos
            while pos < len(ud) and ud[pos][0] == col:
                pos += 1
            en[ci] = pos
        ud_st_rows.append(st)
        ud_en_rows.append(en)
        # offd-dst: segment per offd slot in level (slots already sorted)
        uo = sorted(uo_by_level[lv])
        uo_a_rows.append(np.array([a for _, a, _ in uo], np.int64))
        uo_b_rows.append(np.array([b for _, _, b in uo], np.int64))
        st2 = np.zeros(int(off_count[lv]), np.int64)
        en2 = np.zeros(int(off_count[lv]), np.int64)
        pos = 0
        for si in range(int(off_count[lv])):
            slot = int(off_start[lv]) + si
            st2[si] = pos
            while pos < len(uo) and uo[pos][0] == slot:
                pos += 1
            en2[si] = pos
        uo_st_rows.append(st2)
        uo_en_rows.append(en2)

    # offd local column positions (for TRSM Lj gather)
    off_colpos_rows = []
    bw_row_rows = []
    bw_st_rows, bw_en_rows = [], []
    for lv in range(n_levels):
        cp = []
        br = []
        for si in range(int(off_count[lv])):
            gid = int(off_start[lv]) + si
            j = cols_l[gid]
            i = rows_l[gid]
            cp.append(j - int(col_start[lv]))
            br.append(i)
        off_colpos_rows.append(np.array(cp, np.int64))
        bw_row_rows.append(np.array(br, np.int64))
        # backward segments: offd slots sorted by col -> boundaries per column
        st = np.zeros(int(ncols[lv]), np.int64)
        en = np.zeros(int(ncols[lv]), np.int64)
        pos = 0
        for ci in range(int(ncols[lv])):
            col = int(col_start[lv]) + ci
            st[ci] = pos
            while pos < len(cp) and cp[pos] == ci:
                pos += 1
            en[ci] = pos
        bw_st_rows.append(st)
        bw_en_rows.append(en)

    # forward solve: entries (i, k) grouped by level(i), sorted by i
    fw_by_level: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_levels)]
    for k in range(n):
        for i in pat_new[k]:
            fw_by_level[int(level_new[i])].append((i, slot_of[(i, k)] - n, k))
    fw_slot_rows, fw_src_rows, fw_st_rows, fw_en_rows = [], [], [], []
    for lv in range(n_levels):
        fw = sorted(fw_by_level[lv])
        fw_slot_rows.append(np.array([s for _, s, _ in fw], np.int64))
        fw_src_rows.append(np.array([k for _, _, k in fw], np.int64))
        st = np.zeros(int(ncols[lv]), np.int64)
        en = np.zeros(int(ncols[lv]), np.int64)
        pos = 0
        for ci in range(int(ncols[lv])):
            col = int(col_start[lv]) + ci
            st[ci] = pos
            while pos < len(fw) and fw[pos][0] == col:
                pos += 1
            en[ci] = pos
        fw_st_rows.append(st)
        fw_en_rows.append(en)

    max_cols = max(1, int(ncols.max()) if n else 1)
    max_off = max(1, int(off_count.max()) if n_levels else 1)
    max_ud = max(1, max((len(r) for r in ud_a_rows), default=1))
    max_uo = max(1, max((len(r) for r in uo_a_rows), default=1))
    max_fw = max(1, max((len(r) for r in fw_slot_rows), default=1))

    rows_arr = np.concatenate([np.arange(n), np.asarray(rows_l, np.int64)]) if n_off else np.arange(n)
    cols_arr = np.concatenate([np.arange(n), np.asarray(cols_l, np.int64)]) if n_off else np.arange(n)

    def dev(a, width, fill):
        return jnp.asarray(_pad_rows(a, width, fill), jnp.int32)

    return PlanV2(
        n=n,
        n_off=n_off,
        n_levels=n_levels,
        max_cols=max_cols,
        max_off=max_off,
        max_ud=max_ud,
        max_uo=max_uo,
        max_fw=max_fw,
        col_order=np.asarray(order, np.int64),
        slot_of=slot_of,
        diag_slot=np.arange(n, dtype=np.int64),
        rows=rows_arr,
        cols=cols_arr,
        lvl_col_start=jnp.asarray(col_start, jnp.int32),
        lvl_ncols=jnp.asarray(ncols, jnp.int32),
        lvl_off_start=jnp.asarray(off_start, jnp.int32),
        lvl_noff=jnp.asarray(off_count, jnp.int32),
        ud_a=dev(ud_a_rows, max_ud, n_off),
        ud_b=dev(ud_b_rows, max_ud, n_off),
        ud_starts=dev(ud_st_rows, max_cols, 0),
        ud_ends=dev(ud_en_rows, max_cols, 0),
        uo_a=dev(uo_a_rows, max_uo, n_off),
        uo_b=dev(uo_b_rows, max_uo, n_off),
        uo_starts=dev(uo_st_rows, max_off, 0),
        uo_ends=dev(uo_en_rows, max_off, 0),
        off_colpos=dev(off_colpos_rows, max_off, 0),
        fw_slot=dev(fw_slot_rows, max_fw, n_off),
        fw_src=dev(fw_src_rows, max_fw, n),
        fw_starts=dev(fw_st_rows, max_cols, 0),
        fw_ends=dev(fw_en_rows, max_cols, 0),
        bw_row=dev(bw_row_rows, max_off, n),
        bw_starts=dev(bw_st_rows, max_cols, 0),
        bw_ends=dev(bw_en_rows, max_cols, 0),
    )


def _segsum(cum0, starts, ends):
    """Segment sums from an exclusive prefix sum: cum0 has a leading zero
    row; sums[s] = cum0[ends[s]] - cum0[starts[s]] (empty segments -> 0)."""
    return cum0[ends] - cum0[starts]


HI = lax.Precision.HIGHEST


def factorize2(plan: PlanV2, Dvals: jnp.ndarray, OffVals: jnp.ndarray, clamp: float = 0.0):
    """Numeric factorization; inputs are the assembled lambda blocks
    (Dvals (n, P, P) lower-triangular diagonal panels; OffVals
    (n_off, P, P)).  Returns (Ld, Loff) in the same layout."""
    P = Dvals.shape[-1]
    eye = jnp.eye(P, dtype=Dvals.dtype)
    # pad for window overhang + dummy gathers
    Dp = jnp.concatenate([Dvals, jnp.broadcast_to(eye, (plan.max_cols, P, P))], 0)
    Op = jnp.concatenate([OffVals, jnp.zeros((plan.max_off + 1, P, P), Dvals.dtype)], 0)

    def step(carry, idx):
        Dp, Op = carry
        (cs, nc, os_, no, ud_a, ud_b, ud_st, ud_en, uo_a, uo_b, uo_st, uo_en, colpos) = idx
        # --- updates with diag destinations
        a = Op[ud_a]
        b = Op[ud_b]
        upd = jnp.einsum("eij,ekj->eik", a, b, precision=HI)
        cum0 = jnp.concatenate([jnp.zeros((1, P, P), upd.dtype), jnp.cumsum(upd, 0)], 0)
        dsub = _segsum(cum0, ud_st, ud_en)  # (max_cols, P, P)
        winD = lax.dynamic_slice(Dp, (cs, jnp.int32(0), jnp.int32(0)), (plan.max_cols, P, P)) - dsub
        # --- updates with offd destinations
        a2 = Op[uo_a]
        b2 = Op[uo_b]
        upd2 = jnp.einsum("eij,ekj->eik", a2, b2, precision=HI)
        cum20 = jnp.concatenate([jnp.zeros((1, P, P), upd2.dtype), jnp.cumsum(upd2, 0)], 0)
        osub = _segsum(cum20, uo_st, uo_en)  # (max_off, P, P)
        winO = lax.dynamic_slice(Op, (os_, jnp.int32(0), jnp.int32(0)), (plan.max_off, P, P)) - osub
        # --- factor the level's diagonal panels (batched, clamped)
        colmask = (jnp.arange(plan.max_cols) < nc)[:, None, None]
        winD_q = jnp.where(colmask, winD, eye[None])
        Lj = small_blocks.cholesky_blocked(winD_q, clamp=clamp)
        Lj_write = jnp.where(
            colmask, Lj, lax.dynamic_slice(Dp, (cs, jnp.int32(0), jnp.int32(0)), (plan.max_cols, P, P))
        )
        Dp = lax.dynamic_update_slice(Dp, Lj_write, (cs, jnp.int32(0), jnp.int32(0)))
        # --- column solves for the level's offd slots (gather each slot's Lj)
        offmask = (jnp.arange(plan.max_off) < no)[:, None, None]
        Ljg = jnp.where(colmask, Lj, eye[None])[colpos]
        X = small_blocks.solve_triangular_right_transpose_blocked(winO, Ljg)
        X = jnp.where(offmask, X, lax.dynamic_slice(Op, (os_, jnp.int32(0), jnp.int32(0)), (plan.max_off, P, P)))
        Op = lax.dynamic_update_slice(Op, X, (os_, jnp.int32(0), jnp.int32(0)))
        return (Dp, Op), None

    (Dp, Op), _ = lax.scan(
        step,
        (Dp, Op),
        (
            plan.lvl_col_start,
            plan.lvl_ncols,
            plan.lvl_off_start,
            plan.lvl_noff,
            plan.ud_a,
            plan.ud_b,
            plan.ud_starts,
            plan.ud_ends,
            plan.uo_a,
            plan.uo_b,
            plan.uo_starts,
            plan.uo_ends,
            plan.off_colpos,
        ),
    )
    return Dp[: plan.n], Op[: plan.n_off]


def solve2(plan: PlanV2, Ld: jnp.ndarray, Loff: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L L^T x = b with factorize2 output; b: (n, P)."""
    P = b.shape[-1]
    eye = jnp.eye(P, dtype=Ld.dtype)
    Dp = jnp.concatenate([Ld, jnp.broadcast_to(eye, (plan.max_cols, P, P))], 0)
    Op = jnp.concatenate([Loff, jnp.zeros((plan.max_off + 1, P, P), Ld.dtype)], 0)
    y = jnp.concatenate([b, jnp.zeros((plan.max_cols, P), b.dtype)], 0)

    def fwd(y, idx):
        cs, nc, fw_slot, fw_src, fw_st, fw_en = idx
        contrib = jnp.einsum("eij,ej->ei", Op[fw_slot], y[fw_src], precision=HI)
        cum0 = jnp.concatenate([jnp.zeros((1, P), contrib.dtype), jnp.cumsum(contrib, 0)], 0)
        sub = _segsum(cum0, fw_st, fw_en)  # (max_cols, P)
        win = lax.dynamic_slice(y, (cs, jnp.int32(0)), (plan.max_cols, P)) - sub
        colmask = (jnp.arange(plan.max_cols) < nc)[:, None]
        Lw = lax.dynamic_slice(Dp, (cs, jnp.int32(0), jnp.int32(0)), (plan.max_cols, P, P))
        Lw_q = jnp.where(colmask[:, :, None], Lw, eye[None])
        yj = small_blocks.solve_lower_blocked(Lw_q, win)
        yj = jnp.where(colmask, yj, lax.dynamic_slice(y, (cs, jnp.int32(0)), (plan.max_cols, P)))
        return lax.dynamic_update_slice(y, yj, (cs, jnp.int32(0))), None

    y, _ = lax.scan(
        fwd,
        y,
        (
            plan.lvl_col_start,
            plan.lvl_ncols,
            plan.fw_slot,
            plan.fw_src,
            plan.fw_starts,
            plan.fw_ends,
        ),
    )

    x = y

    def bwd(x, idx):
        cs, nc, os_, no, bw_row, bw_st, bw_en = idx
        # contributions L[i,j]^T x_i for this level's offd slots
        offmask = (jnp.arange(plan.max_off) < no)[:, None]
        Ow = lax.dynamic_slice(Op, (os_, jnp.int32(0), jnp.int32(0)), (plan.max_off, P, P))
        contrib = jnp.einsum("eji,ej->ei", Ow, x[bw_row], precision=HI)
        contrib = jnp.where(offmask, contrib, 0.0)
        cum0 = jnp.concatenate([jnp.zeros((1, P), contrib.dtype), jnp.cumsum(contrib, 0)], 0)
        sub = _segsum(cum0, bw_st, bw_en)
        win = lax.dynamic_slice(x, (cs, jnp.int32(0)), (plan.max_cols, P)) - sub
        colmask = (jnp.arange(plan.max_cols) < nc)[:, None]
        Lw = lax.dynamic_slice(Dp, (cs, jnp.int32(0), jnp.int32(0)), (plan.max_cols, P, P))
        Lw_q = jnp.where(colmask[:, :, None], Lw, eye[None])
        xj = small_blocks.solve_lower_transpose_blocked(Lw_q, win)
        xj = jnp.where(colmask, xj, lax.dynamic_slice(x, (cs, jnp.int32(0)), (plan.max_cols, P)))
        return lax.dynamic_update_slice(x, xj, (cs, jnp.int32(0))), None

    rev = lambda a: jnp.flip(a, 0)
    x, _ = lax.scan(
        bwd,
        x,
        (
            rev(plan.lvl_col_start),
            rev(plan.lvl_ncols),
            rev(plan.lvl_off_start),
            rev(plan.lvl_noff),
            rev(plan.bw_row),
            rev(plan.bw_starts),
            rev(plan.bw_ends),
        ),
    )
    return x[: plan.n]


def spmv2(plan: PlanV2, Dvals, OffVals, x):
    """y = A x on the packed v2 layout (symmetric; lower stored)."""
    P = x.shape[-1]
    Dlow = jnp.tril(Dvals, -1)
    Dsym = Dlow + jnp.swapaxes(Dlow, 1, 2) + jnp.eye(P, dtype=Dvals.dtype) * Dvals
    y = jnp.einsum("nij,nj->ni", Dsym, x, precision=HI)
    r = plan.rows[plan.n :]
    c = plan.cols[plan.n :]
    rj = jnp.asarray(r, jnp.int32)
    cj = jnp.asarray(c, jnp.int32)
    y = y.at[rj].add(jnp.einsum("eij,ej->ei", OffVals, x[cj], precision=HI))
    y = y.at[cj].add(jnp.einsum("eji,ej->ei", OffVals, x[rj], precision=HI))
    return y


def solve_refined2(
    plan: PlanV2,
    Dvals64,
    OffVals64,
    b64,
    refine_iters: int = 1,
    damping_rel: float = 1e-6,
):
    """Mixed-precision v2 solve (equilibrate -> clamped f32 factor -> f64
    refinement); mirrors core/sparse_chol.solve_refined."""
    P = Dvals64.shape[-1]
    d = jnp.arange(P)
    diag_entries = Dvals64[:, d, d]
    s = 1.0 / jnp.sqrt(jnp.maximum(diag_entries, 1e-30))
    rj = jnp.asarray(plan.rows[plan.n :], jnp.int32)
    cj = jnp.asarray(plan.cols[plan.n :], jnp.int32)
    Dscaled = Dvals64 * s[:, :, None] * s[:, None, :]
    Oscaled = OffVals64 * s[rj][:, :, None] * s[cj][:, None, :]
    Dscaled = Dscaled.at[:, d, d].add(damping_rel)
    Ld, Lo = factorize2(plan, Dscaled.astype(jnp.float32), Oscaled.astype(jnp.float32), clamp=1e-8)

    def solve32(r64):
        z = solve2(plan, Ld, Lo, (s * r64).astype(jnp.float32))
        return s * z.astype(jnp.float64)

    x = solve32(b64)
    for _ in range(refine_iters):
        r = b64 - spmv2(plan, Dvals64, OffVals64, x)
        x = x + solve32(r)
    return x
