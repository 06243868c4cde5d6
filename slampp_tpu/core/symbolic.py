"""Host-side symbolic block Cholesky: elimination tree, fill pattern, level
schedule, and the scan-padded index plans consumed by the device kernels.

This is the device-program replacement for the reference's symbolic machinery
(``Build_EliminationTree`` src/slam/BlockMatrix.cpp:9403 and the pattern
analysis inside ``CholeskyOf`` :9547): all pointer-chasing happens here, once
per graph structure, producing fixed-shape integer arrays; the numeric
factorization (core/sparse_chol.py) is then a data-independent jitted program
(SURVEY.md §7 design inversion).

Block convention: uniform block size; lower-triangular factor L in
block-CSC order (columns ascending, rows ascending inside a column, diagonal
first).  ``slot`` = index into the packed (nnzb, bs, bs) value array.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CholeskyPlan:
    """Everything the device factorization/solve kernels need (all NumPy)."""

    n: int  # number of block columns
    nnzb: int  # nonzero blocks in L (incl. diagonal)
    # slot lookup for scattering A into L: (i, j) -> slot (i >= j)
    rows: np.ndarray  # (nnzb,) block-row of each slot
    cols: np.ndarray  # (nnzb,) block-col of each slot
    diag_slot: np.ndarray  # (n,) slot of (j, j)
    n_levels: int
    # --- factorization schedule (per level, padded) ---
    # update triples: L[(i,j)] -= L[(i,k)] @ L[(j,k)]^T
    upd_dst: np.ndarray  # (n_levels, max_upd) slot of (i,j); nnzb = padding
    upd_a: np.ndarray  # (n_levels, max_upd) slot of (i,k)
    upd_b: np.ndarray  # (n_levels, max_upd) slot of (j,k)
    # diagonal factor + column solve
    lvl_diag: np.ndarray  # (n_levels, max_cols) diag slots; nnzb = padding
    lvl_offd: np.ndarray  # (n_levels, max_offd) off-diag slots; nnzb = padding
    lvl_offd_diag: np.ndarray  # (n_levels, max_offd) the diag slot of that column
    # --- forward solve schedule (per level, padded) ---
    fwd_slot: np.ndarray  # (n_levels, max_row) slot of (j,k), k < j
    fwd_src: np.ndarray  # (n_levels, max_row) block col k (y source); n = padding
    fwd_dst: np.ndarray  # (n_levels, max_row) block row j (y target); n = padding
    lvl_cols: np.ndarray  # (n_levels, max_cols) block columns in level; n = padding
    # --- backward solve schedule (per reverse level, padded) ---
    bwd_slot: np.ndarray  # (n_levels, max_col_ent) slot of (i,j), i > j
    bwd_src: np.ndarray  # (n_levels, max_col_ent) block row i (x source)
    bwd_dst: np.ndarray  # (n_levels, max_col_ent) block col j (x target)
    # host-only: (i, j) -> slot lookup (i >= j), for building block routings
    slot_of: dict = dataclasses.field(default_factory=dict, repr=False)


def _pad2(rows: List[np.ndarray], fill: int) -> np.ndarray:
    m = max((len(r) for r in rows), default=0)
    m = max(m, 1)
    out = np.full((len(rows), m), fill, np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def analyze(n: int, pairs: Sequence[Tuple[int, int]]):
    """Core symbolic analysis shared by the plan builders: fill pattern,
    elimination tree, and tree levels for a block pattern of off-diagonal
    pairs on n columns.  Returns (pattern: List[set], parent, level)."""
    lower: List[set] = [set() for _ in range(n)]
    for i, j in pairs:
        if i == j:
            continue
        a, b = (int(i), int(j)) if i > j else (int(j), int(i))
        lower[b].add(a)

    # symbolic factorization via row-merge (left-looking symbolic):
    # pattern[j] = A-pattern[j] ∪ (∪_{children c} pattern[c] \ {c});
    # parent[j] = min(pattern[j])
    pattern: List[set] = [set(lower[j]) for j in range(n)]
    parent = np.full(n, -1, np.int64)
    children: List[List[int]] = [[] for _ in range(n)]
    for j in range(n):
        for c in children[j]:
            pattern[j].update(x for x in pattern[c] if x > j)
        if pattern[j]:
            p = min(pattern[j])
            parent[j] = p
            children[p].append(j)
    level = np.zeros(n, np.int64)
    for j in range(n):  # children have smaller indices than parents
        for c in children[j]:
            level[j] = max(level[j], level[c] + 1)
    return pattern, parent, level


def symbolic_cholesky(n: int, pairs: Sequence[Tuple[int, int]]) -> CholeskyPlan:
    """Symbolic factorization of a block pattern given by off-diagonal block
    pairs (i, j) (unordered) on n block columns.

    Returns the full :class:`CholeskyPlan` with fill, elimination-tree level
    schedule, and padded per-level index arrays.
    """
    pattern, parent, _level_arr = analyze(n, pairs)
    children: List[List[int]] = [[] for _ in range(n)]
    for j in range(n):
        if parent[j] >= 0:
            children[parent[j]].append(j)

    # slots: block-CSC with diagonal first in each column
    rows_list: List[int] = []
    cols_list: List[int] = []
    slot_of: Dict[Tuple[int, int], int] = {}
    for j in range(n):
        slot_of[(j, j)] = len(rows_list)
        rows_list.append(j)
        cols_list.append(j)
        for i in sorted(pattern[j]):
            slot_of[(i, j)] = len(rows_list)
            rows_list.append(i)
            cols_list.append(j)
    nnzb = len(rows_list)
    rows = np.asarray(rows_list, np.int64)
    cols = np.asarray(cols_list, np.int64)
    diag_slot = np.asarray([slot_of[(j, j)] for j in range(n)], np.int64)

    # etree levels (leaves = 0)
    level = np.zeros(n, np.int64)
    for j in range(n):  # children have smaller indices than parents in etree
        for c in children[j]:
            level[j] = max(level[j], level[c] + 1)
    n_levels = int(level.max()) + 1 if n else 1

    # ---- factorization schedule
    upd_dst: List[List[int]] = [[] for _ in range(n_levels)]
    upd_a: List[List[int]] = [[] for _ in range(n_levels)]
    upd_b: List[List[int]] = [[] for _ in range(n_levels)]
    for k in range(n):
        pk = sorted(pattern[k])  # rows > k in column k
        for a_i, j in enumerate(pk):
            lv = int(level[j])
            # diagonal update of (j, j) and off-diagonal (i, j) for i > j
            for i in pk[a_i:]:
                upd_dst[lv].append(slot_of[(i, j)])
                upd_a[lv].append(slot_of[(i, k)])
                upd_b[lv].append(slot_of[(j, k)])
    # sort each level's triples by destination slot: sorted scatter indices
    # let XLA lower cheaper scatter-adds (indices_are_sorted)
    for lv in range(n_levels):
        if upd_dst[lv]:
            perm = np.argsort(np.asarray(upd_dst[lv]), kind="stable")
            upd_dst[lv] = [upd_dst[lv][i] for i in perm]
            upd_a[lv] = [upd_a[lv][i] for i in perm]
            upd_b[lv] = [upd_b[lv][i] for i in perm]

    lvl_cols: List[np.ndarray] = []
    lvl_diag: List[np.ndarray] = []
    lvl_offd: List[List[int]] = [[] for _ in range(n_levels)]
    lvl_offd_diag: List[List[int]] = [[] for _ in range(n_levels)]
    cols_by_level: List[List[int]] = [[] for _ in range(n_levels)]
    for j in range(n):
        lv = int(level[j])
        cols_by_level[lv].append(j)
        for i in sorted(pattern[j]):
            lvl_offd[lv].append(slot_of[(i, j)])
            lvl_offd_diag[lv].append(slot_of[(j, j)])
    for lv in range(n_levels):
        lvl_cols.append(np.asarray(cols_by_level[lv], np.int64))
        lvl_diag.append(diag_slot[np.asarray(cols_by_level[lv], np.int64)])

    # ---- forward solve schedule: per level of j, entries (j, k) k < j
    fwd_slot: List[List[int]] = [[] for _ in range(n_levels)]
    fwd_src: List[List[int]] = [[] for _ in range(n_levels)]
    fwd_dst: List[List[int]] = [[] for _ in range(n_levels)]
    for k in range(n):
        for i in pattern[k]:  # L[i,k], i > k: contributes to y_i from y_k
            lv = int(level[i])
            fwd_slot[lv].append(slot_of[(i, k)])
            fwd_src[lv].append(k)
            fwd_dst[lv].append(i)

    # ---- backward solve schedule: per level of j, entries (i, j) i > j
    bwd_slot: List[List[int]] = [[] for _ in range(n_levels)]
    bwd_src: List[List[int]] = [[] for _ in range(n_levels)]
    bwd_dst: List[List[int]] = [[] for _ in range(n_levels)]
    for j in range(n):
        lv = int(level[j])
        for i in pattern[j]:
            bwd_slot[lv].append(slot_of[(i, j)])
            bwd_src[lv].append(i)
            bwd_dst[lv].append(j)

    return CholeskyPlan(
        n=n,
        nnzb=nnzb,
        rows=rows,
        cols=cols,
        diag_slot=diag_slot,
        n_levels=n_levels,
        upd_dst=_pad2([np.asarray(x) for x in upd_dst], nnzb),
        upd_a=_pad2([np.asarray(x) for x in upd_a], nnzb),
        upd_b=_pad2([np.asarray(x) for x in upd_b], nnzb),
        lvl_diag=_pad2(lvl_diag, nnzb),
        lvl_offd=_pad2([np.asarray(x) for x in lvl_offd], nnzb),
        lvl_offd_diag=_pad2([np.asarray(x) for x in lvl_offd_diag], nnzb),
        fwd_slot=_pad2([np.asarray(x) for x in fwd_slot], nnzb),
        fwd_src=_pad2([np.asarray(x) for x in fwd_src], n),
        fwd_dst=_pad2([np.asarray(x) for x in fwd_dst], n),
        lvl_cols=_pad2(lvl_cols, n),
        bwd_slot=_pad2([np.asarray(x) for x in bwd_slot], nnzb),
        bwd_src=_pad2([np.asarray(x) for x in bwd_src], n),
        bwd_dst=_pad2([np.asarray(x) for x in bwd_dst], n),
        slot_of=slot_of,
    )
