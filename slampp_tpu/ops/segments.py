"""Grouped (padded-gather) segment reductions.

The host lays segments out as (groups, cap) index maps — bucketed by
segment size so padding stays < 2x — and the device does gather + sum.
This replaced a prefix-sum ("cumsum + boundary gather") formulation whose
f64 compile time grew badly at Venice scale.  Which of the two is faster on
the GPU is not measured (ROADMAP re-decide list).

Reference analog: the reduction-plan concept (CMatrixReductionPlan,
include/slam/NonlinearSolver_Lambda_Base.h:524) — precomputed routing of
conflicting contributions, reduced in parallel.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp


class RangeBucket(NamedTuple):
    """Size-class bucket with LAZY index rows: the padded gather indices are
    computed on device as ``starts[:, None] + iota`` masked to the dummy row
    — nothing O(sum caps) is ever materialized on the host or uploaded.
    Only valid for un-remapped plans (contiguous segments)."""

    seg_ids: jnp.ndarray   # (G,)
    starts: jnp.ndarray    # (G,)
    sizes: jnp.ndarray     # (G,)
    cap: int


def _range_idx(b: RangeBucket, m: int) -> jnp.ndarray:
    iota = jnp.arange(b.cap, dtype=b.starts.dtype)
    return jnp.where(
        iota[None, :] < b.sizes[:, None], b.starts[:, None] + iota[None, :], m
    )


class GroupBucket(NamedTuple):
    seg_ids: jnp.ndarray  # (G,) int32 segment index per group row
    idx: jnp.ndarray  # (G, cap) int32 element indices (m = dummy/pad)


class GroupedSegments(NamedTuple):
    """Bucketed padded-group layout of sorted segments."""

    m: int  # total elements (dummy row at index m)
    n_seg: int
    buckets: Tuple[GroupBucket, ...]


def plan_grouped_segments(
    starts: np.ndarray, ends: np.ndarray, m: int, bucket_base: int = 4,
    min_cap: int = 4, remap: np.ndarray = None, materialize: bool = True,
) -> GroupedSegments:
    """Host planner: segment [starts[g], ends[g]) -> padded index rows.

    Segments are bucketed by size class (powers of ``bucket_base``) so the
    padding waste is bounded by ``bucket_base``x; empty segments are skipped
    (their reduction is zero via the dummy row).

    ``remap`` (length m+1, entry m = the target dummy) relabels index rows
    ON THE HOST before upload.  Callers must NOT remap by reading the
    device buckets back: each np.asarray on a device array is a full
    device->host transfer.

    ``materialize=False`` (only without remap) emits :class:`RangeBucket`s:
    the padded index rows are generated on DEVICE from (starts, sizes) —
    O(#segments) host work and upload instead of O(sum padded caps).
    """
    if not materialize and remap is not None:
        raise ValueError("materialize=False requires remap=None")
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    n_seg = len(starts)
    sizes = ends - starts
    if remap is not None:
        remap = np.asarray(remap, np.int64)
    buckets: List[GroupBucket] = []
    cap = min_cap
    remaining = np.flatnonzero(sizes > 0)
    while len(remaining):
        in_b = remaining[sizes[remaining] <= cap]
        remaining = remaining[sizes[remaining] > cap]
        if len(in_b):
            G = len(in_b)
            if not materialize:
                buckets.append(
                    RangeBucket(
                        seg_ids=jnp.asarray(in_b, jnp.int32),
                        starts=jnp.asarray(starts[in_b], jnp.int32),
                        sizes=jnp.asarray(sizes[in_b], jnp.int32),
                        cap=cap,
                    )
                )
                cap *= bucket_base
                continue
            idx = np.full((G, cap), m, np.int64)
            # vectorized fill: row r covers [starts, starts+cap), masked
            rng = np.arange(cap)[None, :]
            cand = starts[in_b][:, None] + rng
            mask = rng < sizes[in_b][:, None]
            idx[mask] = cand[mask]
            if remap is not None:
                idx = remap[idx]
            buckets.append(
                GroupBucket(
                    seg_ids=jnp.asarray(in_b, jnp.int32),
                    idx=jnp.asarray(idx, jnp.int32),
                )
            )
        cap *= bucket_base
    return GroupedSegments(m=m, n_seg=n_seg, buckets=tuple(buckets))


# register as pytrees so plans pass as jit arguments
jax.tree_util.register_pytree_node(
    GroupBucket, lambda b: ((b.seg_ids, b.idx), None),
    lambda aux, c: GroupBucket(*c),
)
jax.tree_util.register_pytree_node(
    RangeBucket,
    lambda b: ((b.seg_ids, b.starts, b.sizes), b.cap),
    lambda aux, c: RangeBucket(c[0], c[1], c[2], aux),
)
jax.tree_util.register_pytree_node(
    GroupedSegments,
    lambda p: ((p.buckets,), (p.m, p.n_seg)),
    lambda aux, c: GroupedSegments(m=aux[0], n_seg=aux[1], buckets=c[0]),
)


def grouped_segsum_last(data: jnp.ndarray, plan: GroupedSegments,
                        max_chunk: int = 4_000_000) -> jnp.ndarray:
    """Segment sums over the LAST axis: data (..., m) -> (..., n_seg).

    ``data`` need not carry the dummy column; it is appended here.  Buckets
    whose gather exceeds ``max_chunk`` elements (per leading-dim row) are
    processed in slices via lax.map to bound peak memory.
    """
    lead = data.shape[:-1]
    dp = jnp.concatenate(
        [data, jnp.zeros(lead + (1,), data.dtype)], -1
    )
    out = jnp.zeros(lead + (plan.n_seg + 1,), data.dtype)
    for b in plan.buckets:
        if isinstance(b, RangeBucket):
            b = GroupBucket(seg_ids=b.seg_ids, idx=_range_idx(b, plan.m))
        G, cap = b.idx.shape
        rows_per_chunk = max(1, max_chunk // max(cap, 1))
        if G > rows_per_chunk:
            C = (G + rows_per_chunk - 1) // rows_per_chunk
            padG = C * rows_per_chunk - G
            idx = jnp.concatenate(
                [b.idx, jnp.full((padG, cap), plan.m, b.idx.dtype)], 0
            ).reshape(C, rows_per_chunk, cap)

            red = jax.lax.map(
                lambda ix: jnp.sum(
                    dp[..., ix.reshape(-1)].reshape(lead + (rows_per_chunk, cap)),
                    -1,
                ),
                idx,
            )  # (C, ..., rows_per_chunk)
            red = jnp.moveaxis(red, 0, -2).reshape(lead + (C * rows_per_chunk,))[
                ..., :G
            ]
        else:
            red = jnp.sum(
                dp[..., b.idx.reshape(-1)].reshape(lead + (G, cap)), -1
            )
        out = out.at[..., b.seg_ids].set(red)
    return out[..., :-1]


def grouped_segsum_first(data: jnp.ndarray, plan: GroupedSegments,
                         max_chunk: int = 4_000_000) -> jnp.ndarray:
    """Segment sums over the FIRST axis: data (m, ...) -> (n_seg, ...)."""
    trail = data.shape[1:]
    dp = jnp.concatenate([data, jnp.zeros((1,) + trail, data.dtype)], 0)
    out = jnp.zeros((plan.n_seg + 1,) + trail, data.dtype)
    for b in plan.buckets:
        if isinstance(b, RangeBucket):
            b = GroupBucket(seg_ids=b.seg_ids, idx=_range_idx(b, plan.m))
        G, cap = b.idx.shape
        rows_per_chunk = max(1, max_chunk // max(cap, 1))
        if G > rows_per_chunk:
            C = (G + rows_per_chunk - 1) // rows_per_chunk
            padG = C * rows_per_chunk - G
            idx = jnp.concatenate(
                [b.idx, jnp.full((padG, cap), plan.m, b.idx.dtype)], 0
            ).reshape(C, rows_per_chunk, cap)
            red = jax.lax.map(
                lambda ix: jnp.sum(
                    dp[ix.reshape(-1)].reshape((rows_per_chunk, cap) + trail), 1
                ),
                idx,
            ).reshape((C * rows_per_chunk,) + trail)[:G]
        else:
            red = jnp.sum(dp[b.idx.reshape(-1)].reshape((G, cap) + trail), 1)
        out = out.at[b.seg_ids].set(red)
    return out[:-1]
