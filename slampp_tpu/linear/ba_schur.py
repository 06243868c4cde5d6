"""Large-scale bundle-adjustment Schur solver (observation-driven).

The dense-H Schur path (linear/schur.py) materializes the full Hessian —
fine for small scenes, impossible for Venice-class BA (871 cameras, 10^5-10^6
landmarks).  This module builds the reduced camera system DIRECTLY from
observations, the way the reference's BA pipeline uses its block-sparse
lambda (SURVEY.md §3.3), but organized for a jitted device program:

  * observations sorted by landmark: landmark blocks D_l, g_l and the
    back-substitution are GROUPED padded-gather reductions (ops/segments.py);
  * a camera-grouped index map gives the block-diagonal part of H_cc and
    the camera RHS the same way (pure BA has no cam-cam edges, so H_cc is
    block-diagonal before the Schur subtraction);
  * the SC off-diagonal mass, SC -= sum_l U_l D_l^-1 U_l^T, expands into
    per-observation-PAIR 6x6 GEMMs (pairs of observations sharing a
    landmark), host-sorted by (cam_i, cam_j) and reduced bucket-by-bucket
    with bounded-memory chunking;
  * the dense SC (6 n_c)^2 factors with XLA's Cholesky (mixed precision
    optional).

Layout: per-observation arrays are batch-LAST and contractions are
broadcast-multiply-reduce over the tiny leading dims.  That layout was
chosen for a tiled-memory accelerator and is unmeasured on the GPU
(ROADMAP re-decide list).

This is the role the reference's GPU Schur backend plays
(LinearSolver_Schur_GPU.cpp) — as the default, at Venice scale, on one card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from slampp_tpu.geometry import camera as cam_geo
from slampp_tpu.geometry import se3
from slampp_tpu.ops.segments import (
    grouped_segsum_first,
    GroupedSegments,
    grouped_segsum_last,
    plan_grouped_segments,
)

HI = lax.Precision.HIGHEST


class BASchurPlan(NamedTuple):
    n_c: int
    n_l: int
    n_obs: int
    n_distinct: int  # distinct SC blocks touched by pair products
    # observation arrays SORTED BY LANDMARK
    obs_cam: jnp.ndarray  # (m,) int32
    obs_lm: jnp.ndarray  # (m,) int32 (sorted ascending)
    obs_uv: jnp.ndarray  # (m, 2)
    obs_info: jnp.ndarray  # (m, 2, 2)
    # grouped reduction plans (ops/segments.py); index entries are DIRECT
    # observation indices (camera plan pre-remapped through the cam sort)
    lm_grp: GroupedSegments
    cam_grp: GroupedSegments
    # observation pairs sharing a landmark, sorted by (cam_i * n_c + cam_j),
    # with ONE dummy pair at index M2 pointing at the dummy observation m
    pair_e: jnp.ndarray  # (M2 + 1,) int32 obs index (row side)
    pair_f: jnp.ndarray  # (M2 + 1,) int32 obs index (col side)
    pair_grp: GroupedSegments  # segments = distinct SC blocks, over pairs
    sc_inv_map: jnp.ndarray  # (n_c*n_c,) -> distinct id or n_distinct (zero)
    anchor_cam: int  # -1 when the gauge anchor is a landmark
    anchor_lm: int  # -1 when the gauge anchor is a camera


# Register as a pytree with the scalars static so plans pass as jit ARGUMENTS
# (closure-captured plans embed megabytes of constants into the MLIR and blow
# up compile time / crash the remote compiler).
_BA_STATIC = ("n_c", "n_l", "n_obs", "n_distinct", "anchor_cam", "anchor_lm")
_BA_FIELDS = BASchurPlan._fields


def _ba_flatten(p):
    arrays = tuple(getattr(p, f) for f in _BA_FIELDS if f not in _BA_STATIC)
    aux = tuple(getattr(p, f) for f in _BA_FIELDS if f in _BA_STATIC)
    return arrays, aux


def _ba_unflatten(aux, arrays):
    kw = dict(zip([f for f in _BA_FIELDS if f in _BA_STATIC], aux))
    kw.update(zip([f for f in _BA_FIELDS if f not in _BA_STATIC], arrays))
    return BASchurPlan(**kw)


jax.tree_util.register_pytree_node(BASchurPlan, _ba_flatten, _ba_unflatten)


def build_ba_schur_plan(system) -> BASchurPlan:
    """Host symbolic phase from a BA GraphSystem (cam/xyz + edge_p2c)."""
    cam_ids = sorted(v for v, (t, _) in system.vertex_index.items() if t == "cam")
    lm_ids = sorted(v for v, (t, _) in system.vertex_index.items() if t == "xyz")
    cam_pos = {v: i for i, v in enumerate(cam_ids)}
    lm_pos = {v: i for i, v in enumerate(lm_ids)}
    n_c, n_l = len(cam_ids), len(lm_ids)

    rec = system._edges["edge_p2c"]
    m = len(rec["vids"])
    oc = np.empty(m, np.int64)
    ol = np.empty(m, np.int64)
    uv = np.empty((m, 2))
    info = np.empty((m, 2, 2))
    for e, vids in enumerate(rec["vids"]):
        p, c = vids
        oc[e] = cam_pos[c]
        ol[e] = lm_pos[p]
        uv[e] = rec["meas"][e]
        info[e] = rec["sigma_inv"][e]

    av = system._unary_anchor
    if av in cam_pos:
        anchor_cam, anchor_lm = cam_pos[av], -1
    elif av in lm_pos:
        anchor_cam, anchor_lm = -1, lm_pos[av]
    else:
        anchor_cam, anchor_lm = 0, -1

    return build_ba_schur_plan_arrays(
        n_c, n_l, oc, ol, uv, info, anchor_cam=anchor_cam, anchor_lm=anchor_lm
    )


import functools as _functools


@_functools.partial(jax.jit, static_argnums=(4, 5))
def _device_pairs(oc, ol, lm_starts, deg, M2: int, n_c: int):
    """Generate the within-landmark unordered observation pairs (e <= f by
    obs index), canonicalize the cam orientation, and sort by the flat
    (ci * n_c + cj) key — entirely on device (see
    build_ba_schur_plan_arrays).  Returns (pair_e, pair_f) int32 sorted to
    match the host-side P^T P segment layout."""
    m = oc.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)
    loc = idx - lm_starts[ol]
    reps = deg[ol] - loc                      # pairs whose e == this obs
    pair_e = jnp.repeat(idx, reps, total_repeat_length=M2)
    run_start = jnp.cumsum(reps) - reps
    offset = jnp.arange(M2, dtype=jnp.int32) - jnp.repeat(
        run_start.astype(jnp.int32), reps, total_repeat_length=M2
    )
    pair_f = pair_e + offset
    ci = oc[pair_e]
    cj = oc[pair_f]
    swap = ci > cj
    pe = jnp.where(swap, pair_f, pair_e)
    pf = jnp.where(swap, pair_e, pair_f)
    flat = jnp.minimum(ci, cj).astype(jnp.int64) * n_c + jnp.maximum(
        ci, cj
    ).astype(jnp.int64)
    flat_s, pe_s, pf_s = jax.lax.sort((flat, pe, pf), num_keys=1)
    return pe_s, pf_s


def build_ba_schur_plan_arrays(
    n_c: int,
    n_l: int,
    oc: np.ndarray,
    ol: np.ndarray,
    uv: np.ndarray,
    info: np.ndarray,
    anchor_cam: int = 0,
    anchor_lm: int = -1,
) -> BASchurPlan:
    """Vectorized host symbolic phase from raw observation arrays (the
    Venice-scale entry point — no Python loop over observations or
    landmarks)."""
    m = len(oc)
    order = np.argsort(ol, kind="stable")
    oc, ol, uv, info = oc[order], ol[order], uv[order], info[order]

    lm_starts = np.searchsorted(ol, np.arange(n_l))
    lm_ends = np.searchsorted(ol, np.arange(n_l) + 1)
    lm_grp = plan_grouped_segments(lm_starts, lm_ends, m, materialize=False)

    cam_perm = np.argsort(oc, kind="stable")
    oc_sorted = oc[cam_perm]
    cam_starts = np.searchsorted(oc_sorted, np.arange(n_c))
    cam_ends = np.searchsorted(oc_sorted, np.arange(n_c) + 1)
    # camera plan with DIRECT observation indices (host-side remap through
    # the cam sort — no device read-back, see plan_grouped_segments)
    perm_pad = np.concatenate([cam_perm, [m]]).astype(np.int64)
    cam_grp = plan_grouped_segments(cam_starts, cam_ends, m, remap=perm_pad)

    # UNORDERED observation pairs sharing a landmark (e <= f), with the cam
    # key CANONICALIZED to (min(ci,cj), max(ci,cj)) — SC symmetry
    # (BD_e B_f^T = (BD_f B_e^T)^T since D is symmetric) lets the device
    # compute each pair once and mirror the reduced grid.  Round-5 redesign
    # (VERDICT r4 #4): the O(sum deg^2) pair table is GENERATED AND SORTED
    # ON DEVICE — the host only derives the per-destination pair COUNTS
    # from the sparse incidence product P^T P (scipy, O(nnz)), so the
    # symbolic phase neither enumerates pairs on the host nor uploads
    # O(pairs) index tables through the (remote) device link.
    import scipy.sparse as _sp

    deg = (lm_ends - lm_starts).astype(np.int64)
    d2 = deg * (deg + 1) // 2
    M2 = int(d2.sum())
    ones = np.ones(m, np.int64)
    P = _sp.csr_matrix((ones, (ol, oc)), shape=(n_l, n_c))
    G = (P.T @ P).tocsr()
    G.sort_indices()
    Gc = _sp.triu(G, k=0).tocsr()
    rows_nz, cols_nz = Gc.nonzero()
    counts = np.asarray(Gc[rows_nz, cols_nz]).ravel().astype(np.int64)
    # ordered -> unordered pair counts: off-diagonal keys hold each
    # unordered cross pair once already; diagonal keys hold ordered pairs
    # (m_i^2 per landmark) -> (m_i^2 + m_i) / 2 unordered incl. e == f
    diag_mask = rows_nz == cols_nz
    cam_obs = np.bincount(oc, minlength=n_c)
    counts[diag_mask] = (counts[diag_mask] + cam_obs[rows_nz[diag_mask]]) // 2
    distinct = rows_nz.astype(np.int64) * n_c + cols_nz.astype(np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    n_distinct = len(distinct)
    assert M2 == int(counts.sum()), (M2, int(counts.sum()))
    pair_grp = plan_grouped_segments(
        starts, ends, M2, bucket_base=2, min_cap=8, materialize=False
    )
    pair_e, pair_f = _device_pairs(
        jnp.asarray(oc, jnp.int32),
        jnp.asarray(ol, jnp.int32),
        jnp.asarray(lm_starts, jnp.int32),
        jnp.asarray(deg, jnp.int32),
        M2,
        n_c,
    )

    grid = np.arange(n_c * n_c, dtype=np.int64)
    if n_distinct:
        pos = np.minimum(np.searchsorted(distinct, grid), n_distinct - 1)
        sc_inv_map = np.where(distinct[pos] == grid, pos, n_distinct)
    else:
        sc_inv_map = np.full(grid.shape, n_distinct, np.int64)

    return BASchurPlan(
        n_c=n_c,
        n_l=n_l,
        n_obs=m,
        n_distinct=n_distinct,
        obs_cam=jnp.asarray(oc, jnp.int32),
        obs_lm=jnp.asarray(ol, jnp.int32),
        obs_uv=jnp.asarray(uv),
        obs_info=jnp.asarray(info),
        lm_grp=lm_grp,
        cam_grp=cam_grp,
        pair_e=jnp.concatenate(
            [pair_e, jnp.full((1,), m, jnp.int32)]
        ),
        pair_f=jnp.concatenate(
            [pair_f, jnp.full((1,), m, jnp.int32)]
        ),
        pair_grp=pair_grp,
        sc_inv_map=jnp.asarray(sc_inv_map, jnp.int32),
        anchor_cam=int(anchor_cam),
        anchor_lm=int(anchor_lm),
    )


def _p2c_residual_jacs(point, cam_state, uv):
    """Autodiff oracle for ONE observation (kept as the test reference for
    the analytic batch kernel below)."""

    def err(dp, dc):
        cam = jnp.concatenate([se3.plus(cam_state[0:6], dc), cam_state[6:11]])
        return cam_geo.p2c_error(point + dp, cam, uv)

    r = cam_geo.p2c_error(point, cam_state, uv)
    Jp, Jc = jax.jacfwd(err, argnums=(0, 1))(jnp.zeros(3), jnp.zeros(6))
    return r, Jp, Jc


def _rodrigues_last(aa):
    """Rotation matrices (3, 3, m) from axis-angle (3, m) — elementwise
    Rodrigues in batch-last layout (se3.axis_angle_to_rot per column)."""
    sq = jnp.sum(aa * aa, axis=0)
    small = sq < 1e-16
    t = jnp.where(small, 1.0, sq)
    angle = jnp.sqrt(t)
    sinc = jnp.where(small, 1.0 - sq / 6.0, jnp.sin(angle) / angle)
    cosc = jnp.where(small, 0.5 - sq / 24.0, (1.0 - jnp.cos(angle)) / t)
    wx, wy, wz = aa[0], aa[1], aa[2]
    zero = jnp.zeros_like(wx)
    K = jnp.stack([
        jnp.stack([zero, -wz, wy]),
        jnp.stack([wz, zero, -wx]),
        jnp.stack([-wy, wx, zero]),
    ])  # (3, 3, m)
    # broadcast-multiply-reduce, NOT einsum: keeps the batch dim last (see
    # the module docstring on layout)
    KK = jnp.sum(K[:, :, None, :] * K[None, :, :, :], axis=1)
    eye = jnp.eye(3, dtype=aa.dtype)[:, :, None]
    return eye + sinc[None, None, :] * K + cosc[None, None, :] * KK


def _p2c_jacs_analytic(points, cam_states, uvs):
    """Hand-derived P2C residual + Jacobians for ALL observations at once,
    batch-last: r (2, m), Jp (2, 3, m), Jc (2, 6, m).

    Closed-form chain matching the reference's analytic Jacobians
    (CBAJacobians::Project_P2C, BASolverBase.h:260) for the retraction
    point+dp / right-composed pose delta (se3.plus): with x = R X + t,
    dx/ddt = R, dx/ddaa = -R [X]x, dx/dX = R; the projection+radial layer
    differentiates elementwise, with no autodiff intermediates (it replaced
    a vmapped jacfwd)."""
    X = points.T  # (3, m)
    tvec = cam_states[:, 0:3].T
    aa = cam_states[:, 3:6].T
    fx, fy, cx, cy, k0 = (cam_states[:, 6 + i] for i in range(5))
    k = k0 / (0.5 * (fx + fy))
    z = uvs.T  # (2, m)

    R = _rodrigues_last(aa)  # (3, 3, m)
    x = jnp.sum(R * X[None, :, :], axis=1) + tvec  # (3, m) camera coords
    iz = 1.0 / x[2]
    a = fx * x[0] * iz  # u - cx
    b = fy * x[1] * iz  # v - cy
    r2 = a * a + b * b
    d = 1.0 + k * r2
    h = jnp.stack([cx + d * a, cy + d * b])
    r = z - h

    zero = jnp.zeros_like(iz)
    da = jnp.stack([fx * iz, zero, -a * iz])  # (3, m) d a / d x
    db = jnp.stack([zero, fy * iz, -b * iz])
    m11 = d + 2.0 * k * a * a
    m12 = 2.0 * k * a * b
    m22 = d + 2.0 * k * b * b
    Jh = jnp.stack([m11 * da + m12 * db, m12 * da + m22 * db])  # (2, 3, m)

    JhR = jnp.sum(Jh[:, :, None, :] * R[None, :, :, :], axis=1)  # (2, 3, m)
    Jp = -JhR
    # rotation part: dx/ddaa = -R skew(X)  ->  dh/ddaa = -Jh R skew(X)
    Xx, Xy, Xz = X[0], X[1], X[2]
    zero3 = jnp.zeros_like(Xx)
    skewX = jnp.stack([
        jnp.stack([zero3, -Xz, Xy]),
        jnp.stack([Xz, zero3, -Xx]),
        jnp.stack([-Xy, Xx, zero3]),
    ])  # (3, 3, m)
    JhRskew = jnp.sum(JhR[:, :, None, :] * skewX[None, :, :, :], axis=1)
    Jc = jnp.concatenate([Jp, JhRskew], axis=1)  # (2, 6, m)
    return r, Jp, Jc


def _jacs_chunked(points, cam_states, uvs, chunk: int = 131072):
    """Per-observation residuals + Jacobians in BATCH-LAST layout:
    r (2, m), Jp (2, 3, m), Jc (2, 6, m).

    Uses the ANALYTIC whole-batch kernel (_p2c_jacs_analytic), elementwise
    over the observation axis."""
    del chunk  # no longer needed: analytic intermediates are O(m)
    return _p2c_jacs_analytic(points, cam_states, uvs)


def _inv3_last(D):
    """Closed-form batched 3x3 inverse for (3, 3, n) arrays (adjugate/det) —
    elementwise over the batch axis, no batched LU (unmeasured against
    jnp.linalg.inv on the GPU; ROADMAP re-decide list)."""
    a, b, c = D[0, 0], D[0, 1], D[0, 2]
    d, e, f = D[1, 0], D[1, 1], D[1, 2]
    g, h, i = D[2, 0], D[2, 1], D[2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    Dd = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * Dd + c * G
    inv_det = 1.0 / det
    row0 = jnp.stack([A, B, C])
    row1 = jnp.stack([Dd, E, F])
    row2 = jnp.stack([G, H, I])
    return jnp.stack([row0, row1, row2]) * inv_det


def _pair_sc_mass(plan: BASchurPlan, BD2, B2, max_chunk: int = 1_000_000,
                  pair_f32: bool = True):
    """Half-triangle SC mass: for every distinct (cam_i, cam_j) block, the
    sum over UNORDERED landmark-sharing observation pairs of BD_e @ B_f^T
    (diagonal e == f pairs scaled by 0.5 so the caller's mirror G + G^T
    restores the full ordered sum).

    BD2, B2: (18, m) flattened (6, 3, m) coupling arrays.  Returns
    (36, n_distinct + 1) with a zero column at n_distinct.  Buckets of the
    pair plan are processed with bounded-memory chunking; ``pair_f32`` runs
    the gather+product in f32 (half the gather bytes; the SC factorization
    is f32-equilibrated downstream anyway).
    """
    dt = jnp.float32 if pair_f32 else BD2.dtype
    # ROW-major gather layout: gathering columns of a (18, m) array costs 18
    # strided reads per pair index; rows of the (m, 18) transpose are one
    # contiguous 72-byte read each
    zrow = jnp.zeros((1, 18), dt)
    BDp = jnp.concatenate([BD2.astype(dt).T, zrow], 0)  # (m + 1, 18)
    Bp = jnp.concatenate([B2.astype(dt).T, zrow], 0)
    M2p = plan.pair_e.shape[0]  # M2 + 1 (dummy at M2)

    out = jnp.zeros((36, plan.n_distinct + 1), dt)

    def rows_product(ix):
        """ix: (rows, cap) pair ids -> (36, rows) reduced products."""
        rows, cap = ix.shape
        flat = ix.reshape(-1)
        pe = plan.pair_e[flat]
        pf = plan.pair_f[flat]
        scale = jnp.where(pe == pf, 0.5, 1.0).astype(dt).reshape(rows, cap)
        BDg = BDp[pe].T.reshape(6, 3, rows, cap)
        Bg = Bp[pf].T.reshape(6, 3, rows, cap)
        prod = jnp.sum(BDg[:, None] * Bg[None, :], axis=2)  # (6, 6, rows, cap)
        return jnp.sum(prod * scale, -1).reshape(36, rows)

    from slampp_tpu.ops.segments import RangeBucket, _range_idx, GroupBucket

    for b in plan.pair_grp.buckets:
        if isinstance(b, RangeBucket):
            b = GroupBucket(seg_ids=b.seg_ids, idx=_range_idx(b, plan.pair_grp.m))
        G, cap = b.idx.shape
        rows_per_chunk = max(1, max_chunk // max(cap, 1))
        if G > rows_per_chunk:
            C = (G + rows_per_chunk - 1) // rows_per_chunk
            padG = C * rows_per_chunk - G
            idx = jnp.concatenate(
                [b.idx, jnp.full((padG, cap), M2p - 1, b.idx.dtype)], 0
            ).reshape(C, rows_per_chunk, cap)
            red = lax.map(rows_product, idx)  # (C, 36, rows_per_chunk)
            red = jnp.moveaxis(red, 0, -2).reshape(36, C * rows_per_chunk)[:, :G]
        else:
            red = rows_product(b.idx)
        out = out.at[:, b.seg_ids].set(red)
    return out


def _segsum_rows(data_last, grp):
    """Segment sum of batch-last (k, m) data via ROW gathers of the (m, k)
    transpose: column gathers of a (k, m) array cost k strided reads per
    index; a row gather is one contiguous read.  Returns (k, n_seg) like
    grouped_segsum_last."""
    return grouped_segsum_first(data_last.T, grp).T


def ba_schur_lm_step(plan: BASchurPlan, cam_states, lm_states, alpha,
                     sc_f64: bool = True, pair_f32: bool = True):
    """One damped (LM) BA iteration without any dense Hessian.

    cam_states: (n_c, 11); lm_states: (n_l, 3).  Returns
    (new_cams, new_lms, dx_norm, chi2, denom).  ``sc_f64`` selects an exact
    f64 SC factorization (the SC is only (6 n_c)^2);
    False uses the equilibrated f32 + refinement path.

    All per-observation arrays are BATCH-LAST (see the module docstring);
    all segment reductions are grouped padded gathers (ops/segments.py).
    """
    n_c = plan.n_c
    r, Jp, Jc = _jacs_chunked(
        lm_states[plan.obs_lm], cam_states[plan.obs_cam], plan.obs_uv
    )
    Wt = jnp.moveaxis(plan.obs_info, 0, -1)  # (2, 2, m)
    # NOTE on contraction style: every per-observation contraction below is a
    # broadcast-multiply-reduce over the TINY leading dims, NOT an einsum, so
    # no batch-first (m, 6, 6) temporary is formed.
    Wr = jnp.sum(Wt * r[None, :, :], axis=1)  # (2, m)
    chi2 = jnp.sum(r * Wr)
    WJc = jnp.sum(Wt[:, :, None, :] * Jc[None, :, :, :], axis=1)  # (2, 6, m)
    WJp = jnp.sum(Wt[:, :, None, :] * Jp[None, :, :, :], axis=1)  # (2, 3, m)

    # landmark blocks + rhs (obs sorted by lm; grouped reductions)
    D = _segsum_rows(
        jnp.sum(Jp[:, :, None, :] * WJp[:, None, :, :], axis=0).reshape(9, -1),
        plan.lm_grp,
    ).reshape(3, 3, plan.n_l)
    g_l = _segsum_rows(
        jnp.sum(WJp * r[:, None, :], axis=0), plan.lm_grp
    )  # (3, n_l)
    D = D + alpha * jnp.eye(3, dtype=D.dtype)[:, :, None]
    if plan.anchor_lm >= 0:
        D = D.at[:, :, plan.anchor_lm].add(jnp.eye(3, dtype=D.dtype))
    Dinv = _inv3_last(D)  # (3, 3, n_l)

    # camera block-diagonal + rhs.  Last-axis gathers of rank-3 arrays make
    # XLA transpose to batch-first — so every gather below runs on a 2-D
    # (k, m) FLATTENED view.
    m = r.shape[-1]
    Hcc_e = jnp.sum(Jc[:, :, None, :] * WJc[:, None, :, :], axis=0).reshape(36, m)
    gc_e = jnp.sum(WJc * r[:, None, :], axis=0)  # (6, m)
    Hcc_diag = _segsum_rows(Hcc_e, plan.cam_grp).reshape(6, 6, n_c)
    g_c = _segsum_rows(gc_e, plan.cam_grp)  # (6, n_c)

    # couplings per observation
    Dinv_obs = Dinv.reshape(9, -1)[:, plan.obs_lm].reshape(3, 3, m)
    B = jnp.sum(Jc[:, :, None, :] * WJp[:, None, :, :], axis=0)  # (6, 3, m)
    BD = jnp.sum(B[:, :, None, :] * Dinv_obs[None, :, :, :], axis=1)  # (6, 3, m)
    B2 = B.reshape(18, m)
    BD2 = BD.reshape(18, m)

    # SC pair mass per distinct (cam_i, cam_j) over the HALF triangle of
    # pairs, placed by inverse-map gather and mirrored: the full grid is
    # G + G^T-of-blocks (BD_e B_f^T = (BD_f B_e^T)^T; e == f pre-scaled 0.5)
    mass = _pair_sc_mass(plan, BD2, B2, pair_f32=pair_f32)
    G36 = mass[:, plan.sc_inv_map].astype(r.dtype)  # (36, n_c*n_c)
    Gg = G36.reshape(6, 6, n_c, n_c)
    # mirror: block at (ci, cj) += transpose of the block at (cj, ci)
    SCf = -(Gg + Gg.transpose(1, 0, 3, 2)).reshape(36, n_c * n_c)
    diag_ids = jnp.arange(n_c) * (n_c + 1)
    diag_add = Hcc_diag + alpha * jnp.eye(6, dtype=SCf.dtype)[:, :, None]
    if plan.anchor_cam >= 0:
        diag_add = diag_add.at[:, :, plan.anchor_cam].add(jnp.eye(6, dtype=SCf.dtype))
    SCf = SCf.at[:, diag_ids].add(diag_add.reshape(36, n_c))
    SC = (
        SCf.reshape(6, 6, n_c, n_c)
        .transpose(2, 0, 3, 1)
        .reshape(n_c * 6, n_c * 6)
    )

    # reduced rhs: g_c - sum_l U_l Dinv_l g_l  (per-obs contribution BD_e g_l)
    r2_e = jnp.sum(BD * g_l[:, plan.obs_lm][None, :, :], axis=1)  # (6, m)
    r2 = _segsum_rows(r2_e, plan.cam_grp)
    rhs = -(g_c - r2).T.reshape(-1)

    if sc_f64:
        L = lax.linalg.cholesky(SC, symmetrize_input=True)
        y = lax.linalg.triangular_solve(L, rhs[:, None], left_side=True, lower=True)
        dx_c = lax.linalg.triangular_solve(
            L, y, left_side=True, lower=True, transpose_a=True
        )[:, 0]
    else:
        # equilibrated f32 factorization + one f64 refinement
        s = 1.0 / jnp.sqrt(jnp.maximum(jnp.diagonal(SC), 1e-30))
        SCs = (SC * s[:, None] * s[None, :]).astype(jnp.float32)
        SCs = SCs + 1e-6 * jnp.eye(SC.shape[0], dtype=jnp.float32)
        L = lax.linalg.cholesky(SCs)

        def solve32(rr):
            y = lax.linalg.triangular_solve(
                L, (s * rr).astype(jnp.float32)[:, None], left_side=True, lower=True
            )
            z = lax.linalg.triangular_solve(
                L, y, left_side=True, lower=True, transpose_a=True
            )[:, 0]
            return s * z.astype(SC.dtype)

        dx_c = solve32(rhs)
        dx_c = dx_c + solve32(rhs - SC @ dx_c)

    # landmark back-substitution: dx_l = Dinv (-g_l - sum_e B_e^T dx_c[cam_e])
    dxc_blocks = dx_c.reshape(n_c, 6)
    bt_e = jnp.sum(B * dxc_blocks.T[:, plan.obs_cam][:, None, :], axis=0)  # (3, m)
    BT = _segsum_rows(bt_e, plan.lm_grp)  # (3, n_l)
    dx_l = jnp.sum(Dinv * (-g_l - BT)[None, :, :], axis=1)  # (3, n_l)

    new_cams = jax.vmap(
        lambda st, d: jnp.concatenate([se3.plus(st[0:6], d), st[6:11]])
    )(cam_states, dxc_blocks)
    new_lms = lm_states + dx_l.T

    sq = jnp.dot(dx_c, dx_c) + jnp.sum(dx_l * dx_l)
    # LM gain denominator dx.(alpha dx - g) with the FULL gradient (g_c, g_l)
    g_dot = jnp.sum(dxc_blocks.T * g_c) + jnp.sum(dx_l * g_l)
    denom = alpha * sq - g_dot
    return new_cams, new_lms, jnp.sqrt(sq), chi2, denom


def _p2c_residual_batch(points, cam_states, uvs):
    """Batch-last residuals r (2, m) — the forward chain of
    _p2c_jacs_analytic without the Jacobian layers."""
    X = points.T
    tvec = cam_states[:, 0:3].T
    aa = cam_states[:, 3:6].T
    fx, fy, cx, cy, k0 = (cam_states[:, 6 + i] for i in range(5))
    k = k0 / (0.5 * (fx + fy))
    R = _rodrigues_last(aa)
    x = jnp.sum(R * X[None, :, :], axis=1) + tvec
    iz = 1.0 / x[2]
    a = fx * x[0] * iz
    b = fy * x[1] * iz
    d = 1.0 + k * (a * a + b * b)
    h = jnp.stack([cx + d * a, cy + d * b])
    return uvs.T - h


def ba_chi2_only(plan: BASchurPlan, cam_states, lm_states):
    """Residual-only chi2 (no Jacobians, no SC) — used by the LM
    accept/reject loop so a rejected step costs O(m) instead of a full
    Schur solve (reference evaluates f_Chi_Squared_Error after the step,
    NonlinearSolver_Lambda_LM.h:205-230)."""
    r = _p2c_residual_batch(
        lm_states[plan.obs_lm], cam_states[plan.obs_cam], plan.obs_uv
    )  # (2, m)
    Wt = jnp.moveaxis(plan.obs_info, 0, -1)
    Wr = jnp.sum(Wt * r[None, :, :], axis=1)
    return jnp.sum(r * Wr)


class BigBASolver:
    """LM over the observation-driven Schur step (the Venice-class solver)."""

    def __init__(self, system, verbose: bool = False, tau: float = 1e-3,
                 sc_f64: bool = True, pair_f32: bool = True):
        self.system = system
        self.verbose = verbose
        self.tau = tau
        self.sc_f64 = sc_f64
        self.pair_f32 = pair_f32
        self.plan = None
        self._step = None
        self._cams = None
        self._lms = None

    @classmethod
    def from_arrays(cls, cam_states, lm_states, obs_cam, obs_lm, uv, info,
                    verbose: bool = False, tau: float = 1e-3,
                    sc_f64: bool = False, pair_f32: bool = True):
        """Venice-scale constructor from raw observation arrays (no
        GraphSystem / parser in the loop)."""
        self = cls(system=None, verbose=verbose, tau=tau, sc_f64=sc_f64,
                   pair_f32=pair_f32)
        self.plan = build_ba_schur_plan_arrays(
            len(cam_states), len(lm_states), obs_cam, obs_lm, uv, info
        )
        self._cams = jnp.asarray(cam_states)
        self._lms = jnp.asarray(lm_states)
        return self

    def _make_step(self):
        if self._step is None:
            step = jax.jit(
                ba_schur_lm_step, static_argnames=("sc_f64", "pair_f32")
            )
            self._step = lambda c, l, a: step(
                self.plan, c, l, a, sc_f64=self.sc_f64, pair_f32=self.pair_f32
            )
            self._chi2_fn = jax.jit(ba_chi2_only)

    def _prepare(self):
        if self.plan is None:
            self.plan = build_ba_schur_plan(self.system)
        self._make_step()
        if self.system is None:
            return None, None, self._cams, self._lms
        cam_ids = sorted(v for v, (t, _) in self.system.vertex_index.items() if t == "cam")
        lm_ids = sorted(v for v, (t, _) in self.system.vertex_index.items() if t == "xyz")
        cams = jnp.asarray(np.stack([self.system.vertex_state(v) for v in cam_ids]))
        lms = jnp.asarray(np.stack([self.system.vertex_state(v) for v in lm_ids]))
        return cam_ids, lm_ids, cams, lms

    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        cam_ids, lm_ids, cams, lms = self._prepare()
        # initial damping from the max Hessian diagonal (LM heuristic)
        alpha = self.tau * 1e3  # scale-free start; adapted by the gain ratio
        nu = 2.0
        last_error = float(self._chi2_fn(self.plan, cams, lms))
        applied = 0
        for it in range(max_iterations):
            nc, nl, dxn, chi2, denom = self._step(cams, lms, alpha)
            if not np.isfinite(float(dxn)) or float(dxn) <= min_dx_norm:
                break
            f_error = float(self._chi2_fn(self.plan, nc, nl))
            rho = (last_error - f_error) / max(float(denom), 1e-300)
            if rho > 0:
                alpha *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                nu = 2.0
                cams, lms = nc, nl
                last_error = f_error
                applied += 1
                if self.verbose:
                    print(f"BigBA iter {it}: accepted chi2={f_error:.2f} alpha={alpha:.2e}")
            else:
                alpha *= nu
                nu *= 2.0
                if self.verbose:
                    print(f"BigBA iter {it}: rejected chi2={f_error:.2f} alpha={alpha:.2e}")
        # write back
        self._cams, self._lms = cams, lms
        if self.system is not None:
            cams_np, lms_np = np.asarray(cams), np.asarray(lms)
            for i, v in enumerate(cam_ids):
                self.system.set_vertex_state(v, cams_np[i])
            for i, v in enumerate(lm_ids):
                self.system.set_vertex_state(v, lms_np[i])
        return applied

    def chi2(self) -> float:
        cam_ids, lm_ids, cams, lms = self._prepare()
        return float(self._chi2_fn(self.plan, cams, lms))
