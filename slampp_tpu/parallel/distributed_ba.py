"""Distributed bundle adjustment via sharded Schur reduction.

The BASELINE.json north-star capability (absent in the reference, which is
single-process): partition landmarks and their observations across devices;
each shard assembles its local contributions, the reduced camera system is
psum-ed over the mesh (one collective per iteration), factored
replicated, and landmarks back-substitute shard-locally:

  per shard:  H_cc += sum_obs J_c^T W J_c        (partial, psum-ed)
              D_l   = sum_obs J_l^T W J_l        (local landmarks)
              U_l   = stacked J_c^T W J_l        (local couplings)
              SC_part = H_cc_part - sum_l U_l D_l^-1 U_l^T
  psum:       SC, rhs_c, chi2
  replicated: dense Cholesky of SC -> dx_c
  local:      dx_l = D_l^-1 (g_l - U_l^T dx_c)

This is SURVEY.md §2.12's mandated design; the same code runs on the virtual
CPU mesh (tests / driver dry-run) and on real cards.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slampp_tpu.geometry import camera as cam_geo
from slampp_tpu.geometry import se3
from slampp_tpu.linear.dense import solve_spd


def _inv3(D):
    """Closed-form batched 3x3 inverse for (n, 3, 3) arrays (adjugate/det).
    The landmark blocks are SPD 3x3: the closed form is exact and fuses into
    the surrounding einsums instead of lowering to a batched LU."""
    a, b, c = D[:, 0, 0], D[:, 0, 1], D[:, 0, 2]
    d, e, f = D[:, 1, 0], D[:, 1, 1], D[:, 1, 2]
    g, h, i = D[:, 2, 0], D[:, 2, 1], D[:, 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / det
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], -1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        -2,
    )
    return adj * inv_det[:, None, None]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BAShards:
    """Landmark-sharded BA problem (leading axis of lm_*/obs_* arrays is
    sharded over the mesh; cam_states is replicated)."""

    cam_states: jnp.ndarray  # (n_c, 11) replicated
    lm_states: jnp.ndarray  # (N_l, 3) sharded
    lm_valid: jnp.ndarray  # (N_l,) sharded
    obs_cam: jnp.ndarray  # (M,) int32 camera index, sharded
    obs_lm: jnp.ndarray  # (M,) int32 LOCAL landmark index within shard
    obs_uv: jnp.ndarray  # (M, 2) sharded
    obs_info: jnp.ndarray  # (M, 2, 2) sharded
    obs_valid: jnp.ndarray  # (M,) sharded
    anchor_cam: int  # gauge anchor camera index (-1 if the anchor is a point)
    anchor_lm: int  # gauge anchor landmark index (-1 if the anchor is a camera)

    def tree_flatten(self):
        return (
            self.cam_states,
            self.lm_states,
            self.lm_valid,
            self.obs_cam,
            self.obs_lm,
            self.obs_uv,
            self.obs_info,
            self.obs_valid,
        ), (self.anchor_cam, self.anchor_lm)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0], aux[1])


def build_ba_shards(system, mesh: Mesh, axis: str = "lm") -> BAShards:
    """Partition a BA GraphSystem (cam/xyz vertices + edge_p2c) by landmark
    into mesh-shard-aligned arrays."""
    n_dev = mesh.shape[axis]
    cam_ids = sorted(
        v for v, (t, _) in system.vertex_index.items() if t == "cam"
    )
    lm_ids = sorted(v for v, (t, _) in system.vertex_index.items() if t == "xyz")
    cam_pos = {v: i for i, v in enumerate(cam_ids)}
    lm_pos = {v: i for i, v in enumerate(lm_ids)}
    cam_states = np.stack([system.vertex_state(v) for v in cam_ids])

    # contiguous landmark partition
    n_l = len(lm_ids)
    per = (n_l + n_dev - 1) // n_dev
    N_l = per * n_dev
    lm_states = np.zeros((N_l, 3))
    lm_valid = np.zeros(N_l, bool)
    for i, v in enumerate(lm_ids):
        lm_states[i] = system.vertex_state(v)
        lm_valid[i] = True

    # observations grouped by owning shard
    rec = system._edges["edge_p2c"]
    shard_obs = [[] for _ in range(n_dev)]
    for e, vids in enumerate(rec["vids"]):
        p, c = vids  # (point, camera) slot order
        li = lm_pos[p]
        shard = li // per
        shard_obs[shard].append((cam_pos[c], li, rec["meas"][e], rec["sigma_inv"][e]))
    m_per = max(len(s) for s in shard_obs)
    M = m_per * n_dev
    obs_cam = np.zeros(M, np.int32)
    obs_lm = np.zeros(M, np.int32)
    obs_uv = np.zeros((M, 2))
    obs_info = np.zeros((M, 2, 2))
    obs_valid = np.zeros(M, bool)
    for s in range(n_dev):
        base = s * m_per
        for k, (ci, li, uv, info) in enumerate(shard_obs[s]):
            obs_cam[base + k] = ci
            obs_lm[base + k] = li  # global; made shard-local inside shard_map
            obs_uv[base + k] = uv
            obs_info[base + k] = info
            obs_valid[base + k] = True

    # match the system's unary gauge anchor (vertex id 0 by default,
    # else the first edge's first vertex — often a point in BA datasets)
    av = system._unary_anchor
    if av in cam_pos:
        anchor_cam, anchor_lm = cam_pos[av], -1
    elif av in lm_pos:
        anchor_cam, anchor_lm = -1, lm_pos[av]
    else:
        anchor_cam, anchor_lm = 0, -1
    shards = BAShards(
        jnp.asarray(cam_states),
        jnp.asarray(lm_states),
        jnp.asarray(lm_valid),
        jnp.asarray(obs_cam),
        jnp.asarray(obs_lm),
        jnp.asarray(obs_uv),
        jnp.asarray(obs_info),
        jnp.asarray(obs_valid),
        anchor_cam,
        anchor_lm,
    )
    spec = BAShards(
        P(), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
        anchor_cam, anchor_lm,
    )
    leaves, treedef = jax.tree_util.tree_flatten(shards)
    spec_leaves = jax.tree_util.tree_flatten(spec)[0]
    placed = [
        jax.device_put(x, NamedSharding(mesh, s)) for x, s in zip(leaves, spec_leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, placed)


def _p2c_residual_jacs(point, cam_state, uv):
    def err(dp, dc):
        cam = jnp.concatenate([se3.plus(cam_state[0:6], dc), cam_state[6:11]])
        return cam_geo.p2c_error(point + dp, cam, uv)

    r = cam_geo.p2c_error(point, cam_state, uv)
    Jp, Jc = jax.jacfwd(err, argnums=(0, 1))(jnp.zeros(3), jnp.zeros(6))
    return r, Jp, Jc


def _segsum(data, starts, ends):
    """Sorted segment sums via exclusive prefix sums (see linear/ba_schur.py)."""
    cum0 = jnp.concatenate(
        [jnp.zeros((1,) + data.shape[1:], data.dtype), jnp.cumsum(data, 0)], 0
    )
    return cum0[ends] - cum0[starts]


class BigBAShards(NamedTuple):
    """Venice-scale landmark-sharded BA problem: per-shard observation plans
    stacked on a leading mesh axis.  Unlike :class:`BAShards`, nothing here is
    dense in the landmark-x-camera product — the Schur off-diagonal mass is
    reduced per observation PAIR exactly as in linear/ba_schur.py, so memory
    per shard is O(local obs + local pairs + (6 n_c)^2 for the reduced camera
    system).  Mirrors the role of the reference's GPU Schur backend
    (src/slam/LinearSolver_Schur_GPU.cpp) across a device mesh."""

    cam_states: jnp.ndarray  # (n_c, 11) replicated
    lm_states: jnp.ndarray  # (n_dev, per, 3) sharded on dim 0
    lm_valid: jnp.ndarray  # (n_dev, per)
    obs_cam: jnp.ndarray  # (n_dev, m_max) int32
    obs_lm: jnp.ndarray  # (n_dev, m_max) int32, LOCAL slot, sorted per shard
    obs_uv: jnp.ndarray  # (n_dev, m_max, 2)
    obs_w: jnp.ndarray  # (n_dev, m_max, 2, 2) information (0 on padding)
    obs_valid: jnp.ndarray  # (n_dev, m_max)
    lm_starts: jnp.ndarray  # (n_dev, per) int32 segment starts into obs
    lm_ends: jnp.ndarray  # (n_dev, per) int32
    pair_e: jnp.ndarray  # (n_dev, p_max) int32 local obs index (row side)
    pair_f: jnp.ndarray  # (n_dev, p_max) int32 local obs index (col side)
    pair_flat: jnp.ndarray  # (n_dev, d_max) int32 distinct (ci*n_c+cj); pad=n_c^2
    pair_starts: jnp.ndarray  # (n_dev, d_max)
    pair_ends: jnp.ndarray  # (n_dev, d_max)
    n_c: int
    per: int
    anchor_cam: int
    anchor_lm: int  # GLOBAL padded landmark index (shard = idx // per), or -1


_BIG_STATIC = ("n_c", "per", "anchor_cam", "anchor_lm")
_BIG_FIELDS = BigBAShards._fields


def _big_flatten(p):
    arrays = tuple(getattr(p, f) for f in _BIG_FIELDS if f not in _BIG_STATIC)
    aux = tuple(getattr(p, f) for f in _BIG_FIELDS if f in _BIG_STATIC)
    return arrays, aux


def _big_unflatten(aux, arrays):
    kw = dict(zip([f for f in _BIG_FIELDS if f in _BIG_STATIC], aux))
    kw.update(zip([f for f in _BIG_FIELDS if f not in _BIG_STATIC], arrays))
    return BigBAShards(**kw)


jax.tree_util.register_pytree_node(BigBAShards, _big_flatten, _big_unflatten)


def _big_specs(axis: str, n_c=0, per=0, anchor_cam=0, anchor_lm=0) -> BigBAShards:
    """PartitionSpec pytree matching BigBAShards; statics must EQUAL the
    shards' statics (pytree aux data participates in structure matching)."""
    sh = P(axis)
    return BigBAShards(
        P(), sh, sh, sh, sh, sh, sh, sh, sh, sh, sh, sh, sh, sh, sh,
        n_c, per, anchor_cam, anchor_lm,
    )


def build_big_ba_shards(system, mesh: Mesh, axis: str = "lm") -> BigBAShards:
    """Host symbolic phase from a BA GraphSystem (cam/xyz + edge_p2c): see
    :func:`build_big_ba_shards_arrays`."""
    cam_ids = sorted(v for v, (t, _) in system.vertex_index.items() if t == "cam")
    lm_ids = sorted(v for v, (t, _) in system.vertex_index.items() if t == "xyz")
    cam_pos = {v: i for i, v in enumerate(cam_ids)}
    lm_pos = {v: i for i, v in enumerate(lm_ids)}

    cam_states = np.stack([system.vertex_state(v) for v in cam_ids])
    lm_states = np.stack([system.vertex_state(v) for v in lm_ids])

    rec = system._edges["edge_p2c"]
    m = len(rec["vids"])
    oc = np.empty(m, np.int64)
    ol = np.empty(m, np.int64)
    for e, vids in enumerate(rec["vids"]):
        p, c = vids
        oc[e] = cam_pos[c]
        ol[e] = lm_pos[p]
    uv = np.asarray(rec["meas"], float).reshape(m, 2)
    info = np.asarray(rec["sigma_inv"], float).reshape(m, 2, 2)

    av = system._unary_anchor
    if av in cam_pos:
        anchor_cam, anchor_lm = cam_pos[av], -1
    elif av in lm_pos:
        anchor_cam, anchor_lm = -1, lm_pos[av]
    else:
        anchor_cam, anchor_lm = 0, -1
    return build_big_ba_shards_arrays(
        cam_states, lm_states, oc, ol, uv, info, mesh, axis,
        anchor_cam=anchor_cam, anchor_lm=anchor_lm,
    )


def build_big_ba_shards_arrays(cam_states, lm_init, oc, ol, uv, info,
                               mesh: Mesh, axis: str = "lm",
                               anchor_cam: int = 0,
                               anchor_lm: int = -1) -> BigBAShards:
    """Host symbolic phase from raw observation arrays (the Venice-scale
    entry point, like ``BigBASolver.from_arrays``): partition landmarks
    contiguously over the mesh and build per-shard sorted-segment
    observation/pair plans.  The gauge anchor defaults to camera 0, as in
    ``build_ba_schur_plan_arrays``."""
    n_dev = mesh.shape[axis]
    n_c, n_l = len(cam_states), len(lm_init)
    per = (n_l + n_dev - 1) // n_dev
    cam_states = np.asarray(cam_states, float)
    lm_states = np.zeros((n_dev * per, 3))
    lm_states[:n_l] = lm_init
    lm_valid = np.zeros(n_dev * per, bool)
    lm_valid[:n_l] = True

    oc = np.asarray(oc, np.int64)
    ol = np.asarray(ol, np.int64)
    uv = np.asarray(uv, float).reshape(-1, 2)
    info = np.asarray(info, float).reshape(-1, 2, 2)
    order = np.argsort(ol, kind="stable")
    oc, ol, uv, info = oc[order], ol[order], uv[order], info[order]
    shard_of = ol // per

    # per-shard slices (obs are landmark-sorted, so shards are contiguous)
    bounds = np.searchsorted(shard_of, np.arange(n_dev + 1))
    m_max = max(1, int(np.max(bounds[1:] - bounds[:-1])))

    obs_cam = np.zeros((n_dev, m_max), np.int32)
    obs_lm = np.zeros((n_dev, m_max), np.int32)
    obs_uv = np.zeros((n_dev, m_max, 2))
    obs_w = np.zeros((n_dev, m_max, 2, 2))
    obs_valid = np.zeros((n_dev, m_max), bool)
    lm_starts = np.zeros((n_dev, per), np.int32)
    lm_ends = np.zeros((n_dev, per), np.int32)
    pe_l, pf_l, flat_l, ps_l, pn_l = [], [], [], [], []
    for s in range(n_dev):
        a, b = int(bounds[s]), int(bounds[s + 1])
        k = b - a
        loc = (ol[a:b] - s * per).astype(np.int32)
        obs_cam[s, :k] = oc[a:b]
        obs_lm[s, :k] = loc
        obs_uv[s, :k] = uv[a:b]
        obs_w[s, :k] = info[a:b]
        obs_valid[s, :k] = True
        lm_starts[s] = np.searchsorted(loc, np.arange(per))
        lm_ends[s] = np.searchsorted(loc, np.arange(per) + 1)
        # observation pairs per local landmark
        pe, pf = [], []
        st, en = lm_starts[s], lm_ends[s]
        for l in range(per):
            idx = np.arange(st[l], en[l])
            if len(idx) == 0:
                continue
            E, F = np.meshgrid(idx, idx, indexing="ij")
            pe.append(E.ravel())
            pf.append(F.ravel())
        pe = np.concatenate(pe) if pe else np.zeros(0, np.int64)
        pf = np.concatenate(pf) if pf else np.zeros(0, np.int64)
        flat = oc[a:b][pe] * n_c + oc[a:b][pf] if len(pe) else np.zeros(0, np.int64)
        po = np.argsort(flat, kind="stable")
        pe, pf, flat = pe[po], pf[po], flat[po]
        distinct, starts = np.unique(flat, return_index=True)
        ends = np.concatenate([starts[1:], [len(flat)]]) if len(starts) else starts
        pe_l.append(pe)
        pf_l.append(pf)
        flat_l.append(distinct)
        ps_l.append(starts)
        pn_l.append(ends)
    p_max = max(1, max(len(x) for x in pe_l))
    d_max = max(1, max(len(x) for x in flat_l))
    pair_e = np.zeros((n_dev, p_max), np.int32)
    pair_f = np.zeros((n_dev, p_max), np.int32)
    pair_flat = np.full((n_dev, d_max), n_c * n_c, np.int32)  # pad -> dump slot
    pair_starts = np.zeros((n_dev, d_max), np.int32)
    pair_ends = np.zeros((n_dev, d_max), np.int32)
    for s in range(n_dev):
        pair_e[s, : len(pe_l[s])] = pe_l[s]
        pair_f[s, : len(pf_l[s])] = pf_l[s]
        pair_flat[s, : len(flat_l[s])] = flat_l[s]
        pair_starts[s, : len(ps_l[s])] = ps_l[s]
        pair_ends[s, : len(pn_l[s])] = pn_l[s]

    shards = BigBAShards(
        jnp.asarray(cam_states),
        jnp.asarray(lm_states.reshape(n_dev, per, 3)),
        jnp.asarray(lm_valid.reshape(n_dev, per)),
        jnp.asarray(obs_cam),
        jnp.asarray(obs_lm),
        jnp.asarray(obs_uv),
        jnp.asarray(obs_w),
        jnp.asarray(obs_valid),
        jnp.asarray(lm_starts),
        jnp.asarray(lm_ends),
        jnp.asarray(pair_e),
        jnp.asarray(pair_f),
        jnp.asarray(pair_flat),
        jnp.asarray(pair_starts),
        jnp.asarray(pair_ends),
        int(n_c),
        int(per),
        int(anchor_cam),
        int(anchor_lm),
    )
    spec = _big_specs(axis)
    leaves, treedef = jax.tree_util.tree_flatten(shards)
    spec_leaves = jax.tree_util.tree_flatten(spec)[0]
    placed = [
        jax.device_put(x, NamedSharding(mesh, s)) for x, s in zip(leaves, spec_leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, placed)


@functools.lru_cache(maxsize=None)
def _big_step_fn(mesh: Mesh, axis: str, n_c: int, per: int, anchor_cam: int,
                 anchor_lm: int):
    """Compiled-step cache: one jitted shard_map per (mesh, problem statics);
    jit handles shape-based retraces for the sharded arrays."""
    spec = _big_specs(axis, n_c, per, anchor_cam, anchor_lm)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, P()),
        out_specs=(P(), P(axis), P(), P(), P()),
        check_vma=False,
    )
    def step(sh: BigBAShards, alpha):
        lm_states = sh.lm_states[0]  # (per, 3) local block
        obs_cam = sh.obs_cam[0]
        obs_lm = sh.obs_lm[0]
        valid = sh.obs_valid[0]
        W = sh.obs_w[0]  # zero on padding
        shard_id = jax.lax.axis_index(axis)

        r, Jp, Jc = jax.vmap(_p2c_residual_jacs)(
            lm_states[obs_lm], sh.cam_states[obs_cam], sh.obs_uv[0]
        )
        # padding obs can produce NaN jacobians (degenerate geometry): mask out
        r = jnp.where(valid[:, None], r, 0.0)
        Jp = jnp.where(valid[:, None, None], Jp, 0.0)
        Jc = jnp.where(valid[:, None, None], Jc, 0.0)
        chi2 = jax.lax.psum(jnp.sum(jnp.einsum("ei,eij,ej->e", r, W, r)), axis)

        WJc = jnp.einsum("eij,ejk->eik", W, Jc)
        WJp = jnp.einsum("eij,ejk->eik", W, Jp)

        # landmark blocks + rhs: sorted segments over local obs
        ls, le = sh.lm_starts[0], sh.lm_ends[0]
        D = _segsum(jnp.einsum("eij,eik->ejk", Jp, WJp), ls, le)
        g_l = _segsum(jnp.einsum("eij,ei->ej", WJp, r), ls, le)
        D = D + alpha * jnp.eye(3)
        if sh.anchor_lm >= 0:
            loc = sh.anchor_lm - shard_id * per
            mine = jnp.logical_and(loc >= 0, loc < per)
            D = D.at[jnp.clip(loc, 0, per - 1)].add(
                jnp.where(mine, 1.0, 0.0) * jnp.eye(3)
            )
        D = jnp.where(sh.lm_valid[0][:, None, None], D, jnp.eye(3)[None])
        Dinv = _inv3(D)

        # camera block-diagonal partials (scatter-add over local obs)
        Hcc_e = jnp.einsum("eij,eik->ejk", Jc, WJc)
        gc_e = jnp.einsum("eij,ei->ej", WJc, r)
        Hcc_diag = jax.ops.segment_sum(Hcc_e, obs_cam, num_segments=n_c)
        g_c = jax.ops.segment_sum(gc_e, obs_cam, num_segments=n_c)

        # couplings + pair-reduced SC mass
        B = jnp.einsum("eij,eik->ejk", Jc, WJp)  # (m, 6, 3)
        BD = jnp.einsum("eij,ejk->eik", B, Dinv[obs_lm])
        prod = jnp.einsum(
            "eij,ekj->eik", BD[sh.pair_e[0]], B[sh.pair_f[0]]
        )
        pair_sums = _segsum(prod, sh.pair_starts[0], sh.pair_ends[0])
        SC_flat = jnp.zeros((n_c * n_c + 1, 6, 6))
        SC_flat = SC_flat.at[sh.pair_flat[0]].add(
            -pair_sums, indices_are_sorted=True
        )
        SC_part = SC_flat[: n_c * n_c].reshape(n_c, n_c, 6, 6)
        diag_idx = jnp.arange(n_c)
        SC_part = SC_part.at[diag_idx, diag_idx].add(Hcc_diag)
        SC_part = jnp.transpose(SC_part, (0, 2, 1, 3)).reshape(n_c * 6, n_c * 6)

        r2_e = jnp.einsum("eij,ej->ei", BD, g_l[obs_lm])
        r2 = jax.ops.segment_sum(r2_e, obs_cam, num_segments=n_c)
        rhs_part = -(g_c - r2).reshape(-1)

        SC = jax.lax.psum(SC_part, axis)
        rhs = jax.lax.psum(rhs_part, axis)

        SC = SC + alpha * jnp.eye(n_c * 6)
        if sh.anchor_cam >= 0:
            aidx = sh.anchor_cam * 6 + jnp.arange(6)
            SC = SC.at[aidx, aidx].add(1.0)

        L = jax.lax.linalg.cholesky(SC, symmetrize_input=True)
        y = jax.lax.linalg.triangular_solve(
            L, rhs[:, None], left_side=True, lower=True
        )
        dx_c = jax.lax.linalg.triangular_solve(
            L, y, left_side=True, lower=True, transpose_a=True
        )[:, 0]

        # landmark back-substitution (shard-local)
        dxc_blocks = dx_c.reshape(n_c, 6)
        bt_e = jnp.einsum("eij,ei->ej", B, dxc_blocks[obs_cam])
        BT = _segsum(bt_e, ls, le)
        dx_l = jnp.einsum("lij,lj->li", Dinv, -g_l - BT)
        dx_l = jnp.where(sh.lm_valid[0][:, None], dx_l, 0.0)

        new_cams = jax.vmap(
            lambda s, d: jnp.concatenate([se3.plus(s[0:6], d), s[6:11]])
        )(sh.cam_states, dxc_blocks)
        new_lms = (lm_states + dx_l)[None]

        sq = jnp.dot(dx_c, dx_c) + jax.lax.psum(jnp.sum(dx_l * dx_l), axis)
        # full-gradient LM gain denominator: the camera gradient must be the
        # psum-ed total; the landmark part stays shard-local
        g_c_tot = jax.lax.psum(g_c, axis)
        g_dot = jnp.sum(dxc_blocks * g_c_tot) + jax.lax.psum(
            jnp.sum(dx_l * g_l), axis
        )
        denom = alpha * sq - g_dot
        return new_cams, new_lms, jnp.sqrt(sq), chi2, denom

    return jax.jit(step)


def distributed_big_ba_step(shards: BigBAShards, mesh: Mesh, alpha, axis: str = "lm"):
    """One damped (LM) BA iteration, observation-driven, landmark-sharded.

    Per shard: local landmark blocks + pair-reduced SC contribution; ONE psum
    of (SC, rhs, chi2) over the mesh; replicated dense SC Cholesky; shard-local
    landmark back-substitution.  Identical math to
    linear/ba_schur.py:ba_schur_lm_step — tested equal on the virtual mesh.
    Returns (new_cams (replicated), new_lms (sharded), dx_norm, chi2, denom).
    """
    step = _big_step_fn(
        mesh, axis, shards.n_c, shards.per, shards.anchor_cam, shards.anchor_lm
    )
    return step(shards, jnp.asarray(alpha, jnp.float64))


class DistributedBigBASolver:
    """LM driver over the landmark-sharded observation-driven Schur step —
    the multi-chip Venice-class solver (SURVEY.md §2.12 'distributed Schur
    reduction'; new capability vs the single-process reference)."""

    def __init__(self, system, mesh: Mesh, axis: str = "lm", verbose: bool = False,
                 tau: float = 1e-3):
        self.system = system
        self.mesh = mesh
        self.axis = axis
        self.verbose = verbose
        self.tau = tau
        self.shards = None

    def _prepare(self):
        if self.shards is None:
            self.shards = build_big_ba_shards(self.system, self.mesh, self.axis)
        return self.shards

    def optimize(self, max_iterations: int = 5, min_dx_norm: float = 0.01) -> int:
        sh = self._prepare()
        alpha = self.tau * 1e3
        nu = 2.0
        _, _, _, chi2, _ = distributed_big_ba_step(sh, self.mesh, 0.0, self.axis)
        last_error = float(chi2)
        applied = 0
        for _ in range(max_iterations):
            nc, nl, dxn, chi2, denom = distributed_big_ba_step(
                sh, self.mesh, alpha, self.axis
            )
            if not np.isfinite(float(dxn)) or float(dxn) <= min_dx_norm:
                break
            cand = sh._replace(cam_states=nc, lm_states=nl)
            _, _, _, chi2_new, _ = distributed_big_ba_step(
                cand, self.mesh, alpha, self.axis
            )
            f_error = float(chi2_new)
            rho = (last_error - f_error) / max(float(denom), 1e-300)
            if rho > 0:
                alpha *= max(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
                nu = 2.0
                sh = cand
                last_error = f_error
                applied += 1
                if self.verbose:
                    print(f"DistBigBA: accepted chi2={f_error:.2f} alpha={alpha:.2e}")
            else:
                alpha *= nu
                nu *= 2.0
                if self.verbose:
                    print(f"DistBigBA: rejected chi2={f_error:.2f} alpha={alpha:.2e}")
        self.shards = sh
        # write back
        cam_ids = sorted(v for v, (t, _) in self.system.vertex_index.items() if t == "cam")
        lm_ids = sorted(v for v, (t, _) in self.system.vertex_index.items() if t == "xyz")
        cams_np = np.asarray(sh.cam_states)
        lms_np = np.asarray(sh.lm_states).reshape(-1, 3)
        for i, v in enumerate(cam_ids):
            self.system.set_vertex_state(v, cams_np[i])
        for i, v in enumerate(lm_ids):
            self.system.set_vertex_state(v, lms_np[i])
        return applied


def distributed_ba_lm_step(shards: BAShards, mesh: Mesh, alpha, axis: str = "lm"):
    """One damped (LM) BA iteration with sharded Schur reduction.

    Returns (new_cam_states (replicated), new_lm_states (sharded), dx_norm,
    chi2, denom) — denom is the LM gain-ratio denominator dx.(alpha dx - g).
    """
    n_c = shards.cam_states.shape[0]
    spec = BAShards(
        P(), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
        shards.anchor_cam, shards.anchor_lm,
    )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, P()),
        out_specs=(P(), P(axis), P(), P(), P()),
        check_vma=False,
    )
    def step(sh: BAShards, alpha):
        per = sh.lm_states.shape[0]  # local landmarks
        shard_id = jax.lax.axis_index(axis)
        lm_local = sh.obs_lm - shard_id * per  # global -> local index

        r, Jp, Jc = jax.vmap(_p2c_residual_jacs)(
            sh.lm_states[lm_local], sh.cam_states[sh.obs_cam], sh.obs_uv
        )
        W = jnp.where(sh.obs_valid[:, None, None], sh.obs_info, 0.0)
        chi2 = jax.lax.psum(jnp.sum(jnp.einsum("ei,eij,ej->e", r, W, r)), axis)

        WJc = jnp.einsum("eij,ejk->eik", W, Jc)
        WJp = jnp.einsum("eij,ejk->eik", W, Jp)

        # camera system partials (6x6 blocks scattered into dense H_cc)
        Hcc = jnp.zeros((n_c * 6, n_c * 6))
        rows = sh.obs_cam[:, None] * 6 + jnp.arange(6)[None, :]
        Hcc_blk = jnp.einsum("eij,eik->ejk", Jc, WJc)
        Hcc = Hcc.at[rows[:, :, None], rows[:, None, :]].add(Hcc_blk)
        g_c = jnp.zeros((n_c * 6,))
        g_c = g_c.at[rows].add(jnp.einsum("eij,ei->ej", WJc, r))

        # landmark blocks (local segment-sum by landmark)
        D = jax.ops.segment_sum(
            jnp.einsum("eij,eik->ejk", Jp, WJp), lm_local, num_segments=per
        )
        g_l = jax.ops.segment_sum(
            jnp.einsum("eij,ei->ej", WJp, r), lm_local, num_segments=per
        )
        D = D + alpha * jnp.eye(3)
        if sh.anchor_lm >= 0:
            # gauge anchor on a landmark: +I on its diagonal block (local)
            loc = sh.anchor_lm - shard_id * per
            mine = jnp.logical_and(loc >= 0, loc < per)
            D = D.at[jnp.clip(loc, 0, per - 1)].add(
                jnp.where(mine, 1.0, 0.0) * jnp.eye(3)
            )
        D = jnp.where(
            sh.lm_valid[:, None, None], D, jnp.eye(3)[None]
        )  # padding landmarks: identity
        Dinv = _inv3(D)

        # SC subtraction: for each observation pair (same landmark), the
        # coupling B_e = J_c^T W J_p (6x3).  SC -= B_i Dinv B_j^T for all
        # pairs sharing a landmark: done as (sum_e gathered) per landmark via
        # U_l = segment stack — use scatter over per-landmark accumulators
        B = jnp.einsum("eij,eik->ejk", Jc, WJp)  # (M, 6, 3)
        BD = jnp.einsum("eij,ejk->eik", B, Dinv[lm_local])  # (M, 6, 3)
        # SC -= sum over landmark l of U_l Dinv U_l^T; expand over obs pairs:
        # for obs e (cam a, lm l) and obs f (cam b, lm l):
        #   SC[a, b] -= B_e Dinv_l B_f^T = BD_e @ B_f^T
        # realize with a dense per-landmark camera-stacked accumulator:
        # T_l = sum_e (rows_e scattered BD_e) — (per, n_c*6, 3) would be big;
        # instead accumulate via segment over (l, cam-slot) pairs using a
        # (per, 6*n_c, 3) tensor only when n_c is small, else via gather
        # pairs.  Here: T = scatter BD by (lm, cam) then contract with the
        # same scatter of B.
        T_BD = jnp.zeros((per, n_c * 6, 3))
        T_B = jnp.zeros((per, n_c * 6, 3))
        T_BD = T_BD.at[lm_local[:, None], rows, :].add(
            jnp.where(sh.obs_valid[:, None, None], BD, 0.0)
        )
        T_B = T_B.at[lm_local[:, None], rows, :].add(
            jnp.where(sh.obs_valid[:, None, None], B, 0.0)
        )
        SC_part = Hcc - jnp.einsum("lad,lbd->ab", T_BD, T_B)
        rhs_part = g_c - jnp.einsum("lad,ld->a", T_BD, g_l)

        SC = jax.lax.psum(SC_part, axis)
        rhs = jax.lax.psum(rhs_part, axis)

        # gauge anchor + LM damping on the camera diagonal
        SC = SC + alpha * jnp.eye(n_c * 6)
        if sh.anchor_cam >= 0:
            aidx = sh.anchor_cam * 6 + jnp.arange(6)
            SC = SC.at[aidx, aidx].add(1.0)

        dx_c = solve_spd(SC, -rhs)
        # landmarks back-substitution (local)
        BTdx = jnp.einsum("lad,a->ld", T_B, dx_c)
        dx_l = jnp.einsum("lde,le->ld", Dinv, -g_l - BTdx)
        dx_l = jnp.where(sh.lm_valid[:, None], dx_l, 0.0)

        # updates
        new_cams = jax.vmap(
            lambda s, d: jnp.concatenate([se3.plus(s[0:6], d), s[6:11]])
        )(sh.cam_states, dx_c.reshape(n_c, 6))
        new_lms = sh.lm_states + dx_l

        sq = jnp.dot(dx_c, dx_c) + jax.lax.psum(jnp.sum(dx_l * dx_l), axis)
        dx_norm = jnp.sqrt(sq)
        g_dot = jnp.dot(dx_c, rhs) + jax.lax.psum(jnp.sum(dx_l * g_l), axis)
        denom = alpha * sq - g_dot
        return new_cams, new_lms, dx_norm, chi2, denom

    return step(shards, jnp.asarray(alpha, jnp.float64))


# ------------------------------------------------------- distributed marginals


def build_lm_pair_plan(shards: BigBAShards):
    """Host symbolic phase for distributed marginals: WITHIN-landmark
    observation pairs (local indices), segmented per landmark.  Returns
    sharded (n_dev, ...) arrays (qe, qf, qs, qn) where landmark slot l of a
    shard owns pair rows [qs[l], qs[l]+qn[l])."""
    ls = np.asarray(shards.lm_starts).astype(np.int64)
    le = np.asarray(shards.lm_ends).astype(np.int64)
    n_dev, per = ls.shape
    deg = le - ls
    QN = deg * deg  # ordered pairs (e, f) per landmark, e-major
    QS = np.cumsum(QN, axis=1) - QN
    q_max = max(1, int(QN.sum(axis=1).max()))
    QE = np.zeros((n_dev, q_max), np.int32)
    QF = np.zeros((n_dev, q_max), np.int32)
    QV = np.zeros((n_dev, q_max), bool)
    for d in range(n_dev):
        n = int(QN[d].sum())
        lm = np.repeat(np.arange(per), QN[d])
        t = np.arange(n) - QS[d][lm]  # pair rank within its landmark
        QE[d, :n] = ls[d][lm] + t // deg[d][lm]
        QF[d, :n] = ls[d][lm] + t % deg[d][lm]
        QV[d, :n] = True
    QS = QS.astype(np.int32)
    QN = QN.astype(np.int32)
    return (jnp.asarray(QE), jnp.asarray(QF), jnp.asarray(QV),
            jnp.asarray(QS), jnp.asarray(QS + QN))


@functools.lru_cache(maxsize=16)
def _big_marginals_fn(mesh: Mesh, axis: str, n_c: int, per: int,
                      anchor_cam: int, anchor_lm: int):
    spec = _big_specs(axis, n_c, per, anchor_cam, anchor_lm)
    sh_ = P(axis)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(spec, (sh_, sh_, sh_, sh_, sh_), P()),
        out_specs=(P(), P(axis)),
        check_vma=False,
    )
    def marg(sh: BigBAShards, qplan, alpha):
        qe, qf, qv, qls, qle = (a[0] for a in qplan)
        lm_states = sh.lm_states[0]
        obs_cam = sh.obs_cam[0]
        obs_lm = sh.obs_lm[0]
        valid = sh.obs_valid[0]
        W = sh.obs_w[0]
        shard_id = jax.lax.axis_index(axis)

        r, Jp, Jc = jax.vmap(_p2c_residual_jacs)(
            lm_states[obs_lm], sh.cam_states[obs_cam], sh.obs_uv[0]
        )
        Jp = jnp.where(valid[:, None, None], Jp, 0.0)
        Jc = jnp.where(valid[:, None, None], Jc, 0.0)
        WJc = jnp.einsum("eij,ejk->eik", W, Jc)
        WJp = jnp.einsum("eij,ejk->eik", W, Jp)

        ls, le = sh.lm_starts[0], sh.lm_ends[0]
        D = _segsum(jnp.einsum("eij,eik->ejk", Jp, WJp), ls, le)
        D = D + alpha * jnp.eye(3)
        if sh.anchor_lm >= 0:
            loc = sh.anchor_lm - shard_id * per
            mine = jnp.logical_and(loc >= 0, loc < per)
            D = D.at[jnp.clip(loc, 0, per - 1)].add(
                jnp.where(mine, 1.0, 0.0) * jnp.eye(3)
            )
        D = jnp.where(sh.lm_valid[0][:, None, None], D, jnp.eye(3)[None])
        Dinv = _inv3(D)

        Hcc_e = jnp.einsum("eij,eik->ejk", Jc, WJc)
        Hcc_diag = jax.ops.segment_sum(Hcc_e, obs_cam, num_segments=n_c)

        B = jnp.einsum("eij,eik->ejk", Jc, WJp)  # (m, 6, 3)
        BD = jnp.einsum("eij,ejk->eik", B, Dinv[obs_lm])
        prod = jnp.einsum("eij,ekj->eik", BD[sh.pair_e[0]], B[sh.pair_f[0]])
        pair_sums = _segsum(prod, sh.pair_starts[0], sh.pair_ends[0])
        SC_flat = jnp.zeros((n_c * n_c + 1, 6, 6))
        SC_flat = SC_flat.at[sh.pair_flat[0]].add(
            -pair_sums, indices_are_sorted=True
        )
        SC_part = SC_flat[: n_c * n_c].reshape(n_c, n_c, 6, 6)
        diag_idx = jnp.arange(n_c)
        SC_part = SC_part.at[diag_idx, diag_idx].add(Hcc_diag)
        SC_part = jnp.transpose(SC_part, (0, 2, 1, 3)).reshape(n_c * 6, n_c * 6)
        SC = jax.lax.psum(SC_part, axis)
        SC = SC + alpha * jnp.eye(n_c * 6)
        if sh.anchor_cam >= 0:
            aidx = sh.anchor_cam * 6 + jnp.arange(6)
            SC = SC.at[aidx, aidx].add(1.0)

        # replicated camera covariance: SC^-1 via Cholesky
        L = jax.lax.linalg.cholesky(SC, symmetrize_input=True)
        eye = jnp.eye(n_c * 6)
        Y = jax.lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
        Scc = Y.T @ Y
        cam_cov = jnp.transpose(
            Scc.reshape(n_c, 6, n_c, 6), (0, 2, 1, 3)
        )[diag_idx, diag_idx]

        # landmark marginals (shard-local): Dinv + Dinv U^T Scc U Dinv over
        # within-landmark observation pairs (BAMarginals.h:43 shape)
        Scc_b = jnp.transpose(Scc.reshape(n_c, 6, n_c, 6), (0, 2, 1, 3))
        G = Scc_b[obs_cam[qe], obs_cam[qf]]  # (q, 6, 6)
        Bq_e = B[qe]
        Bq_f = B[qf]
        prod_q = jnp.einsum("qia,qij,qjb->qab", Bq_e, G, Bq_f)
        prod_q = jnp.where(qv[:, None, None], prod_q, 0.0)
        M = _segsum(prod_q, qls, qle)  # (per, 3, 3)
        lm_cov = Dinv + jnp.einsum("lij,ljk,lkm->lim", Dinv, M, Dinv)
        lm_cov = jnp.where(sh.lm_valid[0][:, None, None], lm_cov, 0.0)
        return cam_cov, lm_cov[None]

    return jax.jit(marg)


def distributed_big_ba_marginals(shards: BigBAShards, mesh: Mesh, alpha=0.0,
                                 axis: str = "lm"):
    """Mesh-parallel block-diagonal marginal recovery (SURVEY §2.12 stage-8
    'distributed marginals'; single-device reference:
    marginals/ba_marginals.py:schur_marginals, BAMarginals.h:43):

      camera blocks  — diag of SC^-1, SC psum-reduced over the mesh and
                       factored replicated (one collective);
      landmark blocks — Sigma_ll = D^-1 + D^-1 U^T Sigma_cc U D^-1,
                       recovered SHARD-LOCALLY from the local observations.

    Returns (cam_cov (n_c, 6, 6) replicated, lm_cov (n_dev, per, 3, 3)
    sharded on the mesh axis)."""
    qplan = build_lm_pair_plan(shards)
    fn = _big_marginals_fn(
        mesh, axis, shards.n_c, shards.per, shards.anchor_cam, shards.anchor_lm
    )
    return fn(shards, qplan, jnp.asarray(alpha, jnp.float64))
