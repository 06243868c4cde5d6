#!/usr/bin/env python
"""Standalone kernel benchmark CLI — the `-rmb` (BlockBench) analog.

Reference: include/slam_app/BlockBench.h:122,2224 (UFLSMC block-matrix
benchmarks producing per-operation timing tables).  Here the hot device
kernels are timed on the current backend and written as CSV:

    python scripts/kernel_bench.py [--out kernel_bench.csv] [--cpu]

Covered kernels: the batched frame Cholesky two ways at the v3 dense-frame
shapes of sphere2500 (``chol_batched``: XLA's batched Cholesky with the
frozen-pivot check, against ``_chol_panel``: the 8-wide panel loop), alone
and inside one dense-frame v3 LM step; batched TRSM; grouped segment
reductions at Venice scale classes; small-block inverse; the v3 fused GN
iteration; device block-sparse products.
"""

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _time(fn, *args, warmup=1, reps=5):
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="kernel_bench.csv")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import slampp_tpu  # noqa: F401
    import numpy as np
    import jax.numpy as jnp

    d0 = jax.devices()[0]
    dev = f"{d0.platform}:{d0.device_kind}"
    rows = []

    def rec(kernel, shape, dtype, secs, flops=None):
        r = {
            "kernel": kernel, "shape": shape, "dtype": dtype,
            "time_ms": round(secs * 1e3, 4),
            "gflops": round(flops / secs / 1e9, 2) if flops else "",
            "device": dev,
        }
        rows.append(r)
        print(",".join(str(r[k]) for k in r), flush=True)

    from slampp_tpu.ops.dense_kernels import (
        chol_batched, trsm_lower_batched,
    )

    rng = np.random.default_rng(0)
    _chol_variants(rec, rng, args.reps)
    for dtype in (jnp.float32, jnp.float64):
        for K, M in ((64, 64), (16, 256), (4, 1024)):
            G = rng.normal(size=(K, M, M))
            A = jnp.asarray(G @ G.transpose(0, 2, 1) + M * np.eye(M), dtype)
            f = jax.jit(lambda a: chol_batched(a, clamp=0.0))
            rec("chol_batched", f"{K}x{M}x{M}", A.dtype.name,
                _time(f, A, reps=args.reps), flops=K * M**3 / 3)
            L = f(A)
            B = jnp.asarray(rng.normal(size=(K, M, 128)), dtype)
            f2 = jax.jit(trsm_lower_batched)
            rec("trsm_lower_batched", f"{K}x{M}x128", A.dtype.name,
                _time(f2, L, B, reps=args.reps), flops=K * M * M * 128)

    # small-block inverse at Venice landmark scale
    for n in (100_000, 1_000_000):
        G = rng.normal(size=(n, 3, 3))
        A = jnp.asarray(
            (G @ G.transpose(0, 2, 1) + 3 * np.eye(3)).transpose(1, 2, 0)
        )
        from slampp_tpu.linear.ba_schur import _inv3_last

        f = jax.jit(_inv3_last)
        rec("inv3_last", f"3x3x{n}", A.dtype.name,
            _time(f, A, reps=args.reps), flops=n * 54)

    # grouped segment reduction, Venice shape class (m obs -> n_l landmarks)
    from slampp_tpu.ops.segments import (
        grouped_segsum_last, plan_grouped_segments,
    )

    for m, n_seg in ((1_000_000, 100_000), (1_000_000, 871)):
        bounds = np.sort(rng.integers(0, m, n_seg - 1))
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [m]])
        plan = plan_grouped_segments(starts, ends, m)
        data = jnp.asarray(rng.normal(size=(9, m)))
        f = jax.jit(lambda d: grouped_segsum_last(d, plan))
        rec("grouped_segsum_last", f"9x{m}->{n_seg}", data.dtype.name,
            _time(f, data, reps=args.reps))

    # v3 fused GN iteration on a manhattan-class pose graph
    import tempfile

    from slampp_tpu.io.datasets import make_manhattan
    from slampp_tpu.io.parser import build_system, parse_file
    from slampp_tpu.linear.partitioned import PartitionedSolver

    text, _ = make_manhattan(n_poses=3500, loop_prob=0.1, seed=0)
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as fh:
        fh.write(text)
        path = fh.name
    try:
        system = build_system(parse_file(path))
    finally:
        os.unlink(path)
    ps = PartitionedSolver(system, target=64, mixed_precision=True,
                           refine_iters=0)
    ps.symbolic()
    graph = system.snapshot()
    t = _time(lambda g: ps.optimize_fused(g, n_iters=5)[3], graph,
              reps=args.reps)
    rec("v3_fused_gn5_manhattan3500", "3500 poses", "mixed", t)

    # general device block-sparse products (BlockMatrix.h:2662,2744 role)
    import numpy as _np

    from slampp_tpu.core.bsm import BlockSparseMatrix

    rng = _np.random.default_rng(0)
    nbr, nbc, bs, nnzb = 2000, 1500, 3, 20000
    A = BlockSparseMatrix(nbr, nbc, bs, bs)
    for _ in range(nnzb):
        A.append_block(int(rng.integers(nbr)), int(rng.integers(nbc)),
                       rng.normal(size=(bs, bs)))
    t = _time(lambda _x: A.ata_device().nnz_blocks, 0, reps=max(2, args.reps // 2))
    rec("bsm_ata_device", f"{nnzb} blocks {bs}x{bs}", "f64", t)
    B = BlockSparseMatrix(nbc, nbr, bs, bs)
    for _ in range(nnzb):
        B.append_block(int(rng.integers(nbc)), int(rng.integers(nbr)),
                       rng.normal(size=(bs, bs)))
    t = _time(lambda _x: A.multiply_device(B).nnz_blocks, 0,
              reps=max(2, args.reps // 2))
    rec("bsm_gemm_device", f"{nnzb}x{nnzb} blocks {bs}x{bs}", "f64", t)

    _write(args.out, rows)


def _write(path, rows):
    with open(path, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {path} ({len(rows)} rows)")


def _chol_variants(rec, rng, reps):
    """(a) ``_chol_panel`` vs (b) ``chol_batched`` at sphere2500's dense
    frames (K part frames of M, one Ms separator frame), f32 and f64, then
    one dense-frame v3 LM step (mixed and f64) with each in place."""
    import tempfile

    import jax
    import jax.numpy as jnp
    import numpy as np

    from slampp_tpu.io.datasets import make_sphere
    from slampp_tpu.io.parser import build_system, parse_file
    from slampp_tpu.linear.partitioned import PartitionedSolver
    from slampp_tpu.ops import dense_kernels as dk

    text, _ = make_sphere(n_poses=2500, seed=0)
    with tempfile.NamedTemporaryFile("w", suffix=".g2o", delete=False) as fh:
        fh.write(text)
        path = fh.name
    try:
        system = build_system(parse_file(path))
    finally:
        os.unlink(path)
    probe = PartitionedSolver(system)
    probe.symbolic()
    p = probe.plan
    variants = {"b_xla_chol": dk.chol_batched,
                "a_panel_loop": lambda A, clamp=1e-8: dk._chol_panel(A, clamp)}
    for K, M in ((p.K, p.M), (1, p.Ms)):
        G = rng.normal(size=(K, M, M))
        A64 = G @ G.transpose(0, 2, 1) / M + np.eye(M)
        for dtype in (jnp.float32, jnp.float64):
            A = jnp.asarray(A64, dtype)
            for name, fn in variants.items():
                f = jax.jit(fn)
                rec(f"chol_{name}", f"{K}x{M}x{M}", A.dtype.name,
                    _time(f, A, reps=reps), flops=K * M**3 / 3)

    graph = system.snapshot()
    keep = dk.chol_batched
    try:
        for name, fn in variants.items():
            dk.chol_batched = fn  # traced into the fresh solver's step
            for mixed in (True, False):
                ps = PartitionedSolver(system, refine_iters=2, mixed_precision=mixed)
                ps.symbolic()
                assert ps.plan.ch_ok == 0
                t = _time(lambda g: ps.damped_step(g, 1e-3)[2], graph, reps=reps)
                rec(f"v3_dense_frame_lm_step_{name}", "sphere2500",
                    "mixed" if mixed else "f64", t)
    finally:
        dk.chol_batched = keep


if __name__ == "__main__":
    main()
