#!/usr/bin/env python
"""Driver benchmark: Venice-871 BA + Manhattan-3500 pose-graph GN +
incremental windowed solve, on one GPU.

Prints one JSON line per metric; the LAST line is the primary north-star
metric (Manhattan-3500 GN iterations/sec, BASELINE.md row 2).

Process model: the parent runs each benchmark in a SUBPROCESS and re-emits
its JSON lines.  A device fault in one benchmark therefore cannot take
down the other metrics or the parent's exit code.  The parent never imports
JAX and runs one child at a time, so only one process holds the card.

Metrics:
  * venice871_ba_iters_per_sec — observation-driven Schur LM iterations/sec
    at FULL Venice scale (871 cams, 110k landmarks, ~1.1M observations;
    real accept/reject LM loop).  vs_baseline is the REFERENCE BINARY
    compiled from /root/reference and timed on this machine's CPU on the
    same generated scene (scripts/build_reference.sh, BENCH_NOTES.md).
  * manhattan3500_gn_iters_per_sec — batch GN on a 3500-pose synthetic
    Manhattan world via the partitioned (v3) solver; vs_baseline against
    the same-machine reference binary (published ICRA'13 ratio in extra).
  * manhattan3500_incremental_steps_per_sec — windowed incremental solve
    (every-vertex solve cadence, the -fL role) on the same dataset.

The reference datasets are not downloadable here (zero egress), so all
benchmarks run md5-stable synthetic datasets of the same size class; chi2
semantics are validated against the reference binary in
scripts/ref_parity.py.
"""

import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _child_setup():
    """x64, the compile cache, and the device check: a child that finds no
    GPU exits non-zero, unless BENCH_PLATFORM=cpu asks for the CPU (the CPU
    smoke tier runs every child that way)."""
    import jax

    want = os.environ.get("BENCH_PLATFORM")
    if want:
        jax.config.update("jax_platforms", want)
    import slampp_tpu  # noqa: F401  (x64 on)
    from slampp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    found = jax.devices()[0].platform
    if found != "gpu" and want != "cpu":
        sys.exit(f"bench child needs the GPU, found platform {found!r} "
                 "(BENCH_PLATFORM=cpu runs it on the CPU)")
    return jax


def _device(jax):
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


# --------------------------------------------------------------------- venice


def bench_venice():
    jax = _child_setup()
    import numpy as np  # noqa: F401

    from slampp_tpu.io.datasets import make_venice_ba_arrays
    from slampp_tpu.linear.ba_schur import BigBASolver

    n_cams = int(os.environ.get("BENCH_VENICE_CAMS", "871"))
    n_points = int(os.environ.get("BENCH_VENICE_POINTS", "110000"))
    # mean track length 10 -> ~1.1M observations (full venice871 scale,
    # unit_tests.sh:182-188)
    mean_track = int(os.environ.get("BENCH_VENICE_TRACK", "10"))
    t_wall0 = time.perf_counter()
    t0 = time.perf_counter()
    jax.block_until_ready(jax.numpy.zeros(8) + 1)
    t_backend = time.perf_counter() - t0
    t0 = time.perf_counter()
    cams, lms, oc, ol, uv, info, _ = make_venice_ba_arrays(
        n_cams=n_cams, n_points=n_points, mean_track=mean_track, seed=0
    )
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = BigBASolver.from_arrays(cams, lms, oc, ol, uv, info, sc_f64=False)
    t_sym = time.perf_counter() - t0

    # warm-up: ONE full step (compile) + chi2 fn
    solver._make_step()
    chi2_0 = float(solver._chi2_fn(solver.plan, solver._cams, solver._lms))
    t0 = time.perf_counter()
    solver._step(solver._cams, solver._lms, 1e-3)[2].block_until_ready()
    t_first = time.perf_counter() - t0

    # the REAL LM accept/reject loop (reference runs 5 LM iterations on
    # venice871; we time the same loop shape end-to-end, host logic included)
    n_lm = int(os.environ.get("BENCH_VENICE_ITERS", "5"))
    t0 = time.perf_counter()
    applied = solver.optimize(max_iterations=n_lm, min_dx_norm=0.0)
    dt = time.perf_counter() - t0
    iters_per_sec = n_lm / dt
    chi2_final = float(solver._chi2_fn(solver.plan, solver._cams, solver._lms))
    # end-to-end: dataset-in-hand to 5 accepted LM iterations' chi2,
    # INCLUDING symbolic + compile/warmup (the reference binary's ~61 s on
    # the old VM's CPU is measured the same way)
    t_end_to_end = time.perf_counter() - t_wall0 - t_gen

    # reference binary measured on this machine (scripts/build_reference.sh +
    # `slam_plus_plus -i venice_synth.g2o -us -nb`), same scene class:
    # 5 LM iterations in 60.99 s -> 0.0820 iter/s (BENCH_NOTES.md)
    ref_iters_per_sec = float(os.environ.get("BENCH_VENICE_REF_IPS", "0.0820"))

    _emit(
        {
            "metric": "venice871_ba_iters_per_sec",
            "value": round(iters_per_sec, 3),
            "unit": "iter/s",
            "vs_baseline": (
                round(iters_per_sec / ref_iters_per_sec, 3) if ref_iters_per_sec else None
            ),
            "extra": {
                "n_cams": n_cams,
                "n_points": n_points,
                "n_obs": int(len(oc)),
                "lm_iterations": n_lm,
                "lm_accepted": applied,
                "chi2_initial": round(chi2_0, 2),
                "chi2_final": round(chi2_final, 2),
                "first_step_s": round(t_first, 3),
                "symbolic_s": round(t_sym, 3),
                "backend_init_s": round(t_backend, 3),
                "gen_s": round(t_gen, 3),
                "time_to_chi2_end_to_end_s": round(t_end_to_end, 2),
                "ref_end_to_end_s": 60.99,
                "sc_pair_buckets": [
                    [int(b.seg_ids.shape[0]), int(getattr(b, "cap", 0) or b.idx.shape[1])]
                    for b in solver.plan.pair_grp.buckets
                ],
                "device": _device(jax),
            },
        }
    )


# ------------------------------------------------------------------ manhattan

# chi2 of the seed-0 BENCH_POSES=N Manhattan graphs after 5 GN iterations:
# f64 oracles (PartitionedSolver mixed_precision=False, CPU); 3500 is ALSO
# pinned by the compiled SLAM++ reference binary on the same file, 404.50
# (BENCH_NOTES.md) — the correctness pin for the mixed-precision path.
# 120/300 cover the CI smoke and verify tiers so chi2_ok is never None.
_MANHATTAN_F64_CHI2 = {120: 3.1722, 300: 3.8854, 3500: 404.504}

# The reference binary measured on THIS machine on the same synthetic
# manhattan3500 file: 5 iterations in 0.1625 s -> 30.8 iter/s (BENCH_NOTES.md;
# the ICRA'13 published 0.0419 s / 5 iters = 119.3 iter/s was the real
# manhattanOlson3500 on a 2013 desktop — dataset not downloadable here).
_REF_MEASURED_IPS = {3500: 30.8}
_REF_PUBLISHED_IPS = 5.0 / 0.0419


def _manhattan_system(n_poses):
    import tempfile

    from slampp_tpu.io.datasets import make_manhattan
    from slampp_tpu.io.parser import build_system, parse_file

    text, _ = make_manhattan(n_poses=n_poses, loop_prob=0.1, seed=0)
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(text)
        path = f.name
    try:
        return build_system(parse_file(path))
    finally:
        os.unlink(path)


def bench_manhattan():
    jax = _child_setup()
    import numpy as np

    from slampp_tpu.linear.partitioned import PartitionedSolver

    n_poses = int(os.environ.get("BENCH_POSES", "3500"))
    target = int(os.environ.get("BENCH_TARGET", "64"))
    refine = int(os.environ.get("BENCH_REFINE", "0"))
    system = _manhattan_system(n_poses)

    # backend init is its own phase, kept out of "symbolic"
    t0 = time.perf_counter()
    jax.block_until_ready(jax.numpy.zeros(8) + 1)
    t_backend = time.perf_counter() - t0

    ps = PartitionedSolver(
        system, target=target, mixed_precision=True, refine_iters=refine
    )
    t0 = time.perf_counter()
    ps.symbolic()
    t_symbolic = time.perf_counter() - t0

    graph = system.snapshot()

    # full 5-iteration batch solve in ONE fused program (reference
    # Optimize(5, ...) semantics); first call includes compile
    t0 = time.perf_counter()
    states, dxn, chi2_init, chi2_final = ps.optimize_fused(graph, n_iters=5)
    chi2_final = float(chi2_final)
    t_first = time.perf_counter() - t0

    # steady state: repeated fused-5 batches, one host sync at the end
    n_rep = 6
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = ps.optimize_fused(graph, n_iters=5)
    np.asarray(out[3])
    dt = time.perf_counter() - t0
    iters_per_sec = 5.0 * n_rep / dt

    expected = _MANHATTAN_F64_CHI2.get(n_poses)
    # small CI sizes converge to tiny chi2 where mixed-precision relative
    # error is proportionally larger; 2% still catches wrong-solve bugs
    tol = 5e-3 if n_poses >= 1000 else 2e-2
    chi2_ok = (
        abs(chi2_final - expected) / expected < tol if expected else None
    )

    # speed-of-light accounting: XLA cost analysis of the fused program
    flops = bytes_acc = None
    try:
        from slampp_tpu.linear import partitioned as _p

        key = ("v3fused", _p._plan_key(ps.block_plan), 5, refine,
               ps.damping_rel, True)
        fn = _p._step_cache.get(key)
        if fn is not None:
            ca = fn.lower(graph).compile().cost_analysis()
            if isinstance(ca, list):
                ca = ca[0] if ca else {}
            flops = float(ca.get("flops", float("nan")))
            bytes_acc = float(ca.get("bytes accessed", float("nan")))
    except Exception:
        pass

    extra = {
        "chi2_initial": round(float(chi2_init), 2),
        "chi2_final": round(chi2_final, 3),
        "chi2_f64_oracle": expected,
        "chi2_ok": chi2_ok,
        "first_solve_s": round(t_first, 3),
        "symbolic_s": round(t_symbolic, 3),
        "backend_init_s": round(t_backend, 3),
        "wall_to_first_chi2_s": round(t_backend + t_symbolic + t_first, 3),
        "n_poses": n_poses,
        "n_edges": system.n_edges,
        "solver": f"v3 partitioned target={target} refine={refine}",
        "device": _device(jax),
    }
    if flops and flops == flops:
        t_iter = 1.0 / iters_per_sec
        extra["flops_per_5iter"] = flops
        extra["achieved_gflops"] = round(flops / (5 * t_iter) / 1e9, 2)
        extra["hbm_gbps"] = round(bytes_acc / (5 * t_iter) / 1e9, 2) if bytes_acc else None

    ref_measured = _REF_MEASURED_IPS.get(n_poses)
    extra["vs_published_icra13"] = round(iters_per_sec / _REF_PUBLISHED_IPS, 3)
    if ref_measured:
        extra["ref_measured_iters_per_sec"] = ref_measured
    _emit(
        {
            "metric": "manhattan3500_gn_iters_per_sec",
            "value": round(iters_per_sec, 3),
            "unit": "iter/s",
            # vs the reference BINARY measured on this machine on the SAME
            # dataset (same-host head-to-head; published-number ratio in extra)
            "vs_baseline": round(
                iters_per_sec / (ref_measured or _REF_PUBLISHED_IPS), 3
            ),
            "extra": extra,
        }
    )


# ---------------------------------------------------------------- incremental


def bench_incremental():
    """Windowed incremental solve on manhattan3500, every-vertex cadence —
    the -fL role (BASELINE.md row 20: 1600 steps / 3.046 s RSS'13).

    A HOST metric: the child runs on the CPU platform, because the FastL
    engine's per-step solves are NumPy on the host by design
    (incremental_windowed.py live_on_host, solvers/fastl.py); the card takes
    no part.  Its line says so (``extra.device``)."""
    os.environ.setdefault("BENCH_PLATFORM", "cpu")
    # one BLAS thread: the FastL hot path is many small LAPACK calls, and
    # threaded OpenBLAS was pathologically slow there on a 2-core VM
    # (chol(150): 0.12 ms on one thread, 235 ms on two spinning ones).  Must
    # be set before numpy loads OpenBLAS.
    os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    _child_setup()

    from slampp_tpu.graph.system import GraphSystem
    from slampp_tpu.io.datasets import make_manhattan
    from slampp_tpu.io.parser import build_system, parse_file
    from slampp_tpu.solvers.fastl import FastLSolver
    from slampp_tpu.solvers.incremental_windowed import WindowedIncrementalSolver
    import tempfile

    # 800 poses matches the same-machine reference -fL measurement
    # (BENCH_NOTES.md); steps/sec is scale-normalized
    n_poses = int(os.environ.get("BENCH_INC_POSES", "800"))
    text, _ = make_manhattan(n_poses=n_poses, loop_prob=0.1, seed=0)
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        f.write(text)
        path = f.name

    system = GraphSystem()
    # every-vertex solve cadence (not closure-gated): the honest analog of
    # the reference's -fL step counting (unit_tests.sh:190-196).  Engine:
    # the resident-system FastL solver (solvers/fastl.py — maintained
    # window factor + resumed Cholesky, zero JAX dispatch per step);
    # BENCH_INC_ENGINE=windowed falls back to the generic windowed solver.
    eng = os.environ.get("BENCH_INC_ENGINE", "fastl")
    cls = FastLSolver if eng == "fastl" else WindowedIncrementalSolver
    inc = cls(system, solve_period=1, require_loop_closure=False)
    t0 = time.perf_counter()
    try:
        build_system(
            parse_file(path), problem="se2", system=system,
            on_edge=lambda s, n: inc.incremental_step(),
        )
    finally:
        os.unlink(path)
    inc.refresh_frozen()
    dt = time.perf_counter() - t0
    chi2 = inc.chi2()
    steps = inc.n_solves
    steps_per_sec = steps / dt

    # reference -fL measured on THIS machine on the SAME generated file
    # (BENCH_NOTES.md): 800-pose seed-0 file, `slam_plus_plus -fL -nsp 1 -po`
    # processes it in 0.0688 s with ~84 closure-gated solves -> 1221 solve/s.
    # CAVEAT: the reference only solves on loop closures (its -fL semantics,
    # and the RSS'13 1600-steps-of-3500 rows); ours solves EVERY vertex, so
    # both sides are counted by solves actually performed.
    ref_sps = float(os.environ.get("BENCH_INC_REF_SPS", "1221"))
    published_sps = 1600 / 3.046
    _emit(
        {
            "metric": "manhattan3500_incremental_steps_per_sec",
            "value": round(steps_per_sec, 3),
            "unit": "step/s",
            "vs_baseline": round(steps_per_sec / (ref_sps or published_sps), 4),
            "extra": {
                "n_poses": n_poses,
                "steps": int(steps),
                "total_s": round(dt, 2),
                "chi2_final": round(float(chi2), 2),
                "engine": eng,
                "cadence": "every-vertex (ref gates on closures; both sides "
                           "counted by solves performed)",
                "ref_same_machine_sps": ref_sps or None,
                "ref_same_machine_total_s": 0.0688,
                "published_rss13_sps": round(published_sps, 1),
                "device": {"platform": "cpu", "host_metric": True},
            },
        }
    )


# ------------------------------------------------------------------- parent


_CHILDREN = {
    "venice": bench_venice,
    "manhattan": bench_manhattan,
    "incremental": bench_incremental,
}


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--only":
        _CHILDREN[sys.argv[2]]()
        return

    # incremental first: it is host-dominated and its backend init has been
    # observed to wedge when started right after the venice child tears
    # down 1.1M-obs device state; manhattan stays last (primary metric)
    jobs = ["incremental", "venice", "manhattan"]
    if os.environ.get("BENCH_SKIP_VENICE", "") == "1":
        jobs.remove("venice")
    if os.environ.get("BENCH_SKIP_INCREMENTAL", "") == "1":
        jobs.remove("incremental")

    names = {
        "venice": "venice871_ba_iters_per_sec",
        "manhattan": "manhattan3500_gn_iters_per_sec",
        "incremental": "manhattan3500_incremental_steps_per_sec",
    }
    any_null = False
    for job in jobs:
        try:
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--only", job],
                capture_output=True, text=True,
                timeout=float(os.environ.get("BENCH_JOB_TIMEOUT", "3000")),
            )
            emitted = False
            for line in out.stdout.splitlines():
                line = line.strip()
                if line.startswith("{"):
                    print(line, flush=True)
                    emitted = True
                    if json.loads(line).get("value") is None:
                        any_null = True
            if not emitted:
                any_null = True
                _emit({
                    "metric": names[job], "value": None, "unit": "iter/s",
                    "vs_baseline": None,
                    "extra": {"error": (out.stderr or out.stdout)[-400:],
                              "rc": out.returncode},
                })
        except subprocess.TimeoutExpired:
            any_null = True
            _emit({
                "metric": names[job], "value": None, "unit": "iter/s",
                "vs_baseline": None, "extra": {"error": "timeout"},
            })
    # a green bench means EVERY metric produced a number: rc=0 with a null
    # metric would hide a dead benchmark
    if any_null:
        sys.exit(1)


if __name__ == "__main__":
    main()
