#!/usr/bin/env python
"""On-card smoke run: the solver's main paths on one NVIDIA GPU, at the
sizes their users run, each checked against its oracle.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Phases (one card): device, native_build, precision, dense_kernels,
manhattan3500_cli, manhattan3500_v3, sphere2500_v3_dense_frame,
venice871_ba, cli_big_ba_routing, incremental_fastl, graft_entry.
Phases (four cards): device, distributed_big_ba_step, distributed_gn_step,
distributed_big_ba_marginals.

Each phase prints one line: name, PASS/FAIL, seconds, compile seconds (JAX
tracing + lowering + backend compilation inside the phase), and the
device's ``peak_bytes_in_use`` after it.  A failed phase makes the run exit
1; the last line is a JSON object only when every phase passed.  The run
fails at its first phase on any platform but ``gpu``.

The phase functions take their sizes as arguments, so the CPU tests call
them at tiny sizes (tests/test_chip_smoke.py).  One process drives the
card(s): a second JAX process would find most of the memory reserved.
"""

import os

# one BLAS thread for the host-side FastL engine (before numpy loads)
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import slampp_tpu  # noqa: E402,F401  (x64 + full-precision f32 matmuls)

# chi2 oracles, computed in f64 on the CPU (same dataset seed, same
# iteration policy as the phase):
#   manhattan3500_cli: `-po` GN (NativeBlockSolver, f64), -mnsi 5 -nset 0.01
#   manhattan3500_v3: bench.py's pin (PartitionedSolver mixed_precision=False,
#     5 fused GN iterations; also the SLAM++ reference binary's 404.50)
#   sphere2500: LM engine="v3" with the f64 partitioned solve, 5 iterations
CHI2_MANHATTAN3500_CLI = 404.5038446353009
CHI2_MANHATTAN3500_V3 = 404.504
CHI2_SPHERE2500_V3 = 21608.742770113484

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)
_compile_s = [0.0]


def _on_duration(event, duration_secs, **_):
    if event in _COMPILE_EVENTS:
        _compile_s[0] += duration_secs


def _say(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def _write_tmp(text, suffix):
    with tempfile.NamedTemporaryFile("w", suffix=suffix, delete=False) as f:
        f.write(text)
        return f.name


def _system(text, suffix=".g2o"):
    from slampp_tpu.io.parser import build_system, parse_file

    path = _write_tmp(text, suffix)
    try:
        return build_system(parse_file(path))
    finally:
        os.unlink(path)


def _run_cli(args):
    """apps.main.main in-process; returns its --json record."""
    from slampp_tpu.apps import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(args) + ["-ns", "-nb", "--no-detailed-timing", "--json"])
    assert rc == 0, f"CLI rc={rc}"
    lines = [l for l in buf.getvalue().splitlines() if l.startswith("{")]
    assert lines, f"CLI printed no JSON:\n{buf.getvalue()[-2000:]}"
    return json.loads(lines[-1])


def _check_rel(name, got, want, rtol):
    rel = abs(got - want) / abs(want)
    assert rel < rtol, f"{name} {got!r} vs oracle {want!r}: rel {rel:.3e} >= {rtol}"
    return f"{name}={got:.6f} oracle={want:.6f} rel={rel:.2e} (tol {rtol})"


# ----------------------------------------------------------------- phases


def phase_device(min_count=1):
    """Platform check and environment: fails on anything but the GPU."""
    devs = jax.devices()
    d = devs[0]
    _say(f"platform={d.platform} device_kind={d.device_kind} "
         f"count={len(devs)} jax={jax.__version__}")
    assert d.platform == "gpu", f"needs the GPU, JAX found platform {d.platform!r}"
    assert len(devs) >= min_count, f"needs {min_count} cards, found {len(devs)}"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in out.stdout.strip().splitlines():
        _say(f"nvidia-smi: {line.strip()}")
    from slampp_tpu.utils.compile_cache import enable_compile_cache

    _say(f"compile cache: {enable_compile_cache()}")
    _say(f"default matmul precision: {jax.config.jax_default_matmul_precision}")


def phase_native_build():
    """Build native/ from the committed sources; the ordering must use it."""
    native = os.path.join(_HERE, "native")
    lib = os.path.join(native, "libslampp_native.so")
    if os.path.exists(lib):
        os.remove(lib)  # never trust a library built on another machine
    subprocess.run(["make", "-C", native], check=True, capture_output=True,
                   text=True, timeout=300)
    from slampp_tpu.core import native_host

    assert native_host.available(), "native/libslampp_native.so did not load"
    return "native min-degree ordering in use"


def phase_precision(n=1024):
    """An f32 product with the program's defaults must be full f32: relative
    error < 1e-5 against f64 (TF32 gives ~1e-3)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(n, n)).astype(np.float32)
    b = rng.normal(size=(n, n)).astype(np.float32)
    c32 = np.asarray(jax.jit(jnp.dot)(jnp.asarray(a), jnp.asarray(b)), np.float64)
    c64 = a.astype(np.float64) @ b.astype(np.float64)
    rel = float(np.linalg.norm(c32 - c64) / np.linalg.norm(c64))
    assert rel < 1e-5, f"f32 matmul rel err {rel:.2e} >= 1e-5 (TF32 in effect?)"
    return f"f32 {n}x{n} matmul rel err {rel:.2e}"


def _spd(rng, K, M):
    G = rng.normal(size=(K, M, M))
    return G @ np.swapaxes(G, 1, 2) / M + np.eye(M)


def phase_dense_kernels(K, M, S, Ms):
    """chol_batched / trsm_lower_batched / trsm_lower_t_batched at the v3
    dense-frame shapes (K frames of M, an S-wide coupling rhs, and one Ms
    separator frame) in f32 and f64 against NumPy f64, plus a rank-deficient
    frame whose pivots must freeze."""
    from scipy.linalg import solve_triangular

    from slampp_tpu.ops import dense_kernels as dk

    rng = np.random.default_rng(1)
    A = _spd(rng, K, M)
    B = rng.normal(size=(K, M, S))
    As = _spd(rng, 1, Ms)
    L_ref = np.linalg.cholesky(A)
    Y_ref = np.stack([solve_triangular(L_ref[k], B[k], lower=True) for k in range(K)])
    X_ref = np.stack([solve_triangular(L_ref[k], Y_ref[k], lower=True, trans="T")
                      for k in range(K)])
    Ls_ref = np.linalg.cholesky(As)
    chol = jax.jit(dk.chol_batched)
    fwd = jax.jit(dk.trsm_lower_batched)
    bwd = jax.jit(dk.trsm_lower_t_batched)
    msgs = []
    for dt, tol in ((jnp.float32, 1e-4), (jnp.float64, 1e-10)):
        L = chol(jnp.asarray(A, dt))
        Y = fwd(L, jnp.asarray(B, dt))
        X = bwd(L, Y)
        Ls = chol(jnp.asarray(As, dt))
        for nm, got, ref in (("chol", L, L_ref), ("trsm", Y, Y_ref),
                             ("trsm_t", X, X_ref), ("chol_sep", Ls, Ls_ref)):
            err = float(np.max(np.abs(np.asarray(got, np.float64) - ref))
                        / np.max(np.abs(ref)))
            assert err < tol, f"{nm} {jnp.dtype(dt).name} rel err {err:.2e} >= {tol}"
        msgs.append(f"{jnp.dtype(dt).name} ok")

    # frozen pivots: frame 1 has a 6-dim null space (an SE(3) gauge mode)
    G = rng.normal(size=(M, M - 6))
    Ad = np.stack([A[0], G @ G.T / M])
    for dt in (jnp.float32, jnp.float64):
        L = np.asarray(chol(jnp.asarray(Ad, dt)), np.float64)
        assert np.isfinite(L).all(), "frozen-pivot factor not finite"
        np.testing.assert_allclose(L[0], L_ref[0], rtol=0, atol=1e-4 * np.abs(L_ref[0]).max())
        diag = np.diagonal(L[1])
        frozen = np.flatnonzero(diag > 1e9)
        assert len(frozen) >= 1, "no pivot froze on the rank-deficient frame"
        mult = max(np.abs(L[1][j + 1:, j]).max(initial=0.0) for j in frozen)
        assert mult < 1e-8 * np.abs(Ad[1]).max(), f"frozen multipliers {mult:.2e}"
        Y = np.asarray(fwd(jnp.asarray(L, dt), jnp.asarray(B[:2], dt)))
        assert np.isfinite(Y).all(), "trsm on a frozen factor not finite"
    msgs.append(f"frozen pivots finite ({len(frozen)} frozen)")
    return f"K={K} M={M} S={S} Ms={Ms}: " + ", ".join(msgs)


def phase_manhattan_cli(n_poses, chi2_ref, rtol=1e-6):
    """`-po` batch GN through the CLI (GaussNewtonSolver -> NativeBlockSolver
    v1, f64).  Tolerance: f64 throughout; sums run in another order on the
    GPU, so only rounding separates it from the CPU oracle."""
    from slampp_tpu.io.datasets import make_manhattan

    text, _ = make_manhattan(n_poses=n_poses, loop_prob=0.1, seed=0)
    path = _write_tmp(text, ".txt")
    try:
        rec = _run_cli(["-i", path, "-po"])
    finally:
        os.unlink(path)
    assert rec["solver"] == "lambda", rec
    return _check_rel("chi2", rec["chi2"], chi2_ref, rtol) + f" iters={rec['iterations']}"


def phase_manhattan_v3(n_poses, chi2_ref, rtol=5e-3):
    """PartitionedSolver.optimize_fused as bench.py runs it (chain mode,
    mixed precision, 5 GN iterations); tolerance is bench.py's."""
    from slampp_tpu.io.datasets import make_manhattan
    from slampp_tpu.linear.partitioned import PartitionedSolver

    text, _ = make_manhattan(n_poses=n_poses, loop_prob=0.1, seed=0)
    system = _system(text, ".txt")
    ps = PartitionedSolver(system, target=64, mixed_precision=True, refine_iters=0)
    ps.symbolic()
    out = ps.optimize_fused(system.snapshot(), n_iters=5)
    chi2 = float(out[3])
    return _check_rel("chi2", chi2, chi2_ref, rtol) + f" chain_mode={ps.plan.ch_ok}"


def phase_sphere_dense_frame(n_poses, n_rings, chi2_ref, rtol=1e-3):
    """SE(3) LM through the v3 engine on a graph chain mode refuses, so the
    dense-frame branch (batched chol/TRSM over part frames) does the solve.
    Tolerance: f32 frames + f64 refinement against the all-f64 oracle (the
    CPU run of the mixed path lands 2.5e-5 from it)."""
    from slampp_tpu.io.datasets import make_sphere
    from slampp_tpu.solvers import LevenbergMarquardtSolver

    text, _ = make_sphere(n_poses=n_poses, n_rings=n_rings, seed=0)
    system = _system(text)
    lm = LevenbergMarquardtSolver(system, engine="v3")
    it = lm.optimize(5, 0.01)
    p = lm._v3.plan
    assert p.ch_ok == 0, "chain mode took the graph: dense-frame branch not exercised"
    return (_check_rel("chi2", lm.chi2(), chi2_ref, rtol)
            + f" accepted={it} dense_frame K={p.K} M={p.M} Ms={p.Ms}")


def phase_venice_ba(n_cams, n_points, mean_track, iters=5, step_rtol=1e-3):
    """Venice-class BA (BigBASolver.from_arrays, as bench.py builds it):
    chi2 must fall over ``iters`` LM iterations, and one f32-SC step and one
    f64-SC step from the same state must agree on the step norm within
    ``step_rtol``: the f32 Schur complement (one f64 refinement) and the
    GPU's unordered scatter-adds are the only differences."""
    from slampp_tpu.io.datasets import make_venice_ba_arrays
    from slampp_tpu.linear.ba_schur import BigBASolver, ba_schur_lm_step

    cams, lms, oc, ol, uv, info, _ = make_venice_ba_arrays(
        n_cams=n_cams, n_points=n_points, mean_track=mean_track, seed=0
    )
    solver = BigBASolver.from_arrays(cams, lms, oc, ol, uv, info, sc_f64=False)
    solver._make_step()
    c0, l0 = solver._cams, solver._lms
    chi2_0 = float(solver._chi2_fn(solver.plan, c0, l0))

    step = jax.jit(ba_schur_lm_step, static_argnames=("sc_f64", "pair_f32"))
    n32 = float(step(solver.plan, c0, l0, 1.0, sc_f64=False)[2])
    n64 = float(step(solver.plan, c0, l0, 1.0, sc_f64=True)[2])
    rel = abs(n32 - n64) / n64
    assert np.isfinite(n32) and rel < step_rtol, (
        f"f32-SC step norm {n32} vs f64-SC {n64}: rel {rel:.2e} >= {step_rtol}")

    applied = solver.optimize(max_iterations=iters, min_dx_norm=0.0)
    chi2 = float(solver._chi2_fn(solver.plan, solver._cams, solver._lms))
    assert applied >= 1 and chi2 < chi2_0, f"chi2 {chi2_0} -> {chi2} ({applied} accepted)"
    return (f"obs={len(oc)} chi2 {chi2_0:.1f} -> {chi2:.1f} over {iters} LM its "
            f"({applied} accepted); step norm f32-SC/f64-SC rel {rel:.2e} (tol {step_rtol})")


def phase_cli_big_ba_routing(n_cams, n_points, obs_per_point):
    """A BA file above SLAMPP_BIGBA_THRESHOLD (default 20,000 observations)
    through the CLI must take LevenbergMarquardtSolver(engine="big_ba")."""
    from slampp_tpu.core import assembly
    from slampp_tpu.io.datasets import make_ba_scene

    text, _ = make_ba_scene(n_cams=n_cams, n_points=n_points,
                            obs_per_point=obs_per_point, seed=0)
    system = _system(text)
    chi2_0 = float(jax.jit(assembly.graph_chi2)(system.snapshot()))
    path = _write_tmp(text, ".g2o")
    try:
        rec = _run_cli(["-i", path])
    finally:
        os.unlink(path)
    assert rec["engine"] == "big_ba", f"CLI routed BA to {rec['engine']!r}"
    assert rec["chi2"] < chi2_0, f"chi2 {chi2_0} -> {rec['chi2']}"
    return f"obs={system.n_edges} engine=big_ba chi2 {chi2_0:.1f} -> {rec['chi2']:.1f}"


def phase_incremental_fastl(n_poses, rtol=1e-4):
    """CLI `-nsp 1 -nls fastL` (host-resident FastL engine) must end where
    a batch GN solve of the same graph ends."""
    from slampp_tpu.io.datasets import make_manhattan

    text, _ = make_manhattan(n_poses=n_poses, loop_prob=0.1, seed=0)
    path = _write_tmp(text, ".txt")
    try:
        inc = _run_cli(["-i", path, "-po", "-nsp", "1", "-nls", "fastL"])
        batch = _run_cli(["-i", path, "-po"])
    finally:
        os.unlink(path)
    assert inc["incremental_solves"] > 0, inc
    return (_check_rel("chi2", inc["chi2"], batch["chi2"], rtol)
            + f" solves={inc['incremental_solves']} (oracle: batch GN)")


def phase_graft_entry():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    states, chi2 = jax.block_until_ready(jax.jit(fn)(*args))
    assert np.isfinite(float(chi2)), chi2
    return f"gn_step chi2={float(chi2):.4f}"


# ------------------------------------------------------- four-card phases


def _committed_everywhere(tree, n):
    for leaf in jax.tree_util.tree_leaves(tree):
        if isinstance(leaf, jax.Array):
            assert len(leaf.sharding.device_set) == n, (
                f"array {leaf.shape} lives on {len(leaf.sharding.device_set)} of {n} devices")


@functools.lru_cache(maxsize=1)
def _venice_shards(n_cams, n_points, mean_track, n_dev):
    from slampp_tpu.io.datasets import make_venice_ba_arrays
    from slampp_tpu.parallel import make_mesh
    from slampp_tpu.parallel.distributed_ba import build_big_ba_shards_arrays

    arrays = make_venice_ba_arrays(
        n_cams=n_cams, n_points=n_points, mean_track=mean_track, seed=0
    )[:6]
    mesh = make_mesh(n_dev, axis="lm")
    shards = build_big_ba_shards_arrays(*arrays, mesh)
    _committed_everywhere(shards, n_dev)
    _say(f"mesh: {mesh}")
    _say(f"obs_cam {shards.obs_cam.shape} sharding: {shards.obs_cam.sharding}")
    _say(f"obs_uv {shards.obs_uv.shape} sharding: {shards.obs_uv.sharding}")
    return arrays, mesh, shards


def phase_distributed_big_ba(n_cams, n_points, mean_track, n_dev=4, alpha=1.0):
    """distributed_big_ba_step on an n_dev landmark mesh against one
    single-device ba_schur_lm_step (f64 SC, f64 pair products) from the same
    state.  Tolerance: both are f64; they differ in summation order
    (per-shard partial SCs + psum, unordered scatter-adds on the GPU)."""
    from slampp_tpu.linear.ba_schur import ba_schur_lm_step, build_ba_schur_plan_arrays
    from slampp_tpu.parallel.distributed_ba import distributed_big_ba_step

    (cams, lms, oc, ol, uv, info), mesh, shards = _venice_shards(
        n_cams, n_points, mean_track, n_dev)
    nc, nl, norm, chi2, denom = distributed_big_ba_step(shards, mesh, alpha)
    _committed_everywhere(nl, n_dev)

    plan = build_ba_schur_plan_arrays(len(cams), len(lms), oc, ol, uv, info)
    step = jax.jit(ba_schur_lm_step, static_argnames=("sc_f64", "pair_f32"))
    rc, rl, rnorm, rchi2, rdenom = step(plan, jnp.asarray(cams), jnp.asarray(lms),
                                        alpha, sc_f64=True, pair_f32=False)
    msg = [_check_rel("chi2", float(chi2), float(rchi2), 1e-9),
           _check_rel("dx_norm", float(norm), float(rnorm), 1e-6),
           _check_rel("denom", float(denom), float(rdenom), 1e-6)]
    atol = 1e-6 * float(rnorm)  # the step-norm tolerance, per entry
    np.testing.assert_allclose(np.asarray(nc), np.asarray(rc), rtol=0, atol=atol)
    lms_d = np.asarray(nl).reshape(-1, 3)[: len(lms)]
    np.testing.assert_allclose(lms_d, np.asarray(rl), rtol=0, atol=atol)
    return f"obs={len(oc)} devices={n_dev}; " + "; ".join(msg)


def phase_distributed_gn(n_poses, n_dev=4):
    """distributed_gn_step (edges sharded, psum-reduced dense system) against
    the single-device dense GN step.  Tolerance: f64 both; partial-sum order
    differs."""
    from slampp_tpu.io.datasets import make_manhattan
    from slampp_tpu.parallel import distributed_gn_step, make_mesh, shard_graph_edges
    from slampp_tpu.solvers.gauss_newton import _gn_step

    text, _ = make_manhattan(n_poses=n_poses, loop_prob=0.1, seed=0)
    graph = _system(text, ".txt").snapshot()
    ref_states, ref_norm, ref_chi2 = _gn_step(graph)
    mesh = make_mesh(n_dev)
    sharded = shard_graph_edges(graph, mesh)
    _committed_everywhere(sharded.edges, n_dev)
    states, norm, chi2 = distributed_gn_step(sharded, mesh)
    msg = [_check_rel("chi2", float(chi2), float(ref_chi2), 1e-9),
           _check_rel("dx_norm", float(norm), float(ref_norm), 1e-6)]
    atol = 1e-6 * float(ref_norm)  # the step-norm tolerance, per entry
    for k in ref_states:
        np.testing.assert_allclose(np.asarray(states[k]), np.asarray(ref_states[k]),
                                   rtol=0, atol=atol)
    return f"poses={n_poses} devices={n_dev}; " + "; ".join(msg)


def phase_distributed_marginals(n_cams, n_points, mean_track, n_dev=4):
    """distributed_big_ba_marginals: finite camera and landmark blocks."""
    from slampp_tpu.parallel.distributed_ba import distributed_big_ba_marginals

    _, mesh, shards = _venice_shards(n_cams, n_points, mean_track, n_dev)
    cam_cov, lm_cov = distributed_big_ba_marginals(shards, mesh, alpha=1e-3)
    _committed_everywhere(lm_cov, n_dev)
    cam_cov, lm_cov = np.asarray(cam_cov), np.asarray(lm_cov)
    assert np.isfinite(cam_cov).all() and np.isfinite(lm_cov).all(), "non-finite marginals"
    return f"cam_cov {cam_cov.shape} lm_cov {lm_cov.shape} finite"


# ------------------------------------------------------------------- main


def _sphere_frame_shapes(n_poses):
    """(K, M, S_rhs, Ms) of the sphere plan's dense frames; S_rhs is the
    coupling width plus the rhs column, padded as _factor32 pads it."""
    from slampp_tpu.io.datasets import make_sphere
    from slampp_tpu.linear.partitioned import PartitionedSolver

    text, _ = make_sphere(n_poses=n_poses, seed=0)
    ps = PartitionedSolver(_system(text), refine_iters=2)
    ps.symbolic()
    p = ps.plan
    return p.K, p.M, -(-(p.S + 1) // 8) * 8, p.Ms


def _phase(name, fn, *args, **kw):
    _compile_s[0] = 0.0
    t0 = time.perf_counter()
    try:
        info = fn(*args, **kw) or ""
        ok = True
    except Exception as e:  # noqa: BLE001  (reported, and the run exits 1)
        traceback.print_exc()
        info = f"{type(e).__name__}: {e}"[:400]
        ok = False
    dt = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "n/a")
    _say(f"{name}: {'PASS' if ok else 'FAIL'} {dt:.1f}s compile={_compile_s[0]:.1f}s "
         f"peak_bytes_in_use={peak} {info}")
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args(argv)
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    n_dev = 4 if args.four_cards else 1
    if not _phase("device", phase_device, n_dev):
        return 1
    venice = dict(n_cams=871, n_points=110_000, mean_track=10)
    if args.four_cards:
        phases = [
            ("distributed_big_ba_step", phase_distributed_big_ba, venice),
            ("distributed_gn_step", phase_distributed_gn, dict(n_poses=3500)),
            ("distributed_big_ba_marginals", phase_distributed_marginals, venice),
        ]
    else:
        K, M, S, Ms = _sphere_frame_shapes(2500)
        phases = [
            ("native_build", phase_native_build, {}),
            ("precision", phase_precision, {}),
            ("dense_kernels", phase_dense_kernels, dict(K=K, M=M, S=S, Ms=Ms)),
            ("manhattan3500_cli", phase_manhattan_cli,
             dict(n_poses=3500, chi2_ref=CHI2_MANHATTAN3500_CLI)),
            ("manhattan3500_v3", phase_manhattan_v3,
             dict(n_poses=3500, chi2_ref=CHI2_MANHATTAN3500_V3)),
            ("sphere2500_v3_dense_frame", phase_sphere_dense_frame,
             dict(n_poses=2500, n_rings=50, chi2_ref=CHI2_SPHERE2500_V3)),
            ("venice871_ba", phase_venice_ba, venice),
            ("cli_big_ba_routing", phase_cli_big_ba_routing,
             dict(n_cams=40, n_points=4000, obs_per_point=6)),
            ("incremental_fastl", phase_incremental_fastl, dict(n_poses=800)),
            ("graft_entry", phase_graft_entry, {}),
        ]
    failed = [name for name, fn, kw in phases if not _phase(name, fn, **kw)]
    if failed:
        _say(f"FAILED: {failed}")
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
