"""slam_plus_plus-compatible CLI.

Capability parity with the reference application (src/slam_app/Main.cpp:42,
flag surface PrintHelp :593-667, generic driver CTester::Run_and_Shout
Main.h:1335): auto-detects the problem type by peeking the dataset
(TDatasetPeeker analog), selects the solver (auto-upgrading lambda -> LM for
BA, Main.cpp:203-207), supports batch and every-N incremental modes,
marginals, solution/timing output.

Usage:
    python -m slampp_tpu.apps.main -i dataset.g2o [options]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_arg_parser():
    p = argparse.ArgumentParser(
        prog="slam_plus_plus",
        description="accelerator-resident sparse nonlinear least squares (SLAM++ capability parity)",
    )
    p.add_argument("-i", "--input", help="input dataset (g2o/TORO/SLAM++)")
    p.add_argument("-rmut", "--run-matrix-unit-tests", action="store_true",
                   help="run the random block-matrix unit tests and exit "
                        "(reference BlockUnit.cpp)")
    p.add_argument("-rmb", "--run-matrix-benchmarks", action="store_true",
                   help="run the block/kernel benchmarks and exit "
                        "(reference BlockBench.h; writes kernel_bench.csv)")
    p.add_argument(
        "-nls",
        "--nonlinear-solver",
        default="lambda",
        choices=["lambda", "lambda-lm", "lambda-dl", "A", "L", "fastL", "spcg"],
        help="nonlinear solver (L/fastL: windowed incremental engines with "
        "-nsp, the lambda solver in batch mode; "
        "spcg = spanning-tree-preconditioned CG, NonlinearSolver_SPCG.h)",
    )
    p.add_argument("-po", "--pose-only", action="store_true", help="pose-only mode")
    p.add_argument("-us", "--use-schur", action="store_true", help="Schur complement solve")
    p.add_argument("-dm", "--do-marginals", action="store_true", help="marginal covariances")
    p.add_argument("-dsm", "--dump-system-matrix", action="store_true",
                   help="write the system matrix as system.mtx (MatrixMarket)"
                        " and a sparsity raster system_matrix.png")
    p.add_argument("-mnsi", "--max-nonlinear-solve-iters", type=int, default=5)
    p.add_argument("-nset", "--nonlinear-solve-error-thresh", type=float, default=0.01)
    p.add_argument("-mfnsi", "--max-final-nonlinear-solve-iters", type=int, default=None)
    p.add_argument("-fnset", "--final-nonlinear-solve-error-thresh", type=float, default=None)
    p.add_argument(
        "-nsp", "--nonlinear-solve-period", type=int, default=0,
        help="incremental: nonlinear solve every N vertices (0 = batch)",
    )
    p.add_argument("-lsp", "--linear-solve-period", type=int, default=0)
    p.add_argument("-s", "--solution", default="solution.txt", help="solution output file")
    p.add_argument("-ns", "--no-solution", action="store_true")
    p.add_argument("-nb", "--no-bitmaps", action="store_true", help="skip plot output")
    p.add_argument("-p", "--plot", default=None, help="write trajectory plot to this file")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--no-detailed-timing", action="store_true")
    p.add_argument("--robust", default=None, choices=[None, "huber", "cauchy", "tukey", "fair", "welsch", "logistic", "hampel"])
    p.add_argument("--json", action="store_true", help="print a JSON result line")
    p.add_argument("--platform", default=None,
                   help="jax platform override (e.g. cpu for tests)")
    return p


def main(argv=None):
    args = build_arg_parser().parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    if args.run_matrix_unit_tests:
        # reference -rmut (BlockUnit.cpp): random block-matrix unit tests
        import subprocess
        import sys as _sys

        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        return subprocess.call(
            [_sys.executable, "-m", "pytest",
             os.path.join(root, "tests", "test_block_unit.py"), "-q"],
            cwd=root,
        )
    if args.run_matrix_benchmarks:
        # reference -rmb (BlockBench.h): kernel benchmark table -> CSV
        import subprocess
        import sys as _sys

        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        return subprocess.call(
            [_sys.executable, os.path.join(root, "scripts", "kernel_bench.py")]
            + (["--cpu"] if args.platform == "cpu" else []),
            cwd=root,
        )
    if args.input is None:
        build_arg_parser().error("the following arguments are required: -i/--input")
    import slampp_tpu  # noqa: F401  (x64)
    from slampp_tpu.io.parser import build_system, detect_problem, parse_file
    from slampp_tpu.solvers import (
        DoglegSolver,
        GaussNewtonSolver,
        IncrementalSolver,
        LevenbergMarquardtSolver,
    )
    from slampp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    t0 = time.time()
    records = parse_file(args.input)
    problem = detect_problem(records[:1000])
    t_parse = time.time() - t0
    is_ba = problem.startswith("ba")

    solver_kind = args.nonlinear_solver
    if solver_kind in ("lambda", "A", "L", "fastL", "spcg") and is_ba:
        # the reference auto-upgrades lambda to LM for BA (Main.cpp:203-207)
        solver_kind = "lambda-lm"
    use_schur = args.use_schur or is_ba

    t0 = time.time()
    if is_ba and args.nonlinear_solve_period > 0:
        # incremental BA: optimize at CONSISTENCY_MARKER records (the
        # reference's CParseLoop_ConsistencyMarker path, Main.h:1066-1074;
        # markers delimit states where no vertices are orphaned)
        from slampp_tpu.graph.system import GraphSystem

        system = GraphSystem()
        n_markers = 0

        def on_marker(s):
            nonlocal n_markers
            n_markers += 1
            lm = LevenbergMarquardtSolver(s, use_schur=True, pad=True)
            lm.optimize(args.max_nonlinear_solve_iters, args.nonlinear_solve_error_thresh)
            if args.verbose:
                print(f"marker #{n_markers}: chi2={lm.chi2():.2f}")

        build_system(records, problem=problem, system=system, on_marker=on_marker)
        solver = LevenbergMarquardtSolver(system, use_schur=True, verbose=args.verbose)
        n_steps = n_markers
    elif args.nonlinear_solve_period > 0 and not is_ba:
        from slampp_tpu.graph.system import GraphSystem

        system = GraphSystem()
        if solver_kind in ("L", "fastL"):
            # windowed incremental engine: cached frozen-chunk Schur
            # complements + bounded live solves (FastL economics).  Problem
            # families with NumPy model kernels run the resident-system
            # FastL engine (solvers/fastl.py — resumed Cholesky, zero JAX
            # dispatch per step); others use the generic windowed solver.
            from slampp_tpu.solvers.incremental_windowed import (
                WindowedIncrementalSolver,
            )

            inc_cls = WindowedIncrementalSolver
            if problem in ("se2", "se3") and not args.robust:
                from slampp_tpu.solvers.fastl import FastLSolver

                inc_cls = FastLSolver
            inc = inc_cls(
                system,
                solve_period=args.nonlinear_solve_period,
                max_iterations=args.max_nonlinear_solve_iters,
                verbose=args.verbose,
            )
        else:
            inc = IncrementalSolver(
                system,
                solve_period=args.nonlinear_solve_period,
                max_iterations=args.max_nonlinear_solve_iters,
                min_dx_norm=args.nonlinear_solve_error_thresh,
                verbose=args.verbose,
            )
        build_system(
            records,
            problem=problem,
            system=system,
            on_edge=lambda s, n: inc.incremental_step(),
        )
        solver = inc
        n_steps = inc.n_solves
    else:
        system = build_system(records, problem=problem)
        if args.robust:
            # swap edge types for their robust (IRLS-weighted) variants
            # (reference: compile-time CRobustify_ErrorNorm_Default policy,
            # RobustUtils.h:60)
            from slampp_tpu.models.robust import apply_robust_to_system

            apply_robust_to_system(system, loss=args.robust)
        if solver_kind == "lambda-lm":
            # Venice-class mono BA: route through the observation-driven
            # Schur engine so no dense Hessian is ever materialized
            # (reference -us BA at any scale, Main.cpp:203-207 ->
            # LinearSolver_Schur.h:1623).  Threshold in observations.
            big_thresh = int(os.environ.get("SLAMPP_BIGBA_THRESHOLD", "20000"))
            engine = (
                "big_ba"
                if (
                    problem == "ba"
                    and set(system.edge_type_names) == {"edge_p2c"}
                    and system.n_edges >= big_thresh
                )
                else "dense"
            )
            solver = LevenbergMarquardtSolver(
                system, use_schur=use_schur, verbose=args.verbose, engine=engine
            )
        elif solver_kind == "lambda-dl":
            solver = DoglegSolver(system, verbose=args.verbose)
        elif solver_kind == "spcg":
            # subgraph (spanning-tree) preconditioned CG (reference
            # CNonlinearSolver_SPCG, NonlinearSolver_SPCG.h:61)
            from slampp_tpu.linear.spcg import SPCGSolver

            solver = SPCGSolver(system, verbose=args.verbose)
        elif solver_kind == "A":
            # the A (Jacobian) solver — normal equations from the exported A
            # (reference CNonlinearSolver_A, NonlinearSolver_A.h:314)
            from slampp_tpu.solvers.a_solver import ASolver

            solver = ASolver(system, verbose=args.verbose)
        else:
            solver = GaussNewtonSolver(system, use_schur=use_schur, verbose=args.verbose)
        n_steps = 0
    t_build = time.time() - t0

    fi = args.max_final_nonlinear_solve_iters
    ft = args.final_nonlinear_solve_error_thresh
    t0 = time.time()
    iters = solver.optimize(
        fi if fi is not None else args.max_nonlinear_solve_iters,
        ft if ft is not None else args.nonlinear_solve_error_thresh,
    )
    t_solve = time.time() - t0
    chi2 = solver.chi2()

    print(f"done. it took {t_solve:.5f} sec (solve) + {t_parse + t_build:.5f} sec (parse/build)")
    print(f"denormalized chi2 error: {chi2:.2f}")
    if not args.no_detailed_timing:
        solver.dump()

    if args.dump_system_matrix:
        # reference -dsm: system.mtx (MatrixMarket) + sparsity raster
        # (Main.h:126,1449-1493 writes system.mtx and system_matrix.tga from
        # the sparse lambda).  Assembled sparsely — chunked per-edge-type
        # block triplets, never a dense Hessian (round-4 advisor fix).
        from slampp_tpu.core.bsm import BlockSparseMatrix
        from slampp_tpu.core.sparse_dump import assemble_sparse_csr
        from slampp_tpu.graph.types import get_vertex_type as _gvt

        dims = {_gvt(t).dim for t, _ in system.vertex_index.values()}
        bs_u = dims.pop() if len(dims) == 1 else 1
        Hs = assemble_sparse_csr(system.snapshot())
        bsm = BlockSparseMatrix.from_sparse(Hs, bs_u, bs_u)
        bsm.save_matrix_market("system.mtx")
        try:
            bsm.rasterize("system_matrix.png")
        except Exception:
            pass
        print(f"system matrix: {bsm.shape[0]}x{bsm.shape[1]}, "
              f"{bsm.nnz_blocks} blocks -> system.mtx")

    if args.do_marginals:
        from slampp_tpu.marginals import MarginalCovariance

        marg = MarginalCovariance(system)
        marg.update_batch()
        d0 = marg.block_diag.get(0)
        if args.verbose and d0 is not None:
            print("marginals: vertex-0 covariance diag:", d0.diagonal())
        # marginals.txt: one line per vertex, diagonal of its covariance
        # block (reference CMarginalCovariance::Dump_Diagonal,
        # include/slam/Marginals.h:7172)
        with open("marginals.txt", "w") as f:
            for vid in sorted(system.vertex_index):
                blk = marg.block_diag.get(vid)
                if blk is None:
                    continue
                f.write(" ".join("%.15g" % x for x in blk.diagonal()) + "\n")

    if not args.no_solution and args.solution:
        with open(args.solution, "w") as f:
            offsets, _ = system._layout()
            for vid in sorted(system.vertex_index):
                st = system.vertex_state(vid)
                f.write(" ".join("%.10f" % x for x in st) + "\n")

    if args.plot and not args.no_bitmaps:
        from slampp_tpu.viz.plot import plot_system

        plot_system(system, args.plot)

    if args.json:
        print(
            json.dumps(
                {
                    "problem": problem,
                    "solver": solver_kind,
                    "engine": getattr(solver, "engine", None),
                    "chi2": chi2,
                    "iterations": iters,
                    "incremental_solves": n_steps,
                    "t_solve": t_solve,
                }
            )
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
