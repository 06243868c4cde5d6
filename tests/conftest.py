"""Test configuration: force an 8-device virtual CPU platform (the "fake
backend" per SURVEY.md §4, so mesh code runs without several cards) and
enable x64.  The platform is pinned before any backend initializes.

Tests that need the GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which decides at run time (never at import) and skips here.
"""

import os
import shutil

# one BLAS thread per test worker (set before numpy loads OpenBLAS): the
# workers share the cores, and the FastL engine's small LAPACK calls are
# slowest with spinning BLAS threads
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")
os.environ.setdefault("OMP_NUM_THREADS", "1")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

import slampp_tpu  # noqa: E402,F401  (enables x64 at import)


@pytest.fixture
def gpu():
    """Skip unless an NVIDIA card is visible.  The test process itself is
    pinned to the CPU, so GPU tests run their work in a child process."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m gpu tests/)")


# ---------------------------------------------------------------- quick tier
# One representative test per subsystem (pytest -m quick, target < 90 s) —
# runs on every commit; the full suite stays the pre-snapshot gate.
_QUICK = {
    ("test_containers", "test_block_sparse_matrix_ops"),
    ("test_geometry", "test_se2_jacobians_match_autodiff"),
    ("test_solvers_se2", "test_parser_manhattan_roundtrip"),
    ("test_solvers_se2", "test_gn_reduces_chi2_and_matches_scipy_oracle"),
    ("test_partitioned", "test_v3_exact_matches_dense_oracle[120-16]"),
    ("test_schur_sparse", "test_sparse_schur_step_matches_dense_oracle"),
    ("test_marginals", "test_dense_marginals_is_inverse"),
    ("test_mvg", "test_triangulation_exact"),
    ("test_sim3_robust", "test_sim3_compose_inverse"),
    ("test_block_unit", "test_random_gemm_vs_dense"),
    ("test_block_unit", "test_random_block_cholesky_vs_dense"),
    ("test_rocv_spheron", "test_rocv_end_to_end"),
}


# ---------------------------------------------------------------- slow tier
# Subprocess-heavy / multi-minute tests: excluded from the MEDIUM tier
# (pytest -m "not slow", target < 5 min — the per-feature iteration gate);
# the full suite (with them) remains the pre-snapshot gate.
_SLOW_MODULES = {
    "test_bench_smoke",     # spawns 3 bench child processes (compiles)
    "test_mesh_scaling",    # 10-rep subprocess scaling run
    "test_examples",        # runs every example script end-to-end
}

# individual multi-minute tests (mostly multichip shard_map compiles that
# the driver's dryrun_multichip exercises anyway)
_SLOW_TESTS = {
    ("test_distributed", "test_graft_dryrun_multichip"),        # 144 s
    ("test_distributed_ba", "test_distributed_ba_step_matches_single_device"),  # 100 s
    ("test_distributed", "test_distributed_gn_matches_single_device"),  # 47 s
    ("test_incremental_windowed", "test_windowed_live_system_is_bounded"),  # 35 s
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        keys = {(mod, item.name), (mod, item.name.split("[")[0])}
        if keys & _QUICK:
            item.add_marker(pytest.mark.quick)
        if mod in _SLOW_MODULES or keys & _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
