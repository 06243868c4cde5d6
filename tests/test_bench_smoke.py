"""Every bench.py child must RUN end-to-end at tiny scale on CPU.

VERDICT r2/r3 cardinal failure: the official benchmark shipped twice with
code that could not execute (a hot-loop rewrite, then an AttributeError on
a method that does not exist).  This tier makes that impossible: each child
runs as the same subprocess the driver launches, tiny-scale, and must emit
one JSON line with a non-null value.
"""

import json
import os
import subprocess
import sys

import pytest

_BENCH = os.path.join(os.path.dirname(__file__), "..", "bench.py")

_TINY_ENV = {
    "BENCH_PLATFORM": "cpu",
    # venice: ~80 cams / 600 points / short tracks
    "BENCH_VENICE_CAMS": "80",
    "BENCH_VENICE_POINTS": "600",
    "BENCH_VENICE_TRACK": "4",
    "BENCH_VENICE_ITERS": "2",
    # manhattan: 120 poses (f64-oracle chi2 pinned in bench._MANHATTAN_F64_CHI2)
    "BENCH_POSES": "120",
    "BENCH_TARGET": "32",
    # incremental: 60 poses, every-vertex cadence
    "BENCH_INC_POSES": "60",
}


def _run_child(job):
    env = dict(os.environ)
    env.update(_TINY_ENV)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, _BENCH, "--only", job],
        capture_output=True, text=True, timeout=600, env=env,
    )
    lines = [l for l in out.stdout.splitlines() if l.strip().startswith("{")]
    assert out.returncode == 0, f"{job} rc={out.returncode}\n{out.stderr[-2000:]}"
    assert lines, f"{job} emitted no JSON\n{out.stderr[-2000:]}"
    rec = json.loads(lines[-1])
    assert rec["value"] is not None, f"{job} value null: {rec}"
    assert rec["value"] > 0
    return rec


@pytest.mark.quick
def test_bench_venice_child_runs():
    rec = _run_child("venice")
    assert rec["extra"]["chi2_final"] <= rec["extra"]["chi2_initial"]


@pytest.mark.quick
def test_bench_manhattan_child_runs():
    rec = _run_child("manhattan")
    assert rec["extra"]["chi2_final"] < rec["extra"]["chi2_initial"]
    # the f64-oracle pin must exist AND hold at this size (VERDICT r4 #9:
    # chi2_ok None meant the CI tier ran with no correctness check at all)
    assert rec["extra"]["chi2_f64_oracle"] is not None
    assert rec["extra"]["chi2_ok"] is True


@pytest.mark.quick
def test_bench_incremental_child_runs():
    rec = _run_child("incremental")
    assert rec["extra"]["steps"] > 0
