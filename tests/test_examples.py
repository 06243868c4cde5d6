"""Smoke tests for the research/example apps (reference L12 apps —
slam_compact_pose_example, slam_dataassoc_example, incremental_ba_3dv,
ba_parameter_acra, geometry_example)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, *args, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", script), *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_compact_pose_example():
    out = _run("compact_pose_example.py", "--poses", "200")
    assert "keyframe ATE" in out
    ate = float(out.rsplit("keyframe ATE compact-vs-full:", 1)[1].split()[0])
    assert ate < 0.5


def test_dataassoc_example():
    out = _run("dataassoc_example.py", "--poses", "150")
    assert "accepted" in out and "rejected" in out


def test_geometry_example():
    out = _run("geometry_example.py")
    assert "P3P" in out and "Kabsch" in out


def test_ba_parameter_acra_example():
    out = _run("ba_parameter_acra_example.py", timeout=900)
    assert out.count("obs):") == 3


def test_incremental_ba_3dv_example():
    out = _run("incremental_ba_3dv_example.py", "--cams", "5", "--points", "40",
               timeout=900)
    assert "consistency markers processed" in out


def test_schur_orderings_study():
    out = _run("schur_orderings_study.py", "--poses", "120", "--landmarks", "40")
    assert "vs best" in out
    # min-degree must beat natural ordering on a loopy landmark graph
    import re
    flops = {}
    for line in out.splitlines():
        m = re.match(r"(chol [a-z-]+|Schur .+?)\s{2,}([0-9.e+]+)\s", line)
        if m:
            flops[m.group(1).strip()] = float(m.group(2))
    assert flops["chol min-degree"] < flops["chol natural"]


def test_compact_pose_ijrr_study():
    out = _run("compact_pose_ijrr_study.py", "--poses", "150")
    import re
    comp = int(re.search(r"compact:\s+(\d+) poses", out).group(1))
    full = int(re.search(r"full:\s+(\d+) poses", out).group(1))
    kept = int(re.search(r"loops kept: (\d+)", out).group(1))
    ate = float(re.search(r"keyframe ATE compact-vs-full: ([0-9.]+)", out).group(1))
    assert comp < full          # poses actually pruned
    assert kept > 0             # some loops accepted through the gain gate
    assert ate < 1.0            # compact trajectory tracks the full one
