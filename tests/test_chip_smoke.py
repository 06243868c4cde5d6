"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to run
anywhere but the GPU.  The full-size run happens on the card
(``python chip_smoke.py``); ``test_chip_smoke_kernels_on_gpu`` is the
``gpu``-marked slice of it."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# f64 CPU oracles at the tiny sizes (computed as the module's full-size pins)
CHI2_MANHATTAN120_CLI = 3.172185311820245
CHI2_MANHATTAN120_V3 = 3.1722  # bench.py's pin; its 2% small-size tolerance
CHI2_SPHERE200_V3 = 1065.6462091312276


def test_device_phase_refuses_cpu():
    with pytest.raises(AssertionError, match="needs the GPU"):
        cs.phase_device()


def test_precision_phase():
    assert jax.config.jax_default_matmul_precision == "highest"
    cs.phase_precision(n=128)


def test_dense_kernels_phase():
    cs.phase_dense_kernels(K=3, M=48, S=16, Ms=64)


def test_manhattan_cli_phase():
    cs.phase_manhattan_cli(120, CHI2_MANHATTAN120_CLI)


def test_manhattan_v3_phase():
    cs.phase_manhattan_v3(120, CHI2_MANHATTAN120_V3, rtol=2e-2)


def test_sphere_dense_frame_phase():
    cs.phase_sphere_dense_frame(200, 10, CHI2_SPHERE200_V3)


def test_venice_phase():
    cs.phase_venice_ba(n_cams=30, n_points=600, mean_track=4, iters=2)


def test_cli_big_ba_routing_phase(monkeypatch):
    monkeypatch.setenv("SLAMPP_BIGBA_THRESHOLD", "100")
    cs.phase_cli_big_ba_routing(n_cams=6, n_points=60, obs_per_point=4)


def test_incremental_fastl_phase():
    cs.phase_incremental_fastl(120)


def test_graft_entry_phase():
    cs.phase_graft_entry()


def test_distributed_big_ba_phase():
    cs.phase_distributed_big_ba(n_cams=12, n_points=200, mean_track=4, n_dev=4)


def test_distributed_gn_phase():
    cs.phase_distributed_gn(n_poses=120, n_dev=4)


def test_distributed_marginals_phase():
    cs.phase_distributed_marginals(n_cams=12, n_points=200, mean_track=4, n_dev=4)


def _script(path, *args):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, path, *args], capture_output=True,
                          text=True, timeout=300, env=env, cwd=os.path.dirname(path))


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_chip_smoke_fails_without_gpu(args):
    out = _script(os.path.join(ROOT, "chip_smoke.py"), *args)
    assert out.returncode != 0
    assert "device: FAIL" in out.stdout
    assert not any(l.startswith("{") for l in out.stdout.splitlines())


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    path = shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _script(path)
    assert out.returncode != 0
    assert not any(l.startswith("{") for l in out.stdout.splitlines())


@pytest.mark.gpu
def test_chip_smoke_kernels_on_gpu(gpu):
    """device, precision and dense_kernels at the sphere2500 frame shapes,
    in a child process (this one is pinned to the CPU)."""
    code = (
        "import chip_smoke as cs\n"
        "cs.phase_device(); cs.phase_precision()\n"
        "cs.phase_dense_kernels(*cs._sphere_frame_shapes(2500))\n"
        "print('GPU_OK')\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "GPU_OK" in out.stdout
