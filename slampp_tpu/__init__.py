"""slampp_tpu — an accelerator-resident sparse nonlinear least-squares / SLAM /
SfM framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of SLAM++
(ru-wang/slam-plus-plus): g2o/TORO dataset ingestion, batch + incremental
Gauss-Newton / Levenberg-Marquardt / Dogleg over SE(2)/SE(3)/Sim(3) pose graphs
and bundle adjustment, block-sparse Hessian assembly via precomputed reduction
plans, Schur-complement elimination of landmarks, sparse block Cholesky, and
marginal-covariance recovery — scaled over device meshes with jax.sharding.

Design (see SURVEY.md §7): the reference gets speed from dynamic pointer-rich
block structures specialized at C++ compile time; a jitted accelerator
program needs static shapes — so all *symbolic* work (parsing, orderings,
elimination schedules, gather/scatter reduction plans) happens on host in
NumPy/C++, and all *numeric* work (residuals, Jacobians, lambda assembly,
Cholesky/Schur, solves, marginals) runs on device as fixed-shape jitted
programs.

Precision: the reference is float64 throughout (Eigen doubles); we enable
jax x64 at import so the chi-squared contract (BASELINE.md) can be met.
Set SLAMPP_NO_X64=1 to opt out (e.g. pure-f32 benchmarking).  f32 matrix
products run at full f32 precision ("highest"): the mixed-precision paths
(f32 frames + f64 refinement) assume it, and a GPU would otherwise be free
to run them in TF32.
"""

import os as _os

import jax as _jax

if not _os.environ.get("SLAMPP_NO_X64"):
    _jax.config.update("jax_enable_x64", True)
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
