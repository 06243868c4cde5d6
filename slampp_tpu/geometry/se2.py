"""SE(2) pose math as pure JAX functions.

Capability parity with the reference's ``C2DJacobians``
(``include/slam/2DSolverBase.h:37``): poses are (x, y, theta) vectors, the
composition/relative transforms match the reference's conventions exactly
(including the fmod-style angle clamping into (-2pi, 2pi) and the
minimum-absolute angular-error fixup), so chi-squared values are comparable
bit-for-bit at f64.

All functions are written for single poses and are ``jax.vmap``-able over
leading batch dimensions; solvers always call them vmapped over edge arrays
(the device replacement for the reference's OpenMP ``For_Each_Parallel``).
"""

from __future__ import annotations

import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi


def clamp_angle_2pi(a):
    """Angle modulo into (-2pi, 2pi), preserving sign (C fmod semantics).

    Reference: ``C2DJacobians::f_ClampAngle_2Pi`` (2DSolverBase.h:45).
    """
    return jnp.where(jnp.isfinite(a), jnp.fmod(a, TWO_PI), 0.0)


def clamp_angular_error_2pi(e):
    """Fix up an angular error to its minimum-absolute 2pi-congruent value.

    Reference: ``C2DJacobians::f_ClampAngularError_2Pi`` (2DSolverBase.h:91).
    """
    e = clamp_angle_2pi(e)
    cand = jnp.stack([e, e - TWO_PI, e + TWO_PI])
    return cand[jnp.argmin(jnp.abs(cand))]


def relative_to_absolute(p1, d):
    """Compose: pose of ``d`` (relative to ``p1``) in the global frame.

    Reference: ``C2DJacobians::Relative_to_Absolute`` (2DSolverBase.h:108).
    """
    c, s = jnp.cos(p1[2]), jnp.sin(p1[2])
    return jnp.stack(
        [
            p1[0] + c * d[0] - s * d[1],
            p1[1] + s * d[0] + c * d[1],
            clamp_angle_2pi(p1[2] + d[2]),
        ]
    )


def absolute_to_relative(p1, p2):
    """Pose of ``p2`` expressed in the frame of ``p1`` (the edge expectation h(x)).

    Reference: ``C2DJacobians::Absolute_to_Relative`` (2DSolverBase.h:269).
    """
    de, dn = p2[0] - p1[0], p2[1] - p1[1]
    c, s = jnp.cos(p1[2]), jnp.sin(p1[2])
    return jnp.stack(
        [
            c * de + s * dn,
            -s * de + c * dn,
            clamp_angle_2pi(p2[2] - p1[2]),
        ]
    )


def absolute_to_relative_jacobians(p1, p2):
    """Hand-derived Jacobians of :func:`absolute_to_relative` w.r.t. (p1, p2).

    Matches the symbolic Jacobians documented in the reference
    (2DSolverBase.h:330-345); also obtainable by autodiff — kept explicit
    because this is the hot path for pose-graph lambda assembly.

    Returns (expectation, J1, J2) with J* of shape (3, 3).
    """
    de, dn = p2[0] - p1[0], p2[1] - p1[1]
    c, s = jnp.cos(p1[2]), jnp.sin(p1[2])
    h = jnp.stack([c * de + s * dn, -s * de + c * dn, clamp_angle_2pi(p2[2] - p1[2])])
    j1 = jnp.stack(
        [
            jnp.stack([-c, -s, -s * de + c * dn]),
            jnp.stack([s, -c, -(c * de + s * dn)]),
            jnp.array([0.0, 0.0, -1.0]),
        ]
    )
    j2 = jnp.stack(
        [
            jnp.stack([c, s, jnp.zeros(())]),
            jnp.stack([-s, c, jnp.zeros(())]),
            jnp.array([0.0, 0.0, 1.0]),
        ]
    )
    return h, j1, j2


def pose_pose_error(x0, x1, meas):
    """Residual of an SE(2) odometry/loop edge: ``z - h(x0, x1)`` with angular fixup.

    Reference: ``CEdgePose2D::Calculate_Jacobians_Expectation_Error``
    (SE2_Types.h:305-318).
    """
    err = meas - absolute_to_relative(x0, x1)
    return err.at[2].set(clamp_angular_error_2pi(err[2]))


def pose_landmark_xy_error(x0, lm, meas):
    """Residual of an SE(2) pose->landmark XY observation edge.

    The expectation is the landmark position in the observing pose's frame.
    Reference: ``CEdgePoseLandmark2D`` (SE2_Types.h:340+) / ``Observation2D_RangeBearing``
    relatives in 2DSolverBase.h.
    """
    de, dn = lm[0] - x0[0], lm[1] - x0[1]
    c, s = jnp.cos(x0[2]), jnp.sin(x0[2])
    h = jnp.stack([c * de + s * dn, -s * de + c * dn])
    return meas - h


def pose_landmark_rb_error(x0, lm, meas):
    """Residual of an SE(2) pose->landmark range-bearing edge (LANDMARK2:RB)."""
    de, dn = lm[0] - x0[0], lm[1] - x0[1]
    rng = jnp.sqrt(de * de + dn * dn)
    brg = jnp.arctan2(dn, de) - x0[2]
    err = meas - jnp.stack([rng, brg])
    return err.at[1].set(clamp_angular_error_2pi(err[1]))


def plus(state, delta):
    """Vertex retraction for SE(2) poses: plain addition + angle clamp.

    Reference: ``CVertexPose2D::Operator_Plus`` (SE2_Types.h:70-75).
    """
    out = state + delta
    return out.at[..., 2].set(clamp_angle_2pi(out[..., 2]))
