"""Cassie biped adaptation (2 legs, position-form leg odometry).

The reference demonstrates Cassie in the paper (README.md:5) but ships no
Cassie kinematics in-repo — deployments supply `p_imu_2_foot`/`J_imu_2_foot`
through the robotSub seam (go1Sub.hpp:32-50 pattern). This module provides the
same seam engine-side: a 2-leg RobotModel with either (a) passthrough channels
(the deployment computes FK externally, e.g. from its own codegen) or (b) a
built-in 3-DoF serial-chain approximation (hip-roll / hip-pitch / knee with
shank+tarsus lumped) for synthetic logs and tests.

Cassie MHE configuration uses leg_odom_type=1 (foot positions as states,
DecentralEst.cpp:101-118) with num_legs=2 => dim_state = 15.
"""

from __future__ import annotations

import jax.numpy as jnp

from decentralized_ekf_mhe_tpu.models.base import RobotModel

# Approximate Cassie geometry (meters): pelvis->hip offsets, thigh, shank+tarsus
HIP_X = 0.021
HIP_Y = 0.135
L_THIGH = 0.12
L_SHANK = 0.4323  # lumped shank + tarsus effective length

_SY = jnp.asarray([-1.0, 1.0])  # leg order: right, left


def _leg_fk(q, sy):
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = jnp.sin(q1), jnp.cos(q1)
    xp = -L_THIGH * jnp.sin(q2) - L_SHANK * jnp.sin(q2 + q3)
    zp = -L_THIGH * jnp.cos(q2) - L_SHANK * jnp.cos(q2 + q3)
    x = HIP_X + xp
    y = sy * HIP_Y * c1 - s1 * zp
    z = sy * HIP_Y * s1 + c1 * zp
    return jnp.stack([x, y, z], axis=-1)


def _leg_jacobian(q, sy):
    q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = jnp.sin(q1), jnp.cos(q1)
    s2, c2 = jnp.sin(q2), jnp.cos(q2)
    s23, c23 = jnp.sin(q2 + q3), jnp.cos(q2 + q3)
    zp = -L_THIGH * c2 - L_SHANK * c23
    dxp_dq2 = -L_THIGH * c2 - L_SHANK * c23
    dxp_dq3 = -L_SHANK * c23
    dzp_dq2 = L_THIGH * s2 + L_SHANK * s23
    dzp_dq3 = L_SHANK * s23
    zero = jnp.zeros_like(q1)
    J = jnp.stack(
        [
            zero, dxp_dq2, dxp_dq3,
            -sy * HIP_Y * s1 - c1 * zp, -s1 * dzp_dq2, -s1 * dzp_dq3,
            sy * HIP_Y * c1 - s1 * zp, c1 * dzp_dq2, c1 * dzp_dq3,
        ],
        axis=-1,
    )
    return J.reshape(q.shape[:-1] + (3, 3))


class CassieModel(RobotModel):
    name = "cassie"
    num_legs = 2

    def __init__(self, p_ib=(0.0, 0.0, 0.0), contact_threshold=150.0):
        super().__init__(p_ib=p_ib, contact_threshold=contact_threshold)

    def fk(self, joints: jnp.ndarray) -> jnp.ndarray:
        """(..., 2, 3) joints -> (..., 2, 3) foot positions (pelvis frame)."""
        return _leg_fk(joints, _SY.astype(joints.dtype))

    def jacobian(self, joints: jnp.ndarray) -> jnp.ndarray:
        return _leg_jacobian(joints, _SY.astype(joints.dtype))
