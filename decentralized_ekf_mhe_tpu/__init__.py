"""decentralized_ekf_mhe_tpu — batched decentralized state estimation for legged robots.

A from-scratch JAX/XLA re-design of the capabilities of
well-robotics/Decentralized_EKF_MHE (arXiv:2405.20567): a quaternion EKF for
orientation (IMU + vision fusion) decoupled from a constrained Moving Horizon
Estimator over time-varying *linear* velocity/position dynamics.

Where the reference is a single-robot, CPU real-time ROS2 workspace
(C++ / Eigen / OSQP), this package is a batched, fused, multi-device GPU engine:

- the orientation EKF (reference: src/orien_est/src/orien_ekf.cpp) is a fused
  `lax.scan` kernel, vmappable over thousands of instances;
- the MHE's sparse OSQP QP (reference: src/decentral_legged_est/src/MheSrb.cpp)
  becomes an *exact* batched block-tridiagonal solve — the reference's
  slack-variable equality-constrained QP reduces analytically to an
  unconstrained banded least-squares in the states — plus an OSQP-semantics
  ADMM path for genuinely inequality-constrained configurations;
- the Schur-complement marginalization / recursive arrival cost
  (MheSrb.cpp:475-713) is a fixed-shape batched kernel fused with the window
  shift;
- FROST/Mathematica leg kinematics codegen (src/go1_example/src/Expressions/*)
  becomes vectorized closed-form JAX kinematics;
- ROS2 DDS pub/sub becomes in-graph array handoff inside one jitted step, with
  `jax.sharding` collectives for cross-instance reductions across devices.
"""

__version__ = "0.1.0"

from decentralized_ekf_mhe_tpu.config import (  # noqa: F401
    EKFParams,
    EstimatorParams,
    OSQPParams,
    load_yaml_params,
)
