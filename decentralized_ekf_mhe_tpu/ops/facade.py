"""Stateful estimator facade — API parity with `DecentralizedEstimation`.

The reference exposes the estimator to deployments as a three-method object:
``initialize(store, params)`` / ``update(T)`` / ``reset()``
(DecentralEst.hpp:101-103, driven from robotSub::timerCallback,
EstSub.cpp:58-91). This facade offers the same surface for online /
tick-at-a-time use (hardware-in-the-loop, notebooks), wrapping the pure
scan-oriented kernels with a cached jitted step. For offline replay and
fleets, prefer the functional drivers (ops/estimator.run_mhe / run_kf,
parallel.batch) — one fused scan is far faster than per-tick dispatch.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from decentralized_ekf_mhe_tpu.config import EstimatorParams
from decentralized_ekf_mhe_tpu.ops import assembly, kf, mhe
from decentralized_ekf_mhe_tpu.utils.precision import full_precision


class DecentralizedEstimator:
    """Tick-at-a-time decentralized estimator (MHE or KF per est_type)."""

    def __init__(self, params: EstimatorParams, dtype=jnp.float32,
                 x_lb=None, x_ub=None,
                 lever_arm=kf.DEFAULT_LEVER_ARM, history_ticks: int = 256):
        self.params = params
        self.dtype = dtype
        self.est_type = params.est_type
        self._c = mhe.make_consts(params, dtype, x_lb=x_lb, x_ub=x_ub)
        self._nc = assembly.make_noise_consts(params, dtype)
        self._A_meas = assembly.a_meas(params, dtype)
        self._lever = jnp.asarray(lever_arm, dtype)
        # Bounded host-side orientation ring for the VO R_pre lookup
        # (DecentralEst.cpp:915). Only the single (3,3) pre-frame rotation is
        # shipped to device per update; tick indices stay ABSOLUTE (no modular
        # aliasing past the ring length — the ring only has to cover the VO
        # pipeline latency, a handful of ticks).
        self._R_hist = np.zeros((history_ticks, 3, 3))
        self._state = None
        self._kf_prev = None
        self.T = 0
        self.x = None
        self.v_body = None
        self._mhe_step_jit = None
        self._block_jit = {}          # K -> jitted K-tick scan

    # -- DecentralizedEstimation::initialize (DecentralEst.cpp:9-150) ------
    @full_precision
    def initialize(self, R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact):
        a = lambda v: jnp.asarray(v, self.dtype)
        args = tuple(map(a, (R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact)))
        self._R_hist[0] = np.asarray(R_sb)
        if self.est_type == 0:
            self._state = mhe.init(self._c, *args, dtype=self.dtype)
            xw = mhe.solve_window(self._c, self._state)
            self.x = xw[..., self._c.N - 1, :]
        else:
            b0, C0, _ = assembly.build_measurement(
                self.params, self._nc, args[0], args[2], args[3], args[4],
                args[5], args[6],
            )
            self._state = kf.init(self.params, self._nc, self._A_meas, b0, C0)
            self._kf_prev = (
                args[0], assembly.spatial_accel(args[0], args[1], self._nc), args[6]
            )
            self.x = self._state.x
        self.v_body = kf.body_velocity(self.x, args[0], args[2], self._lever)
        self.T = 1
        return self.x

    # -- DecentralizedEstimation::update (DecentralEst.cpp:152-198) --------
    @full_precision
    def update(self, R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact,
               vo_active=False, vo_dp=None, vo_tick_pre=0, vo_tick_now=0):
        if self._state is None:
            raise RuntimeError("call initialize() before update()")
        a = lambda v: jnp.asarray(v, self.dtype)
        args = tuple(map(a, (R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact)))
        self._R_hist[self.T % len(self._R_hist)] = np.asarray(R_sb)

        if self.est_type == 0:
            if self._mhe_step_jit is None:
                # donate the carry: the previous window state's device buffers
                # are reused in place instead of allocating per tick
                self._mhe_step_jit = jax.jit(
                    lambda st, *a_, : mhe.step(self._c, st, *a_),
                    donate_argnums=0,
                )
            vo_dp = a(vo_dp) if vo_dp is not None else jnp.zeros(3, self.dtype)
            if vo_active and self.T - int(vo_tick_pre) >= len(self._R_hist):
                raise ValueError(
                    f"VO previous frame (tick {int(vo_tick_pre)}) predates the "
                    f"{len(self._R_hist)}-tick orientation history at tick "
                    f"{self.T}; raise history_ticks"
                )
            R_pre = jnp.asarray(
                self._R_hist[int(vo_tick_pre) % len(self._R_hist)], self.dtype
            )
            self._state, (x_T, _) = self._mhe_step_jit(
                self._state, *args, bool(vo_active), vo_dp,
                jnp.asarray(int(vo_tick_pre), jnp.int32),
                jnp.asarray(int(vo_tick_now), jnp.int32), R_pre,
            )
            self.x = x_T
        else:
            R_prev, accel_s_prev, contact_prev = self._kf_prev
            A_dyn, b_dyn, C_dyn, _ = assembly.build_dynamics(
                self.params, self._nc, R_prev, accel_s_prev, contact_prev
            )
            b_meas, C_meas, _ = assembly.build_measurement(
                self.params, self._nc, args[0], args[2], args[3], args[4],
                args[5], args[6],
            )
            self._state = kf.update(self._state, A_dyn, b_dyn, C_dyn,
                                    self._A_meas, b_meas, C_meas)
            self._kf_prev = (
                args[0], assembly.spatial_accel(args[0], args[1], self._nc), args[6]
            )
            self.x = self._state.x
        self.v_body = kf.body_velocity(self.x, args[0], args[2], self._lever)
        self.T += 1
        return self.x

    # -- block update: K ticks in ONE device dispatch ----------------------
    @full_precision
    def update_block(self, R_sb, accel_b, omega_b, p_foot, J_foot, dq,
                     contact, vo_active=None, vo_dp=None, vo_tick_pre=None,
                     vo_tick_now=None):
        """Process K aligned ticks in one dispatch — the HIL hot path.

        All tensor args carry a leading K axis (R_sb (K,3,3), accel_b (K,3),
        …, vo_active (K,) bool, vo_dp (K,3), vo_tick_pre/now (K,) absolute
        tick indices). Internally a jitted ``lax.scan`` of ``mhe.step`` with
        the carry DONATED, so per-call Python/dispatch overhead (the p99
        killer of tick-at-a-time use over remote transports) is amortized
        K-fold. Semantics are exactly K calls of update() (MHE path only).

        Returns (x (K,s), v_body (K,3)); advances T by K.
        """
        if self._state is None:
            raise RuntimeError("call initialize() before update_block()")
        if self.est_type != 0:
            raise NotImplementedError("update_block is MHE-only (est_type=0)")
        a = lambda v: jnp.asarray(v, self.dtype)
        R_np = np.asarray(R_sb)
        K = R_np.shape[0]
        H = len(self._R_hist)
        # Snapshot the ring BEFORE writing the block's rows: an event at block
        # index k may reference a pre-block tick whose slot a LATER row of
        # this same block (tick vtp+H > T+k) would clobber — gathering
        # pre-block references from the snapshot and in-block references from
        # R_np keeps the semantics of exactly K calls of update().
        ring_pre = self._R_hist.copy()
        for k in range(K):
            self._R_hist[(self.T + k) % H] = R_np[k]
        va = (np.zeros(K, bool) if vo_active is None
              else np.asarray(vo_active, bool))
        vdp = (np.zeros((K, 3)) if vo_dp is None else np.asarray(vo_dp))
        vtp = (np.zeros(K, np.int64) if vo_tick_pre is None
               else np.asarray(vo_tick_pre, np.int64))
        vtn = (np.zeros(K, np.int64) if vo_tick_now is None
               else np.asarray(vo_tick_now, np.int64))
        ticks = self.T + np.arange(K)
        if bool((va & (ticks - vtp >= H)).any()):
            raise ValueError(
                f"a VO previous frame predates the {H}-tick orientation "
                f"history; raise history_ticks")
        in_blk = vtp >= self.T
        R_pre = np.where(in_blk[:, None, None],
                         R_np[np.clip(vtp - self.T, 0, K - 1)],
                         ring_pre[vtp % H])

        if K not in self._block_jit:
            c = self._c
            lever = self._lever

            def block_step(st, R, ab, ob, pf, Jf, dqv, ct, vav, vdpv, vtpv,
                           vtnv, Rpre):
                def scan_step(st_, inp):
                    (R_, ab_, ob_, pf_, Jf_, dq_, ct_, va_, vdp_, vtp_,
                     vtn_, Rp_) = inp
                    st_, (x_T, _) = mhe.step(
                        c, st_, R_, ab_, ob_, pf_, Jf_, dq_, ct_, va_,
                        vdp_, vtp_, vtn_, Rp_)
                    v_b = kf.body_velocity(x_T, R_, ob_, lever)
                    return st_, (x_T, v_b)

                return jax.lax.scan(
                    scan_step, st,
                    (R, ab, ob, pf, Jf, dqv, ct, vav, vdpv, vtpv, vtnv, Rpre))

            self._block_jit[K] = jax.jit(block_step, donate_argnums=0)

        self._state, (x_seq, v_seq) = self._block_jit[K](
            self._state, a(R_sb), a(accel_b), a(omega_b), a(p_foot),
            a(J_foot), a(dq), a(contact), jnp.asarray(va),
            a(vdp), jnp.asarray(vtp, jnp.int32), jnp.asarray(vtn, jnp.int32),
            a(R_pre))
        self.x = x_seq[-1]
        self.v_body = v_seq[-1]
        self.T += K
        return x_seq, v_seq

    # -- DecentralizedEstimation::reset -> MHEproblem::resetQP -------------
    def reset(self):
        """Full estimator reset (DecentralEst.cpp:1011-1015, MheSrb.cpp:734-760)."""
        self._state = None
        self._kf_prev = None
        self.T = 0
        self.x = None
        self.v_body = None


class PipelineEstimator:
    """Stateful FULL-CYCLE facade: orientation EKF *in the loop* + MHE.

    The reference deployment runs `orien_est` live — the 500 Hz quaternion
    EKF publishes `imu/filter` (orien_ekf.cpp:77-105) which `robotSub`
    consumes every 5 ms cycle (EstSub.cpp:34-43) before the MHE solve. This
    facade closes the same loop for streaming/HIL use: ``update_block``
    takes RAW gyro/accel substep blocks plus the tick-rate leg-odometry
    rows, runs ekf_lanes.substep_block and mhe_lanes.step in the SAME jitted
    scan (donated carry, one dispatch per K ticks), and keeps a device-side
    orientation ring for the MHE's delayed-VO R_pre lookup
    (DecentralEst.cpp:915). Block-streamed output equals the offline
    run_pipeline_lanes replay exactly (tests/test_facade.py).
    """

    def __init__(self, params: EstimatorParams, ekf_params,
                 dtype=jnp.float32, x_lb=None, x_ub=None,
                 ekf_ring_len: int = 16,
                 lever_arm=kf.DEFAULT_LEVER_ARM, history_ticks: int = 256):
        from decentralized_ekf_mhe_tpu.ops import ekf_lanes

        self.params = params
        self.ekf_params = ekf_params
        self.dtype = dtype
        self._c = mhe.make_consts(params, dtype, x_lb=x_lb, x_ub=x_ub)
        self._ec = ekf_lanes.make_consts(ekf_params, dtype)
        self._ekf_ring_len = ekf_ring_len
        self._H = history_ticks
        self._lever = jnp.asarray(lever_arm, dtype)
        self._carry = None
        self.T = 0
        self.x = None
        self.v_body = None
        self.q = None
        self._block_jit = {}

    def _lanes(self, a, tail_dims):
        """Host array -> lanes layout with a singleton instance axis."""
        return jnp.asarray(a, self.dtype)[..., None]

    # -- tick-0: EKF over block 0 -> R_0 -> InitializeMHE ------------------
    def initialize(self, ekf_gyro, ekf_accel, ekf_valid,
                   accel_b, omega_b, p_foot, J_foot, dq, contact,
                   ekf_vo_active=None, ekf_vo_q=None, ekf_vo_steps_back=None):
        """Tick 0 (timerCallback first pass, EstSub.cpp:65-70): run the
        tick's EKF substeps (ekf_gyro/ekf_accel (S,3), ekf_valid (S,)),
        then InitializeMHE with the fused orientation."""
        from decentralized_ekf_mhe_tpu.ops import ekf_lanes, mhe_lanes

        S = np.asarray(ekf_gyro).shape[0]
        ekf_st = ekf_lanes.init_state(self.ekf_params, 1,
                                      ring_len=self._ekf_ring_len,
                                      dtype=self.dtype)
        va = (np.zeros(S, bool) if ekf_vo_active is None
              else np.asarray(ekf_vo_active, bool))
        vq = (np.zeros((S, 4)) if ekf_vo_q is None
              else np.asarray(ekf_vo_q))
        sb = (np.zeros(S, np.int64) if ekf_vo_steps_back is None
              else np.asarray(ekf_vo_steps_back, np.int64))
        ekf_st = ekf_lanes.substep_block(
            ekf_st, self._lanes(ekf_gyro, 1), self._lanes(ekf_accel, 1),
            jnp.asarray(ekf_valid, bool), jnp.asarray(va),
            jnp.asarray(vq, self.dtype), jnp.asarray(sb, jnp.int32),
            self._ec)
        R0 = ekf_lanes.to_rot(ekf_st.q)                  # (3,3,1)

        l = self._lanes
        mhe_st = mhe_lanes.init(
            self._c, R0, l(accel_b, 1), l(omega_b, 1), l(p_foot, 2),
            l(J_foot, 3), l(dq, 2), l(contact, 1), dtype=self.dtype)
        x0 = mhe_lanes.solve_window(self._c, mhe_st)[self._c.N - 1]  # (s,1)
        ring = jnp.zeros((self._H, 3, 3, 1), self.dtype).at[0].set(R0)
        self._carry = (ekf_st, mhe_st, ring, jnp.asarray(0, jnp.int32))
        self.x = x0[:, 0]
        self.q = ekf_st.q[:, 0]
        from decentralized_ekf_mhe_tpu.ops import lanes as lanes_ops
        self.v_body = lanes_ops.mv(
            R0, x0[3:6] + lanes_ops.cross(l(omega_b, 1),
                                          self._lever[:, None]))[:, 0]
        self.T = 1
        return self.x

    # -- K full cycles in ONE device dispatch ------------------------------
    def update_block(self, ekf_gyro, ekf_accel, ekf_valid,
                     accel_b, omega_b, p_foot, J_foot, dq, contact,
                     ekf_vo_active=None, ekf_vo_q=None,
                     ekf_vo_steps_back=None,
                     vo_active=None, vo_dp=None, vo_tick_pre=None,
                     vo_tick_now=None):
        """Process K aligned FULL cycles (EKF substeps + MHE solve each) in
        one dispatch. EKF-rate args carry (K,S,...) padded blocks; MHE-rate
        args carry a leading K axis; vo_tick_* are absolute tick indices.
        Returns (x (K,s), v_body (K,3), q (K,4)); advances T by K."""
        if self._carry is None:
            raise RuntimeError("call initialize() before update_block()")
        a = lambda v: jnp.asarray(v, self.dtype)
        K, S = np.asarray(ekf_gyro).shape[:2]
        H = self._H
        eva = (np.zeros((K, S), bool) if ekf_vo_active is None
               else np.asarray(ekf_vo_active, bool))
        evq = (np.zeros((K, S, 4)) if ekf_vo_q is None
               else np.asarray(ekf_vo_q))
        esb = (np.zeros((K, S), np.int64) if ekf_vo_steps_back is None
               else np.asarray(ekf_vo_steps_back, np.int64))
        va = (np.zeros(K, bool) if vo_active is None
              else np.asarray(vo_active, bool))
        vdp = (np.zeros((K, 3)) if vo_dp is None else np.asarray(vo_dp))
        vtp = (np.zeros(K, np.int64) if vo_tick_pre is None
               else np.asarray(vo_tick_pre, np.int64))
        vtn = (np.zeros(K, np.int64) if vo_tick_now is None
               else np.asarray(vo_tick_now, np.int64))
        ticks = self.T + np.arange(K)
        if bool((va & (ticks - vtp >= H)).any()):
            raise ValueError(
                f"a VO previous frame predates the {H}-tick orientation "
                f"ring; raise history_ticks")

        key = (K, S)
        if key not in self._block_jit:
            c = self._c
            ec = self._ec
            lever = self._lever
            Hn = self._H

            def block_step(carry, gyro, accel, valid, eva_, evq_, esb_,
                           ab, ob, pf, Jf, dqv, ct, va_, vdp_, vtp_, vtn_):
                from decentralized_ekf_mhe_tpu.ops import (
                    ekf_lanes, lanes as lanes_ops, mhe_lanes)

                def scan_step(cr, inp):
                    ekf_st, mhe_st, ring, t = cr
                    (g, ac, vl, ea, eq, es, ab1, ob1, pf1, Jf1, dq1, ct1,
                     v1, dp1, tp1, tn1) = inp
                    ekf_st = ekf_lanes.substep_block(
                        ekf_st, g[..., None], ac[..., None], vl, ea,
                        eq, es, ec)
                    R_t = ekf_lanes.to_rot(ekf_st.q)      # (3,3,1)
                    t = t + 1
                    ring = ring.at[jnp.mod(t, Hn)].set(R_t)
                    R_pre = ring[jnp.mod(tp1, Hn)]
                    mhe_st, (x_T, _) = mhe_lanes.step(
                        c, mhe_st, R_t, ab1[:, None], ob1[:, None],
                        pf1[..., None], Jf1[..., None], dq1[..., None],
                        ct1[..., None], v1, dp1[:, None], tp1, tn1, R_pre)
                    v_b = lanes_ops.mv(
                        R_t, x_T[3:6] + lanes_ops.cross(ob1[:, None],
                                                        lever[:, None]))
                    return (ekf_st, mhe_st, ring, t), (
                        x_T[:, 0], v_b[:, 0], ekf_st.q[:, 0])

                return jax.lax.scan(
                    scan_step, carry,
                    (gyro, accel, valid, eva_, evq_, esb_, ab, ob, pf, Jf,
                     dqv, ct, va_, vdp_, vtp_, vtn_))

            self._block_jit[key] = jax.jit(block_step, donate_argnums=0)

        carry0 = self._carry
        # the in-graph ring is indexed by absolute tick mod H; seed the scan
        # tick counter from self.T - 1 (the last completed tick)
        carry0 = (carry0[0], carry0[1], carry0[2],
                  jnp.asarray(self.T - 1, jnp.int32))
        self._carry, (x_seq, v_seq, q_seq) = self._block_jit[key](
            carry0, a(ekf_gyro), a(ekf_accel), jnp.asarray(ekf_valid, bool),
            jnp.asarray(eva), a(evq), jnp.asarray(esb, jnp.int32),
            a(accel_b), a(omega_b), a(p_foot), a(J_foot), a(dq), a(contact),
            jnp.asarray(va), a(vdp), jnp.asarray(vtp, jnp.int32),
            jnp.asarray(vtn, jnp.int32))
        self.x = x_seq[-1]
        self.v_body = v_seq[-1]
        self.q = q_seq[-1]
        self.T += K
        return x_seq, v_seq, q_seq

    def reset(self):
        self._carry = None
        self.T = 0
        self.x = None
        self.v_body = None
        self.q = None
