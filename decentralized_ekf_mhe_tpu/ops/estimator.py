"""Fused estimation drivers: scan the full decentralized pipeline over a log.

The reference splits EKF (500 Hz), MHE/KF (200 Hz) and VO (30 Hz) into three
OS processes wired by DDS topics (go1_launch.py:18-63); here each stage is a
pure function and one jitted `lax.scan` replays the entire log on-device —
the EKF→estimator handoff is an in-graph array, and rate mismatch becomes
per-tick sub-stepping (SURVEY.md §2 parallelism table).

This module currently provides the KF-path slice (est_type=1); the MHE path
plugs into the same scan via ops.mhe.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from decentralized_ekf_mhe_tpu.config import EstimatorParams
from decentralized_ekf_mhe_tpu.ops import assembly, kf
from decentralized_ekf_mhe_tpu.utils import quaternion as quat
from decentralized_ekf_mhe_tpu.utils.precision import full_precision


class TickData(NamedTuple):
    """Per-MHE-tick aligned inputs (leading axis = time inside scan)."""

    accel_b: jnp.ndarray   # (3,)
    omega_b: jnp.ndarray   # (3,)
    R_sb: jnp.ndarray      # (3,3) orientation input (EKF output or GT)
    p_foot: jnp.ndarray    # (L,3)
    J_foot: jnp.ndarray    # (L,3,3)
    dq: jnp.ndarray        # (L,3)
    contact: jnp.ndarray   # (L,)


def tickdata_from_log(log, R_sb=None, dtype=jnp.float64) -> TickData:
    """Pack a SynthLog / replay log into scan-ready TickData (time-leading)."""
    R = log.R_sb_gt if R_sb is None else R_sb
    return TickData(
        accel_b=jnp.asarray(log.accel_b, dtype),
        omega_b=jnp.asarray(log.omega_b, dtype),
        R_sb=jnp.asarray(R, dtype),
        p_foot=jnp.asarray(log.p_foot, dtype),
        J_foot=jnp.asarray(log.J_foot, dtype),
        dq=jnp.asarray(log.dq, dtype),
        contact=jnp.asarray(log.contact, dtype),
    )


@full_precision
def run_kf(
    params: EstimatorParams,
    data: TickData,
    lever_arm=kf.DEFAULT_LEVER_ARM,
    dtype=jnp.float64,
):
    """Replay the KF baseline over a log (est_type=1 path, EstSub.cpp:58-91).

    Returns (x_seq (T,s), v_b_seq (T,3)); tick 0 performs InitializeKF, ticks
    1.. perform UpdateKF, exactly as timerCallback dispatches them.
    """
    nc = assembly.make_noise_consts(params, dtype)
    A_meas = assembly.a_meas(params, dtype)
    lever = jnp.asarray(lever_arm, dtype)

    d0 = jax.tree.map(lambda a: a[0], data)
    b0, C0, _ = assembly.build_measurement(
        params, nc, d0.R_sb, d0.omega_b, d0.p_foot, d0.J_foot, d0.dq, d0.contact
    )
    state = kf.init(params, nc, A_meas, b0, C0)
    x0 = state.x
    v0 = kf.body_velocity(state.x, d0.R_sb, d0.omega_b, lever)

    # UpdateKF reads R/accel_s/contact from the stacks *before* GetMeasurement
    # pushes the current tick (DecentralEst.cpp:707-709, 766) — prediction at
    # tick T uses the inputs of tick T−1, correction uses tick T.
    prev0 = (d0.R_sb, assembly.spatial_accel(d0.R_sb, d0.accel_b, nc), d0.contact)

    def step(carry, d: TickData):
        state, (R_prev, accel_s_prev, contact_prev) = carry
        A_dyn, b_dyn, C_dyn, _ = assembly.build_dynamics(
            params, nc, R_prev, accel_s_prev, contact_prev
        )
        b_meas, C_meas, _ = assembly.build_measurement(
            params, nc, d.R_sb, d.omega_b, d.p_foot, d.J_foot, d.dq, d.contact
        )
        state = kf.update(state, A_dyn, b_dyn, C_dyn, A_meas, b_meas, C_meas)
        v_b = kf.body_velocity(state.x, d.R_sb, d.omega_b, lever)
        prev = (d.R_sb, assembly.spatial_accel(d.R_sb, d.accel_b, nc), d.contact)
        return (state, prev), (state.x, v_b)

    rest = jax.tree.map(lambda a: a[1:], data)
    _, (x_seq, v_seq) = jax.lax.scan(step, (state, prev0), rest)
    x_seq = jnp.concatenate([x0[None], x_seq], axis=0)
    v_seq = jnp.concatenate([v0[None], v_seq], axis=0)
    return x_seq, v_seq


class VOData(NamedTuple):
    """Per-tick VO event stream (time-leading), from the alignment pass."""

    active: jnp.ndarray    # (T,) bool
    dp_body: jnp.ndarray   # (T,3)
    tick_pre: jnp.ndarray  # (T,) int32
    tick_now: jnp.ndarray  # (T,) int32


def vodata_from_log(log, dtype=jnp.float64) -> VOData:
    return VOData(
        active=jnp.asarray(log.vo_active),
        dp_body=jnp.asarray(log.vo_dp_body, dtype),
        tick_pre=jnp.asarray(log.vo_tick_pre, jnp.int32),
        tick_now=jnp.asarray(log.vo_tick_now, jnp.int32),
    )


@full_precision
def run_mhe(
    params: EstimatorParams,
    data: TickData,
    vo: Optional[VOData] = None,
    lever_arm=kf.DEFAULT_LEVER_ARM,
    dtype=jnp.float64,
    consts=None,
):
    """Replay the MHE (est_type=0) over a log: init at tick 0, then one
    mhe.step per tick (the timerCallback dispatch, EstSub.cpp:58-91).

    ``data`` may be single-instance (T, ...) or fleet-batched (T, B, ...) —
    every kernel broadcasts over the trailing instance axis, so a batched
    time-leading layout replays the whole fleet in one scan (see
    parallel.batch.make_fused_batched_runner). Pass ``consts`` to override
    solver options (e.g. state constraints).

    Returns (x_seq (T,[B,]s), v_b_seq (T,[B,]3)). x_seq[0] is the
    prior+measurement solve at tick 0 (the reference does not publish an
    estimate at T=0; the slot is provided for completeness).
    """
    from decentralized_ekf_mhe_tpu.ops import mhe

    c = consts if consts is not None else mhe.make_consts(params, dtype)
    lever = jnp.asarray(lever_arm, dtype)
    T_total = data.accel_b.shape[0]
    if vo is None:
        vo = VOData(
            active=jnp.zeros(T_total, bool),
            dp_body=jnp.zeros((T_total, 3), dtype),
            tick_pre=jnp.zeros(T_total, jnp.int32),
            tick_now=jnp.zeros(T_total, jnp.int32),
        )
    # pre-gather the orientation at each VO pair's previous-frame tick (the
    # R_vo_sb_pre lookup of DecentralEst.cpp:915) so the scan carries no
    # history ring — one gather over the whole log instead of T dynamic slices
    R_pre_seq = data.R_sb[vo.tick_pre]

    d0 = jax.tree.map(lambda a: a[0], data)
    st = mhe.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot,
                  d0.dq, d0.contact, dtype=dtype)
    x0_win = mhe.solve_window(c, st)
    x0 = x0_win[..., c.N - 1, :]
    v0 = kf.body_velocity(x0, d0.R_sb, d0.omega_b, lever)

    def scan_step(st, inp):
        d, v, R_pre = inp
        st, (x_T, _) = mhe.step(
            c, st, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
            d.contact, v.active, v.dp_body, v.tick_pre, v.tick_now, R_pre,
        )
        v_b = kf.body_velocity(x_T, d.R_sb, d.omega_b, lever)
        return st, (x_T, v_b)

    rest = jax.tree.map(lambda a: a[1:], (data, vo, R_pre_seq))
    _, (x_seq, v_seq) = jax.lax.scan(scan_step, st, rest)
    x_seq = jnp.concatenate([x0[None], x_seq], axis=0)
    v_seq = jnp.concatenate([v0[None], v_seq], axis=0)
    return x_seq, v_seq


@full_precision
def run_mhe_lanes(
    params: EstimatorParams,
    data: TickData,
    vo: Optional[VOData] = None,
    lever_arm=kf.DEFAULT_LEVER_ARM,
    dtype=jnp.float32,
    consts=None,
):
    """Fleet MHE replay in instance-on-lanes layout (ops/mhe_lanes.py) — the
    lanes twin of run_mhe on a (T,B,...) fleet.

    ``data`` fields are lanes-layout time-leading: accel_b (T,3,B), R_sb
    (T,3,3,B), p_foot (T,L,3,B), ... (parallel.batch.tickdata_to_lanes
    converts from (T,B,...)).

    ``vo`` is either the shared fleet VO schedule (active (T,), dp_body
    (T,3), ticks (T,)) or a PER-INSTANCE schedule in lanes layout (active
    (T,B), dp_body (T,3,B), ticks (T,B)) — detected by active's rank; the
    per-instance path runs the fully masked mhe_lanes.step_per_instance_vo
    so Monte-Carlo fleets can perturb VO timing and content per lane.
    Returns (x_seq (T,B,s), v_b_seq (T,B,3)) in standard layout.
    """
    from decentralized_ekf_mhe_tpu.ops import lanes, mhe, mhe_lanes

    c = consts if consts is not None else mhe.make_consts(params, dtype)
    lever = jnp.asarray(lever_arm, dtype)
    T_total = data.accel_b.shape[0]
    if vo is None:
        vo = VOData(
            active=jnp.zeros(T_total, bool),
            dp_body=jnp.zeros((T_total, 3), dtype),
            tick_pre=jnp.zeros(T_total, jnp.int32),
            tick_now=jnp.zeros(T_total, jnp.int32),
        )
    per_instance_vo = vo.active.ndim == 2
    if per_instance_vo:
        # R_sb[tick_pre[t,b], :, :, b] — per-lane time gather
        R_pre_seq = jnp.take_along_axis(
            data.R_sb, vo.tick_pre[:, None, None, :], axis=0)
    else:
        R_pre_seq = data.R_sb[vo.tick_pre]  # (T,3,3,B) pre-frame orientations
    B = data.accel_b.shape[-1]
    lever_l = jnp.broadcast_to(lever[:, None], (3, B))

    def body_vel(x_T, R_sb, omega_b):
        return lanes.mv(R_sb, x_T[3:6] + lanes.cross(omega_b, lever_l))

    d0 = jax.tree.map(lambda a: a[0], data)
    st = mhe_lanes.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot,
                        d0.J_foot, d0.dq, d0.contact, dtype=dtype,
                        per_instance_vo=per_instance_vo)
    x0 = mhe_lanes.solve_window(c, st)[c.N - 1]
    v0 = body_vel(x0, d0.R_sb, d0.omega_b)

    step_fn = (mhe_lanes.step_per_instance_vo if per_instance_vo
               else mhe_lanes.step)

    def scan_step(st, inp):
        d, v, R_pre = inp
        st, (x_T, _) = step_fn(
            c, st, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
            d.contact, v.active, v.dp_body, v.tick_pre, v.tick_now, R_pre,
        )
        v_b = body_vel(x_T, d.R_sb, d.omega_b)
        return st, (x_T, v_b)

    rest = jax.tree.map(lambda a: a[1:], (data, vo, R_pre_seq))
    _, (x_seq, v_seq) = jax.lax.scan(scan_step, st, rest)
    x_seq = jnp.concatenate([x0[None], x_seq], axis=0)   # (T,s,B)
    v_seq = jnp.concatenate([v0[None], v_seq], axis=0)
    return jnp.moveaxis(x_seq, -1, 1), jnp.moveaxis(v_seq, -1, 1)


class EKFBlocks(NamedTuple):
    """EKF-rate inputs regrouped per MHE tick (the 500/200 Hz sub-stepping):
    tick k owns EKF substeps bounds[k]..bounds[k+1]-1, padded to S_max slots
    with ``valid`` masking the padding. vo_* carry the delayed VO quaternion
    events at EKF resolution (shared across a fleet — one camera log)."""

    gyro: jnp.ndarray           # (T,S,3) or lanes (T,S,3,B)
    accel: jnp.ndarray          # (T,S,3) or lanes (T,S,3,B)
    valid: jnp.ndarray          # (T,S) bool, shared
    vo_active: jnp.ndarray      # (T,S) bool, shared
    vo_q: jnp.ndarray           # (T,S,4), shared
    vo_steps_back: jnp.ndarray  # (T,S) int32, shared


def ekfblocks_from_log(log, dtype=jnp.float64) -> EKFBlocks:
    """Pack a log's EKF-rate streams into per-MHE-tick padded blocks."""
    substeps = np.asarray(log.ekf_substeps, np.int64)
    T = substeps.shape[0]
    S = int(substeps.max()) if T else 0
    bounds = np.concatenate([[0], np.cumsum(substeps)])
    T_ekf = int(bounds[-1])

    def blk(src, shape_tail, fill=0):
        out = np.full((T, S) + shape_tail, fill, dtype=np.asarray(src).dtype)
        for k in range(T):
            n = substeps[k]
            out[k, :n] = np.asarray(src)[bounds[k]:bounds[k] + n]
        return out

    valid = np.zeros((T, S), bool)
    for k in range(T):
        valid[k, : substeps[k]] = True
    return EKFBlocks(
        gyro=jnp.asarray(blk(log.ekf_gyro, (3,)), dtype),
        accel=jnp.asarray(blk(log.ekf_accel, (3,)), dtype),
        valid=jnp.asarray(valid),
        vo_active=jnp.asarray(blk(np.asarray(log.ekf_vo_active, bool), ())),
        vo_q=jnp.asarray(blk(log.ekf_vo_q, (4,)), dtype),
        vo_steps_back=jnp.asarray(
            blk(np.asarray(log.ekf_vo_steps_back, np.int64), ()), jnp.int32),
    )


def scan_ekf_blocks(ekf_st, ekf_blocks: EKFBlocks, ec):
    """Scan the per-tick EKF substep blocks over the whole log.

    When the measured VO quaternion is PER-LANE ((T,S,4,B) — Monte-Carlo
    vision draws, perturb_ekf_blocks(vo_noise_scale)), that tensor is NOT
    streamed through the scan: it stays a loop-invariant in HBM and a
    tick-level ``lax.cond`` on "any VO event this tick" dynamic-slices the
    (S,4,B) block only on active ticks (~15% at 30 Hz VO / 200 Hz ticks) —
    streaming it per tick cost the benched pipeline ~8%.
    Returns (final_state, q_seq (T,4,B))."""
    from decentralized_ekf_mhe_tpu.ops import ekf_lanes

    if ekf_blocks.vo_q.ndim != 4:
        def ekf_step(st, ebt):
            st = ekf_lanes.substep_block(
                st, ebt.gyro, ebt.accel, ebt.valid, ebt.vo_active, ebt.vo_q,
                ebt.vo_steps_back, ec)
            return st, st.q

        return jax.lax.scan(ekf_step, ekf_st, ekf_blocks)

    vo_q_full = ekf_blocks.vo_q                       # (T,S,4,B) invariant
    T = vo_q_full.shape[0]
    zero_blk = jnp.zeros(vo_q_full.shape[1:], vo_q_full.dtype)
    any_act = jnp.any(jnp.asarray(ekf_blocks.vo_active, bool)
                      .reshape(T, -1), axis=1)        # (T,)
    eb_xs = ekf_blocks._replace(vo_q=jnp.zeros((T, 0), vo_q_full.dtype))

    def ekf_step(st, inp):
        ebt, t, act = inp
        q_blk = jax.lax.cond(
            act,
            lambda: jax.lax.dynamic_index_in_dim(vo_q_full, t, 0,
                                                 keepdims=False),
            lambda: zero_blk)
        st = ekf_lanes.substep_block(
            st, ebt.gyro, ebt.accel, ebt.valid, ebt.vo_active, q_blk,
            ebt.vo_steps_back, ec)
        return st, st.q

    return jax.lax.scan(
        ekf_step, ekf_st,
        (eb_xs, jnp.arange(T, dtype=jnp.int32), any_act))


@full_precision
def run_pipeline_lanes(
    params: EstimatorParams,
    ekf_params,
    data: TickData,
    ekf_blocks: EKFBlocks,
    vo: Optional[VOData] = None,
    lever_arm=kf.DEFAULT_LEVER_ARM,
    dtype=jnp.float32,
    consts=None,
    ekf_ring_len: int = 16,
):
    """Staged EKF(500 Hz) → MHE(200 Hz) fleet replay in lanes layout — the
    reference's full two-process pipeline (go1_launch.py:18-63: orien_ekf.cpp
    timer → imu/filter → EstSub.cpp timerCallback) as one jit of TWO scans.

    The reference's dataflow is strictly orien_ekf → imu/filter → est_sub
    with no feedback, so staging is an exact reordering of the interleaved
    per-tick composition: stage 1 scans every tick's EKF substeps
    (ekf_lanes.substep_block, masked padding) producing the fused orientation
    sequence; stage 2 is the lanes MHE replay (run_mhe_lanes) consuming it.
    Staging also lets the VO R_pre lookup (the rotation stack the reference
    indexes at DecentralEst.cpp:915) gather the *exact* per-tick orientation
    from the full sequence instead of a bounded ring, and compiles much
    faster than a single fused scan body (XLA's loop passes scale badly in
    the combined EKF+MHE carry). ``data.R_sb`` is IGNORED — orientation
    comes from the EKF.

    ``data`` fields are lanes-layout time-leading (T,...,B); ``ekf_blocks``
    gyro/accel are lanes (T,S,3,B). Returns (x_seq (T,B,s), v_b (T,B,3),
    q_seq (T,4,B) fused quaternions).
    """
    from decentralized_ekf_mhe_tpu.ops import ekf_lanes, mhe

    c = consts if consts is not None else mhe.make_consts(params, dtype)
    ec = ekf_lanes.make_consts(ekf_params, dtype)
    B = data.accel_b.shape[-1]
    ekf_st = ekf_lanes.init_state(ekf_params, B, ring_len=ekf_ring_len,
                                  dtype=dtype)
    _, q_seq = scan_ekf_blocks(ekf_st, ekf_blocks, ec)      # (T,4,B)
    R_seq = ekf_lanes.to_rot(q_seq)                         # (T,3,3,B)
    x_seq, v_seq = run_mhe_lanes(
        params, data._replace(R_sb=R_seq), vo=vo, lever_arm=lever_arm,
        dtype=dtype, consts=c)
    return x_seq, v_seq, q_seq


@full_precision
def ekf_orientation_sequence(params_ekf, log, dtype=jnp.float64):
    """Run the orientation EKF over the log's EKF-rate stream and sample the
    fused quaternion at each MHE tick (the imu/filter -> est_sub handoff,
    orien_ekf.cpp:90-105 -> EstSub.cpp:34-43), as rotation matrices (T,3,3)."""
    from decentralized_ekf_mhe_tpu.ops import ekf as ekf_ops

    c = ekf_ops.make_consts(params_ekf, dtype)
    state = ekf_ops.init_state(params_ekf, ring_len=64, dtype=dtype)
    _, q_seq = ekf_ops.run_sequence(
        state,
        jnp.asarray(log.ekf_gyro, dtype),
        jnp.asarray(log.ekf_accel, dtype),
        jnp.asarray(log.ekf_vo_active),
        jnp.asarray(log.ekf_vo_q, dtype),
        jnp.asarray(log.ekf_vo_steps_back, jnp.int32),
        c,
    )
    bounds = np.cumsum(np.asarray(log.ekf_substeps))
    idx = jnp.asarray(np.maximum(bounds - 1, 0), jnp.int32)
    q_mhe = q_seq[idx]
    return quat.to_rot(q_mhe), q_mhe
