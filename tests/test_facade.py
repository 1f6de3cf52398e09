"""Stateful facade parity: tick-at-a-time API == the scan drivers."""

import numpy as np
import jax
import jax.numpy as jnp

from decentralized_ekf_mhe_tpu.config import EstimatorParams
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import estimator
from decentralized_ekf_mhe_tpu.ops.facade import DecentralizedEstimator


def _params(est_type=0, N=8):
    return EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=N,
                           est_type=est_type, foot_swing_std=[1e7] * 3)


def _tick_args(log, k):
    return (log.R_sb_gt[k], log.accel_b[k], log.omega_b[k], log.p_foot[k],
            log.J_foot[k], log.dq[k], log.contact[k])


def test_facade_mhe_matches_scan():
    p = _params(0)
    log = synth.generate(synth.SynthConfig(T=30, seed=1))
    est = DecentralizedEstimator(p, dtype=jnp.float64)
    est.initialize(*_tick_args(log, 0))
    xs = [np.asarray(est.x)]
    for k in range(1, 30):
        vo = (bool(log.vo_active[k]), log.vo_dp_body[k],
              int(log.vo_tick_pre[k]), int(log.vo_tick_now[k]))
        est.update(*_tick_args(log, k), vo_active=vo[0], vo_dp=vo[1],
                   vo_tick_pre=vo[2], vo_tick_now=vo[3])
        xs.append(np.asarray(est.x))
    xs = np.stack(xs)

    data = estimator.tickdata_from_log(log)
    voD = estimator.vodata_from_log(log)
    x_scan, _ = estimator.run_mhe(p, data, vo=voD)
    np.testing.assert_allclose(xs, np.asarray(x_scan), atol=1e-9)


def test_facade_kf_matches_scan():
    p = _params(1)
    log = synth.generate(synth.SynthConfig(T=25, seed=2))
    est = DecentralizedEstimator(p, dtype=jnp.float64)
    est.initialize(*_tick_args(log, 0))
    xs = [np.asarray(est.x)]
    for k in range(1, 25):
        est.update(*_tick_args(log, k))
        xs.append(np.asarray(est.x))
    data = estimator.tickdata_from_log(log)
    x_scan, _ = estimator.run_kf(p, data)
    np.testing.assert_allclose(np.stack(xs), np.asarray(x_scan), atol=1e-9)


def test_facade_vo_past_ring_length():
    """Regression: with a tiny orientation history ring,
    VO lookups far past the ring length must still read the correct R_pre —
    tick counters stay absolute and only the bounded R ring is modular."""
    p = _params(0, N=6)
    T = 64
    log = synth.generate(synth.SynthConfig(T=T, seed=6, vo_every=5,
                                           vo_latency=2))
    est = DecentralizedEstimator(p, dtype=jnp.float64, history_ticks=16)
    est.initialize(*_tick_args(log, 0))
    xs = [np.asarray(est.x)]
    for k in range(1, T):
        est.update(*_tick_args(log, k), vo_active=bool(log.vo_active[k]),
                   vo_dp=log.vo_dp_body[k], vo_tick_pre=int(log.vo_tick_pre[k]),
                   vo_tick_now=int(log.vo_tick_now[k]))
        xs.append(np.asarray(est.x))
    data = estimator.tickdata_from_log(log)
    voD = estimator.vodata_from_log(log)
    x_scan, _ = estimator.run_mhe(p, data, vo=voD)
    np.testing.assert_allclose(np.stack(xs), np.asarray(x_scan), atol=1e-9)
    # VO events really did land beyond the ring length
    assert int(np.asarray(log.vo_tick_pre).max()) > 16


def test_facade_vo_predating_ring_raises():
    p = _params(0, N=6)
    log = synth.generate(synth.SynthConfig(T=40, seed=6))
    est = DecentralizedEstimator(p, dtype=jnp.float64, history_ticks=8)
    est.initialize(*_tick_args(log, 0))
    for k in range(1, 20):
        est.update(*_tick_args(log, k))
    import pytest
    with pytest.raises(ValueError, match="predates"):
        est.update(*_tick_args(log, 20), vo_active=True,
                   vo_dp=np.zeros(3), vo_tick_pre=2, vo_tick_now=18)


def test_facade_reset():
    p = _params(0)
    log = synth.generate(synth.SynthConfig(T=10, seed=3))
    est = DecentralizedEstimator(p, dtype=jnp.float64)
    est.initialize(*_tick_args(log, 0))
    x_first = np.asarray(est.x)
    for k in range(1, 6):
        est.update(*_tick_args(log, k))
    est.reset()
    assert est.T == 0 and est.x is None
    est.initialize(*_tick_args(log, 0))
    np.testing.assert_array_equal(np.asarray(est.x), x_first)


def test_example_run_robot():
    from conftest import run_example

    run_example("run_robot.py", "--robot", "pogox", "--ticks", "80",
                "--v-limit", "0.6", "--cpu")
    run_example("run_robot.py", "--robot", "cassie", "--ticks", "80", "--cpu")


def test_facade_update_block_matches_per_tick():
    """update_block (one jitted K-tick dispatch, donated carry) == K calls
    of update(), VO events included, at float64."""
    p = _params(0)
    T = 25
    log = synth.generate(synth.SynthConfig(T=T, seed=6))

    est1 = DecentralizedEstimator(p, dtype=jnp.float64)
    est1.initialize(*_tick_args(log, 0))
    xs = []
    for k in range(1, T):
        est1.update(*_tick_args(log, k), vo_active=bool(log.vo_active[k]),
                    vo_dp=log.vo_dp_body[k],
                    vo_tick_pre=int(log.vo_tick_pre[k]),
                    vo_tick_now=int(log.vo_tick_now[k]))
        xs.append(np.asarray(est1.x))
    xs = np.stack(xs)

    est2 = DecentralizedEstimator(p, dtype=jnp.float64)
    est2.initialize(*_tick_args(log, 0))
    # two uneven blocks exercise the per-K jit cache and the carry handoff
    splits = [(1, 10), (10, T)]
    outs = []
    for lo, hi in splits:
        sl = slice(lo, hi)
        x_blk, v_blk = est2.update_block(
            log.R_sb_gt[sl], log.accel_b[sl], log.omega_b[sl],
            log.p_foot[sl], log.J_foot[sl], log.dq[sl], log.contact[sl],
            vo_active=log.vo_active[sl], vo_dp=log.vo_dp_body[sl],
            vo_tick_pre=log.vo_tick_pre[sl], vo_tick_now=log.vo_tick_now[sl])
        outs.append(np.asarray(x_blk))
    np.testing.assert_allclose(np.concatenate(outs), xs, atol=1e-9)
    assert est2.T == est1.T


def test_facade_update_block_vo_slot_clobber():
    """A VO event whose pre-block frame slot would be overwritten by a LATER
    row of the same block must still read the correct pre-frame orientation
    (advisor r04: update_block wrote all K rows before gathering R_pre)."""
    p = _params(0, N=6)
    T = 20
    H = 8
    log = synth.generate(synth.SynthConfig(T=T, seed=7))
    # craft one VO event at tick 10 referencing tick 5: with H=8 the slot
    # 5%8 is clobbered by the block row at tick 13 (13%8=5) unless the gather
    # snapshots the ring before writing
    va = np.zeros(T, bool); va[10] = True
    vtp = np.zeros(T, np.int64); vtp[10] = 5
    vtn = np.zeros(T, np.int64); vtn[10] = 9
    vdp = np.zeros((T, 3)); vdp[10] = [0.01, -0.02, 0.005]

    est1 = DecentralizedEstimator(p, dtype=jnp.float64, history_ticks=H)
    est1.initialize(*_tick_args(log, 0))
    for k in range(1, T):
        est1.update(*_tick_args(log, k), vo_active=bool(va[k]), vo_dp=vdp[k],
                    vo_tick_pre=int(vtp[k]), vo_tick_now=int(vtn[k]))

    est2 = DecentralizedEstimator(p, dtype=jnp.float64, history_ticks=H)
    est2.initialize(*_tick_args(log, 0))
    # blocks [1,10) then [10,20): the event rides the second block whose
    # later rows (ticks 13..) wrap onto the event's pre-frame slot
    for lo, hi in ((1, 10), (10, T)):
        sl = slice(lo, hi)
        est2.update_block(
            log.R_sb_gt[sl], log.accel_b[sl], log.omega_b[sl],
            log.p_foot[sl], log.J_foot[sl], log.dq[sl], log.contact[sl],
            vo_active=va[sl], vo_dp=vdp[sl], vo_tick_pre=vtp[sl],
            vo_tick_now=vtn[sl])
    np.testing.assert_allclose(np.asarray(est2.x), np.asarray(est1.x),
                               atol=1e-9)


def test_facade_update_block_vo_in_block_reference():
    """A VO event whose pre-frame tick lies INSIDE the same block gathers the
    orientation from the block's own rows."""
    p = _params(0, N=6)
    T = 16
    log = synth.generate(synth.SynthConfig(T=T, seed=8))
    va = np.zeros(T, bool); va[12] = True
    vtp = np.zeros(T, np.int64); vtp[12] = 9
    vtn = np.zeros(T, np.int64); vtn[12] = 11
    vdp = np.zeros((T, 3)); vdp[12] = [0.004, 0.002, -0.001]

    est1 = DecentralizedEstimator(p, dtype=jnp.float64)
    est1.initialize(*_tick_args(log, 0))
    for k in range(1, T):
        est1.update(*_tick_args(log, k), vo_active=bool(va[k]), vo_dp=vdp[k],
                    vo_tick_pre=int(vtp[k]), vo_tick_now=int(vtn[k]))

    est2 = DecentralizedEstimator(p, dtype=jnp.float64)
    est2.initialize(*_tick_args(log, 0))
    sl = slice(1, T)
    est2.update_block(
        log.R_sb_gt[sl], log.accel_b[sl], log.omega_b[sl], log.p_foot[sl],
        log.J_foot[sl], log.dq[sl], log.contact[sl],
        vo_active=va[sl], vo_dp=vdp[sl], vo_tick_pre=vtp[sl],
        vo_tick_now=vtn[sl])
    np.testing.assert_allclose(np.asarray(est2.x), np.asarray(est1.x),
                               atol=1e-9)


def test_pipeline_estimator_streamed_matches_offline():
    """PipelineEstimator (EKF IN the loop, block-streamed with donated
    carry) == the offline run_pipeline_lanes replay, exactly, at f64 —
    including delayed-VO EKF replays and MHE VO events across block
    boundaries."""
    from decentralized_ekf_mhe_tpu.config import EKFParams
    from decentralized_ekf_mhe_tpu.ops.facade import PipelineEstimator
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

    p = _params(0, N=6)
    ekf_p = EKFParams()
    T = 30
    log = synth.generate(synth.SynthConfig(T=T, seed=12))
    dt64 = jnp.float64

    # offline oracle: B=1 lanes pipeline replay
    data = estimator.tickdata_from_log(log, dtype=dt64)
    vo = estimator.vodata_from_log(log, dtype=dt64)
    eb = estimator.ekfblocks_from_log(log, dtype=dt64)
    data_b = jax.tree.map(lambda a: a[:, None], data)       # (T,1,...)
    data_l = batch_lib.tickdata_to_lanes(data_b)
    eb_l = eb._replace(gyro=eb.gyro[..., None], accel=eb.accel[..., None])
    x_ref, v_ref, q_ref = estimator.run_pipeline_lanes(
        p, ekf_p, data_l, eb_l, vo=vo, dtype=dt64, ekf_ring_len=16)

    est = PipelineEstimator(p, ekf_p, dtype=dt64, ekf_ring_len=16)
    g = np.asarray(eb.gyro); ac = np.asarray(eb.accel)
    vl = np.asarray(eb.valid)
    eva = np.asarray(eb.vo_active); evq = np.asarray(eb.vo_q)
    esb = np.asarray(eb.vo_steps_back)
    est.initialize(g[0], ac[0], vl[0], log.accel_b[0], log.omega_b[0],
                   log.p_foot[0], log.J_foot[0], log.dq[0], log.contact[0],
                   ekf_vo_active=eva[0], ekf_vo_q=evq[0],
                   ekf_vo_steps_back=esb[0])
    np.testing.assert_allclose(np.asarray(est.x), np.asarray(x_ref[0, 0]),
                               atol=1e-9)
    outs = []
    for lo, hi in ((1, 11), (11, T)):                  # uneven blocks
        sl = slice(lo, hi)
        x_blk, v_blk, q_blk = est.update_block(
            g[sl], ac[sl], vl[sl], log.accel_b[sl], log.omega_b[sl],
            log.p_foot[sl], log.J_foot[sl], log.dq[sl], log.contact[sl],
            ekf_vo_active=eva[sl], ekf_vo_q=evq[sl],
            ekf_vo_steps_back=esb[sl],
            vo_active=log.vo_active[sl], vo_dp=log.vo_dp_body[sl],
            vo_tick_pre=log.vo_tick_pre[sl], vo_tick_now=log.vo_tick_now[sl])
        outs.append((np.asarray(x_blk), np.asarray(v_blk), np.asarray(q_blk)))
    x_str = np.concatenate([o[0] for o in outs])
    v_str = np.concatenate([o[1] for o in outs])
    q_str = np.concatenate([o[2] for o in outs])
    np.testing.assert_allclose(x_str, np.asarray(x_ref[1:, 0]), atol=1e-9)
    np.testing.assert_allclose(v_str, np.asarray(v_ref[1:, 0]), atol=1e-9)
    np.testing.assert_allclose(q_str, np.asarray(q_ref[1:, :, 0]), atol=1e-9)
    assert est.T == T


def test_example_run_hil_full_cycle():
    """The HIL streaming driver runs the FULL EKF+MHE cycle end-to-end
    (orientation EKF in the loop, raw IMU rows) and stays in budget."""
    from conftest import run_example

    proc = run_example("run_hil.py", "--ticks", "200", "--block", "20",
                       "--cpu")
    assert "FULL EKF+MHE cycles" in proc.stderr
    assert "sustained per-tick latency" in proc.stderr
