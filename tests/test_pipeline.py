"""Fused EKF→MHE pipeline (ops/estimator.run_pipeline_lanes) vs the composed
oracle: ops/ekf.run_sequence orientation feeding ops/estimator.run_mhe — the
reference's two-process handoff (orien_ekf.cpp:90-105 → EstSub.cpp:34-43)
validated end-to-end at float64, plus the lanes EKF vs the standard EKF."""

import jax
import jax.numpy as jnp
import numpy as np

from decentralized_ekf_mhe_tpu.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import ekf as ekf_ops
from decentralized_ekf_mhe_tpu.ops import ekf_lanes, estimator
from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

DT = jnp.float64


def test_ekf_lanes_matches_standard():
    """Lanes EKF scan == standard EKF scan at float64, incl. delayed-VO
    replay, over a synthetic EKF-rate stream; fleet lanes are independent."""
    log = synth.generate(synth.SynthConfig(T=40, seed=4))
    p = EKFParams()
    c = ekf_ops.make_consts(p, DT)
    ring = 16
    T_ekf = log.ekf_gyro.shape[0]

    # standard single-instance replay
    st = ekf_ops.init_state(p, ring_len=ring, dtype=DT)
    _, q_ref = ekf_ops.run_sequence(
        st,
        jnp.asarray(log.ekf_gyro, DT), jnp.asarray(log.ekf_accel, DT),
        jnp.asarray(log.ekf_vo_active), jnp.asarray(log.ekf_vo_q, DT),
        jnp.asarray(log.ekf_vo_steps_back, jnp.int32), c)

    # lanes fleet: lane 0 = the same stream, lane 1 = a perturbed stream
    B = 2
    gyro_l = jnp.stack(
        [jnp.asarray(log.ekf_gyro, DT),
         jnp.asarray(log.ekf_gyro, DT) + 1e-3], axis=-1)
    accel_l = jnp.stack(
        [jnp.asarray(log.ekf_accel, DT),
         jnp.asarray(log.ekf_accel, DT) - 1e-3], axis=-1)
    stl = ekf_lanes.init_state(p, B, ring_len=ring, dtype=DT)

    def step(s, x):
        g, a, va, qv, sb = x
        s = ekf_lanes.tick(s, g, a, va, qv, sb, c)
        return s, s.q

    _, q_l = jax.lax.scan(
        step, stl,
        (gyro_l, accel_l, jnp.asarray(log.ekf_vo_active),
         jnp.asarray(log.ekf_vo_q, DT),
         jnp.asarray(log.ekf_vo_steps_back, jnp.int32)))
    np.testing.assert_allclose(np.asarray(q_l[:, :, 0]), np.asarray(q_ref),
                               rtol=1e-10, atol=1e-12)
    # perturbed lane must differ (no cross-lane leakage of the shared cond)
    assert np.abs(np.asarray(q_l[:, :, 1]) - np.asarray(q_ref)).max() > 1e-6


def test_pipeline_matches_composed_oracle():
    """run_pipeline_lanes == (ekf_orientation_sequence → run_mhe) at float64:
    the fused in-graph handoff reproduces the staged pipeline exactly,
    including VO in both stages and MHE warmup→steady state."""
    T = 30
    p = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=6)
    pe = EKFParams()
    log = synth.generate(synth.SynthConfig(T=T, seed=9))

    # composed oracle (ring_len=64 inside ekf_orientation_sequence)
    R_seq, q_seq = estimator.ekf_orientation_sequence(pe, log, dtype=DT)
    data = estimator.tickdata_from_log(log, R_sb=np.asarray(R_seq), dtype=DT)
    vo = estimator.vodata_from_log(log, dtype=DT)
    x_ref, v_ref = estimator.run_mhe(p, data, vo=vo, dtype=DT)

    # fused pipeline, B=2 identical lanes
    B = 2
    data_b = batch_lib.to_time_leading(jax.tree.map(
        lambda a: jnp.broadcast_to(a[None].astype(DT), (B,) + a.shape),
        data))
    eb = estimator.ekfblocks_from_log(log, dtype=DT)
    eb_l = eb._replace(
        gyro=jnp.broadcast_to(eb.gyro[..., None], eb.gyro.shape + (B,)),
        accel=jnp.broadcast_to(eb.accel[..., None], eb.accel.shape + (B,)))
    data_l = batch_lib.tickdata_to_lanes(data_b)
    x_pl, v_pl, q_pl = estimator.run_pipeline_lanes(
        p, pe, data_l, eb_l, vo=vo, dtype=DT, ekf_ring_len=64)

    np.testing.assert_allclose(np.asarray(q_pl[:, :, 0]), np.asarray(q_seq),
                               rtol=1e-9, atol=1e-11)
    for b in range(B):
        np.testing.assert_allclose(np.asarray(x_pl[:, b]), np.asarray(x_ref),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(v_pl[:, b]), np.asarray(v_ref),
                                   rtol=1e-7, atol=1e-9)


def test_pipeline_fleet_runner_f32_sane():
    """The production pipeline fleet runner at float32: finite outputs and
    velocity tracking within the Monte-Carlo envelope."""
    T, B = 60, 4
    p = EstimatorParams(
        num_legs=4, leg_odom_type=0, rate=200, N=10,
        p_process_std=[0.001] * 3, accel_input_std=[0.025, 0.025, 0.02],
        gyro_input_std=[0.03] * 3, accel_bias_std=[0.07, 0.02, 0.03],
        joint_position_std=[0.04] * 3, joint_velocity_std=[0.22] * 3,
        foot_slide_std=[0.003] * 3, foot_swing_std=[1e7] * 3,
        vo_p_std=[1.5e-5] * 3)
    pe = EKFParams()
    log = synth.generate(synth.SynthConfig(T=T, seed=1))
    data = estimator.tickdata_from_log(log, dtype=jnp.float32)
    vo = estimator.vodata_from_log(log, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    data_b = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, B, key, dtype=jnp.float32))
    eb = batch_lib.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=jnp.float32), B,
        jax.random.PRNGKey(1), dtype=jnp.float32)

    runner = jax.jit(batch_lib.make_pipeline_fleet_runner(
        p, pe, jnp.float32))
    x, v, q = runner(data_b, eb, vo)
    assert x.shape == (T, B, 9) and v.shape == (T, B, 3)
    assert np.isfinite(np.asarray(x)).all()
    err = np.asarray(x)[T // 2:, :, 3:6] - log.gt_v_s[T // 2:, None]
    rmse = float(np.sqrt((err ** 2).mean()))
    assert rmse < 0.15, rmse


def test_example_run_fleet():
    from conftest import run_example

    out = run_example("run_fleet.py", "--cpu", "--instances", "4",
                      "--ticks", "60", "--sweep")
    assert "sweep argmin" in out.stdout
    out = run_example("run_fleet.py", "--cpu", "--instances", "8",
                      "--ticks", "40", "--mesh")
    assert "fleet velocity RMSE" in out.stdout


def test_pipeline_per_lane_vo_q_matches_materialized_scan():
    """The tick-gated loop-invariant gather of per-lane vo_q
    (estimator.scan_ekf_blocks) equals streaming the materialized (T,S,4,B)
    tensor through a plain scan, and a uniform per-lane fleet equals the
    shared-q path."""
    from decentralized_ekf_mhe_tpu.io import synth as synth_mod

    log = synth_mod.generate(synth_mod.SynthConfig(T=24, seed=15))
    p = EKFParams()
    c = ekf_ops.make_consts(p, DT)
    B = 3
    eb1 = estimator.ekfblocks_from_log(log, dtype=DT)
    key = jax.random.PRNGKey(7)
    eb = batch_lib.perturb_ekf_blocks(eb1, B, key, dtype=DT,
                                      vo_noise_scale=1.0)
    assert eb.vo_q.ndim == 4          # genuinely per-lane

    st0 = ekf_lanes.init_state(p, B, ring_len=16, dtype=DT)
    _, q_gated = estimator.scan_ekf_blocks(st0, eb, c)

    def plain_step(st, ebt):
        st = ekf_lanes.substep_block(
            st, ebt.gyro, ebt.accel, ebt.valid, ebt.vo_active, ebt.vo_q,
            ebt.vo_steps_back, c)
        return st, st.q

    st0b = ekf_lanes.init_state(p, B, ring_len=16, dtype=DT)
    _, q_plain = jax.lax.scan(plain_step, st0b, eb)
    np.testing.assert_allclose(np.asarray(q_gated), np.asarray(q_plain),
                               rtol=1e-12, atol=1e-14)

    # uniform per-lane content (noise 0) == shared-q path
    eb_u = batch_lib.perturb_ekf_blocks(eb1, B, key, noise_scale=0.0,
                                        dtype=DT, vo_noise_scale=0.0)
    eb_u_pl = eb_u._replace(
        vo_q=jnp.broadcast_to(eb_u.vo_q[..., None],
                              eb_u.vo_q.shape + (B,)))
    st0c = ekf_lanes.init_state(p, B, ring_len=16, dtype=DT)
    _, q_shared = estimator.scan_ekf_blocks(st0c, eb_u, c)
    st0d = ekf_lanes.init_state(p, B, ring_len=16, dtype=DT)
    _, q_perlane = estimator.scan_ekf_blocks(st0d, eb_u_pl, c)
    np.testing.assert_allclose(np.asarray(q_perlane), np.asarray(q_shared),
                               rtol=1e-12, atol=1e-14)
