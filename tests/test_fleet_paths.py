"""The XLA fleet paths (lanes layout, parallel.batch runners) against
independent standard-layout oracles at float64, for the configurations a
fleet actually runs: no VO, a camera clock per lane under a state box, per-lane
vision content through the full pipeline, and the constrained pipeline."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from decentralized_ekf_mhe_tpu.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import estimator, mhe
from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

DT = jnp.float64


def _box(p, vb, iters=40):
    p.osqp.abs_tol = 1e-8
    p.osqp.relative_tol = 1e-8
    s = p.dim_state
    x_lb = np.full(s, -np.inf); x_lb[3:6] = -vb
    x_ub = np.full(s, np.inf); x_ub[3:6] = vb
    return mhe.make_consts(p, DT, x_lb=x_lb, x_ub=x_ub, admm_iters=iters)


def _lane_log(log, eb, b, dp_body=None):
    """Log of pipeline lane b: its EKF-rate streams unpadded from the
    (T,S,...,B) blocks, and its VO translation increments."""
    valid = np.asarray(eb.valid)

    def stream(a):
        a = np.asarray(a)
        return (a[..., b] if a.ndim == valid.ndim + 2 else a)[valid]

    return dataclasses.replace(
        log, ekf_gyro=stream(eb.gyro), ekf_accel=stream(eb.accel),
        ekf_vo_q=stream(eb.vo_q),
        vo_dp_body=log.vo_dp_body if dp_body is None else dp_body)


def test_fused_batched_runner_matches_vmapped():
    """The no-vmap (T,B,...) fleet replay == the vmapped replay, bitwise."""
    p = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=8,
                        foot_swing_std=[1e7] * 3)
    log = synth.generate(synth.SynthConfig(T=40, seed=3))
    data = estimator.tickdata_from_log(log, dtype=jnp.float32)
    vo = estimator.vodata_from_log(log, dtype=jnp.float32)
    B = 3
    db = batch_lib.perturb_log_batch(data, B, jax.random.PRNGKey(0))
    xv, _ = jax.jit(batch_lib.make_batched_runner(p, jnp.float32))(db, vo)
    xf, _ = jax.jit(batch_lib.make_fused_batched_runner(
        p, jnp.float32))(batch_lib.to_time_leading(db), vo)
    np.testing.assert_array_equal(np.asarray(xv), np.asarray(jnp.swapaxes(xf, 0, 1)))


@pytest.mark.parametrize("lot", [0, 1])
def test_lanes_runner_no_vo_matches_standard(lot):
    """A fleet with no VO event at all (VO never fuses, the window runs on
    leg odometry and IMU alone) through make_lanes_fleet_runner equals the
    standard-layout run_mhe(vo=None) per instance, both leg-odometry forms."""
    p = EstimatorParams(num_legs=4, leg_odom_type=lot, rate=200, N=5)
    T, B = 14, 3
    log = synth.generate(synth.SynthConfig(T=T, seed=3))
    data = estimator.tickdata_from_log(log, dtype=DT)
    data_b = batch_lib.perturb_log_batch(data, B, jax.random.PRNGKey(5),
                                         dtype=DT)
    vo_off = estimator.VOData(
        active=jnp.zeros(T, bool), dp_body=jnp.zeros((T, 3), DT),
        tick_pre=jnp.zeros(T, jnp.int32), tick_now=jnp.zeros(T, jnp.int32))
    x_l, v_l = batch_lib.make_lanes_fleet_runner(p, DT)(
        batch_lib.to_time_leading(data_b), vo_off)
    for b in range(B):
        x_ref, v_ref = estimator.run_mhe(
            p, jax.tree.map(lambda a: a[b], data_b), vo=None, dtype=DT)
        np.testing.assert_allclose(np.asarray(x_l[:, b]), np.asarray(x_ref),
                                   rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(np.asarray(v_l[:, b]), np.asarray(v_ref),
                                   rtol=1e-8, atol=1e-9)


def test_per_instance_vo_clocks_under_box_match_standard():
    """Each lane on its own camera clock AND the box-ADMM tail: the lanes
    path (step_per_instance_vo + solve_box_tridiag_lanes) equals the
    standard-layout constrained run_mhe of each lane with its own VO."""
    p = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=5,
                        foot_swing_std=[1e7] * 3)
    vb = 0.08
    c = _box(p, vb, iters=30)
    T, B = 18, 3
    logs = [synth.generate(synth.SynthConfig(
        T=T, seed=21, vo_every=5 + b, vo_latency=1 + b % 2)) for b in range(B)]
    data = estimator.tickdata_from_log(logs[0], dtype=DT)
    data_b = batch_lib.perturb_log_batch(data, B, jax.random.PRNGKey(3),
                                         dtype=DT)                 # (B,T,...)
    vos = [estimator.vodata_from_log(lg, dtype=DT) for lg in logs]
    vo_l = estimator.VOData(
        active=jnp.stack([v.active for v in vos], -1),
        dp_body=jnp.stack([v.dp_body for v in vos], -1),
        tick_pre=jnp.stack([v.tick_pre for v in vos], -1),
        tick_now=jnp.stack([v.tick_now for v in vos], -1))
    x_l, _ = estimator.run_mhe_lanes(
        p, batch_lib.tickdata_to_lanes(batch_lib.to_time_leading(data_b)),
        vo=vo_l, dtype=DT, consts=c)
    for b in range(B):
        x_ref, _ = estimator.run_mhe(
            p, jax.tree.map(lambda a: a[b], data_b), vo=vos[b], dtype=DT,
            consts=c)
        np.testing.assert_allclose(np.asarray(x_l[:, b]), np.asarray(x_ref),
                                   rtol=1e-7, atol=1e-9)
    v = np.abs(np.asarray(x_l[..., 3:6]))
    assert (v <= vb + 1e-6).all() and (v >= vb - 1e-6).any()
    assert not np.array_equal(np.asarray(vo_l.active[:, 0]),
                              np.asarray(vo_l.active[:, 1]))


def test_pipeline_per_lane_vo_content_matches_composed_oracle():
    """Per-lane vision content through the full pipeline runner: measured VO
    quaternions drawn per lane into the EKF and VO translations drawn per
    lane into the MHE, one shared camera clock. Lane b equals the composed
    standard-layout oracle (ops/ekf.run_sequence -> run_mhe) on lane b's own
    streams."""
    p = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=6,
                        vo_p_std=[1e-3] * 3)
    pe = EKFParams(vo_meas_std=[1e-2] * 4)
    T, B = 24, 3
    log = synth.generate(synth.SynthConfig(T=T, seed=13))
    data = estimator.tickdata_from_log(log, dtype=DT)
    vo = estimator.vodata_from_log(log, dtype=DT)
    data_b = batch_lib.to_time_leading(batch_lib.perturb_log_batch(
        data, B, jax.random.PRNGKey(0), p, dtype=DT))
    eb = batch_lib.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=DT), B, jax.random.PRNGKey(1),
        p, dtype=DT, vo_noise_scale=1.0, ekf_params=pe)
    vo_b = batch_lib.perturb_vo_batch(vo, B, jax.random.PRNGKey(2), p,
                                      dtype=DT)
    assert eb.vo_q.ndim == 4 and vo_b.dp_body.ndim == 3
    x, v, _ = batch_lib.make_pipeline_fleet_runner(
        p, pe, DT, ekf_ring_len=64)(data_b, eb, vo_b)
    for b in range(B):
        lg = _lane_log(log, eb, b, dp_body=np.asarray(vo_b.dp_body[..., b]))
        R_seq, _ = estimator.ekf_orientation_sequence(pe, lg, dtype=DT)
        d_b = jax.tree.map(lambda a: a[:, b], data_b)._replace(
            R_sb=jnp.asarray(R_seq))
        x_ref, v_ref = estimator.run_mhe(
            p, d_b, vo=estimator.vodata_from_log(lg, dtype=DT), dtype=DT)
        np.testing.assert_allclose(np.asarray(x[:, b]), np.asarray(x_ref),
                                   rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(np.asarray(v[:, b]), np.asarray(v_ref),
                                   rtol=1e-7, atol=1e-9)
    act = np.flatnonzero(np.asarray(vo.active))
    assert not np.array_equal(np.asarray(vo_b.dp_body[act[0], :, 0]),
                              np.asarray(vo_b.dp_body[act[0], :, 1]))


def test_constrained_pipeline_matches_composed_oracle():
    """The CONSTRAINED production pipeline (EKF lanes scan -> lanes MHE with
    the box-ADMM tail) equals the composed standard-layout oracle
    (ekf_orientation_sequence -> constrained run_mhe) per lane, with the
    box binding."""
    p = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=6,
                        foot_swing_std=[1e7] * 3)
    vb = 0.08
    c = _box(p, vb, iters=30)
    pe = EKFParams()
    T, B = 20, 2
    log = synth.generate(synth.SynthConfig(T=T, seed=17))
    data = estimator.tickdata_from_log(log, dtype=DT)
    vo = estimator.vodata_from_log(log, dtype=DT)
    data_b = batch_lib.to_time_leading(batch_lib.perturb_log_batch(
        data, B, jax.random.PRNGKey(0), p, dtype=DT))
    eb = batch_lib.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=DT), B, jax.random.PRNGKey(1),
        p, dtype=DT)
    x, _, _ = batch_lib.make_pipeline_fleet_runner(
        p, pe, DT, ekf_ring_len=64, consts=c)(data_b, eb, vo)
    for b in range(B):
        R_seq, _ = estimator.ekf_orientation_sequence(
            pe, _lane_log(log, eb, b), dtype=DT)
        d_b = jax.tree.map(lambda a: a[:, b], data_b)._replace(
            R_sb=jnp.asarray(R_seq))
        x_ref, _ = estimator.run_mhe(p, d_b, vo=vo, dtype=DT, consts=c)
        np.testing.assert_allclose(np.asarray(x[:, b]), np.asarray(x_ref),
                                   rtol=1e-7, atol=1e-9)
    vmax = np.abs(np.asarray(x[..., 3:6])).max()
    assert vb - 1e-6 <= vmax <= vb + 1e-6
