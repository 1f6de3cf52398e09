"""Multi-chip sharding on the 8-virtual-device CPU mesh (SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from decentralized_ekf_mhe_tpu.config import EstimatorParams
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import estimator
from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib
from decentralized_ekf_mhe_tpu.parallel import mesh as mesh_lib


@pytest.fixture(scope="module")
def setup():
    p = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=8,
                        foot_swing_std=[1e7] * 3)
    log = synth.generate(synth.SynthConfig(T=40, seed=0))
    data = estimator.tickdata_from_log(log, dtype=jnp.float32)
    vo = estimator.vodata_from_log(log, dtype=jnp.float32)
    return p, log, data, vo


def test_mesh_construction():
    m = mesh_lib.make_mesh()
    assert dict(m.shape) == {"data": 4, "model": 2}
    m2 = mesh_lib.make_mesh(devices=jax.devices()[:5])
    assert dict(m2.shape) == {"data": 5, "model": 1}


def test_sharded_fleet_matches_single_device(setup):
    """8-way sharded fused fleet == unsharded fused fleet."""
    p, log, data, vo = setup
    B = 16
    db = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, B, jax.random.PRNGKey(0))
    )
    gt_v = jnp.asarray(log.gt_v_s, jnp.float32)

    x_ref, _ = jax.jit(batch_lib.make_fused_batched_runner(
        p, jnp.float32))(db, vo)

    mesh = mesh_lib.make_mesh()
    runner = batch_lib.sharded_fleet_runner(p, mesh, jnp.float32)
    from jax.sharding import NamedSharding, PartitionSpec as P

    db_sharded = jax.device_put(
        db, NamedSharding(mesh, P(None, ("data", "model")))
    )
    x_sh, rmse, fleet_mean, fleet_max = runner(db_sharded, vo, gt_v)

    np.testing.assert_allclose(np.asarray(x_sh), np.asarray(x_ref), atol=2e-5)
    # the psum-reduced stats equal the host-side reduction
    r = np.asarray(rmse)
    np.testing.assert_allclose(float(fleet_mean), r.mean(), rtol=1e-5)
    np.testing.assert_allclose(float(fleet_max), r.max(), rtol=1e-5)


def test_scaling_harness_runs(setup):
    p, log, data, vo = setup
    db = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, 4, jax.random.PRNGKey(1))
    )
    gt_v = jnp.asarray(log.gt_v_s, jnp.float32)
    res = batch_lib.measure_scaling(p, db, vo, gt_v, device_counts=(1, 2),
                                    reps=1)
    assert set(res) == {1, 2}
    for n, (wall, rate) in res.items():
        assert wall > 0 and rate > 0


def test_covariance_sweep(setup):
    p, log, data, vo = setup
    variants = []
    for scale in (0.5, 1.0, 2.0):
        q = EstimatorParams(**{**p.__dict__})
        q.accel_input_std = [v * scale for v in [0.025, 0.025, 0.02]]
        variants.append(q)
    rmses, best = batch_lib.covariance_sweep(
        variants, data, jnp.asarray(log.gt_v_s, jnp.float32)
    )
    assert rmses.shape == (3,)
    assert np.isfinite(np.asarray(rmses)).all()
    assert 0 <= int(best) < 3


def test_sharded_pipeline_per_lane_vo_q(setup):
    """8-way sharded full pipeline with PER-LANE vision draws (vo_q sharded
    over the instance axis) == the unsharded pipeline fleet runner."""
    from decentralized_ekf_mhe_tpu.config import EKFParams

    p, log, data, vo = setup
    B = 16
    ekf_p = EKFParams()
    db = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, B, jax.random.PRNGKey(0)))
    eb = batch_lib.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=jnp.float32), B,
        jax.random.PRNGKey(1), vo_noise_scale=1.0)
    assert eb.vo_q.ndim == 4
    gt_v = jnp.asarray(log.gt_v_s, jnp.float32)

    x_ref, _, _ = jax.jit(batch_lib.make_pipeline_fleet_runner(
        p, ekf_p, jnp.float32))(db, eb, vo)

    mesh = mesh_lib.make_mesh()
    runner = batch_lib.sharded_pipeline_runner(
        p, ekf_p, mesh, jnp.float32, ekf_ring_len=16,
        per_lane_vo_q=True)
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = ("data", "model")
    db_sh = jax.device_put(db, NamedSharding(mesh, P(None, axes)))
    lanes_sh = NamedSharding(mesh, P(None, None, None, axes))
    eb_sh = eb._replace(gyro=jax.device_put(eb.gyro, lanes_sh),
                        accel=jax.device_put(eb.accel, lanes_sh),
                        vo_q=jax.device_put(eb.vo_q, lanes_sh))
    x_sh, rmse, fleet_mean, fleet_max = runner(db_sh, eb_sh, vo, gt_v)
    np.testing.assert_allclose(np.asarray(x_sh), np.asarray(x_ref), atol=2e-5)


def test_sharded_constrained_fleet_matches_single_device(setup):
    """8-way sharded CONSTRAINED fleet (box-ADMM window solves, warm-start
    carry) == the unsharded constrained run."""
    from decentralized_ekf_mhe_tpu.ops import mhe

    p, log, data, vo = setup
    B = 16
    db = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, B, jax.random.PRNGKey(0), p))
    gt_v = jnp.asarray(log.gt_v_s, jnp.float32)
    s = p.dim_state
    x_lb = np.full(s, -np.inf); x_lb[3:6] = -0.1
    x_ub = np.full(s, np.inf); x_ub[3:6] = 0.1
    c = mhe.make_consts(p, jnp.float32, x_lb=x_lb, x_ub=x_ub, admm_iters=15)

    x_ref, _ = jax.jit(batch_lib.make_fused_batched_runner(
        p, jnp.float32))(db, vo)
    # unsharded constrained oracle (standard layout, same consts)
    from decentralized_ekf_mhe_tpu.ops import estimator as est_mod
    x_con_ref, _ = jax.jit(lambda d, v: est_mod.run_mhe(
        p, d, vo=v, dtype=jnp.float32, consts=c))(db, vo)

    mesh = mesh_lib.make_mesh()
    runner = batch_lib.sharded_fleet_runner(p, mesh, jnp.float32, consts=c)
    from jax.sharding import NamedSharding, PartitionSpec as P

    db_sh = jax.device_put(db, NamedSharding(mesh, P(None, ("data", "model"))))
    x_sh, rmse, fleet_mean, fleet_max = runner(db_sh, vo, gt_v)
    np.testing.assert_allclose(np.asarray(x_sh), np.asarray(x_con_ref),
                               atol=2e-5)
    # the box binds (sharded result differs from the unconstrained one and
    # respects the bound)
    v_sh = np.abs(np.asarray(x_sh[..., 3:6]))
    assert (v_sh <= 0.1 + 1e-3).all()
    assert np.abs(np.asarray(x_sh) - np.asarray(x_ref)).max() > 1e-3


def test_sharded_pipeline_per_instance_vo(setup):
    """8-way sharded pipeline with a FULLY PER-INSTANCE VO schedule (timing
    AND content sharded over instances) == the unsharded per-instance run."""
    from decentralized_ekf_mhe_tpu.config import EKFParams

    p, log, data, vo = setup
    B = 16
    ekf_p = EKFParams()
    db = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, B, jax.random.PRNGKey(0), p))
    eb = batch_lib.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=jnp.float32), B,
        jax.random.PRNGKey(1), p)
    vo_pi = batch_lib.perturb_vo_batch(vo, B, jax.random.PRNGKey(2), p,
                                       per_instance_timing=True)
    assert vo_pi.active.ndim == 2
    gt_v = jnp.asarray(log.gt_v_s, jnp.float32)

    x_ref, _, _ = jax.jit(batch_lib.make_pipeline_fleet_runner(
        p, ekf_p, jnp.float32))(db, eb, vo_pi)

    mesh = mesh_lib.make_mesh()
    runner = batch_lib.sharded_pipeline_runner(
        p, ekf_p, mesh, jnp.float32, ekf_ring_len=16,
        per_instance_vo=True)
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = ("data", "model")
    db_sh = jax.device_put(db, NamedSharding(mesh, P(None, axes)))
    lanes_sh = NamedSharding(mesh, P(None, None, None, axes))
    eb_sh = eb._replace(gyro=jax.device_put(eb.gyro, lanes_sh),
                        accel=jax.device_put(eb.accel, lanes_sh))
    vo_sh = estimator.VOData(
        active=jax.device_put(vo_pi.active, NamedSharding(mesh, P(None, axes))),
        dp_body=jax.device_put(vo_pi.dp_body,
                               NamedSharding(mesh, P(None, None, axes))),
        tick_pre=jax.device_put(vo_pi.tick_pre,
                                NamedSharding(mesh, P(None, axes))),
        tick_now=jax.device_put(vo_pi.tick_now,
                                NamedSharding(mesh, P(None, axes))))
    x_sh, rmse, fleet_mean, fleet_max = runner(db_sh, eb_sh, vo_sh, gt_v)
    np.testing.assert_allclose(np.asarray(x_sh), np.asarray(x_ref), atol=2e-5)


def test_example_run_fleet_bound_sweep():
    """The per-lane constraint-bound sweep example runs end-to-end: every
    lane respects its own box, tight bounds bind."""
    import subprocess
    import sys as _sys
    import os as _os

    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    env = dict(_os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [_sys.executable, _os.path.join(repo, "examples", "run_fleet.py"),
         "--cpu", "--instances", "8", "--ticks", "100", "--bound-sweep"],
        capture_output=True, text=True, timeout=900, cwd=repo, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "every lane within its own box: True" in proc.stdout
