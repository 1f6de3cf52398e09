"""Aux subsystems: checkpoint/resume, timing probes, example driver."""

import numpy as np
import jax
import jax.numpy as jnp

from decentralized_ekf_mhe_tpu.config import EstimatorParams
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import estimator, mhe
from decentralized_ekf_mhe_tpu.utils import checkpoint, timing


def test_checkpoint_resume_bit_exact(tmp_path):
    """Snapshot mid-run, resume, and get bit-identical estimates."""
    p = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=10,
                        foot_swing_std=[1e7] * 3)
    log = synth.generate(synth.SynthConfig(T=60, seed=2))
    data = estimator.tickdata_from_log(log)
    c = mhe.make_consts(p, jnp.float64)
    d0 = jax.tree.map(lambda a: a[0], data)
    st = mhe.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot,
                  d0.dq, d0.contact, dtype=jnp.float64)

    def run(st, ks):
        outs = []
        for k in ks:
            d = jax.tree.map(lambda a: a[k], data)
            st, (xT, _) = mhe.step(c, st, d.R_sb, d.accel_b, d.omega_b,
                                   d.p_foot, d.J_foot, d.dq, d.contact,
                                   False, jnp.zeros(3), 0, 0, d.R_sb)
            outs.append(np.asarray(xT))
        return st, outs

    st_mid, _ = run(st, range(1, 30))
    path = str(tmp_path / "carry.npz")
    checkpoint.save_carry(path, st_mid)
    st_restored = checkpoint.load_carry(path, st_mid)
    _, out_a = run(st_mid, range(30, 50))
    _, out_b = run(st_restored, range(30, 50))
    np.testing.assert_array_equal(np.stack(out_a), np.stack(out_b))


def test_timing_probes(capsys):
    timing.tic("unit")
    dt = timing.toc("unit", quiet=True)
    assert dt >= 0
    res = {}
    with timing.scoped_timer("block", res):
        pass
    assert "block" in res
    w, out = timing.rate_probe(lambda x: x + 1, jnp.ones(4), reps=2)
    assert w > 0 and np.asarray(out).shape == (4,)


def test_example_driver(tmp_path):
    from conftest import run_example

    run_example("run_go1.py", "--ticks", "120", "--est-type", "1",
                "--gt-orientation", "--log-dir", str(tmp_path), "--cpu")
    from decentralized_ekf_mhe_tpu.io import logger as log_io

    out = log_io.read_log(str(tmp_path / "go1"))
    assert out["x_MHE"].shape == (120, 9)
    assert np.isfinite(out["v_body"]).all()


def test_checkpoint_shape_mismatch_raises(tmp_path):
    """A saved leaf whose shape disagrees with the template (carry structure
    changed in a non-trailing position) must refuse to load, not silently
    shift every later leaf (advisor r04)."""
    carry = {"a": jnp.zeros((3, 4)), "b": jnp.ones((2,))}
    path = str(tmp_path / "c.npz")
    checkpoint.save_carry(path, carry)
    bad_template = {"a": jnp.zeros((3, 5)), "b": jnp.ones((2,))}
    try:
        checkpoint.load_carry(path, bad_template)
    except ValueError as e:
        assert "shape" in str(e)
    else:
        raise AssertionError("shape mismatch did not raise")
    # matching template still round-trips
    out = checkpoint.load_carry(path, carry)
    np.testing.assert_array_equal(np.asarray(out["a"]), np.zeros((3, 4)))


def test_perturb_noise_matches_configured_stds():
    """Monte-Carlo draws are scaled by the CONFIGURED sensor stds (robot_params
    schema, DecentralEst.hpp:18-63) — the fleet samples the noise model the
    estimator assumes."""
    from decentralized_ekf_mhe_tpu.config import EKFParams
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

    p = EstimatorParams(
        num_legs=4, leg_odom_type=0, rate=200, N=10,
        accel_input_std=[0.025, 0.05, 0.02], gyro_input_std=[0.03] * 3,
        joint_velocity_std=[0.22] * 3, vo_p_std=[0.004] * 3,
        foot_swing_std=[1e7] * 3)
    log = synth.generate(synth.SynthConfig(T=64, seed=3))
    data = estimator.tickdata_from_log(log, dtype=jnp.float32)
    B = 256
    d_b = batch_lib.perturb_log_batch(data, B, jax.random.PRNGKey(0), p,
                                      dtype=jnp.float32)
    # empirical std across the fleet ≈ configured std, per axis
    for field, std in (("accel_b", p.accel_input_std),
                       ("omega_b", p.gyro_input_std)):
        delta = np.asarray(getattr(d_b, field)) - np.asarray(
            getattr(data, field))[None]
        emp = delta.std(axis=(0, 1))
        np.testing.assert_allclose(emp, std, rtol=0.05)
    dq_delta = np.asarray(d_b.dq) - np.asarray(data.dq)[None]
    np.testing.assert_allclose(dq_delta.std(axis=(0, 1, 2)),
                               p.joint_velocity_std, rtol=0.05)

    vo = estimator.vodata_from_log(log, dtype=jnp.float32)
    vo_b = batch_lib.perturb_vo_batch(vo, B, jax.random.PRNGKey(1), p,
                                      dtype=jnp.float32)
    act = np.asarray(vo.active)
    dp_delta = (np.asarray(vo_b.dp_body)
                - np.asarray(vo.dp_body)[:, :, None])[act]
    np.testing.assert_allclose(dp_delta.std(axis=(0, 2)), p.vo_p_std,
                               rtol=0.1)

    eb = estimator.ekfblocks_from_log(log, dtype=jnp.float32)
    ep = EKFParams(vo_meas_std=[0.003] * 4)
    eb_b = batch_lib.perturb_ekf_blocks(eb, B, jax.random.PRNGKey(2), p,
                                        dtype=jnp.float32, vo_noise_scale=1.0,
                                        ekf_params=ep)
    v = np.asarray(eb.valid)
    g_delta = (np.asarray(eb_b.gyro) - np.asarray(eb.gyro)[..., None])[v]
    np.testing.assert_allclose(g_delta.std(axis=(0, 2)), p.gyro_input_std,
                               rtol=0.05)
    a_delta = (np.asarray(eb_b.accel) - np.asarray(eb.accel)[..., None])[v]
    np.testing.assert_allclose(a_delta.std(axis=(0, 2)), p.accel_input_std,
                               rtol=0.05)
