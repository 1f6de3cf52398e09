import numpy as np
import jax
import jax.numpy as jnp
import pytest

from decentralized_ekf_mhe_tpu.config import EKFParams, std_to_cov
from decentralized_ekf_mhe_tpu.ops import ekf
from tests.ref_impl.ekf_ref import RefEKF


def make_imu_log(T, dt, seed=0):
    """Synthetic IMU: smooth rotation + gravity-consistent accelerometer."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) * dt
    gyro = np.stack(
        [
            0.8 * np.sin(2 * np.pi * 0.7 * t),
            0.5 * np.cos(2 * np.pi * 0.4 * t),
            0.3 * np.sin(2 * np.pi * 1.1 * t + 0.5),
        ],
        axis=-1,
    ) + 0.01 * rng.standard_normal((T, 3))
    # integrate the true orientation to synthesize accel = Rᵀ g + noise
    from tests.ref_impl import ekf_ref

    q = np.array([1.0, 0, 0, 0])
    accel = np.zeros((T, 3))
    qs = np.zeros((T, 4))
    for k in range(T):
        F = np.eye(4) + dt / 2 * ekf_ref.omega(gyro[k])
        q = F @ q
        q /= np.linalg.norm(q)
        qs[k] = q
        accel[k] = ekf_ref.rot(q).T @ ekf_ref.G + 0.05 * rng.standard_normal(3)
    return gyro, accel, qs


@pytest.mark.parametrize("quirk", [True, False])
def test_single_tick_matches_oracle(quirk):
    params = EKFParams(quirk_compatible_W=quirk)
    c = ekf.make_consts(params, dtype=jnp.float64)
    state = ekf.init_state(params, ring_len=16, dtype=jnp.float64)

    ref = RefEKF(
        params.quaternion_init,
        std_to_cov(params.init_std),
        std_to_cov(params.process_std),
        std_to_cov(params.gravity_meas_std),
        std_to_cov(params.vo_meas_std),
        params.dt,
        quirk,
    )
    gyro = np.array([0.1, -0.2, 0.05])
    accel = np.array([0.3, -0.1, 9.7])
    state = ekf.tick(state, jnp.asarray(gyro), jnp.asarray(accel), False,
                     jnp.zeros(4), 0, c)
    q_ref = ref.tick(gyro, accel)
    np.testing.assert_allclose(np.asarray(state.q), q_ref, atol=1e-12)
    np.testing.assert_allclose(np.asarray(state.P), ref.P, atol=1e-12)


def test_sequence_no_vo_matches_oracle():
    params = EKFParams()
    dt = params.dt
    T = 200
    gyro, accel, _ = make_imu_log(T, dt)

    c = ekf.make_consts(params, dtype=jnp.float64)
    state = ekf.init_state(params, ring_len=64, dtype=jnp.float64)
    _, q_seq = ekf.run_sequence(
        state,
        jnp.asarray(gyro),
        jnp.asarray(accel),
        jnp.zeros(T, bool),
        jnp.zeros((T, 4)),
        jnp.zeros(T, jnp.int32),
        c,
    )

    ref = RefEKF(
        params.quaternion_init, std_to_cov(params.init_std),
        std_to_cov(params.process_std), std_to_cov(params.gravity_meas_std),
        std_to_cov(params.vo_meas_std), dt,
    )
    for k in range(T):
        q_ref = ref.tick(gyro[k], accel[k])
        np.testing.assert_allclose(np.asarray(q_seq[k]), q_ref, atol=1e-10,
                                   err_msg=f"tick {k}")


def test_sequence_with_vo_replay_matches_oracle():
    params = EKFParams()
    dt = params.dt
    T = 120
    gyro, accel, qs_true = make_imu_log(T, dt, seed=3)

    # VO quaternion arrives every 17 ticks with a sync point 5 steps back
    vo_active = np.zeros(T, bool)
    vo_q = np.zeros((T, 4))
    vo_sb = np.zeros(T, np.int32)
    for k in range(20, T, 17):
        vo_active[k] = True
        vo_q[k] = qs_true[k - 5]
        vo_sb[k] = 5

    c = ekf.make_consts(params, dtype=jnp.float64)
    state = ekf.init_state(params, ring_len=32, dtype=jnp.float64)
    _, q_seq = ekf.run_sequence(
        state, jnp.asarray(gyro), jnp.asarray(accel),
        jnp.asarray(vo_active), jnp.asarray(vo_q), jnp.asarray(vo_sb), c,
    )

    ref = RefEKF(
        params.quaternion_init, std_to_cov(params.init_std),
        std_to_cov(params.process_std), std_to_cov(params.gravity_meas_std),
        std_to_cov(params.vo_meas_std), dt,
    )
    for k in range(T):
        q_ref = ref.tick(gyro[k], accel[k], vo_active[k], vo_q[k], int(vo_sb[k]))
        np.testing.assert_allclose(np.asarray(q_seq[k]), q_ref, atol=1e-9,
                                   err_msg=f"tick {k}")


def test_converges_to_true_attitude():
    """The filter should track the synthetic true orientation closely."""
    params = EKFParams()
    T = 1000
    gyro, accel, qs_true = make_imu_log(T, params.dt, seed=9)
    c = ekf.make_consts(params, dtype=jnp.float64)
    state = ekf.init_state(params, ring_len=64, dtype=jnp.float64)
    _, q_seq = ekf.run_sequence(
        state, jnp.asarray(gyro), jnp.asarray(accel),
        jnp.zeros(T, bool), jnp.zeros((T, 4)), jnp.zeros(T, jnp.int32), c,
    )
    q_est = np.asarray(q_seq[-1])
    q_true = qs_true[-1]
    # angle between quaternions
    dot = abs(float(np.dot(q_est, q_true)))
    angle = 2 * np.arccos(min(dot, 1.0))
    assert angle < 0.05, f"attitude error {angle} rad"


def test_float32_adequacy():
    """f32 path (the accelerator default) stays within 1e-4 quaternion error of f64."""
    params = EKFParams()
    T = 500
    gyro, accel, _ = make_imu_log(T, params.dt, seed=5)

    outs = {}
    for dtype in (jnp.float64, jnp.float32):
        c = ekf.make_consts(params, dtype=dtype)
        state = ekf.init_state(params, ring_len=64, dtype=dtype)
        _, q_seq = ekf.run_sequence(
            state, jnp.asarray(gyro, dtype), jnp.asarray(accel, dtype),
            jnp.zeros(T, bool), jnp.zeros((T, 4), dtype), jnp.zeros(T, jnp.int32), c,
        )
        outs[str(dtype)] = np.asarray(q_seq, np.float64)
    err = np.abs(outs["<class 'jax.numpy.float64'>"] - outs["<class 'jax.numpy.float32'>"]).max()
    assert err < 1e-4, f"f32 drift {err}"


def test_vmap_batch_consistency():
    """A batch of identical instances must equal the single instance."""
    params = EKFParams()
    T = 64
    B = 4
    gyro, accel, _ = make_imu_log(T, params.dt, seed=11)
    c = ekf.make_consts(params, dtype=jnp.float64)
    state = ekf.init_state(params, ring_len=32, dtype=jnp.float64)

    def run_one(g, a):
        _, q_seq = ekf.run_sequence(
            state, g, a, jnp.zeros(T, bool), jnp.zeros((T, 4)),
            jnp.zeros(T, jnp.int32), c,
        )
        return q_seq

    single = run_one(jnp.asarray(gyro), jnp.asarray(accel))
    batched = jax.vmap(run_one)(
        jnp.tile(gyro[None], (B, 1, 1)), jnp.tile(accel[None], (B, 1, 1))
    )
    for b in range(B):
        np.testing.assert_allclose(np.asarray(batched[b]), np.asarray(single), atol=1e-12)
