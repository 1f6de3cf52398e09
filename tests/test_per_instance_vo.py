"""Per-instance VO schedules on the lanes fast path: the fully masked
mhe_lanes.step_per_instance_vo must equal the vmapped standard runner
lane-by-lane at float64 — each lane gets a DIFFERENT VO schedule (shifted
timing, perturbed content, some lanes with no VO at all)."""

import jax
import jax.numpy as jnp
import numpy as np

from decentralized_ekf_mhe_tpu.config import EstimatorParams
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import estimator
from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

DT = jnp.float64


def _make_fleet(T, B, seed):
    """B perturbed instances with per-instance VO event streams."""
    rng = np.random.default_rng(seed)
    logs = [synth.generate(synth.SynthConfig(
        T=T, seed=seed, vo_every=5 + b % 3, vo_latency=1 + b % 2))
        for b in range(B)]
    base = logs[0]
    datas, vos = [], []
    for b, lg in enumerate(logs):
        d = estimator.tickdata_from_log(base, dtype=DT)
        d = d._replace(
            accel_b=d.accel_b + 0.01 * rng.standard_normal((T, 3)))
        v = estimator.vodata_from_log(lg, dtype=DT)
        if b == B - 1:  # one lane entirely VO-free
            v = v._replace(active=jnp.zeros(T, bool))
        else:
            v = v._replace(dp_body=v.dp_body + 1e-4 * b)
        datas.append(d)
        vos.append(v)
    data_b = jax.tree.map(lambda *a: jnp.stack(a), *datas)   # (B,T,...)
    vo_b = jax.tree.map(lambda *a: jnp.stack(a), *vos)       # (B,T,...)
    return data_b, vo_b


def test_per_instance_vo_matches_vmapped():
    T, B = 26, 4
    p = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=6)
    data_b, vo_b = _make_fleet(T, B, seed=11)

    # oracle: vmap the standard runner over (data, vo) pairs
    x_ref, v_ref = jax.vmap(
        lambda d, v: estimator.run_mhe(p, d, vo=v, dtype=DT)
    )(data_b, vo_b)                                          # (B,T,...)

    # lanes fast path with per-instance VO
    data_tb = batch_lib.to_time_leading(data_b)              # (T,B,...)
    data_l = batch_lib.tickdata_to_lanes(data_tb)
    vo_l = estimator.VOData(
        active=jnp.swapaxes(vo_b.active, 0, 1),              # (T,B)
        dp_body=jnp.moveaxis(vo_b.dp_body, 0, -1),           # (T,3,B)
        tick_pre=jnp.swapaxes(vo_b.tick_pre, 0, 1),
        tick_now=jnp.swapaxes(vo_b.tick_now, 0, 1),
    )
    x_l, v_l = estimator.run_mhe_lanes(p, data_l, vo=vo_l, dtype=DT)
    np.testing.assert_allclose(np.asarray(jnp.swapaxes(x_l, 0, 1)),
                               np.asarray(x_ref), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.asarray(jnp.swapaxes(v_l, 0, 1)),
                               np.asarray(v_ref), rtol=1e-7, atol=1e-9)

    # the schedules genuinely differ across lanes (the test has teeth)
    assert not np.array_equal(np.asarray(vo_b.active[0]),
                              np.asarray(vo_b.active[1]))


def test_per_instance_vo_shared_schedule_consistency():
    """A per-instance stream where every lane carries the SAME schedule must
    reproduce the shared-schedule path exactly."""
    T, B = 22, 3
    p = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=5)
    log = synth.generate(synth.SynthConfig(T=T, seed=2))
    data = estimator.tickdata_from_log(log, dtype=DT)
    vo = estimator.vodata_from_log(log, dtype=DT)
    key = jax.random.PRNGKey(0)
    data_b = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, B, key, dtype=DT))
    data_l = batch_lib.tickdata_to_lanes(data_b)

    x_shared, _ = estimator.run_mhe_lanes(p, data_l, vo=vo, dtype=DT)
    vo_pi = estimator.VOData(
        active=jnp.broadcast_to(vo.active[:, None], (T, B)),
        dp_body=jnp.broadcast_to(vo.dp_body[:, :, None], (T, 3, B)),
        tick_pre=jnp.broadcast_to(vo.tick_pre[:, None], (T, B)),
        tick_now=jnp.broadcast_to(vo.tick_now[:, None], (T, B)),
    )
    x_pi, _ = estimator.run_mhe_lanes(p, data_l, vo=vo_pi, dtype=DT)
    np.testing.assert_allclose(np.asarray(x_pi), np.asarray(x_shared),
                               rtol=1e-9, atol=1e-11)


def test_ekf_per_lane_vo_matches_single():
    """Per-lane EKF VO events (ekf_lanes._replay_per_lane): a lanes fleet
    where every lane carries a DIFFERENT delayed-VO schedule (timing, content,
    steps-back; one lane VO-free) must equal the single-instance EKF
    (ops/ekf.run_sequence) lane-by-lane at float64."""
    from decentralized_ekf_mhe_tpu.config import EKFParams
    from decentralized_ekf_mhe_tpu.ops import ekf as ekf_ops
    from decentralized_ekf_mhe_tpu.ops import ekf_lanes

    p = EKFParams()
    c = ekf_ops.make_consts(p, DT)
    ring = 16
    B = 3
    logs = [synth.generate(synth.SynthConfig(
        T=24, seed=20 + b, vo_every=4 + b, vo_latency=1 + b % 2))
        for b in range(B)]
    T_ekf = min(lg.ekf_gyro.shape[0] for lg in logs)

    actives = []
    refs = []
    for b, lg in enumerate(logs):
        gyro = jnp.asarray(lg.ekf_gyro[:T_ekf], DT)
        accel = jnp.asarray(lg.ekf_accel[:T_ekf], DT)
        act = jnp.asarray(lg.ekf_vo_active[:T_ekf])
        if b == B - 1:
            act = jnp.zeros(T_ekf, bool)        # one lane entirely VO-free
        st = ekf_ops.init_state(p, ring_len=ring, dtype=DT)
        _, q_ref = ekf_ops.run_sequence(
            st, gyro, accel, act, jnp.asarray(lg.ekf_vo_q[:T_ekf], DT),
            jnp.asarray(lg.ekf_vo_steps_back[:T_ekf], jnp.int32), c)
        refs.append(q_ref)
        actives.append(act)

    gyro_l = jnp.stack([jnp.asarray(lg.ekf_gyro[:T_ekf], DT) for lg in logs],
                       axis=-1)
    accel_l = jnp.stack([jnp.asarray(lg.ekf_accel[:T_ekf], DT) for lg in logs],
                        axis=-1)
    va_l = jnp.stack(actives, axis=-1)                       # (T,B)
    qv_l = jnp.stack([jnp.asarray(lg.ekf_vo_q[:T_ekf], DT) for lg in logs],
                     axis=-1)                                # (T,4,B)
    sb_l = jnp.stack(
        [jnp.asarray(lg.ekf_vo_steps_back[:T_ekf], jnp.int32) for lg in logs],
        axis=-1)                                             # (T,B)

    stl = ekf_lanes.init_state(p, B, ring_len=ring, dtype=DT)

    def step(s, x):
        g, a, va, qv, sb = x
        s = ekf_lanes.tick(s, g, a, va, qv, sb, c)
        return s, s.q

    _, q_l = jax.lax.scan(step, stl, (gyro_l, accel_l, va_l, qv_l, sb_l))
    for b in range(B):
        np.testing.assert_allclose(np.asarray(q_l[..., b]),
                                   np.asarray(refs[b]), rtol=1e-9, atol=1e-11)
    # schedules genuinely differ across lanes
    assert not np.array_equal(np.asarray(actives[0]), np.asarray(actives[1]))


def test_ekf_per_lane_uniform_matches_shared():
    """A per-lane EKF VO stream where every lane carries the SAME schedule
    must reproduce the shared-scalar path exactly (incl. per-lane q_vo that
    happens to be identical across lanes)."""
    from decentralized_ekf_mhe_tpu.config import EKFParams
    from decentralized_ekf_mhe_tpu.ops import ekf as ekf_ops
    from decentralized_ekf_mhe_tpu.ops import ekf_lanes

    p = EKFParams()
    c = ekf_ops.make_consts(p, DT)
    log = synth.generate(synth.SynthConfig(T=20, seed=9))
    T_ekf = log.ekf_gyro.shape[0]
    B = 2
    gyro_l = jnp.stack([jnp.asarray(log.ekf_gyro, DT)] * B, axis=-1)
    accel_l = jnp.stack([jnp.asarray(log.ekf_accel, DT) + 1e-4 * b
                         for b in range(B)], axis=-1)
    va = jnp.asarray(log.ekf_vo_active)
    qv = jnp.asarray(log.ekf_vo_q, DT)
    sb = jnp.asarray(log.ekf_vo_steps_back, jnp.int32)

    def run(va_x, qv_x, sb_x):
        stl = ekf_lanes.init_state(p, B, ring_len=16, dtype=DT)

        def step(s, x):
            g, a, vax, qvx, sbx = x
            return ekf_lanes.tick(s, g, a, vax, qvx, sbx, c), s.q

        _, q = jax.lax.scan(step, stl, (gyro_l, accel_l, va_x, qv_x, sb_x))
        return q

    q_shared = run(va, qv, sb)
    q_perlane = run(
        jnp.broadcast_to(va[:, None], (T_ekf, B)),
        jnp.broadcast_to(qv[:, :, None], (T_ekf, 4, B)),
        jnp.broadcast_to(sb[:, None], (T_ekf, B)),
    )
    np.testing.assert_allclose(np.asarray(q_perlane), np.asarray(q_shared),
                               rtol=1e-12, atol=1e-14)
