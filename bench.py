"""Headline benchmark: full EKF+MHE pipeline ticks/s/chip at the Go1 config.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}
where vs_baseline is value / 50_000 (the BASELINE.md north-star target for
MHE solves/s/chip — each pipeline tick contains exactly one windowed MHE
solve, so the units are comparable and the pipeline number is the *stricter*
claim). Supplementary numbers go to stderr and into the JSON extras.

One "tick" is the reference's full 5 ms production cycle (go1_launch.py
pipeline): the tick's 500 Hz EKF substeps (predict + scaled accel-correct +
delayed-VO replay, orien_ekf.cpp:77-212), the EKF→MHE orientation handoff,
window shift/append, masked VO handling, arrival-cost marginalization, and
the exact block-tridiagonal QP solve at N=20 (MheSrb.cpp:351-713). The fleet
is a Monte-Carlo batch (BASELINE.json config 4) scanned fully on-device in
float32; wall time is measured over whole scans ended by
``jax.block_until_ready``.

Also measured (stderr + JSON extras):
- MHE-only fleet rate through the scanned lanes path
- state-constrained MHE rate (velocity box + OSQP-semantics ADMM with the
  reference YAML's tolerances — README.md:5's constraint capability)
- Cassie (s=15) and PogoX (L=1) MHE fleets
- f32-vs-f64 accuracy gate: velocity-RMSE delta vs a CPU float64 oracle
  (subprocess), asserted < 1e-3 (BASELINE.md north star), and a long-log
  soak against the same oracle
- latency: on-device per-tick time of a B=1 pipeline scan, per-dispatch
  p50/p99 of tick-at-a-time and K=20 block dispatch, and the full-cycle
  streaming facade, against the 5 ms budget

Needs a GPU: with none it stops (utils/runtime.init_backend). Every phase's
failure fails the run. The JSON carries the device it ran on.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Log length for the timed fleets.
T = int(os.environ.get("BENCH_T", "2000"))
SKIP = 100  # RMSE warmup skip (ticks)


def _f64_oracle(tmpdir, T_o=None, seed=0):
    """Run the float64 CPU oracle in a subprocess (x64 is process-global, and
    the child is held to the CPU so that it never opens the GPU); returns
    (x_seq (T,s), gt_v (T,3)). The child skips the persistent compile cache:
    a shared cache can hold CPU code compiled for another host's CPU."""
    T_o = T if T_o is None else T_o
    out = os.path.join(tmpdir, "oracle.npz")
    code = f"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)
import numpy as np
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import estimator
from bench import _params, _ekf_params
log = synth.generate(synth.SynthConfig(T={T_o}, seed={seed}))
R_seq, _ = estimator.ekf_orientation_sequence(_ekf_params(), log)
data = estimator.tickdata_from_log(log, R_sb=np.asarray(R_seq))
vo = estimator.vodata_from_log(log)
x, v = estimator.run_mhe(_params(), data, vo=vo)
np.savez("{out}", x=np.asarray(x), gt_v=log.gt_v_s)
"""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(os.path.abspath(__file__)))
    d = np.load(out)
    return d["x"], d["gt_v"]


def _params():
    from decentralized_ekf_mhe_tpu.config import EstimatorParams

    return EstimatorParams(
        num_legs=4, leg_odom_type=0, rate=200, N=20,
        p_process_std=[0.001] * 3, accel_input_std=[0.025, 0.025, 0.02],
        gyro_input_std=[0.03] * 3, accel_bias_std=[0.07, 0.02, 0.03],
        joint_position_std=[0.04] * 3, joint_velocity_std=[0.22] * 3,
        foot_slide_std=[0.003] * 3, foot_swing_std=[1e7] * 3,
        vo_p_std=[1.5e-5] * 3,
    )


def _ekf_params():
    from decentralized_ekf_mhe_tpu.config import EKFParams

    return EKFParams()


def main():
    from decentralized_ekf_mhe_tpu.utils import runtime

    devices = runtime.init_backend()
    import jax
    import jax.numpy as jnp

    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.ops import estimator, mhe
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

    dev = devices[0]
    card = runtime.gpu_query()
    print(f"device: {dev.device_kind} x{len(devices)}; {card}",
          file=sys.stderr)
    dtype = jnp.float32
    extras = {
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(devices),
        "power_limit": runtime.parse_gpu_query(card)[1],
    }
    extras["bench_T"] = T
    extras["bench_B"] = int(os.environ.get("BENCH_B", "1024"))

    params = _params()
    ekf_params = _ekf_params()
    B = int(os.environ.get("BENCH_B", "1024"))

    log = synth.generate(synth.SynthConfig(T=T, seed=0))
    data = estimator.tickdata_from_log(log, dtype=dtype)
    vo = estimator.vodata_from_log(log, dtype=dtype)
    key = jax.random.PRNGKey(0)
    data_b = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, B, key, params, dtype=dtype)
    )
    # the benched fleet perturbs the FULL sensor suite per instance with the
    # CONFIGURED sensor stds (accel/gyro/joint-velocity/vo_p from params):
    # IMU/encoders (perturb_log_batch) AND vision — per-lane VO quaternion
    # draws into the EKF (vo_noise_scale) and per-lane relative-translation
    # draws into the MHE (perturb_vo_batch), one shared camera clock
    eb = batch_lib.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=dtype), B,
        jax.random.PRNGKey(1), params, dtype=dtype, vo_noise_scale=1.0,
        ekf_params=ekf_params)
    vo_b = batch_lib.perturb_vo_batch(vo, B, jax.random.PRNGKey(2), params,
                                      dtype=dtype)

    def timed(fn, *args, reps=3, jitter=None):
        """(compile_s, best_wall_s, last_output). jitter(args, rep) perturbs
        inputs so reps are not no-op cache hits."""
        t0 = time.time()
        out = jax.block_until_ready(fn(*args))
        compile_s = time.time() - t0
        walls = []
        for rep in range(reps):
            a = jitter(args, rep) if jitter is not None else args
            t0 = time.time()
            out = jax.block_until_ready(fn(*a))
            walls.append(time.time() - t0)
        return compile_s, min(walls), out

    def jit_data(args, rep):
        d, *rest = args
        return (d._replace(accel_b=d.accel_b + (rep + 1) * 1e-7), *rest)

    # ---- headline: full EKF+MHE pipeline fleet --------------------------
    pipe = jax.jit(batch_lib.make_pipeline_fleet_runner(
        params, ekf_params, dtype))
    c_pipe, w_pipe, (x_p, v_p, _q) = timed(pipe, data_b, eb, vo_b,
                                           jitter=jit_data)
    ticks = B * (T - 1)
    rate_pipe = ticks / w_pipe
    extras["compile_s_pipeline"] = round(c_pipe, 1)
    print(f"pipeline (EKF+MHE) B={B}: compile+first {c_pipe:.1f}s, "
          f"best wall {w_pipe:.3f}s -> {rate_pipe:,.0f} ticks/s",
          file=sys.stderr)

    # accuracy: fleet estimates vs ground truth
    v_est = np.asarray(x_p[..., 3:6]).astype(np.float64)
    assert np.isfinite(v_est).all(), "non-finite estimates"
    rmse = float(np.sqrt(((v_est[SKIP:] - log.gt_v_s[SKIP:, None]) ** 2).mean()))
    extras["fleet_rmse_vs_gt"] = round(rmse, 5)
    print(f"pipeline fleet velocity RMSE vs GT: {rmse:.4f} m/s", file=sys.stderr)
    assert rmse < 0.1, f"accuracy regression: RMSE {rmse}"

    # ---- MHE-only fleet ------------------------------------------------
    scan = jax.jit(batch_lib.make_lanes_fleet_runner(params, dtype))
    c_scan, w_scan, _ = timed(scan, data_b, vo_b, jitter=jit_data)
    rate_scan = ticks / w_scan
    extras["compile_s_mhe_scan"] = round(c_scan, 1)
    extras["mhe_only_scan_solves_per_s"] = round(rate_scan, 0)
    print(f"MHE-only scanned lanes: compile {c_scan:.1f}s, "
          f"{rate_scan:,.0f} solves/s", file=sys.stderr)

    # ---- constrained MHE (velocity box — MheSrb.cpp:272-349 capability) -
    # The |v|<=0.3 box genuinely binds on this log (unconstrained max|v| is
    # 0.386) — asserted active AND respected below. The
    # constrained fleet consumes the PER-INSTANCE vision draws (vo_b).
    s_dim = params.dim_state
    vbound = 0.3
    x_lb = np.full(s_dim, -np.inf); x_lb[3:6] = -vbound
    x_ub = np.full(s_dim, np.inf); x_ub[3:6] = vbound
    params.osqp.abs_tol = 1e-6
    params.osqp.relative_tol = 1e-6
    c_con = mhe.make_consts(params, dtype, x_lb=x_lb, x_ub=x_ub,
                            admm_iters=50)
    con = jax.jit(batch_lib.make_lanes_fleet_runner(params, dtype,
                                                    consts=c_con))
    c_adm, w_adm, (x_c, _) = timed(con, data_b, vo_b, jitter=jit_data)
    rate_con = B * (T - 1) / w_adm
    extras["compile_s_constrained"] = round(c_adm, 1)
    extras["constrained_admm_solves_per_s"] = round(rate_con, 0)
    extras["constrained_box_bound"] = vbound
    vmax = float(np.abs(np.asarray(x_c[..., 3:6])).max())
    extras["constrained_max_abs_v"] = round(vmax, 4)
    print(f"constrained MHE (lanes ADMM, box |v|<={vbound}): "
          f"compile {c_adm:.1f}s, B={B}: {rate_con:,.0f} solves/s, "
          f"max|v|={vmax:.4f} (bound active)", file=sys.stderr)
    assert vmax <= vbound + 1e-3, "box constraint violated"
    assert vmax >= vbound - 1e-2, "box constraint never active"

    # ---- non-Go1 shape classes: Cassie (leg_odom_type=1, num_legs=2 =>
    # s=15 position-form measurements, DecentralEst.cpp:101-118,550-563) and
    # PogoX (single-leg hopper, L=1) through the scanned lanes path.
    for rname, n_legs, lot in (("cassie_s15", 2, 1), ("pogox_L1", 1, 0)):
        rp = _params()
        rp.num_legs = n_legs
        rp.leg_odom_type = lot
        log_r = synth.generate(synth.SynthConfig(T=T, seed=2,
                                                 num_legs=n_legs))
        data_r = estimator.tickdata_from_log(log_r, dtype=dtype)
        vo_r = estimator.vodata_from_log(log_r, dtype=dtype)
        data_rb = batch_lib.to_time_leading(
            batch_lib.perturb_log_batch(data_r, B, key, rp, dtype=dtype))
        rfn = jax.jit(batch_lib.make_lanes_fleet_runner(rp, dtype))
        c_r, w_r, (x_r, _) = timed(rfn, data_rb, vo_r, jitter=jit_data)
        rate_r = B * (T - 1) / w_r
        v_r = np.asarray(x_r[..., 3:6]).astype(np.float64)
        assert np.isfinite(v_r).all(), "non-finite estimates"
        rmse_r = float(np.sqrt(
            ((v_r[SKIP:] - log_r.gt_v_s[SKIP:, None]) ** 2).mean()))
        extras[f"{rname}_scan_solves_per_s"] = round(rate_r, 0)
        extras[f"{rname}_scan_rmse"] = round(rmse_r, 5)
        print(f"{rname} scan: compile {c_r:.1f}s, B={B}: "
              f"{rate_r:,.0f} solves/s, RMSE {rmse_r:.4f}", file=sys.stderr)
        assert rmse_r < 0.5, f"{rname} accuracy blowup: {rmse_r}"

    # ---- f32 accuracy gate vs the CPU float64 oracle --------------------
    with tempfile.TemporaryDirectory() as td:
        x64, gt_v = _f64_oracle(td)
    eb1 = batch_lib.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=dtype), 8,
        jax.random.PRNGKey(2), params, noise_scale=0.0, dtype=dtype)
    data1 = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, 8, key, params, noise_scale=0.0,
                                    dtype=dtype))
    pipe1 = jax.jit(batch_lib.make_pipeline_fleet_runner(
        params, ekf_params, dtype))
    x1, _, _ = jax.block_until_ready(pipe1(data1, eb1, vo))
    x32 = np.asarray(x1[:, 0]).astype(np.float64)

    def vrmse(x):
        return float(np.sqrt(((x[SKIP:, 3:6] - gt_v[SKIP:]) ** 2).mean()))

    r32, r64 = vrmse(x32), vrmse(x64)
    delta = abs(r32 - r64)
    dev_max = float(np.abs(x32 - x64).max())
    extras["rmse_f32"] = round(r32, 6)
    extras["rmse_f64_oracle"] = round(r64, 6)
    extras["rmse_delta_f32_vs_f64"] = round(delta, 6)
    extras["max_state_dev_f32_vs_f64"] = round(dev_max, 5)
    print(f"f32 gate: RMSE f32 {r32:.5f} vs f64 oracle {r64:.5f} "
          f"(delta {delta:.2e} < 1e-3 gate), max state dev {dev_max:.4f}",
          file=sys.stderr)
    assert delta < 1e-3, f"f32 accuracy gate failed: delta {delta}"

    # ---- long-log f32 soak: recursive-arrival-cost drift at deployment
    # durations. T>=20k ticks = 100+ s of robot time through
    # the full staged pipeline, vs the f64
    # CPU oracle; the 1e-3 RMSE gate is asserted on the END of the log, and
    # the drift curve is printed per block.
    T_SOAK = int(os.environ.get("BENCH_SOAK_T", "20000"))
    if T_SOAK:
        log_s = synth.generate(synth.SynthConfig(T=T_SOAK, seed=1))
        data_s = estimator.tickdata_from_log(log_s, dtype=dtype)
        vo_s = estimator.vodata_from_log(log_s, dtype=dtype)
        eb_s = estimator.ekfblocks_from_log(log_s, dtype=dtype)
        Bs = 8

        runner_s = batch_lib.make_pipeline_fleet_runner(
            params, ekf_params, dtype)

        @jax.jit
        def soak(d, e, v):
            # tile to a small identical fleet INSIDE the jit so only the
            # base log is copied to the device
            db = jax.tree.map(
                lambda a: jnp.broadcast_to(
                    a[:, None], (a.shape[0], Bs) + a.shape[1:]), d)
            el = e._replace(
                gyro=jnp.broadcast_to(e.gyro[..., None], e.gyro.shape + (Bs,)),
                accel=jnp.broadcast_to(e.accel[..., None],
                                       e.accel.shape + (Bs,)))
            return runner_s(db, el, v)[0]

        t0 = time.time()
        xs_ = jax.block_until_ready(soak(data_s, eb_s, vo_s))
        c_s = time.time() - t0
        t0 = time.time()
        xs_ = jax.block_until_ready(
            soak(data_s._replace(accel_b=data_s.accel_b + 1e-7), eb_s, vo_s))
        w_s = time.time() - t0
        x32s = np.asarray(xs_[:, 0]).astype(np.float64)
        extras["soak_compile_s_scan"] = round(c_s, 1)
        print(f"soak: T={T_SOAK} compile+first {c_s:.1f}s, "
              f"wall {w_s:.1f}s ({Bs * (T_SOAK - 1) / w_s:,.0f} "
              f"ticks/s at B={Bs})", file=sys.stderr)

        with tempfile.TemporaryDirectory() as td:
            x64_s, gt_v_s = _f64_oracle(td, T_o=T_SOAK, seed=1)
        tail = int(T_SOAK * 0.9)          # END-of-log window (last 10%)
        blk = max(1, T_SOAK // 10)
        dev = np.abs(x32s - x64_s)
        curve = [float(dev[b:b + blk].max()) for b in range(0, T_SOAK, blk)]
        # per-dimension split: velocity dims (3:6) are the gate-relevant
        # ones; position/foot dims drift benignly (an unobservable
        # absolute-position mode — the MHE only measures velocities and
        # relative translations)
        vel_curve = [float(dev[b:b + blk, 3:6].max())
                     for b in range(0, T_SOAK, blk)]
        r32s = float(np.sqrt(((x32s[tail:, 3:6] - gt_v_s[tail:]) ** 2).mean()))
        r64s = float(np.sqrt(((x64_s[tail:, 3:6] - gt_v_s[tail:]) ** 2).mean()))
        delta_s = abs(r32s - r64s)
        dev_end_pos = float(np.delete(dev[tail:], [3, 4, 5], axis=1).max())
        extras["soak_rmse_delta_end_scan"] = round(delta_s, 6)
        extras["soak_max_dev_end_scan"] = round(float(dev[tail:].max()), 5)
        extras["soak_max_dev_end_vel_scan"] = round(
            float(dev[tail:, 3:6].max()), 6)
        extras["soak_max_dev_end_pos_scan"] = round(dev_end_pos, 5)
        extras["soak_drift_curve_scan"] = [round(c, 4) for c in curve]
        extras["soak_vel_drift_curve_scan"] = [round(c, 5) for c in vel_curve]
        print(f"soak: drift curve (max|x32-x64| per {blk}-tick block): "
              f"{[round(c, 4) for c in curve]}", file=sys.stderr)
        print(f"soak: velocity-dim drift curve: "
              f"{[round(c, 5) for c in vel_curve]}", file=sys.stderr)
        print(f"soak: END-window RMSE f32 {r32s:.5f} vs f64 {r64s:.5f} "
              f"(delta {delta_s:.2e} < 1e-3 gate), max state dev "
              f"{float(dev[tail:].max()):.4f} (velocity dims "
              f"{float(dev[tail:, 3:6].max()):.5f}, position/foot dims "
              f"{dev_end_pos:.4f})", file=sys.stderr)
        assert delta_s < 1e-3, f"soak f32 gate failed: {delta_s}"
        extras["soak_T"] = T_SOAK

    # ---- latency: B=1 on-device per-tick + per-dispatch p50/p99 ---------
    dataL = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, 1, key, params, dtype=dtype))
    ebL = batch_lib.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=dtype), 1,
        jax.random.PRNGKey(3), params, dtype=dtype)
    pipeL = jax.jit(batch_lib.make_pipeline_fleet_runner(
        params, ekf_params, dtype))
    _, wL, _ = timed(pipeL, dataL, ebL, vo, jitter=jit_data)
    tick_ms_b1 = wL / (T - 1) * 1e3
    extras["b1_on_device_tick_ms"] = round(tick_ms_b1, 4)
    print(f"B=1 on-device pipeline tick: {tick_ms_b1:.3f} ms "
          f"(5 ms reference budget)", file=sys.stderr)

    # facade-style per-tick dispatch: one jitted MHE tick per host call —
    # the HIL analog; host dispatch and launch latency dominate at B=1.
    c1 = mhe.make_consts(params, dtype)
    d0 = __import__("jax").tree.map(lambda a: a[0], data)
    st = mhe.init(c1, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot,
                  d0.dq, d0.contact, dtype=dtype)
    step1 = jax.jit(lambda st_, d: mhe.step(
        c1, st_, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
        d.contact, False, jnp.zeros(3, dtype), 0, 0, d.R_sb))
    dticks = [__import__("jax").tree.map(lambda a: a[k], data)
              for k in range(1, min(41, T))]
    st, _ = jax.block_until_ready(step1(st, dticks[0]))
    lats = []
    for k in range(1, len(dticks)):
        t0 = time.time()
        st, (xT, _) = jax.block_until_ready(step1(st, dticks[k]))
        lats.append(time.time() - t0)
    lats_ms = np.asarray(lats) * 1e3
    extras["dispatch_p50_ms"] = round(float(np.percentile(lats_ms, 50)), 2)
    extras["dispatch_p99_ms"] = round(float(np.percentile(lats_ms, 99)), 2)
    print(f"per-dispatch tick latency: p50 "
          f"{extras['dispatch_p50_ms']} ms, p99 {extras['dispatch_p99_ms']} ms "
          f"(n={len(lats)})", file=sys.stderr)

    # HIL block dispatch: one jitted 20-tick scan per host call with a
    # DONATED carry (facade.update_block semantics) — per-tick dispatch cost
    # drops ~K-fold vs tick-at-a-time (examples/run_hil.py is the streaming
    # driver built on this)
    K_blk = 20

    def blk_fn(st_, d):
        def sc(st2, dk):
            st2, (xT, _) = mhe.step(
                c1, st2, dk.R_sb, dk.accel_b, dk.omega_b, dk.p_foot,
                dk.J_foot, dk.dq, dk.contact, False, jnp.zeros(3, dtype),
                0, 0, dk.R_sb)
            return st2, xT

        return jax.lax.scan(sc, st_, d)

    blk_jit = jax.jit(blk_fn, donate_argnums=0)
    st2 = mhe.init(c1, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot,
                   d0.J_foot, d0.dq, d0.contact, dtype=dtype)
    blocks = [jax.tree.map(lambda a: a[k:k + K_blk], data)
              for k in range(1, T - K_blk, K_blk)]
    st2, xb = blk_jit(st2, blocks[0])
    jax.block_until_ready(xb)
    blats = []
    for blk in blocks[1:]:
        t0 = time.time()
        st2, xb = jax.block_until_ready(blk_jit(st2, blk))
        blats.append((time.time() - t0) / K_blk)
    blats_ms = np.asarray(blats) * 1e3
    extras["dispatch_block20_per_tick_p50_ms"] = round(
        float(np.percentile(blats_ms, 50)), 3)
    extras["dispatch_block20_per_tick_p99_ms"] = round(
        float(np.percentile(blats_ms, 99)), 3)
    print(f"HIL block dispatch (K=20, donated carry): per-tick p50 "
          f"{extras['dispatch_block20_per_tick_p50_ms']} ms, p99 "
          f"{extras['dispatch_block20_per_tick_p99_ms']} ms "
          f"({float(np.percentile(lats_ms, 50)) / max(float(np.percentile(blats_ms, 50)), 1e-9):.0f}x "
          f"better than tick-at-a-time p50)", file=sys.stderr)

    # FULL-cycle HIL streaming latency: PipelineEstimator
    # runs the orientation EKF IN the loop (raw gyro/accel substep blocks +
    # MHE solve per tick, one donated-carry dispatch per 20-tick block) —
    # the complete production cycle, not just the MHE half
    from decentralized_ekf_mhe_tpu.ops.facade import PipelineEstimator

    eb_hil = estimator.ekfblocks_from_log(log, dtype=dtype)
    g_h = np.asarray(eb_hil.gyro); a_h = np.asarray(eb_hil.accel)
    v_h = np.asarray(eb_hil.valid)
    pe = PipelineEstimator(params, ekf_params, dtype=dtype)
    pe.initialize(g_h[0], a_h[0], v_h[0], log.accel_b[0], log.omega_b[0],
                  log.p_foot[0], log.J_foot[0], log.dq[0], log.contact[0])
    K_h = 20
    n_hil = min(40, (T - 1) // K_h)
    sl0 = slice(1, 1 + K_h)
    x_h, _, _ = pe.update_block(
        g_h[sl0], a_h[sl0], v_h[sl0], log.accel_b[sl0], log.omega_b[sl0],
        log.p_foot[sl0], log.J_foot[sl0], log.dq[sl0], log.contact[sl0])
    jax.block_until_ready(x_h)
    hlats = []
    for kb in range(1, n_hil):
        sl = slice(1 + kb * K_h, 1 + (kb + 1) * K_h)
        t0 = time.time()
        jax.block_until_ready(pe.update_block(
            g_h[sl], a_h[sl], v_h[sl], log.accel_b[sl], log.omega_b[sl],
            log.p_foot[sl], log.J_foot[sl], log.dq[sl], log.contact[sl]))
        hlats.append((time.time() - t0) / K_h)
    hlats_ms = np.asarray(hlats) * 1e3
    extras["hil_full_cycle_per_tick_p50_ms"] = round(
        float(np.percentile(hlats_ms, 50)), 3)
    extras["hil_full_cycle_per_tick_p99_ms"] = round(
        float(np.percentile(hlats_ms, 99)), 3)
    print(f"HIL FULL-cycle streaming (EKF in the loop, K=20 blocks, "
          f"donated carry): per-tick p50 "
          f"{extras['hil_full_cycle_per_tick_p50_ms']} ms, p99 "
          f"{extras['hil_full_cycle_per_tick_p99_ms']} ms "
          f"(5 ms reference budget)", file=sys.stderr)

    cyc = w_pipe / (T - 1)
    print(f"fleet cycle time: {cyc*1e3:.3f} ms for {B} instances "
          f"({cyc*1e3/B:.4f} ms/instance; reference budget 5 ms/instance)",
          file=sys.stderr)

    print(json.dumps({
        "metric": "mhe_solves_per_s_per_chip",
        "value": round(rate_pipe, 1),
        "unit": ("pipeline ticks/s (full EKF 500Hz substeps + MHE N=20 solve "
                 "per tick, Go1 config, incl. VO+marginalization; staged "
                 "lanes scans)"),
        "vs_baseline": round(rate_pipe / 50_000.0, 3),
        **extras,
    }))


if __name__ == "__main__":
    main()
