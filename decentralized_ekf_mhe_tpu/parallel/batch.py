"""Batched / sharded estimation harness: Monte-Carlo fleets and tuning sweeps.

Replaces the reference's single-trajectory realtime loop with fleets
(BASELINE.json configs 4-5): thousands of estimator instances per device in
one program, sharded across devices via a (data, model) mesh, with
cross-instance statistics reduced by XLA collectives (psum).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from decentralized_ekf_mhe_tpu.config import EstimatorParams
from decentralized_ekf_mhe_tpu.ops import estimator, kf as kf_ops, mhe
from decentralized_ekf_mhe_tpu.parallel import mesh as mesh_lib


def perturb_log_batch(data: estimator.TickData, B: int, key,
                      params: Optional[EstimatorParams] = None,
                      noise_scale=1.0,
                      dtype=jnp.float32) -> estimator.TickData:
    """Tile one log into B Monte-Carlo instances with fresh sensor noise draws
    (config 4: sampled IMU/encoder noise).

    Draw magnitudes come from the CONFIGURED sensor stds (``params`` →
    accel_input_std / gyro_input_std / joint_velocity_std — the same
    robot_params schema the estimator's covariances are built from,
    DecentralEst.hpp:18-63, parameters_go1.yaml:4-31), so the fleet samples
    exactly the noise model the estimator assumes. ``params=None`` keeps the
    schema defaults (EstimatorParams())."""
    p = params if params is not None else EstimatorParams()
    ka, kg, kq = jax.random.split(key, 3)
    acc_std = jnp.asarray(p.accel_input_std, dtype)       # (3,)
    gyro_std = jnp.asarray(p.gyro_input_std, dtype)       # (3,)
    dq_std = jnp.asarray(p.joint_velocity_std, dtype)     # (3,) per joint

    def tile(a):
        return jnp.broadcast_to(a[None].astype(dtype), (B,) + a.shape)

    d = jax.tree.map(tile, data)
    T = data.accel_b.shape[0]
    d = d._replace(
        accel_b=d.accel_b
        + noise_scale * acc_std * jax.random.normal(ka, (B, T, 3), dtype),
        omega_b=d.omega_b
        + noise_scale * gyro_std * jax.random.normal(kg, (B, T, 3), dtype),
        dq=d.dq + noise_scale * dq_std * jax.random.normal(kq, d.dq.shape, dtype),
    )
    return d


def perturb_ekf_blocks(eb: estimator.EKFBlocks, B: int, key,
                       params: Optional[EstimatorParams] = None,
                       noise_scale=1.0,
                       dtype=jnp.float32,
                       vo_noise_scale=0.0, ekf_params=None) -> estimator.EKFBlocks:
    """Tile one log's EKF-rate blocks into a B-instance lanes-layout fleet
    with fresh gyro/accel noise draws (the EKF half of perturb_log_batch),
    scaled by the configured gyro_input_std / accel_input_std (``params``;
    defaults to the EstimatorParams() schema values).

    ``vo_noise_scale`` > 0 additionally perturbs the VISION content per lane:
    the measured VO quaternion becomes per-lane (T,S,4,B) with a fresh draw
    per instance scaled by the EKF's configured per-component quaternion
    measurement std (``ekf_params.vo_meas_std``, orien_ekf.cpp:144-154 /
    parameters_go1.yaml orien_sub vo_meas_std; renormalized), so the
    Monte-Carlo fleet perturbs the full sensor suite with the stds the
    estimator assumes. Event timing (valid/vo_active/steps_back) stays the
    fleet's shared camera clock — one camera log drives every instance."""
    from decentralized_ekf_mhe_tpu.config import EKFParams

    p = params if params is not None else EstimatorParams()
    ep = ekf_params if ekf_params is not None else EKFParams()
    kg, ka, kq = jax.random.split(key, 3)
    T, S = eb.gyro.shape[:2]
    gyro_std = jnp.asarray(p.gyro_input_std, dtype)[None, None, :, None]
    acc_std = jnp.asarray(p.accel_input_std, dtype)[None, None, :, None]

    def tile_lanes(a):
        return jnp.broadcast_to(a.astype(dtype)[..., None], a.shape + (B,))

    vo_q = eb.vo_q.astype(dtype)
    if vo_noise_scale > 0.0:
        q_std = jnp.asarray(ep.vo_meas_std, dtype)[None, None, :, None]
        q_l = tile_lanes(vo_q)                          # (T,S,4,B)
        q_l = q_l + (
            vo_noise_scale * q_std
            * jax.random.normal(kq, (T, S, 4, B), dtype)
            * eb.vo_active.astype(dtype)[..., None, None]
        )
        nrm = jnp.sqrt(jnp.sum(q_l * q_l, axis=-2, keepdims=True))
        vo_q = jnp.where(nrm > 0, q_l / jnp.maximum(nrm, 1e-20), q_l)

    return eb._replace(
        gyro=tile_lanes(eb.gyro)
        + noise_scale * gyro_std * jax.random.normal(kg, (T, S, 3, B), dtype),
        accel=tile_lanes(eb.accel)
        + noise_scale * acc_std * jax.random.normal(ka, (T, S, 3, B), dtype),
        vo_q=vo_q,
    )


def perturb_vo_batch(vo: estimator.VOData, B: int, key,
                     params: Optional[EstimatorParams] = None,
                     noise_scale=1.0,
                     dtype=jnp.float32,
                     per_instance_timing=False) -> estimator.VOData:
    """Per-lane VO content noise for the MHE stage (the vision half of the
    Monte-Carlo story, DecentralEst.cpp:883-945 relative-translation
    measurements): dp_body becomes (T,3,B) with fresh per-instance draws on
    active events, scaled by the configured per-axis VO translation std
    (``params.vo_p_std`` — the same std the VO cost weights assume,
    parameters_go1.yaml visual_odom). With ``per_instance_timing`` the
    active/tick metadata are also broadcast per lane ((T,B)) for the fully
    per-instance scan path (mhe_lanes.step_per_instance_vo); otherwise timing
    stays the shared camera clock."""
    p = params if params is not None else EstimatorParams()
    T = vo.dp_body.shape[0]
    dp_std = jnp.asarray(p.vo_p_std, dtype)[None, :, None]
    dp = jnp.broadcast_to(vo.dp_body.astype(dtype)[:, :, None], (T, 3, B))
    dp = dp + (
        noise_scale * dp_std * jax.random.normal(key, (T, 3, B), dtype)
        * vo.active.astype(dtype)[:, None, None]
    )
    if per_instance_timing:
        return estimator.VOData(
            active=jnp.broadcast_to(vo.active[:, None], (T, B)),
            dp_body=dp,
            tick_pre=jnp.broadcast_to(vo.tick_pre[:, None], (T, B)),
            tick_now=jnp.broadcast_to(vo.tick_now[:, None], (T, B)),
        )
    return vo._replace(dp_body=dp)


def make_pipeline_fleet_runner(params: EstimatorParams, ekf_params,
                               dtype=jnp.float32, ekf_ring_len: int = 16,
                               consts=None):
    """The full-pipeline fleet path: EKF(500 Hz) → MHE(200 Hz) staged in
    lanes layout (estimator.run_pipeline_lanes) — the reference's actual
    production pipeline (go1_launch.py:18-63), batched. Staging is an exact
    reordering because the dataflow is strictly orien_ekf → imu/filter →
    est_sub, never back.

    f(TickData[T,B,...], EKFBlocks lanes, VOData) -> (x[T,B,s], v[T,B,3],
    q[T,4,B]). ``data.R_sb`` is ignored (orientation comes from the EKF).

    Pass ``consts`` (mhe.make_consts(..., x_lb=, x_ub=)) to run the
    CONSTRAINED production cycle — the reference's 200 Hz loop IS the
    inequality-capable OSQP solve (MheSrb.cpp:272-349 invoked per tick from
    DecentralEst.cpp:172-177), so state box constraints ride the same
    pipeline here through the lanes ADMM (admm.solve_box_tridiag_lanes),
    warm-started, with (s,) shared or (s,B) per-lane bounds.
    """
    c = consts if consts is not None else mhe.make_consts(params, dtype)

    def run(data_tb: estimator.TickData, eb: estimator.EKFBlocks,
            vo: estimator.VOData):
        data_l = tickdata_to_lanes(data_tb)
        return estimator.run_pipeline_lanes(
            params, ekf_params, data_l, eb, vo=vo, dtype=dtype, consts=c,
            ekf_ring_len=ekf_ring_len)

    return run


def mhe_window_solve_batch(params: EstimatorParams, dtype=jnp.float32):
    """Return a jittable f(batched MHEState) -> (B, N, s) window solve — the
    pure QP kernel used for solves/s benchmarking."""
    c = mhe.make_consts(params, dtype)

    def f(st):
        return mhe.solve_window(c, st)

    return f


def make_batched_runner(params: EstimatorParams, dtype=jnp.float32, with_vo=True):
    """vmapped full-log MHE replay: f(TickData[B], VOData) -> (x[B,T,s], v[B,T,3])."""

    def run_one(data, vo):
        return estimator.run_mhe(params, data, vo=vo, dtype=dtype)

    if with_vo:
        return jax.vmap(run_one, in_axes=(0, None))
    return jax.vmap(lambda d: estimator.run_mhe(params, d, vo=None, dtype=dtype))


def make_fused_batched_runner(params: EstimatorParams, dtype=jnp.float32):
    """Batched full-log MHE replay WITHOUT vmap: f(TickData[T,B,...], VOData)
    -> (x[T,B,s], v[T,B,3]).

    All mhe kernels broadcast over a trailing instance batch natively, so a
    time-leading/(T,B,...) layout runs the whole fleet through one scan with
    scalar tick counters — the VO and marginalization `lax.cond`s stay real
    branches (vmap would turn them into executed-both-sides selects).
    """
    c = mhe.make_consts(params, dtype)

    def run(data_tb: estimator.TickData, vo: estimator.VOData):
        return estimator.run_mhe(params, data_tb, vo=vo, dtype=dtype, consts=c)

    return run


def to_time_leading(data_b: estimator.TickData) -> estimator.TickData:
    """(B, T, ...) TickData -> (T, B, ...) for the fused batched runner."""
    return jax.tree.map(lambda a: jnp.swapaxes(a, 0, 1), data_b)


def tickdata_to_lanes(data_tb: estimator.TickData) -> estimator.TickData:
    """(T, B, ...) TickData -> lanes layout (T, ..., B) (ops/lanes.py)."""
    return jax.tree.map(lambda a: jnp.moveaxis(a, 1, -1), data_tb)


def make_lanes_fleet_runner(params: EstimatorParams, dtype=jnp.float32,
                            lever_arm=kf_ops.DEFAULT_LEVER_ARM,
                            consts=None):
    """MHE-only fleet replay: f(TickData[T,B,...], VOData) -> (x[T,B,s],
    v[T,B,3]) with the whole MHE state and assembly in instance-on-lanes
    layout (ops/mhe_lanes.py) and zero layout transposes inside the scan.
    Orientation comes from ``data.R_sb``.
    """
    c = consts if consts is not None else mhe.make_consts(params, dtype)

    def run(data_tb: estimator.TickData, vo: estimator.VOData):
        data_l = tickdata_to_lanes(data_tb)
        return estimator.run_mhe_lanes(params, data_l, vo=vo,
                                       lever_arm=lever_arm, dtype=dtype,
                                       consts=c)

    return run


def sharded_monte_carlo(params: EstimatorParams, mesh, data_b: estimator.TickData,
                        vo: Optional[estimator.VOData], gt_v: jnp.ndarray,
                        dtype=jnp.float32):
    """Run a sharded Monte-Carlo fleet and reduce summary statistics.

    Instances are sharded over the whole mesh; the per-instance velocity RMSE
    is reduced to fleet mean/max — XLA lowers the reductions to psum-style
    collectives. Returns (x_last (B,s), rmse (B,), stats dict).
    """
    shard = mesh_lib.instance_sharding(mesh)
    repl = mesh_lib.replicated(mesh)

    data_b = jax.device_put(data_b, shard)
    gt_v = jax.device_put(gt_v.astype(dtype), repl)

    if vo is not None:
        runner = make_batched_runner(params, dtype, with_vo=True)

        @partial(jax.jit, out_shardings=(shard, shard, repl, repl))
        def go(d, v):
            x, _ = runner(d, v)
            err = x[..., 3:6] - gt_v[None]
            skip = min(50, err.shape[1] // 2)
            rmse = jnp.sqrt(jnp.mean(err[:, skip:] ** 2, axis=(1, 2)))
            return x[:, -1], rmse, jnp.mean(rmse), jnp.max(rmse)

        x_last, rmse, mean_r, max_r = go(data_b, vo)
    else:
        runner = make_batched_runner(params, dtype, with_vo=False)

        @partial(jax.jit, out_shardings=(shard, shard, repl, repl))
        def go(d):
            x, _ = runner(d)
            err = x[..., 3:6] - gt_v[None]
            skip = min(50, err.shape[1] // 2)
            rmse = jnp.sqrt(jnp.mean(err[:, skip:] ** 2, axis=(1, 2)))
            return x[:, -1], rmse, jnp.mean(rmse), jnp.max(rmse)

        x_last, rmse, mean_r, max_r = go(data_b)
    return x_last, rmse, {"rmse_mean": mean_r, "rmse_max": max_r}


def sharded_fleet_runner(params: EstimatorParams, mesh, dtype=jnp.float32,
                         consts=None):
    """shard_map the fused fleet runner over the mesh (config 5).

    The instance axis is sharded over all mesh axes; each shard replays its
    local sub-fleet through one scan, and fleet statistics are psum-reduced. Returns f(data_tb, vo, gt_v) ->
    (x (T,B,s) sharded, rmse (B,) sharded, stats replicated).

    Pass ``consts`` with x_lb/x_ub for the constrained fleet. NOTE: (s,B)
    per-lane bounds must be sized to the PER-SHARD fleet (B/n_devices) —
    the consts are closed over inside the shard_map body.
    """
    c = consts if consts is not None else mhe.make_consts(params, dtype)
    axes = tuple(mesh.axis_names)
    batch_spec = P(None, axes)        # (T, B, ...) with B sharded
    repl = P()

    def body(data_tb, vo, gt_v):
        x, v_b = estimator.run_mhe(params, data_tb, vo=vo, dtype=dtype, consts=c)
        err = x[..., 3:6] - gt_v[:, None, :]
        skip = min(50, err.shape[0] // 2)  # warmup skip, adaptive to log length
        local_sq = jnp.sum(err[skip:] ** 2, axis=(0, 2))
        rmse = jnp.sqrt(local_sq / (err.shape[0] - skip) / 3.0)
        n_total = jax.lax.psum(jnp.asarray(rmse.shape[0], dtype), axes)
        fleet_mean = jax.lax.psum(jnp.sum(rmse), axes) / n_total
        fleet_max = jax.lax.pmax(jnp.max(rmse), axes)
        return x, rmse, fleet_mean, fleet_max

    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(
            estimator.TickData(*([batch_spec] * 7)),
            estimator.VOData(*([repl] * 4)),
            repl,
        ),
        out_specs=(batch_spec, P(axes), repl, repl),
        check_vma=False,
    )
    return jax.jit(fn)


def sharded_pipeline_runner(params: EstimatorParams, ekf_params, mesh,
                            dtype=jnp.float32, ekf_ring_len: int = 16,
                            per_lane_vo_q: bool = False, consts=None,
                            per_instance_vo: bool = False):
    """shard_map the full EKF+MHE pipeline fleet over the mesh — the
    production multi-device path (config 5): instances sharded over all mesh
    axes, per-shard lanes-layout pipeline scan, fleet statistics
    psum-reduced.

    Returns f(data_tb (T,B,...) B-sharded, eb EKFBlocks lanes (gyro/accel
    (T,S,3,B) B-sharded, metadata replicated), vo replicated, gt_v (T,3)
    replicated) -> (x (T,B,s) sharded, rmse (B,) sharded, fleet_mean,
    fleet_max replicated).

    Pass ``consts`` with x_lb/x_ub for the CONSTRAINED multi-device pipeline
    (MheSrb.cpp:272-349 per-tick solve, sharded). (s,B) per-lane bounds must
    be sized to the PER-SHARD fleet (B/n_devices).

    ``per_instance_vo=True`` shards a fully per-instance VO schedule (active
    (T,B), dp_body (T,3,B), ticks (T,B)) over the instance axis — each shard
    runs the per-instance lanes path on its own lanes' camera clocks.
    """
    c = consts if consts is not None else mhe.make_consts(params, dtype)
    axes = tuple(mesh.axis_names)
    data_spec = P(None, axes)          # (T, B, ...) with B sharded
    lanes_spec = P(None, None, None, axes)  # (T, S, 3, B) with B sharded
    repl = P()

    def body(data_tb, eb, vo, gt_v):
        data_l = tickdata_to_lanes(data_tb)
        x, v_b, _q = estimator.run_pipeline_lanes(
            params, ekf_params, data_l, eb, vo=vo, dtype=dtype, consts=c,
            ekf_ring_len=ekf_ring_len)
        err = x[..., 3:6] - gt_v[:, None, :]
        skip = min(50, err.shape[0] // 2)
        local_sq = jnp.sum(err[skip:] ** 2, axis=(0, 2))
        rmse = jnp.sqrt(local_sq / (err.shape[0] - skip) / 3.0)
        n_total = jax.lax.psum(jnp.asarray(rmse.shape[0], dtype), axes)
        fleet_mean = jax.lax.psum(jnp.sum(rmse), axes) / n_total
        fleet_max = jax.lax.pmax(jnp.max(rmse), axes)
        return x, rmse, fleet_mean, fleet_max

    # per-lane measured-VO quaternions ((T,S,4,B) Monte-Carlo vision draws)
    # shard over the instance axis like the other lanes tensors
    vo_q_spec = P(None, None, None, axes) if per_lane_vo_q else repl
    vo_specs = (estimator.VOData(P(None, axes), P(None, None, axes),
                                 P(None, axes), P(None, axes))
                if per_instance_vo else estimator.VOData(*([repl] * 4)))
    fn = jax.shard_map(
        body, mesh=mesh,
        in_specs=(
            estimator.TickData(*([data_spec] * 7)),
            estimator.EKFBlocks(lanes_spec, lanes_spec, repl, repl,
                                vo_q_spec, repl),
            vo_specs,
            repl,
        ),
        out_specs=(data_spec, P(axes), repl, repl),
        check_vma=False,
    )
    return jax.jit(fn)


def measure_scaling(params, data_tb, vo, gt_v, device_counts, dtype=jnp.float32,
                    reps=2):
    """Weak-scaling efficiency harness: fixed per-device fleet, growing mesh.

    Returns {n_devices: (wall_s, solves_per_s)}; efficiency at n = rate(n) /
    (n * rate(1)). On several devices this measures the collective and
    sharding overhead; on the virtual CPU mesh it validates the sharded
    program end-to-end.
    """
    import time

    T = data_tb.accel_b.shape[0]
    B_per = data_tb.accel_b.shape[1]
    results = {}
    for n in device_counts:
        mesh = mesh_lib.make_mesh(devices=jax.devices()[:n])
        B = B_per * n
        data_n = jax.tree.map(
            lambda a: jnp.concatenate([a] * n, axis=1), data_tb
        )
        runner = sharded_fleet_runner(params, mesh, dtype)
        shard = NamedSharding(mesh, P(None, tuple(mesh.axis_names)))
        data_n = jax.device_put(data_n, shard)
        jax.block_until_ready(runner(data_n, vo, gt_v))
        best = float("inf")
        for _ in range(reps):
            t0 = time.time()
            jax.block_until_ready(runner(data_n, vo, gt_v))
            best = min(best, time.time() - t0)
        results[n] = (best, B * (T - 1) / best)
    return results


def covariance_sweep(params_list, data: estimator.TickData, gt_v, mesh=None,
                     dtype=jnp.float32):
    """Config-grid covariance tuning sweep (BASELINE.json config 5): run the
    same log under each parameter set, return per-config RMSE and the argmin.

    Parameter sets differ only in noise std values (static shapes equal), so
    the sweep vmaps over stacked NoiseConsts rather than recompiling per
    config.
    """
    from decentralized_ekf_mhe_tpu.ops import assembly

    base = params_list[0]
    ncs = [assembly.make_noise_consts(p, dtype) for p in params_list]
    ncs_stacked = jax.tree.map(lambda *a: jnp.stack(a), *ncs)

    def run_with_nc(nc):
        c = mhe.make_consts(base, dtype)._replace(nc=nc)
        dd = jax.tree.map(lambda a: a.astype(dtype) if a.dtype.kind == "f" else a, data)
        d0 = jax.tree.map(lambda a: a[0], dd)
        st = mhe.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot,
                      d0.dq, d0.contact, dtype=dtype)

        def scan_step(st_, d):
            st_, (x_T, _) = mhe.step(
                c, st_, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
                d.contact, False, jnp.zeros(3, dtype), 0, 0, d.R_sb,
            )
            return st_, x_T

        _, x_seq = jax.lax.scan(scan_step, st, jax.tree.map(lambda a: a[1:], dd))
        err = x_seq[..., 3:6] - gt_v[1:].astype(dtype)
        skip = min(50, err.shape[0] // 2)  # warmup skip, adaptive to log length
        return jnp.sqrt(jnp.mean(err[skip:] ** 2))

    rmses = jax.jit(jax.vmap(run_with_nc))(ncs_stacked)
    return rmses, jnp.argmin(rmses)
