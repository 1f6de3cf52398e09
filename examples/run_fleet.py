"""Monte-Carlo fleet driver — the scale-out entry point (BASELINE.json
configs 4-5).

Replays a B-instance perturbed fleet through the full EKF(500 Hz)→MHE(200 Hz)
pipeline in one jitted lanes-layout scan, prints fleet velocity-RMSE
statistics, and optionally:

- shards the fleet over a device mesh (``--mesh``; on CPU set
  XLA_FLAGS=--xla_force_host_platform_device_count=8 to simulate 8 devices),
  reducing statistics with psum collectives;
- runs a covariance tuning sweep (``--sweep``) over process-noise scalings,
  reporting the argmin config — the reference's hand-tuning loop
  (parameters_go1.yaml noise groups) as one vmapped program;
- runs a CONSTRAINT-BOUND tuning sweep (``--bound-sweep``): every fleet lane
  solves the box-constrained MHE under its OWN velocity bound ((s,B)
  per-lane bounds through the lanes ADMM, one compiled program), reporting
  RMSE-vs-bound — the per-run YAML bound construction
  of DecentralEst.cpp:222-348 lifted to a Monte-Carlo axis.

Usage:
    python examples/run_fleet.py [--instances 256] [--ticks 400] [--mesh]
                                 [--sweep] [--bound-sweep] [--cpu]
                                 [--yaml PATH]
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--yaml",
                    default=os.path.join(ROOT, "configs", "parameters_go1.yaml"))
    ap.add_argument("--instances", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", action="store_true",
                    help="shard the fleet over all visible devices")
    ap.add_argument("--sweep", action="store_true",
                    help="run a 5-point process-noise tuning sweep")
    ap.add_argument("--bound-sweep", action="store_true",
                    help="sweep the velocity-box bound across fleet lanes "
                         "(constrained MHE, per-lane bounds)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from decentralized_ekf_mhe_tpu.utils.runtime import init_backend

    init_backend(cpu=args.cpu)
    import jax
    import jax.numpy as jnp
    import numpy as np

    import decentralized_ekf_mhe_tpu as dem
    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.ops import estimator
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib
    from decentralized_ekf_mhe_tpu.parallel import mesh as mesh_lib

    est_params, ekf_params = dem.load_yaml_params(args.yaml)
    dtype = jnp.float32
    T, B = args.ticks, args.instances

    log = synth.generate(synth.SynthConfig(T=T, rate=est_params.rate,
                                           seed=args.seed))
    data = estimator.tickdata_from_log(log, dtype=dtype)
    vo = estimator.vodata_from_log(log, dtype=dtype)
    key = jax.random.PRNGKey(args.seed)
    data_b = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, B, key, est_params, dtype=dtype))
    eb = batch_lib.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=dtype), B,
        jax.random.PRNGKey(args.seed + 1), est_params, dtype=dtype)
    gt_v = jnp.asarray(log.gt_v_s, dtype)

    if args.mesh:
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = mesh_lib.make_mesh()
        axes = tuple(mesh.axis_names)
        data_b = jax.device_put(data_b, NamedSharding(mesh, P(None, axes)))
        eb = eb._replace(
            gyro=jax.device_put(
                eb.gyro, NamedSharding(mesh, P(None, None, None, axes))),
            accel=jax.device_put(
                eb.accel, NamedSharding(mesh, P(None, None, None, axes))))
        runner = batch_lib.sharded_pipeline_runner(
            est_params, ekf_params, mesh, dtype)
        t0 = time.time()
        x, rmse, mean_r, max_r = runner(data_b, eb, vo, gt_v)
        jax.block_until_ready(x)
        wall = time.time() - t0
        print(f"mesh {dict(mesh.shape)}: B={B} T={T} wall={wall:.2f}s "
              f"(incl. compile)")
        print(f"fleet velocity RMSE: mean={float(mean_r):.4f} "
              f"max={float(max_r):.4f} m/s over {B} instances")
    else:
        runner = jax.jit(batch_lib.make_pipeline_fleet_runner(
            est_params, ekf_params, dtype))
        t0 = time.time()
        x, v, q = runner(data_b, eb, vo)
        jax.block_until_ready(x)
        wall = time.time() - t0
        err = np.asarray(x)[T // 2:, :, 3:6] - log.gt_v_s[T // 2:, None]
        rmse = np.sqrt((err ** 2).mean(axis=(0, 2)))
        print(f"B={B} T={T} wall={wall:.2f}s (incl. compile) -> "
              f"{B * (T - 1) / wall:,.0f} ticks/s amortized")
        print(f"fleet velocity RMSE: mean={rmse.mean():.4f} "
              f"max={rmse.max():.4f} min={rmse.min():.4f} m/s")

    if args.sweep:
        import dataclasses

        scales = [0.25, 0.5, 1.0, 2.0, 4.0]
        plist = []
        for s in scales:
            p = dataclasses.replace(est_params)
            p.accel_input_std = [v * s for v in est_params.accel_input_std]
            p.p_process_std = [v * s for v in est_params.p_process_std]
            plist.append(p)
        rmses, best = batch_lib.covariance_sweep(
            plist, data, jnp.asarray(log.gt_v_s), dtype=dtype)
        for s, r in zip(scales, np.asarray(rmses)):
            print(f"  process-noise x{s:<4}: RMSE {float(r):.4f} m/s")
        print(f"sweep argmin: x{scales[int(best)]}")

    if args.bound_sweep:
        from decentralized_ekf_mhe_tpu.ops import mhe

        s_dim = est_params.dim_state
        bnds = np.linspace(0.1, 0.5, B)
        lb_B = np.full((s_dim, B), -np.inf)
        ub_B = np.full((s_dim, B), np.inf)
        lb_B[3:6] = -bnds
        ub_B[3:6] = bnds
        p_c = dataclasses_replace_params(est_params)
        c_sw = mhe.make_consts(p_c, dtype, x_lb=lb_B, x_ub=ub_B,
                               admm_iters=20)
        sw = jax.jit(batch_lib.make_lanes_fleet_runner(p_c, dtype,
                                                       consts=c_sw))
        t0 = time.time()
        x_sw, _ = sw(data_b, vo)
        jax.block_until_ready(x_sw)
        wall = time.time() - t0
        v_sw = np.abs(np.asarray(x_sw)[..., 3:6])
        per_lane_max = v_sw.max(axis=(0, 2))
        err = np.asarray(x_sw)[T // 2:, :, 3:6] - log.gt_v_s[T // 2:, None]
        rmse_l = np.sqrt((err ** 2).mean(axis=(0, 2)))
        ok = bool((per_lane_max <= bnds + 1e-3).all())
        print(f"bound sweep: |v| box {bnds[0]:.2f}->{bnds[-1]:.2f} across "
              f"{B} lanes in ONE program, wall={wall:.2f}s (incl. compile); "
              f"every lane within its own box: {ok}")
        for q in (0, B // 4, B // 2, 3 * B // 4, B - 1):
            print(f"  bound {bnds[q]:.3f}: max|v| {per_lane_max[q]:.3f}, "
                  f"RMSE {rmse_l[q]:.4f} m/s")
    return 0


def dataclasses_replace_params(p):
    import dataclasses

    q = dataclasses.replace(p)
    q.osqp = dataclasses.replace(p.osqp)   # don't mutate the caller's osqp
    q.osqp.abs_tol = 1e-6
    q.osqp.relative_tol = 1e-6
    q.osqp.rho = 5000.0
    q.osqp.adapt_rho = False
    q.osqp.polish = True
    return q


if __name__ == "__main__":
    sys.exit(main())
