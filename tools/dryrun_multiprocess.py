"""Multi-process distributed dry run — the closest DCN-codepath proxy here.

The single-process virtual mesh (``__graft_entry__.dryrun_multichip``)
validates sharded-program *semantics* but never exercises the multi-host
initialization or cross-process collective codepath a real pod uses
(jax.distributed + DCN). This driver launches N OS processes on localhost,
each owning its own XLA CPU client with M local virtual devices,
``jax.distributed.initialize``s them into one runtime, builds a
process-spanning (N*M)-device mesh, assembles the fleet as a GLOBAL jax.Array
from per-process local shards (``jax.make_array_from_process_local_data``),
and runs the production ``sharded_fleet_runner`` — asserting the
psum-reduced fleet statistics match a single-process oracle computed
independently in each worker.

This is the genuine multi-process collective path (cross-process gloo/XLA
CPU collectives standing in for the network between hosts); the runner under
test is the one multi-host deployments call.

Run:  python tools/dryrun_multiprocess.py [--procs 2] [--devs-per-proc 2]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def worker(pid: int, nprocs: int, devs: int, port: int) -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devs}")
    os.environ.pop("JAX_PLATFORM_NAME", None)
    import jax

    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # older/newer flag name; the default may already be gloo
    jax.distributed.initialize(f"localhost:{port}", num_processes=nprocs,
                               process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from decentralized_ekf_mhe_tpu.config import EstimatorParams
    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.ops import estimator
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

    n_dev = nprocs * devs
    assert len(jax.devices()) == n_dev, (len(jax.devices()), n_dev)
    assert jax.process_count() == nprocs

    dtype = jnp.float32
    T = 8
    params = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=4)
    log = synth.generate(synth.SynthConfig(T=T, seed=0))
    data = estimator.tickdata_from_log(log, dtype=dtype)
    vo = estimator.vodata_from_log(log, dtype=dtype)
    gt_v = jnp.asarray(log.gt_v_s, dtype)
    B = 2 * n_dev
    data_b = batch_lib.to_time_leading(
        batch_lib.perturb_log_batch(data, B, jax.random.PRNGKey(0), params,
                                    dtype=dtype))

    mesh = Mesh(np.array(jax.devices()).reshape(n_dev, 1), ("data", "model"))
    shard = NamedSharding(mesh, P(None, ("data", "model")))

    # every process holds the (deterministic) full fleet; hand each its own
    # instance slice as the local shard of ONE global array
    per = B // nprocs
    lo = pid * per

    def to_global(a):
        local = a[:, lo:lo + per]
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(None, ("data", "model"))), np.asarray(local))

    data_g = jax.tree.map(to_global, data_b)
    runner = batch_lib.sharded_fleet_runner(params, mesh, dtype)
    x, rmse, fleet_mean, fleet_max = runner(data_g, vo, gt_v)
    jax.block_until_ready((fleet_mean, fleet_max))
    fm, fx = float(fleet_mean), float(fleet_max)

    # single-process oracle, computed independently in this worker
    x_ref, _ = jax.jit(batch_lib.make_fused_batched_runner(
        params, dtype))(data_b, vo)
    err = np.asarray(x_ref[..., 3:6], np.float64) - np.asarray(
        gt_v, np.float64)[:, None, :]
    skip = min(50, err.shape[0] // 2)
    rmse_ref = np.sqrt((err[skip:] ** 2).sum(axis=(0, 2))
                       / (err.shape[0] - skip) / 3.0)
    ok = (abs(fm - rmse_ref.mean()) < 1e-4
          and abs(fx - rmse_ref.max()) < 1e-4)
    if pid == 0:
        print(f"dryrun_multiprocess OK: {nprocs} processes x {devs} devices "
              f"= {n_dev}-device mesh, B={B}; cross-process psum fleet "
              f"stats mean={fm:.5f} max={fx:.5f} match the single-process "
              f"oracle ({rmse_ref.mean():.5f}/{rmse_ref.max():.5f}): {ok}")
    assert ok, (fm, rmse_ref.mean(), fx, rmse_ref.max())
    jax.distributed.shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devs-per-proc", type=int, default=2)
    ap.add_argument("--port", type=int, default=51733)
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.worker is not None:
        return worker(args.worker, args.procs, args.devs_per_proc, args.port)

    procs = []
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    for pid in range(args.procs):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--procs", str(args.procs),
             "--devs-per-proc", str(args.devs_per_proc),
             "--port", str(args.port), "--worker", str(pid)],
            env=env,
            stdout=None if pid == 0 else subprocess.DEVNULL,
            stderr=subprocess.STDOUT if pid == 0 else subprocess.DEVNULL,
        ))
    rc = 0
    for p in procs:
        rc |= p.wait(timeout=600)
    return rc


if __name__ == "__main__":
    sys.exit(main())
