"""Compare fused standard-layout vs lanes-layout fleet runners on the GPU.

Run from repo root: python tools/bench_lanes.py [B ...]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from decentralized_ekf_mhe_tpu.utils.runtime import init_backend  # noqa: E402


def main():
    devices = init_backend()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from decentralized_ekf_mhe_tpu.config import EstimatorParams
    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.ops import estimator
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

    print(f"device: {devices[0].device_kind} x{len(devices)}")
    dtype = jnp.float32
    params = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=20)
    T = 200
    log = synth.generate(synth.SynthConfig(T=T, seed=0))
    data = estimator.tickdata_from_log(log, dtype=dtype)
    vo = estimator.vodata_from_log(log, dtype=dtype)
    key = jax.random.PRNGKey(0)

    Bs = [int(a) for a in sys.argv[1:]] or [4096]
    for B in Bs:
        data_b = batch_lib.to_time_leading(
            batch_lib.perturb_log_batch(data, B, key, dtype=dtype))
        for name, maker in [
            ("lanes", batch_lib.make_lanes_fleet_runner),
            ("std  ", batch_lib.make_fused_batched_runner),
        ]:
            runner = jax.jit(maker(params, dtype))
            t0 = time.time()
            x, v = jax.block_until_ready(runner(data_b, vo))
            tc = time.time() - t0
            walls = []
            for rep in range(3):
                db = data_b._replace(accel_b=data_b.accel_b + (rep + 1) * 1e-7)
                t0 = time.time()
                x, v = jax.block_until_ready(runner(db, vo))
                walls.append(time.time() - t0)
            wall = min(walls)
            rate = B * (T - 1) / wall
            v_est = np.asarray(x[..., 3:6], np.float64)
            rmse = float(np.sqrt(((v_est[100:] - log.gt_v_s[100:, None]) ** 2).mean()))
            print(f"{name} B={B:6d} compile={tc:5.1f}s wall={wall:.3f}s "
                  f"rate={rate/1e3:9.1f}k/s rmse={rmse:.4f}")


if __name__ == "__main__":
    main()
