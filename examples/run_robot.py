"""Multi-robot pipeline driver: Go1 / Cassie / PogoX (BASELINE configs 1-3).

Like examples/run_go1.py but covering all three demonstrated robots
(README.md:5), with optional state constraints (PogoX high-dynamic-range
velocity bounds via the ADMM path).

Usage:
    python examples/run_robot.py --robot {go1,cassie,pogox} [--ticks N]
                                 [--v-limit V] [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = {
    "go1": os.path.join(ROOT, "configs", "parameters_go1.yaml"),
    "cassie": os.path.join(ROOT, "configs", "parameters_cassie.yaml"),
    "pogox": os.path.join(ROOT, "configs", "parameters_pogox.yaml"),
}
GAITS = {
    "go1": dict(num_legs=4, gait_hz=2.5, duty=0.6),
    "cassie": dict(num_legs=2, gait_hz=1.6, duty=0.55),
    "pogox": dict(num_legs=1, gait_hz=1.8, duty=0.45),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robot", choices=sorted(YAMLS), default="go1")
    ap.add_argument("--ticks", type=int, default=600)
    ap.add_argument("--v-limit", type=float, default=None,
                    help="symmetric velocity box constraint (m/s) -> ADMM path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    from decentralized_ekf_mhe_tpu.utils.runtime import init_backend

    init_backend(cpu=args.cpu)
    import jax
    import jax.numpy as jnp
    import numpy as np

    import decentralized_ekf_mhe_tpu as dem
    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.ops import estimator, mhe

    est_params, ekf_params = dem.load_yaml_params(YAMLS[args.robot])
    g = GAITS[args.robot]
    print(f"{args.robot}: dims s/m={est_params.dim_state}/{est_params.dim_meas} "
          f"leg_odom_type={est_params.leg_odom_type} N={est_params.N}")

    log = synth.generate(synth.SynthConfig(
        T=args.ticks, rate=est_params.rate, seed=args.seed, **g))
    dtype = jnp.float32
    data = estimator.tickdata_from_log(log, dtype=dtype)
    vo = estimator.vodata_from_log(log, dtype=dtype)

    consts = None
    if args.v_limit is not None:
        s = est_params.dim_state
        lb = np.full(s, -np.inf)
        ub = np.full(s, np.inf)
        lb[3:6], ub[3:6] = -args.v_limit, args.v_limit
        consts = mhe.make_consts(est_params, dtype, x_lb=lb, x_ub=ub,
                                 admm_iters=300)
        print(f"state constraints: |v| <= {args.v_limit} m/s (ADMM path)")

    x, v_b = jax.jit(
        lambda d, v: estimator.run_mhe(est_params, d, vo=v, dtype=dtype,
                                       consts=consts)
    )(data, vo)
    x = np.asarray(x)
    T = x.shape[0]
    skip = min(100, T // 2)
    rmse = float(np.sqrt(((x[skip:, 3:6] - log.gt_v_s[skip:T]) ** 2).mean()))
    print(f"velocity RMSE vs GT: {rmse:.4f} m/s over {T} ticks")
    if args.v_limit is not None:
        print(f"max |v| estimate: {np.abs(x[:, 3:6]).max():.3f} "
              f"(bound {args.v_limit})")
    assert np.isfinite(x).all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
