"""Constrained-MHE solver-budget study: iteration budget / rho vs a
converged oracle, at float64 on CPU.

The reference's production cycle caps OSQP by wall clock
(timeLimit 2.8 ms, parameters_go1.yaml:50); our analog is a fixed
iteration budget. This script quantifies what a given (rho, iters,
adaptive, polish) budget costs in ESTIMATE quality relative to a
400-iteration converged solve, with everything at f64 so solver-budget
error is isolated from f32 rounding.

Run:  python tools/constrained_budget_study.py [--T 400]

Representative output (T=200, Go1 synth log, |v|<=0.3 box, 2026-08-21):
  oracle  adapt rho0=0.1 it=400 polish : velocity RMSE 0.03998 (reference)
  adapt   rho0=0.1 it=50  polish       : dev 1.1e-2  rmse_delta 3.7e-04
  fixed   rho=5000 it=20  polish       : dev 6.7e-2  rmse_delta 4.9e-03
  fixed   rho=5000 it=60  polish       : dev 4.4e-2  rmse_delta 2.9e-03
The adaptive 50-iteration budget is ~10x closer to the converged solution
than fixed rho=5000/it=20; both respect the box (polish pins the active
set). Pick per deployment accuracy needs.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--T", type=int, default=200)
    ap.add_argument("--vbound", type=float, default=0.3)
    a = ap.parse_args(argv)

    import jax

    from decentralized_ekf_mhe_tpu.utils.runtime import init_backend

    init_backend(cpu=True)
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.ops import estimator, mhe
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

    from bench import _params

    T = a.T
    log = synth.generate(synth.SynthConfig(T=T, seed=0))
    data = estimator.tickdata_from_log(log)
    vo = estimator.vodata_from_log(log)
    gt_v = log.gt_v_s
    s = _params().dim_state
    x_lb = np.full(s, -np.inf); x_lb[3:6] = -a.vbound
    x_ub = np.full(s, np.inf); x_ub[3:6] = a.vbound

    def run(rho, adapt, iters, polish):
        p = _params()
        p.osqp.abs_tol = 1e-9 if iters >= 400 else 1e-6
        p.osqp.relative_tol = p.osqp.abs_tol
        p.osqp.rho = rho
        p.osqp.adapt_rho = adapt
        p.osqp.polish = polish
        c = mhe.make_consts(p, jnp.float64, x_lb=x_lb, x_ub=x_ub,
                            admm_iters=iters)
        db = batch_lib.to_time_leading(batch_lib.perturb_log_batch(
            data, 2, jax.random.PRNGKey(0), p, noise_scale=0.0,
            dtype=jnp.float64))
        dl = batch_lib.tickdata_to_lanes(db)
        x, _ = estimator.run_mhe_lanes(p, dl, vo=vo, dtype=jnp.float64,
                                       consts=c)
        return np.asarray(x[:, 0])

    skip = T // 2
    x_or = run(0.1, True, 400, True)
    r_or = float(np.sqrt(((x_or[skip:, 3:6] - gt_v[skip:]) ** 2).mean()))
    print(f"oracle  adapt rho0=0.1 it=400 polish : velocity RMSE {r_or:.5f} "
          f"(reference)")
    for name, rho, adapt, iters in (
        ("adapt   rho0=0.1 it=50 ", 0.1, True, 50),
        ("fixed   rho=5000 it=20 ", 5000.0, False, 20),
        ("fixed   rho=5000 it=60 ", 5000.0, False, 60),
        ("fixed   rho=500  it=20 ", 500.0, False, 20),
    ):
        x = run(rho, adapt, iters, True)
        dev = float(np.abs(x - x_or).max())
        r = float(np.sqrt(((x[skip:, 3:6] - gt_v[skip:]) ** 2).mean()))
        vmax = float(np.abs(x[:, 3:6]).max())
        print(f"{name} polish : dev {dev:.1e}  rmse_delta {abs(r - r_or):.1e}"
              f"  max|v| {vmax:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
