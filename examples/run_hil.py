"""Hardware-in-the-loop streaming demo: the reference's realtime loop, closed.

The reference runs online: the 500 Hz orientation EKF (`orien_est`,
orien_ekf.cpp:77-105) publishes `imu/filter`, sensor callbacks mutate
`robot_store`, and a wall timer drives one MHE tick every 5 ms
(src/decentral_legged_est/src/EstSub.cpp:25,58-91). This driver is the
batched-engine analog of that FULL cycle for replayed or live-fed
data — the orientation EKF runs IN the loop (PipelineEstimator), consuming
raw gyro/accel substep blocks, not ground-truth orientation:

  stage block k+1 on the host  ║  device computes block k
  (native double-buffered      ║  (ONE jitted K-tick scan of EKF substeps +
   BlockFeeder, dem_native.cpp)║   MHE solve with a donated carry —
                               ║   facade.PipelineEstimator.update_block)

Aligned tick rows stream through the C++ `BlockFeeder`
(native/dem_native.cpp: dem_feeder_*), which alternates two staging buffers
so the block handed to the device stays valid while the next one is being
copied — the host-side analog of double-buffered DMA. Each block is ONE
device dispatch; with jax's async dispatch the host stages block k+1 while
the device crunches block k, so the sustained per-tick latency is the
device's, not the host's.

Run:  python examples/run_hil.py [--ticks 2000] [--block 20] [--no-native]
                                 [--cpu]

Prints the sustained per-tick latency series (p50/p99) of the FULL
EKF+MHE cycle against the reference's 5 ms budget, plus a tick-at-a-time
comparison showing what per-tick dispatch costs without blocking.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from decentralized_ekf_mhe_tpu import native
from decentralized_ekf_mhe_tpu.utils.runtime import init_backend
from decentralized_ekf_mhe_tpu.config import EKFParams, EstimatorParams
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import estimator
from decentralized_ekf_mhe_tpu.ops.facade import (
    DecentralizedEstimator, PipelineEstimator)


def pack_rows(log, eb) -> np.ndarray:
    """Flatten each tick's aligned FULL-cycle inputs into one f64 row.

    Layout per tick: ekf_gyro(S*3) ekf_accel(S*3) ekf_valid(S)
    ekf_vo_active(S) ekf_vo_q(S*4) ekf_vo_sb(S) | accel(3) omega(3)
    p_foot(L*3) J_foot(L*9) dq(L*3) contact(L) vo_active(1) vo_dp(3)
    vo_tick_pre(1) vo_tick_now(1).
    """
    T = log.accel_b.shape[0]
    f = np.float64
    parts = [
        np.asarray(eb.gyro, f).reshape(T, -1),
        np.asarray(eb.accel, f).reshape(T, -1),
        np.asarray(eb.valid, f).reshape(T, -1),
        np.asarray(eb.vo_active, f).reshape(T, -1),
        np.asarray(eb.vo_q, f).reshape(T, -1),
        np.asarray(eb.vo_steps_back, f).reshape(T, -1),
        log.accel_b.reshape(T, -1), log.omega_b.reshape(T, -1),
        log.p_foot.reshape(T, -1),
        log.J_foot.reshape(T, -1), log.dq.reshape(T, -1),
        log.contact.reshape(T, -1),
        np.asarray(log.vo_active, f).reshape(T, 1),
        log.vo_dp_body.reshape(T, -1),
        np.asarray(log.vo_tick_pre, f).reshape(T, 1),
        np.asarray(log.vo_tick_now, f).reshape(T, 1),
    ]
    return np.ascontiguousarray(np.concatenate(parts, axis=1))


def unpack_rows(rows: np.ndarray, L: int, S: int):
    """Inverse of pack_rows for a (K, width) block."""
    K = rows.shape[0]
    o = 0

    def take(n, shape):
        nonlocal o
        out = rows[:, o:o + n].reshape((K,) + shape)
        o += n
        return out

    ekf_gyro = take(3 * S, (S, 3))
    ekf_accel = take(3 * S, (S, 3))
    ekf_valid = take(S, (S,)).astype(bool)
    ekf_va = take(S, (S,)).astype(bool)
    ekf_vq = take(4 * S, (S, 4))
    ekf_sb = take(S, (S,)).astype(np.int64)
    accel = take(3, (3,))
    omega = take(3, (3,))
    p_foot = take(3 * L, (L, 3))
    J_foot = take(9 * L, (L, 3, 3))
    dq = take(3 * L, (L, 3))
    contact = take(L, (L,))
    vo_active = take(1, ()).astype(bool)
    vo_dp = take(3, (3,))
    vo_tick_pre = take(1, ()).astype(np.int64)
    vo_tick_now = take(1, ()).astype(np.int64)
    return dict(
        ekf_gyro=ekf_gyro, ekf_accel=ekf_accel, ekf_valid=ekf_valid,
        accel_b=accel, omega_b=omega, p_foot=p_foot, J_foot=J_foot, dq=dq,
        contact=contact, ekf_vo_active=ekf_va, ekf_vo_q=ekf_vq,
        ekf_vo_steps_back=ekf_sb, vo_active=vo_active, vo_dp=vo_dp,
        vo_tick_pre=vo_tick_pre, vo_tick_now=vo_tick_now)


class NumpyFeeder:
    """Pure-numpy fallback with the BlockFeeder interface."""

    def __init__(self, src: np.ndarray, block: int):
        self._src = src.reshape(src.shape[0], -1)
        self._block = block
        self._pos = 0

    def next(self):
        n = min(self._block, self._src.shape[0] - self._pos)
        if n <= 0:
            self._pos, n = 0, min(self._block, self._src.shape[0])
        out = np.zeros((self._block, self._src.shape[1]))
        out[:n] = self._src[self._pos:self._pos + n]
        self._pos += n
        return out, n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=2000)
    ap.add_argument("--block", type=int, default=20,
                    help="ticks per device dispatch (0.1 s at 200 Hz)")
    ap.add_argument("--no-native", action="store_true",
                    help="use the numpy feeder even if the C++ lib is built")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    init_backend(cpu=args.cpu)

    p = EstimatorParams(num_legs=4, leg_odom_type=0, rate=200, N=20,
                        foot_swing_std=[1e7] * 3)
    ekf_p = EKFParams()
    L = p.num_legs
    log = synth.generate(synth.SynthConfig(T=args.ticks, seed=0))
    eb = estimator.ekfblocks_from_log(log)
    S = int(np.asarray(eb.gyro).shape[1])
    rows = pack_rows(log, eb)

    use_native = native.available() and not args.no_native
    feeder_cls = "native BlockFeeder" if use_native else "numpy feeder"
    feeder = (native.BlockFeeder(rows[1:], args.block) if use_native
              else NumpyFeeder(rows[1:], args.block))
    print(f"streaming {args.ticks} FULL EKF+MHE cycles in blocks of "
          f"{args.block} via {feeder_cls} on {jax.devices()[0]}",
          file=sys.stderr)

    est = PipelineEstimator(p, ekf_p, dtype=jnp.float32)
    g0 = np.asarray(eb.gyro[0]); a0 = np.asarray(eb.accel[0])
    est.initialize(g0, a0, np.asarray(eb.valid[0]),
                   log.accel_b[0], log.omega_b[0], log.p_foot[0],
                   log.J_foot[0], log.dq[0], log.contact[0],
                   ekf_vo_active=np.asarray(eb.vo_active[0]),
                   ekf_vo_q=np.asarray(eb.vo_q[0]),
                   ekf_vo_steps_back=np.asarray(eb.vo_steps_back[0]))

    n_blocks = (args.ticks - 1) // args.block
    # warm the (K,S) jit before timing
    blk, n_valid = feeder.next()
    fields = unpack_rows(blk[:n_valid], L, S)
    x, v, q = est.update_block(**fields)
    jax.block_until_ready(x)

    lat = []
    done = 1 + n_valid
    for _ in range(1, n_blocks):
        t0 = time.time()
        # device computes the PREVIOUS dispatch while we stage this block
        blk, n_valid = feeder.next()
        fields = unpack_rows(blk[:n_valid], L, S)
        x, v, q = jax.block_until_ready(est.update_block(**fields))
        lat.append((time.time() - t0) / n_valid)
        done += n_valid
    lat_ms = np.asarray(lat) * 1e3
    print(f"sustained per-tick latency over {done} FULL cycles (EKF "
          f"substeps + MHE solve each): "
          f"p50 {np.percentile(lat_ms, 50):.3f} ms, "
          f"p99 {np.percentile(lat_ms, 99):.3f} ms "
          f"(reference cycle budget: 5 ms)", file=sys.stderr)

    # sanity: the streamed estimate tracks ground truth (spatial velocity)
    v_err = (np.asarray(x[-1][3:6])
             - log.gt_v_s[min(done - 1, args.ticks - 1)])
    print(f"final-tick velocity error vs GT: {np.abs(v_err).max():.4f} m/s",
          file=sys.stderr)

    # tick-at-a-time comparison: what per-tick dispatch costs (MHE facade)
    est2 = DecentralizedEstimator(p, dtype=jnp.float32)
    est2.initialize(log.R_sb_gt[0], log.accel_b[0], log.omega_b[0],
                    log.p_foot[0], log.J_foot[0], log.dq[0], log.contact[0])
    n1 = min(40, args.ticks - 1)
    est2.update(*[a[1] for a in (log.R_sb_gt, log.accel_b, log.omega_b,
                                 log.p_foot, log.J_foot, log.dq,
                                 log.contact)])
    jax.block_until_ready(est2.x)
    lat1 = []
    for k in range(2, n1):
        t0 = time.time()
        jax.block_until_ready(est2.update(
            log.R_sb_gt[k], log.accel_b[k], log.omega_b[k], log.p_foot[k],
            log.J_foot[k], log.dq[k], log.contact[k]))
        lat1.append(time.time() - t0)
    lat1_ms = np.asarray(lat1) * 1e3
    print(f"tick-at-a-time comparison (n={len(lat1)}): "
          f"p50 {np.percentile(lat1_ms, 50):.3f} ms/tick — blocking "
          f"amortizes dispatch {np.percentile(lat1_ms, 50) / max(np.percentile(lat_ms, 50), 1e-9):.0f}x",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
