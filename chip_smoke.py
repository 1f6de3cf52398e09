"""Chip smoke test: the estimator's main path once on an NVIDIA card, checked.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py              # one card: phases 1-6 below
    python chip_smoke.py --four-gpus  # four cards: the sharded pipeline only

Phases (one card):

1. device: JAX's default device must be a GPU, else exit non-zero.
2. go1_replay: examples/run_go1.main on configs/parameters_go1.yaml (MHE,
   500 ticks); velocity RMSE against ground truth below 0.1.
3. go1_fleet: parallel.batch.make_pipeline_fleet_runner at B=4096, T=500
   (BASELINE.json config 4); lanes 0-7 are noise-free and held to the
   float64 CPU oracle (bench._f64_oracle): velocity-RMSE delta below 1e-3.
4. go1_box: the same fleet under the velocity box |v| <= 0.3 through the
   lanes ADMM (50 iterations); the box must be respected and active.
5. cassie_pogox: the Cassie (s=15) and PogoX (L=1) pipelines at B=4096 from
   configs/; finite, velocity RMSE below 0.5.
6. facade: PipelineEstimator.update_block at K=20, B=1; per-tick p50/p99
   against the 5 ms budget.

``--four-gpus`` runs parallel.batch.sharded_pipeline_runner over four cards
at B=4096 per card, unconstrained and with the box, and compares it with
make_pipeline_fleet_runner on one card over the same instances.

Every phase prints its compile time, wall time and the card's name and
power limit. Any failure raises, so the script exits non-zero and does not
print the final line, which is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

B_FLEET = 4096      # instances per card (BASELINE.json config 4)
T_FLEET = 500       # ticks: 2.5 s of robot time
N_CLEAN = 8         # noise-free lanes held to the f64 oracle
VBOUND = 0.3        # |v| box; binds on the Go1 synth log
SKIP = 100          # RMSE warm-up skip (ticks)
GATE = 1e-3         # f32-vs-f64 velocity-RMSE gate (BASELINE.md)

ONE_CARD_PHASES = ("go1_replay", "go1_fleet", "go1_box", "cassie_pogox",
                   "facade")
FOUR_CARD_PHASES = ("sharded",)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded pipeline over four cards")
    return ap.parse_args(argv)


def select_phases(args) -> tuple:
    return FOUR_CARD_PHASES if args.four_gpus else ONE_CARD_PHASES


def result_line(devices) -> str:
    """The last line of a successful run."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def say(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def yaml_params(robot: str):
    import decentralized_ekf_mhe_tpu as dem

    return dem.load_yaml_params(
        os.path.join(ROOT, "configs", f"parameters_{robot}.yaml"))


def vrmse(x, gt_v, skip=SKIP):
    """Velocity RMSE of x (T,[B,]s) against gt_v (T,3), per instance."""
    import numpy as np

    x = np.asarray(x, np.float64)
    gt = gt_v[:, None] if x.ndim == 3 else gt_v
    return np.sqrt(((x[skip:, ..., 3:6] - gt[skip:]) ** 2).mean(axis=(0, -1)))


def make_fleet(log, params, ekf_params, B, n_clean, seed=0):
    """A B-instance pipeline fleet over one log: IMU/encoder noise and
    per-lane measured-VO quaternion draws at the configured stds, one shared
    camera clock. Lanes [:n_clean] are noise-free copies of the log."""
    import jax
    import jax.numpy as jnp

    from decentralized_ekf_mhe_tpu.ops import estimator
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

    dtype = jnp.float32
    data = estimator.tickdata_from_log(log, dtype=dtype)
    eb1 = estimator.ekfblocks_from_log(log, dtype=dtype)
    key = jax.random.PRNGKey(seed)
    data_b = batch_lib.to_time_leading(batch_lib.perturb_log_batch(
        data, B, key, params, dtype=dtype))
    eb = batch_lib.perturb_ekf_blocks(
        eb1, B, jax.random.fold_in(key, 1), params, dtype=dtype,
        vo_noise_scale=1.0, ekf_params=ekf_params)
    if n_clean:
        clean_d = jax.tree.map(
            lambda a: jnp.broadcast_to(a[:, None], (a.shape[0], n_clean)
                                       + a.shape[1:]), data)
        data_b = jax.tree.map(lambda a, c: a.at[:, :n_clean].set(c),
                              data_b, clean_d)
        lanes = lambda a: jnp.broadcast_to(a[..., None], a.shape + (n_clean,))
        eb = eb._replace(
            gyro=eb.gyro.at[..., :n_clean].set(lanes(eb1.gyro)),
            accel=eb.accel.at[..., :n_clean].set(lanes(eb1.accel)),
            vo_q=eb.vo_q.at[..., :n_clean].set(lanes(eb1.vo_q)))
    vo = estimator.vodata_from_log(log, dtype=dtype)
    return data_b, eb, vo


def box_consts(params, dtype):
    import numpy as np

    from decentralized_ekf_mhe_tpu.ops import mhe

    p = dataclasses.replace(params, osqp=dataclasses.replace(params.osqp))
    p.osqp.polish = True
    s = p.dim_state
    x_lb = np.full(s, -np.inf)
    x_ub = np.full(s, np.inf)
    x_lb[3:6], x_ub[3:6] = -VBOUND, VBOUND
    return mhe.make_consts(p, dtype, x_lb=x_lb, x_ub=x_ub, admm_iters=50)


def compile_and_time(fn, args, reps=3):
    """(compile_s, [wall_s per rep], output, compiled). Compilation is timed
    apart from the runs; each run ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))      # first run (warm-up)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        walls.append(time.perf_counter() - t0)
    return compile_s, walls, out, compiled


def memory_report(compiled, device) -> str:
    m = compiled.memory_analysis()
    stats = device.memory_stats() or {}
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    parts = [f"{f.replace('_size_in_bytes', '')}={getattr(m, f, None)}"
             for f in fields] if m is not None else ["memory_analysis=None"]
    parts.append(f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")
    return " ".join(parts)


# ---------------------------------------------------------------- phases

def phase_go1_replay(ctx, T=T_FLEET):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "run_go1", os.path.join(ROOT, "examples", "run_go1.py"))
    run_go1 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_go1)
    argv = ["--ticks", str(T), "--est-type", "0"] + ctx["cpu_flag"]
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        first = run_go1.main(argv + ["--log-dir", td])
        cold = time.perf_counter() - t0
        warm = run_go1.main(argv + ["--log-dir", td])
    say("go1_replay", f"T={T}: replay incl. compile {first['replay_s']:.3f}s "
        f"(whole first call {cold:.3f}s), warm replay {warm['replay_s']:.3f}s "
        f"-> {T / warm['replay_s']:,.1f} ticks/s; card {ctx['card']}")
    say("go1_replay", f"velocity RMSE vs GT {warm['rmse']:.5f} m/s (< 0.1)")
    assert first["rmse"] < 0.1 and warm["rmse"] < 0.1, (first, warm)


def phase_go1_fleet(ctx, B=B_FLEET, T=T_FLEET):
    import jax.numpy as jnp
    import numpy as np

    import bench
    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

    params, ekf_params = yaml_params("go1")
    log = synth.generate(synth.SynthConfig(T=T, seed=0))
    fleet = make_fleet(log, params, ekf_params, B, N_CLEAN)
    run = batch_lib.make_pipeline_fleet_runner(params, ekf_params,
                                               jnp.float32)
    c_s, walls, (x, v, q), compiled = compile_and_time(run, fleet)
    rate = B * (T - 1) / min(walls)
    say("go1_fleet", f"B={B} T={T}: compile {c_s:.3f}s, walls "
        f"{[round(w, 4) for w in walls]}s -> {rate:,.0f} ticks/s "
        f"(best); card {ctx['card']}")
    say("go1_fleet", "memory: " + memory_report(compiled, ctx["device"]))
    x = np.asarray(x, np.float64)
    assert x.shape == (T, B, params.dim_state) and np.isfinite(x).all()
    rm = vrmse(x, log.gt_v_s)
    say("go1_fleet", f"fleet velocity RMSE vs GT: mean {rm.mean():.5f} "
        f"max {rm.max():.5f} m/s")
    assert rm.max() < 0.1, rm.max()

    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        x64, gt_v = bench._f64_oracle(td, T_o=T, seed=0)
        oracle_s = time.perf_counter() - t0
    r64 = float(vrmse(x64, gt_v))
    r32 = vrmse(x[:, :N_CLEAN], gt_v)
    delta = float(np.abs(r32 - r64).max())
    dev = float(np.abs(x[:, :N_CLEAN] - x64[:, None]).max())
    say("go1_fleet", f"f32 gate ({N_CLEAN} noise-free lanes vs f64 CPU oracle, "
        f"oracle {oracle_s:.1f}s): RMSE f32 {r32.max():.6f} f64 {r64:.6f}, "
        f"delta {delta:.3e} (< {GATE}), max state dev {dev:.3e}")
    assert delta < GATE, delta
    ctx["go1"] = (params, ekf_params, log, fleet)


def phase_go1_box(ctx, B=B_FLEET, T=T_FLEET):
    import jax.numpy as jnp
    import numpy as np

    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

    if "go1" in ctx:
        params, ekf_params, log, fleet = ctx["go1"]
    else:
        params, ekf_params = yaml_params("go1")
        log = synth.generate(synth.SynthConfig(T=T, seed=0))
        fleet = make_fleet(log, params, ekf_params, B, N_CLEAN)
    c = box_consts(params, jnp.float32)
    run = batch_lib.make_pipeline_fleet_runner(params, ekf_params,
                                               jnp.float32, consts=c)
    c_s, walls, (x, _, _), compiled = compile_and_time(run, fleet)
    rate = B * (T - 1) / min(walls)
    say("go1_box", f"B={B} T={T} |v|<={VBOUND}, ADMM 50 it: compile "
        f"{c_s:.3f}s, walls {[round(w, 4) for w in walls]}s -> "
        f"{rate:,.0f} ticks/s (best); card {ctx['card']}")
    say("go1_box", "memory: " + memory_report(compiled, ctx["device"]))
    v = np.abs(np.asarray(x[..., 3:6], np.float64))
    assert np.isfinite(v).all()
    vmax = float(v.max())
    say("go1_box", f"max|v| {vmax:.5f}: respected (<= {VBOUND + 1e-3}) and "
        f"active (>= {VBOUND - 1e-2})")
    assert vmax <= VBOUND + 1e-3, vmax
    assert vmax >= VBOUND - 1e-2, vmax


def phase_cassie_pogox(ctx, B=B_FLEET, T=T_FLEET):
    import jax.numpy as jnp
    import numpy as np

    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

    for robot in ("cassie", "pogox"):
        params, ekf_params = yaml_params(robot)
        log = synth.generate(synth.SynthConfig(
            T=T, seed=2, num_legs=params.num_legs))
        fleet = make_fleet(log, params, ekf_params, B, 0, seed=2)
        run = batch_lib.make_pipeline_fleet_runner(params, ekf_params,
                                                   jnp.float32)
        c_s, walls, (x, _, _), _ = compile_and_time(run, fleet)
        rate = B * (T - 1) / min(walls)
        x = np.asarray(x, np.float64)
        assert x.shape == (T, B, params.dim_state) and np.isfinite(x).all()
        rm = float(vrmse(x, log.gt_v_s).mean())
        say("cassie_pogox", f"{robot} s={params.dim_state} L={params.num_legs}"
            f" B={B} T={T}: compile {c_s:.3f}s, walls "
            f"{[round(w, 4) for w in walls]}s -> {rate:,.0f} ticks/s (best), "
            f"velocity RMSE {rm:.5f} (< 0.5); card {ctx['card']}")
        assert rm < 0.5, (robot, rm)


def phase_facade(ctx, T=T_FLEET, K=20):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.ops import estimator
    from decentralized_ekf_mhe_tpu.ops.facade import PipelineEstimator

    params, ekf_params = yaml_params("go1")
    log = synth.generate(synth.SynthConfig(T=T, seed=0))
    eb = estimator.ekfblocks_from_log(log, dtype=jnp.float32)
    cols = dict(ekf_gyro=np.asarray(eb.gyro), ekf_accel=np.asarray(eb.accel),
                ekf_valid=np.asarray(eb.valid),
                ekf_vo_active=np.asarray(eb.vo_active),
                ekf_vo_q=np.asarray(eb.vo_q),
                ekf_vo_steps_back=np.asarray(eb.vo_steps_back),
                accel_b=log.accel_b, omega_b=log.omega_b, p_foot=log.p_foot,
                J_foot=log.J_foot, dq=log.dq, contact=log.contact,
                vo_active=log.vo_active, vo_dp=log.vo_dp_body,
                vo_tick_pre=log.vo_tick_pre, vo_tick_now=log.vo_tick_now)
    pe = PipelineEstimator(params, ekf_params, dtype=jnp.float32)
    init_keys = ("ekf_gyro", "ekf_accel", "ekf_valid", "accel_b", "omega_b",
                 "p_foot", "J_foot", "dq", "contact")
    pe.initialize(*(cols[k][0] for k in init_keys),
                  ekf_vo_active=cols["ekf_vo_active"][0],
                  ekf_vo_q=cols["ekf_vo_q"][0],
                  ekf_vo_steps_back=cols["ekf_vo_steps_back"][0])
    n_blocks = (T - 1) // K
    per_tick, xs = [], []
    for b in range(n_blocks):
        sl = slice(1 + b * K, 1 + (b + 1) * K)
        t0 = time.perf_counter()
        x, _, _ = jax.block_until_ready(
            pe.update_block(**{k: a[sl] for k, a in cols.items()}))
        dt = time.perf_counter() - t0
        if b == 0:
            first = dt
        else:
            per_tick.append(dt / K)
        xs.append(np.asarray(x, np.float64))
    ms = np.asarray(per_tick) * 1e3
    p50, p99 = float(np.percentile(ms, 50)), float(np.percentile(ms, 99))
    say("facade", f"K={K} B=1: first block incl. compile {first:.3f}s; "
        f"per-tick p50 {p50:.4f} ms p99 {p99:.4f} ms over {len(ms)} blocks "
        f"(5 ms budget); card {ctx['card']}")
    x = np.concatenate(xs)
    assert np.isfinite(x).all()
    rm = float(vrmse(x, log.gt_v_s[1:1 + len(x)]))
    say("facade", f"streamed velocity RMSE vs GT {rm:.5f} m/s")
    assert rm < 0.1, rm


def phase_sharded(ctx, B=B_FLEET, T=T_FLEET, n=4):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib
    from decentralized_ekf_mhe_tpu.parallel import mesh as mesh_lib

    devs = jax.devices()[:n]
    assert len(devs) == n, f"need {n} devices, have {len(jax.devices())}"
    mesh = mesh_lib.make_mesh(devices=devs)
    axes = tuple(mesh.axis_names)
    params, ekf_params = yaml_params("go1")
    log = synth.generate(synth.SynthConfig(T=T, seed=0))
    gt = log.gt_v_s
    data_b, eb, vo = make_fleet(log, params, ekf_params, n * B, N_CLEAN)
    gt_v = jnp.asarray(gt, jnp.float32)

    def chunk(i):
        sl = slice(i * B, (i + 1) * B)
        return (jax.tree.map(lambda a: a[:, sl], data_b),
                eb._replace(gyro=eb.gyro[..., sl], accel=eb.accel[..., sl],
                            vo_q=eb.vo_q[..., sl]), vo)

    shard_d = NamedSharding(mesh, P(None, axes))
    shard_l = NamedSharding(mesh, P(None, None, None, axes))
    data_s = jax.device_put(data_b, shard_d)
    eb_s = eb._replace(gyro=jax.device_put(eb.gyro, shard_l),
                       accel=jax.device_put(eb.accel, shard_l),
                       vo_q=jax.device_put(eb.vo_q, shard_l))

    for name, consts in (("unconstrained", None),
                         ("box", box_consts(params, jnp.float32))):
        # one card over the same instances, B at a time
        one = jax.jit(batch_lib.make_pipeline_fleet_runner(
            params, ekf_params, jnp.float32, consts=consts))
        t0 = time.perf_counter()
        jax.block_until_ready(one(*chunk(0)))
        c1 = time.perf_counter() - t0
        x_ref, w1 = [], []
        for i in range(n):
            args = chunk(i)
            t0 = time.perf_counter()
            xi = jax.block_until_ready(one(*args)[0])
            w1.append(time.perf_counter() - t0)
            x_ref.append(np.asarray(xi, np.float64))
        x_ref = np.concatenate(x_ref, axis=1)
        rate1 = B * (T - 1) / min(w1)

        run = batch_lib.sharded_pipeline_runner(
            params, ekf_params, mesh, jnp.float32, consts=consts,
            per_lane_vo_q=True)
        t0 = time.perf_counter()
        out = jax.block_until_ready(run(data_s, eb_s, vo, gt_v))
        c4 = time.perf_counter() - t0
        w4 = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = jax.block_until_ready(run(data_s, eb_s, vo, gt_v))
            w4.append(time.perf_counter() - t0)
        rate4 = n * B * (T - 1) / min(w4)
        x4 = out[0]
        shard_devs = {s.device for s in x4.addressable_shards}
        assert len(x4.addressable_shards) == n and shard_devs == set(devs), (
            x4.sharding, shard_devs)
        x4 = np.asarray(x4, np.float64)
        assert np.isfinite(x4).all()
        d_rmse = float(np.abs(vrmse(x4, gt) - vrmse(x_ref, gt)).max())
        dev = float(np.abs(x4 - x_ref).max())
        say("sharded", f"{name}: {n} cards x B={B} T={T}: compile {c4:.3f}s, "
            f"walls {[round(w, 4) for w in w4]}s -> {rate4:,.0f} ticks/s; "
            f"one card: compile {c1:.3f}s, walls {[round(w, 4) for w in w1]}s "
            f"-> {rate1:,.0f} ticks/s; weak-scaling efficiency "
            f"{rate4 / (n * rate1):.3f}; card {ctx['card']}")
        say("sharded", f"{name}: one shard per device on {sorted(str(d) for d in shard_devs)}; "
            f"per-instance velocity-RMSE delta vs one card max {d_rmse:.3e} "
            f"(< {GATE}), max state dev {dev:.3e}")
        assert d_rmse < GATE, d_rmse
        if consts is not None:
            vmax = float(np.abs(x4[..., 3:6]).max())
            say("sharded", f"{name}: max|v| {vmax:.5f} (bound {VBOUND})")
            assert vmax <= VBOUND + 1e-3, vmax


PHASES = {
    "go1_replay": phase_go1_replay, "go1_fleet": phase_go1_fleet,
    "go1_box": phase_go1_box, "cassie_pogox": phase_cassie_pogox,
    "facade": phase_facade, "sharded": phase_sharded,
}


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    from decentralized_ekf_mhe_tpu.utils import runtime

    cache_dir = runtime.compile_cache_dir()
    cache_warm = os.path.isdir(cache_dir) and bool(os.listdir(cache_dir))
    devices = runtime.init_backend()          # SystemExit without a GPU
    import jax

    line = runtime.gpu_query()
    name, limit = runtime.parse_gpu_query(line)
    d = devices[0]
    print(f"[device] {d.platform} {d.device_kind} x{len(devices)}; "
          f"jax {jax.__version__}; compile cache {cache_dir} "
          f"({'warm' if cache_warm else 'cold'})", flush=True)
    print(line, flush=True)
    ctx = {"card": f"{name} at {limit}", "device": d, "cpu_flag": []}
    for name in select_phases(args):
        t0 = time.perf_counter()
        PHASES[name](ctx)
        say(name, f"phase done in {time.perf_counter() - t0:.1f}s")
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
