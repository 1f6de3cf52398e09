"""Profile one run of the Go1 pipeline fleet on the GPU and reduce the trace.

Compiles parallel.batch.make_pipeline_fleet_runner at the chip_smoke.py fleet
shape (Go1, B=4096, T=500), runs it once untraced, then once inside
``jax.profiler.trace`` and reports, from the device planes of the trace:

- kernels per tick: device kernel events in the traced run / T;
- device idle share: 1 - (union of kernel intervals) / (first kernel start
  to last kernel end);
- the kernels that take the most device time.

Run from the repo root:  python tools/trace_fleet.py [--out DIR] [--B 4096]
                                                     [--T 500]
The raw trace (``*.xplane.pb``) stays under DIR for offline reduction.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# lines of a GPU plane that summarize kernels already listed per stream
SUMMARY_LINES = ("XLA Modules", "XLA Ops", "Steps", "Source", "TensorFlow Ops")


def kernel_lines(plane):
    """The lines of a device plane that carry one event per kernel."""
    lines = list(plane.lines)
    streams = [ln for ln in lines if "Stream" in ln.name]
    return streams or [ln for ln in lines if ln.name not in SUMMARY_LINES]


def reduce_trace(planes, ticks: int) -> dict:
    """Kernel count, busy/idle time and top kernels of the device planes."""
    events = []
    for plane in planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for ln in kernel_lines(plane):
            events += [(e.start_ns, e.start_ns + e.duration_ns, e.name)
                       for e in ln.events]
    if not events:
        raise ValueError("no device kernel events in the trace")
    events.sort()
    busy, cur_s, cur_e = 0.0, events[0][0], events[0][1]
    for s, e, _ in events[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e, _ in events) - events[0][0]
    per_name = collections.defaultdict(lambda: [0, 0.0])
    for s, e, name in events:
        per_name[name][0] += 1
        per_name[name][1] += e - s
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])
    return {
        "kernels": len(events), "kernels_per_tick": len(events) / ticks,
        "window_ns": window, "busy_ns": busy,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "top": [(n, c, t) for n, (c, t) in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "traces",
                                                  "trace_fleet"))
    ap.add_argument("--B", type=int, default=4096)
    ap.add_argument("--T", type=int, default=500)
    args = ap.parse_args(argv)

    from decentralized_ekf_mhe_tpu.utils import runtime

    devices = runtime.init_backend()
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

    card = runtime.gpu_query()
    params, ekf_params = chip_smoke.yaml_params("go1")
    log = synth.generate(synth.SynthConfig(T=args.T, seed=0))
    fleet = chip_smoke.make_fleet(log, params, ekf_params, args.B,
                                  chip_smoke.N_CLEAN)
    run = jax.jit(batch_lib.make_pipeline_fleet_runner(
        params, ekf_params, jnp.float32))
    t0 = time.perf_counter()
    jax.block_until_ready(run(*fleet))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    jax.block_until_ready(run(*fleet))
    wall = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*fleet))
        traced = time.perf_counter() - t0
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    r = reduce_trace(jax.profiler.ProfileData.from_file(path).planes, args.T)
    print(f"{devices[0].device_kind}; {card}; B={args.B} T={args.T}: first "
          f"call {first:.3f}s, untraced wall {wall:.4f}s, traced wall "
          f"{traced:.4f}s")
    print(f"device kernels {r['kernels']} ({r['kernels_per_tick']:.1f} per "
          f"tick); kernel window {r['window_ns'] / 1e6:.3f} ms, busy "
          f"{r['busy_ns'] / 1e6:.3f} ms, idle share {r['idle_share']:.4f}")
    total = sum(t for _, _, t in r["top"])
    for name, count, t in r["top"][:15]:
        print(f"  {t / 1e6:9.3f} ms {100 * t / total:5.1f}%  x{count:<6d} "
              f"{name[:100]}")
    print(f"trace: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
