"""chip_smoke.py and tools/trace_fleet.py on the CPU: what can be checked
without a card (refusal, phase selection, output contract, parsing, trace
reduction), plus the card run itself behind the ``gpu`` marker."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace as NS

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from decentralized_ekf_mhe_tpu.utils import runtime  # noqa: E402


def _run_smoke(env, *args, timeout=1500):
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_refuses_to_run_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = _run_smoke(env, timeout=300)
    assert proc.returncode != 0
    assert "no GPU found" in proc.stderr
    assert not any(l.lstrip().startswith("{") for l in proc.stdout.splitlines())


def test_result_line_has_exactly_the_contract_keys():
    devs = [NS(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")] * 4
    out = json.loads(chip_smoke.result_line(devs))
    assert out == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert json.loads(chip_smoke.result_line(devs[:1]))["device"]["count"] == 1


def test_four_gpus_selects_only_the_sharded_phase():
    four = chip_smoke.select_phases(chip_smoke.parse_args(["--four-gpus"]))
    one = chip_smoke.select_phases(chip_smoke.parse_args([]))
    assert four == ("sharded",)
    assert "sharded" not in one
    assert one == ("go1_replay", "go1_fleet", "go1_box", "cassie_pogox",
                   "facade")
    assert set(one) | set(four) == set(chip_smoke.PHASES)


@pytest.mark.parametrize("line,expected", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3", "700.00 W")),
    ("NVIDIA H100, PCIe, 350.00 W", ("NVIDIA H100, PCIe", "350.00 W")),
    (" NVIDIA H200 ,[N/A]\n", ("NVIDIA H200", "[N/A]")),
    ("", None), ("no comma here", None), (", 700 W", None), ("H100,", None),
])
def test_nvidia_smi_line_parser(line, expected):
    if expected is None:
        with pytest.raises(ValueError):
            runtime.parse_gpu_query(line)
    else:
        assert runtime.parse_gpu_query(line) == expected


def test_trace_reduction_counts_kernels_and_idle_share():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import trace_fleet

    ev = lambda name, s, d: NS(name=name, start_ns=s, duration_ns=d)
    gpu = NS(name="/device:GPU:0", lines=[
        NS(name="XLA Ops", events=[ev("fusion", 0, 100)]),
        NS(name="Stream #13(Compute)", events=[
            ev("fusion_1", 0, 10), ev("fusion_2", 5, 10), ev("fusion_1", 40, 10)]),
        NS(name="Stream #14(MemcpyD2D)", events=[ev("copy", 60, 40)]),
    ])
    host = NS(name="/host:CPU", lines=[
        NS(name="python", events=[ev("call", 0, 1000)])])
    r = trace_fleet.reduce_trace([host, gpu], ticks=2)
    assert r["kernels"] == 4 and r["kernels_per_tick"] == 2.0
    assert r["window_ns"] == 100 and r["busy_ns"] == 15 + 10 + 40
    assert r["idle_share"] == pytest.approx(0.35)
    assert r["top"][0] == ("copy", 1, 40)
    assert ("fusion_1", 2, 20) in r["top"]
    with pytest.raises(ValueError):
        trace_fleet.reduce_trace([host], ticks=2)


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu_card):
    """The whole one-card smoke run; needs an NVIDIA card."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = _run_smoke(env)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert gpu_card in proc.stdout
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
