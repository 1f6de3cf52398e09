"""The reference-YAML reader (config.parse_yaml) against PyYAML on the
repository's configs, its scalar forms, and the reconstructed Go1 config
against the Go1 parameters the bench records."""

import glob
import os

import numpy as np
import pytest

from decentralized_ekf_mhe_tpu.config import (EKFParams, load_yaml_params,
                                              parse_yaml)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILES = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _numbers(obj):
    """PyYAML (YAML 1.1) reads ``1e-6`` as a string; rclcpp and parse_yaml
    read it as a number. Normalize such strings before comparing."""
    if isinstance(obj, dict):
        return {k: _numbers(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_numbers(v) for v in obj]
    if isinstance(obj, str):
        try:
            return float(obj)
        except ValueError:
            return obj
    return obj


@pytest.mark.parametrize("path", CONFIG_FILES,
                         ids=[os.path.basename(p) for p in CONFIG_FILES])
def test_reader_matches_pyyaml_on_configs(path):
    yaml = pytest.importorskip("yaml")
    with open(path) as f:
        text = f.read()
    ours = parse_yaml(text)
    assert _numbers(ours) == _numbers(yaml.safe_load(text))
    # numbers come back typed, not as strings
    osqp = ours["est_sub"]["ros__parameters"]["osqp"]
    assert isinstance(osqp["absTol"], float) and osqp["absTol"] == 1e-6


def test_reader_scalar_forms():
    yaml = pytest.importorskip("yaml")
    text = """
# comment line
top:
  int: 500
  neg: -3
  float: 0.0028
  exp: 1.5e-05
  t: true
  f: False
  s: "a # not a comment"
  s2: 'single'
  bare: hello world   # trailing comment
  empty:
  nested:
    lst: [1.0, -2, "x", true]
    none: ~
  inf: -.inf
last: [ ]
"""
    ours = parse_yaml(text)
    assert ours == yaml.safe_load(text)
    assert type(ours["top"]["int"]) is int
    assert ours["top"]["empty"] is None
    assert ours["last"] == []
    # where YAML 1.1 and rclcpp differ, the reader follows rclcpp
    assert parse_yaml("tol: 1e-6\n") == {"tol": 1e-6}


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n  - 2\n",          # block sequence
    "a: {b: 1}\n",                 # flow mapping
    "a: 1\n   b: 2\n",             # bad indentation
    "a 1\n",                       # not a mapping line
    "a: [1, 2\n",                  # unterminated list
])
def test_reader_rejects_unsupported_yaml(text):
    with pytest.raises(ValueError):
        parse_yaml(text)


def test_go1_config_holds_the_bench_parameters():
    import bench

    est, ekf = load_yaml_params(os.path.join(ROOT, "configs",
                                             "parameters_go1.yaml"))
    ref = bench._params()
    for f in ("num_legs", "leg_odom_type", "rate", "N", "p_process_std",
              "accel_input_std", "gyro_input_std", "accel_bias_std",
              "joint_position_std", "joint_velocity_std", "foot_slide_std",
              "foot_swing_std", "vo_p_std"):
        np.testing.assert_array_equal(getattr(est, f), getattr(ref, f),
                                      err_msg=f)
    assert est.dim_state == 9 and est.interval_ms == 5 and est.log_name == "go1"
    np.testing.assert_array_equal(est.p_ib, [0.01592, 0.06659, 0.00617])
    o = est.osqp
    assert (o.max_iter, o.adapt_rho, o.polish, o.time_limit) == (
        4000, True, False, 0.0028)
    assert o.abs_tol == o.relative_tol == o.prim_tol == o.dual_tol == 1e-6
    assert ekf == EKFParams() == bench._ekf_params()
