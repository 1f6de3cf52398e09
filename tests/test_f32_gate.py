"""The float32 accuracy gate of the fleet pipeline: make_pipeline_fleet_runner
at float32 on noise-free lanes against the float64 composed oracle
(ekf_orientation_sequence -> run_mhe), for each robot configuration in
configs/. The velocity-RMSE delta must stay under 1e-3 (BASELINE.md); the
chip smoke test holds the card to the same gate at full fleet width."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import decentralized_ekf_mhe_tpu as dem
from decentralized_ekf_mhe_tpu.io import synth
from decentralized_ekf_mhe_tpu.ops import estimator
from decentralized_ekf_mhe_tpu.parallel import batch as batch_lib

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


@pytest.mark.parametrize("robot", ["go1", "cassie", "pogox"])
def test_pipeline_f32_matches_f64_oracle(robot):
    params, ekf_params = dem.load_yaml_params(
        os.path.join(CONFIGS, f"parameters_{robot}.yaml"))
    T, B, skip = 120, 2, 40
    log = synth.generate(synth.SynthConfig(T=T, seed=4,
                                           num_legs=params.num_legs))

    R64, _ = estimator.ekf_orientation_sequence(ekf_params, log,
                                                dtype=jnp.float64)
    x64, _ = estimator.run_mhe(
        params, estimator.tickdata_from_log(log, R_sb=np.asarray(R64)),
        vo=estimator.vodata_from_log(log), dtype=jnp.float64)
    x64 = np.asarray(x64)

    f32 = jnp.float32
    data = estimator.tickdata_from_log(log, dtype=f32)
    data_b = batch_lib.to_time_leading(batch_lib.perturb_log_batch(
        data, B, jax.random.PRNGKey(0), params, noise_scale=0.0, dtype=f32))
    eb = batch_lib.perturb_ekf_blocks(
        estimator.ekfblocks_from_log(log, dtype=f32), B,
        jax.random.PRNGKey(1), params, noise_scale=0.0, dtype=f32)
    x32, _, _ = jax.jit(batch_lib.make_pipeline_fleet_runner(
        params, ekf_params, f32, ekf_ring_len=64))(
        data_b, eb, estimator.vodata_from_log(log, dtype=f32))
    assert x32.dtype == f32
    x32 = np.asarray(x32, np.float64)
    assert np.isfinite(x32).all()

    def vrmse(x):
        return float(np.sqrt(((x[skip:, 3:6] - log.gt_v_s[skip:]) ** 2).mean()))

    r64 = vrmse(x64)
    for b in range(B):
        assert abs(vrmse(x32[:, b]) - r64) < 1e-3, (robot, vrmse(x32[:, b]), r64)
        # velocity dims stay pointwise close; absolute position may drift
        assert np.abs(x32[:, b, 3:6] - x64[:, 3:6]).max() < 5e-2
    assert r64 < 0.5
