"""Device mesh construction and canonical shardings.

The reference's parallelism is three OS processes on pinned cores
(go1_launch.py:18-63); the engine's scale axes are instead (SURVEY.md §2
parallelism table):

- ``data``:  Monte-Carlo / trajectory instances (the primary axis —
  BASELINE.json configs 4-5: 4096 per device),
- ``model``: scenario/config sub-axis for covariance-tuning sweeps (robots ×
  noise grids), also usable as a second instance shard.

Estimation state is tiny (KBs/instance), so instances are fully sharded and
nothing is replicated except scalar consts; cross-instance reductions
(sweep argmin, Monte-Carlo statistics) are psum collectives. The cards of
one host are joined all to all, so the mesh is the device list in order,
reshaped: no placement follows a physical topology.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(shape=None, devices=None) -> Mesh:
    """Create a (data, model) mesh over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)
    return Mesh(np.asarray(devices).reshape(shape), (DATA_AXIS, MODEL_AXIS))


def instance_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading instance axis over the whole mesh."""
    return NamedSharding(mesh, P((DATA_AXIS, MODEL_AXIS)))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
