"""Cubic-Bezier VO interpolation carry — fixed-shape JAX port of C5.

The reference turns sparse ~30 Hz VO frames into per-tick equality-constraint
increments by fitting a cubic Bezier over the last 4 accumulated VO waypoints
and sampling it at the estimator rate (Bezier_simple.cpp:12-82, driven from
DecentralEst.cpp:915-933). Here the waypoint list is a fixed (...,4,3) buffer
and interpolation emits a fixed-length masked node array.

The carry broadcasts over instance batch axes. Waypoint *times* and the
*count* may be shared (shapes (4,) / scalar — one camera log driving the
whole fleet) or batched per instance (shapes (...,4) / (...,) — Monte-Carlo
fleets that perturb VO timing/content per instance); every function below
handles both layouts.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class BezierCarry(NamedTuple):
    pts: jnp.ndarray     # (...,4,3) control points, oldest..newest
    times: jnp.ndarray   # (4,) shared or (...,4) per-instance waypoint times
    count: jnp.ndarray   # int32 points ever added — scalar or (...,)
    p_accum: jnp.ndarray  # (...,3) accumulated world-frame VO path (p_vo_accmulate_)


def init(dtype=jnp.float32, batch=(), per_instance_schedule=False) -> BezierCarry:
    sched = tuple(batch) if per_instance_schedule else ()
    return BezierCarry(
        pts=jnp.zeros(tuple(batch) + (4, 3), dtype),
        times=jnp.zeros(sched + (4,), dtype),
        count=jnp.zeros(sched, jnp.int32) if sched else jnp.asarray(0, jnp.int32),
        p_accum=jnp.zeros(tuple(batch) + (3,), dtype),
    )


def add_way_point(c: BezierCarry, p: jnp.ndarray, t_end,
                  mask=None) -> BezierCarry:
    """Push (p, t); keep the last 4 (Bezier_simple.cpp:12-27).

    Mask-select writes (no scatter) so the op broadcasts over batch axes and
    lowers inside scan/vmap contexts alike. With batched times/count the
    push is per instance; ``mask`` (broadcastable to count's shape) keeps
    masked-out instances' carries untouched (their VO frame didn't arrive).
    """
    full = c.count >= 4
    row = jnp.arange(4)
    write = jnp.where(full, 3, jnp.clip(c.count, 0, 3))
    sel = row == write[..., None]                       # (...,4)
    base = jnp.where(full[..., None, None], jnp.roll(c.pts, -1, axis=-2), c.pts)
    pts = jnp.where(sel[..., None], p[..., None, :], base)
    base_t = jnp.where(full[..., None], jnp.roll(c.times, -1, axis=-1), c.times)
    t_val = jnp.asarray(t_end, c.times.dtype)
    t_val = t_val[..., None] if t_val.ndim else t_val
    times = jnp.where(sel, t_val, base_t)
    new = BezierCarry(pts=pts, times=times, count=c.count + 1,
                      p_accum=c.p_accum)
    if mask is None:
        return new
    m = jnp.asarray(mask, bool)

    def pick(a, b):
        mm = m.reshape(m.shape + (1,) * (a.ndim - m.ndim))
        return jnp.where(mm, a, b)

    return jax.tree.map(pick, new, c)


def _bezier(u, P0, P1, P2, P3):
    """Cubic blend (Bezier_simple.cpp:73-82); u (...,n) broadcasts over
    nodes, P* are (...,3) -> result (...,n,3)."""
    u = u[..., :, None]
    P0, P1, P2, P3 = (P[..., None, :] for P in (P0, P1, P2, P3))
    return (
        u**3 * (-P0 + 3 * P1 - 3 * P2 + P3)
        + u**2 * (3 * P0 - 6 * P1 + 3 * P2)
        + u * (-3 * P0 + 3 * P1)
        + P0
    )


def interpolate_increments(c: BezierCarry, t_start, num, dt, max_nodes: int):
    """Sample ``num`` nodes from t_start at spacing dt; returns per-node
    increments (diffs (...,max_nodes,3)), nodes, and a validity mask.

    ``t_start``/``num`` may be scalars (shared schedule) or (...,) batched to
    match batched carry times. diffs[0] = node_0 − 0 (node_pre seeded to
    zero, Bezier_simple.cpp:70) — the consumer skips it exactly as
    UpdateVOConstraints does (DecentralEst.cpp:993-999 uses _distances[i+1]).
    """
    t_interval = c.times[..., 3] - c.times[..., 0]
    u0 = (jnp.asarray(t_start, c.times.dtype) - c.times[..., 0]) / t_interval
    du = dt / t_interval
    i = jnp.arange(max_nodes, dtype=c.times.dtype)
    u = u0[..., None] + du[..., None] * i
    nodes = _bezier(
        u, c.pts[..., 0, :], c.pts[..., 1, :], c.pts[..., 2, :], c.pts[..., 3, :]
    )
    node_prev = jnp.concatenate(
        [jnp.zeros_like(nodes[..., :1, :]), nodes[..., :-1, :]], axis=-2
    )
    diffs = nodes - node_prev
    mask = i < jnp.asarray(num, c.times.dtype)[..., None]
    return diffs, nodes, mask


def eval_at(c: BezierCarry, u):
    """Evaluate the current cubic at parameter(s) ``u`` (...,n) -> (...,n,3)."""
    return _bezier(u, c.pts[..., 0, :], c.pts[..., 1, :], c.pts[..., 2, :],
                   c.pts[..., 3, :])
