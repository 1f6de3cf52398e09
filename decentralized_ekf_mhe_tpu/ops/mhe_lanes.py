"""MHE window engine in instance-on-lanes layout — the fleet hot path.

Identical semantics to ops/mhe.py (same reference anchors: MheSrb.cpp window
registries/marginalization, DecentralEst.cpp formulation; equivalence is
asserted at float64 in tests/test_mhe_lanes.py) but every window tensor keeps
the instance batch B on the trailing (lane) axis (see ops/lanes.py), with no
layout transposes anywhere on the tick path. This is what the fleet runners
(parallel/batch.make_pipeline_fleet_runner, make_lanes_fleet_runner) scan.

Restrictions vs ops/mhe.py: exactly one instance axis. The VO schedule is
shared across the fleet (step) or per instance (step_per_instance_vo).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from decentralized_ekf_mhe_tpu.ops import assembly_lanes, bezier, lanes
from decentralized_ekf_mhe_tpu.ops.mhe import MHEConsts, _params_view
from decentralized_ekf_mhe_tpu.utils.precision import full_precision


class MHEStateL(NamedTuple):
    """Lanes-layout twin of mhe.MHEState (see its field docs)."""

    y_meas: jnp.ndarray      # (N,m,B)
    Q_meas: jnp.ndarray      # (N,m,m,B)
    A_dyn: jnp.ndarray       # (N,s,s,B)
    b_dyn: jnp.ndarray       # (N,s,B)
    Q_dyn: jnp.ndarray       # (N,s,s,B)
    b_cam: jnp.ndarray       # (N,3,B)
    Q_cam: jnp.ndarray       # (N,3,3,B)
    cam_active: jnp.ndarray  # (N,B) bool
    M_p: jnp.ndarray         # (s,s,B)
    n_p: jnp.ndarray         # (s,B)
    T: jnp.ndarray           # int32
    bez: bezier.BezierCarry  # batch-leading (B,...) — small, layout-agnostic
    prev_R: jnp.ndarray        # (3,3,B)
    prev_accel_s: jnp.ndarray  # (3,B)
    prev_contact: jnp.ndarray  # (L,B)
    # ADMM warm-start iterates for the constrained path (lanes twin of
    # MHEState.z_adm/y_adm; OSQP setWarmStart(true), DecentralEst.cpp:204).
    # Empty tuples (and unused) on unconstrained configs.
    z_adm: jnp.ndarray = ()    # (N,s,B)
    y_adm: jnp.ndarray = ()    # (N,s,B)


def to_lanes_state(st) -> MHEStateL:
    """mhe.MHEState with one leading batch axis -> lanes layout (tests)."""
    return MHEStateL(
        *(lanes.to_lanes(a) for a in (
            st.y_meas, st.Q_meas, st.A_dyn, st.b_dyn, st.Q_dyn,
            st.b_cam, st.Q_cam, st.cam_active,
        )),
        M_p=lanes.to_lanes(st.M_p),
        n_p=lanes.to_lanes(st.n_p),
        T=st.T,
        bez=st.bez,
        prev_R=lanes.to_lanes(st.prev_R),
        prev_accel_s=lanes.to_lanes(st.prev_accel_s),
        prev_contact=lanes.to_lanes(st.prev_contact),
        z_adm=() if isinstance(st.z_adm, tuple) else lanes.to_lanes(st.z_adm),
        y_adm=() if isinstance(st.y_adm, tuple) else lanes.to_lanes(st.y_adm),
    )


@full_precision
def init(
    c: MHEConsts,
    R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact,
    dtype=jnp.float32,
    per_instance_vo: bool = False,
) -> MHEStateL:
    """Tick-0 initialization (InitializeMHE, DecentralEst.cpp:200-351).
    ``per_instance_vo`` allocates a per-lane Bezier schedule (times/count
    batched) for fleets whose VO events differ per instance."""
    N, s, m = c.N, c.dim_state, c.dim_meas
    p = _params_view(c)
    y0, Q0 = assembly_lanes.build_measurement(
        p, c.nc, R_sb, omega_b, p_foot, J_foot, dq, contact
    )
    x_prior, Q_prior = assembly_lanes.prior_state(p, c.nc, y0)
    B = y0.shape[-1]

    def z(shape):
        return jnp.zeros(shape + (B,), dtype)

    return MHEStateL(
        y_meas=z((N, m)).at[N - 1].set(y0),
        Q_meas=z((N, m, m)).at[N - 1].set(Q0),
        A_dyn=z((N, s, s)),
        b_dyn=z((N, s)),
        Q_dyn=z((N, s, s)),
        b_cam=z((N, 3)),
        Q_cam=z((N, 3, 3)),
        cam_active=jnp.zeros((N, B), bool),
        M_p=Q_prior,
        n_p=-lanes.mv(Q_prior, x_prior),
        T=jnp.asarray(0, jnp.int32),
        bez=bezier.init(dtype, batch=(B,),
                        per_instance_schedule=per_instance_vo),
        prev_R=R_sb,
        prev_accel_s=assembly_lanes.spatial_accel(R_sb, accel_b, c.nc),
        prev_contact=contact,
        z_adm=z((N, s)) if c.x_lb is not None else (),
        y_adm=z((N, s)) if c.x_lb is not None else (),
    )


def _marginalize(c: MHEConsts, st: MHEStateL):
    """Lanes transcription of mhe._marginalize (MheSrb.cpp:475-713)."""
    A = st.A_dyn[0]
    b = st.b_dyn[0]
    Qd = st.Q_dyn[0]
    H = c.A_meas
    R = st.Q_meas[0]
    y = st.y_meas[0]
    P = c.P_cam
    Qc = st.Q_cam[0]
    c0 = st.b_cam[0]
    act = st.cam_active[0].astype(A.dtype)[None, None, :]
    act_v = st.cam_active[0].astype(A.dtype)[None, :]

    AtQd = lanes.mm_tn(A, Qd)
    PtQc = lanes.cmm_t(P, Qc)                 # (s,3,B)
    PtQcP = lanes.mmc(PtQc, P)                # (s,s,B)
    HtR = lanes.cmm_t(H, R)                   # (s,m,B)

    S = st.M_p + lanes.mm(AtQd, A) + lanes.mmc(HtR, H) + act * PtQcP
    C01 = -(AtQd + act * PtQcP)
    D1 = Qd + act * PtQcP
    l0 = st.n_p - lanes.mv(AtQd, b) - lanes.mv(HtR, y) - act_v * lanes.mv(PtQc, c0)
    l1 = lanes.mv(Qd, b) + act_v * lanes.mv(PtQc, c0)
    Sinv = lanes.gj_inv(S)
    M_new = D1 - lanes.mm_tn(C01, lanes.mm(Sinv, C01))
    n_new = l1 - lanes.mv_t(C01, lanes.mv(Sinv, l0))
    return M_new, n_new


def _apply_vo(c: MHEConsts, st: MHEStateL, vo_R_pre, vo_dp, vo_tick_pre, vo_tick_now):
    """Lanes transcription of mhe._apply_vo (VO sync + Bezier + masked
    activation, DecentralEst.cpp:883-945, 987-1009). The VO schedule
    (ticks, dp) is shared across the fleet; the accumulated path differs per
    instance through each instance's pre-frame orientation vo_R_pre (3,3,B),
    gathered from the orientation stream by the scan driver."""
    N = c.N
    dt = jnp.asarray(c.dt, st.prev_accel_s.dtype)
    T = st.T + 1
    B = st.prev_accel_s.shape[-1]

    R_pre = vo_R_pre                                 # (3,3,B)
    # dp is shared (3,) or per-lane (3,B) (Monte-Carlo vision content noise)
    dp = jnp.broadcast_to(vo_dp[:, None] if vo_dp.ndim == 1 else vo_dp,
                          (3, B))
    inc = lanes.mv(R_pre, dp)                        # (3,B)
    p_accum = st.bez.p_accum + inc.T                 # carry is (B,3)
    bez_c = st.bez._replace(p_accum=p_accum)
    bez_c = bezier.add_way_point(bez_c, p_accum, vo_tick_now.astype(dt.dtype) * dt)

    window_start = T - jnp.minimum(N, T)
    start = jnp.maximum(window_start, vo_tick_pre)
    num = vo_tick_now - start + 1
    do_interp = jnp.logical_and(vo_tick_now > window_start, bez_c.count >= 4)

    diffs, _, node_mask = bezier.interpolate_increments(
        bez_c, start.astype(dt.dtype) * dt, num, dt, max_nodes=N + 1
    )
    diffs_l = jnp.moveaxis(diffs, 0, -1)             # (N+1,3,B)
    i = jnp.arange(N)
    slot = start + i - T + N
    mask = do_interp & (i <= num - 2) & (slot >= 0) & (slot <= N - 2) & node_mask[1:]
    tgt = jnp.where(mask, slot, N + 8)
    b_cam = st.b_cam.at[tgt].set(-diffs_l[1:], mode="drop")
    cam_active = st.cam_active.at[tgt].set(True, mode="drop")
    return st._replace(b_cam=b_cam, cam_active=cam_active, bez=bez_c)


def _tree_select(mask, a, b):
    """Per-instance select over batch-leading pytrees (mask (B,))."""
    m = jnp.asarray(mask, bool)

    def pick(x, y):
        mm = m.reshape(m.shape + (1,) * (x.ndim - m.ndim))
        return jnp.where(mm, x, y)

    return jax.tree.map(pick, a, b)


def _apply_vo_per_instance(c: MHEConsts, st: MHEStateL, vo_R_pre, vo_dp,
                           vo_tick_pre, vo_tick_now, vo_active):
    """Per-instance VO ingestion — the fully masked twin of _apply_vo for
    Monte-Carlo fleets whose VO schedules differ per lane (timing AND
    content). All VO operands are batched: vo_R_pre (3,3,B), vo_dp (3,B),
    vo_tick_pre/now/active (B,). Requires a per-instance Bezier schedule
    (mhe_lanes.init(..., per_instance_vo=True)); the branch never uses
    lax.cond — inactive lanes are masked out, matching the semantics of the
    scalar path lane-by-lane (equivalence: tests/test_per_instance_vo.py).
    """
    N = c.N
    dt = jnp.asarray(c.dt, st.prev_accel_s.dtype)
    T = st.T + 1
    B = st.prev_accel_s.shape[-1]
    act = jnp.asarray(vo_active, bool)

    inc = lanes.mv(vo_R_pre, vo_dp) * act.astype(vo_dp.dtype)[None, :]
    p_accum = st.bez.p_accum + inc.T                  # carry is (B,3)
    bez_c = st.bez._replace(p_accum=p_accum)
    bez_c = bezier.add_way_point(
        bez_c, p_accum, vo_tick_now.astype(dt.dtype) * dt, mask=act)

    window_start = T - jnp.minimum(N, T)
    start = jnp.maximum(window_start, vo_tick_pre)    # (B,)
    num = vo_tick_now - start + 1                     # (B,)
    do_interp = act & (vo_tick_now > window_start) & (bez_c.count >= 4)

    # node index i of window slot j: slot = start + i - T + N  ⇒
    # i = j - start + T - N  (per instance)
    j = jnp.arange(N)
    i_b = j[:, None] - start[None, :] + T - N         # (N,B)
    ok = (
        do_interp[None, :]
        & (i_b >= 0)
        & (i_b <= num[None, :] - 2)
        & (j[:, None] <= N - 2)
    )

    t_int = bez_c.times[:, 3] - bez_c.times[:, 0]     # (B,)
    t_int = jnp.where(t_int == 0, jnp.ones_like(t_int), t_int)
    u0 = (start.astype(dt.dtype) * dt - bez_c.times[:, 0]) / t_int
    du = dt / t_int
    uf = i_b.astype(dt.dtype)
    # diff over [i, i+1] evaluated directly per (slot, instance); pts are
    # (B,4,3) so eval_at yields (B,N,3) → lanes (N,3,B)
    lo = bezier.eval_at(bez_c, u0[:, None] + uf.T * du[:, None])
    hi = bezier.eval_at(bez_c, u0[:, None] + (uf.T + 1) * du[:, None])
    diff = jnp.moveaxis(hi - lo, 0, -1)               # (N,3,B)

    b_cam = jnp.where(ok[:, None, :], -diff, st.b_cam)
    cam_active = st.cam_active | ok
    return st._replace(b_cam=b_cam, cam_active=cam_active, bez=bez_c)


def assemble_normal_equations(c: MHEConsts, st: MHEStateL):
    """States-only block-tridiagonal normal equations in lanes layout.
    Returns (D (N,s,s,B), U (N,s,s,B; only :-1 meaningful), r (N,s,B),
    state_valid (N,))."""
    N = c.N
    H = c.A_meas
    P = c.P_cam
    dtype = st.A_dyn.dtype

    n_states = jnp.minimum(st.T + 1, N)
    first = N - n_states
    j = jnp.arange(N)
    state_valid = j >= first
    int_valid = (j >= first) & (j <= N - 2)

    act = (st.cam_active & int_valid[:, None]).astype(dtype)[:, None, None, :]
    ivm = int_valid.astype(dtype)[:, None, None, None]

    AtQd = lanes.mm_tn(st.A_dyn, st.Q_dyn) * ivm     # (N,s,s,B)
    AtQdA = lanes.mm(AtQd, st.A_dyn)
    PtQc = lanes.cmm_t(P, st.Q_cam) * act            # (N,s,3,B)
    PtQcP = lanes.mmc(PtQc, P)
    HtR = lanes.cmm_t(H, st.Q_meas)                  # (N,s,m,B)
    HtRH = lanes.mmc(HtR, H)
    Qd_b = lanes.mv(st.Q_dyn * ivm, st.b_dyn)
    AtQd_b = lanes.mv(AtQd, st.b_dyn)
    PtQc_c = lanes.mv(PtQc, st.b_cam)
    HtR_y = lanes.mv(HtR, st.y_meas)

    Qd_in = jnp.concatenate(
        [jnp.zeros_like(st.Q_dyn[:1]), (st.Q_dyn * ivm + PtQcP)[:-1]], axis=0
    )
    r_in = jnp.concatenate(
        [jnp.zeros_like(Qd_b[:1]), (Qd_b + PtQc_c)[:-1]], axis=0
    )

    D = HtRH + AtQdA + PtQcP + Qd_in
    U = -(AtQd + PtQcP)
    r = HtR_y + AtQd_b + PtQc_c - r_in

    first_mask = (j == first).astype(dtype)
    D = D + first_mask[:, None, None, None] * st.M_p[None]
    r = r - first_mask[:, None, None] * st.n_p[None]
    return D, U, r, state_valid


def _masked_system(c: MHEConsts, st: MHEStateL):
    D, U, r, valid = assemble_normal_equations(c, st)
    s = c.dim_state
    eye = jnp.eye(s, dtype=D.dtype)[:, :, None]
    v = valid.astype(D.dtype)[:, None, None, None]
    D = D * v + eye[None] * (1.0 - v)
    r = r * valid.astype(r.dtype)[:, None, None]
    vU = (valid[:-1] & valid[1:]).astype(D.dtype)[:, None, None, None]
    U = U[:-1] * vU
    return D, U, r


@full_precision
def solve_window(c: MHEConsts, st: MHEStateL) -> jnp.ndarray:
    """Solve the current window; returns (N, s, B) (zeros on dead slots).

    Unconstrained configs solve exactly (Thomas sweep); with state box
    constraints (c.x_lb/x_ub) the lanes OSQP-semantics ADMM runs,
    warm-started from st.z_adm/y_adm."""
    D, U, r = _masked_system(c, st)
    if c.x_lb is not None:
        return _solve_constrained(c, D, U, r, st.z_adm, st.y_adm).x
    return lanes.thomas_solve(D, U, r)


def _solve_constrained(c: MHEConsts, D, U, r, z0, y0):
    """The lanes box-ADMM (OSQP semantics, warm-started from z0/y0)."""
    from decentralized_ekf_mhe_tpu.ops import admm as admm_lib

    return admm_lib.solve_box_tridiag_lanes(
        D, U, r, c.x_lb, c.x_ub, c.admm, z0=z0, y0=y0)


@full_precision
def solve_window_with_duals(c: MHEConsts, st: MHEStateL):
    """Constrained solve returning the ADMM iterates for the next tick's warm
    start: (x, z, y), each (N, s, B)."""
    D, U, r = _masked_system(c, st)
    res = _solve_constrained(c, D, U, r, st.z_adm, st.y_adm)
    return res.x, res.z, res.y


def _shift_set(arr, new_vals: dict):
    """Roll slot axis 0 left by one and write new_vals {slot: value}."""
    rolled = jnp.roll(arr, -1, axis=0)
    for idx, val in new_vals.items():
        rolled = rolled.at[idx].set(val)
    return rolled


@full_precision
def step(
    c: MHEConsts,
    st: MHEStateL,
    R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact,
    vo_active, vo_dp, vo_tick_pre, vo_tick_now,
    vo_R_pre,
):
    """One estimator tick in lanes layout — mirror of mhe.step.
    ``vo_R_pre`` (3,3,B) is the orientation at tick vo_tick_pre (unused when
    vo_active is false). Returns (new_state, (x_T (s,B), x_window (N,s,B)))."""
    N = c.N
    p = _params_view(c)
    vo_dp = jnp.asarray(vo_dp, st.prev_accel_s.dtype)
    vo_tick_pre = jnp.asarray(vo_tick_pre, jnp.int32)
    vo_tick_now = jnp.asarray(vo_tick_now, jnp.int32)

    st = jax.lax.cond(
        jnp.asarray(vo_active, bool),
        lambda s_: _apply_vo(c, s_, vo_R_pre, vo_dp, vo_tick_pre, vo_tick_now),
        lambda s_: s_,
        st,
    )
    return _tick_tail(c, st, R_sb, accel_b, omega_b, p_foot, J_foot, dq,
                      contact)


@full_precision
def step_per_instance_vo(
    c: MHEConsts,
    st: MHEStateL,
    R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact,
    vo_active, vo_dp, vo_tick_pre, vo_tick_now,
    vo_R_pre,
):
    """One estimator tick with PER-INSTANCE VO: vo_active (B,), vo_dp (3,B),
    vo_tick_pre/now (B,), vo_R_pre (3,3,B). Requires a state built with
    init(..., per_instance_vo=True). Inactive lanes are masked, not
    branched; otherwise identical to step."""
    st = _apply_vo_per_instance(
        c, st, vo_R_pre,
        jnp.asarray(vo_dp, st.prev_accel_s.dtype),
        jnp.asarray(vo_tick_pre, jnp.int32),
        jnp.asarray(vo_tick_now, jnp.int32),
        vo_active,
    )
    return _tick_tail(c, st, R_sb, accel_b, omega_b, p_foot, J_foot, dq,
                      contact)


def _tick_tail(c: MHEConsts, st: MHEStateL, R_sb, accel_b, omega_b, p_foot,
               J_foot, dq, contact):
    """Marginalize-if-full → shift/append → solve (the VO-independent tail
    of the tick; see step's docstring for the reference anchors)."""
    N = c.N
    p = _params_view(c)
    T = st.T + 1
    M_new, n_new = jax.lax.cond(
        T >= N,
        lambda: _marginalize(c, st),
        lambda: (st.M_p, st.n_p),
    )

    A_d, b_d, Q_d = assembly_lanes.build_dynamics(
        p, c.nc, st.prev_R, st.prev_accel_s, st.prev_contact
    )
    Q_cam_new = lanes.mm_nt(lanes.mmc(st.prev_R, c.Q_vo_p), st.prev_R)
    y_T, Q_T = assembly_lanes.build_measurement(
        p, c.nc, R_sb, omega_b, p_foot, J_foot, dq, contact
    )

    st = MHEStateL(
        y_meas=_shift_set(st.y_meas, {N - 1: y_T}),
        Q_meas=_shift_set(st.Q_meas, {N - 1: Q_T}),
        A_dyn=_shift_set(st.A_dyn, {N - 2: A_d, N - 1: jnp.zeros_like(A_d)}),
        b_dyn=_shift_set(st.b_dyn, {N - 2: b_d, N - 1: jnp.zeros_like(b_d)}),
        Q_dyn=_shift_set(st.Q_dyn, {N - 2: Q_d, N - 1: jnp.zeros_like(Q_d)}),
        b_cam=_shift_set(
            st.b_cam,
            {N - 2: jnp.zeros_like(st.b_cam[0]), N - 1: jnp.zeros_like(st.b_cam[0])},
        ),
        Q_cam=_shift_set(
            st.Q_cam, {N - 2: Q_cam_new, N - 1: jnp.zeros_like(Q_cam_new)}
        ),
        cam_active=_shift_set(st.cam_active, {N - 2: False, N - 1: False}),
        M_p=M_new,
        n_p=n_new,
        T=T,
        bez=st.bez,
        prev_R=R_sb,
        prev_accel_s=assembly_lanes.spatial_accel(R_sb, accel_b, c.nc),
        prev_contact=contact,
        # warm-start iterates travel with their window slots; the fresh slot
        # N−1 reuses the previous newest iterate (mirror of mhe.step)
        z_adm=_shift_set(st.z_adm, {N - 1: st.z_adm[N - 1]})
        if c.x_lb is not None else st.z_adm,
        y_adm=_shift_set(st.y_adm, {N - 1: st.y_adm[N - 1]})
        if c.x_lb is not None else st.y_adm,
    )

    if c.x_lb is not None:
        x_window, z_w, y_w = solve_window_with_duals(c, st)
        st = st._replace(z_adm=z_w, y_adm=y_w)
    else:
        x_window = solve_window(c, st)
    x_T = x_window[N - 1]
    return st, (x_T, x_window)
