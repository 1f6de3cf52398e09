"""Moving Horizon Estimator — fixed-shape window engine + exact QP solve.

Re-design of the reference MHE stack (MheSrb.cpp + the formulation
side of DecentralEst.cpp): the string-keyed incremental QP registries
(MheSrb.hpp:128-136), conservativeResize growth (MheSrb.cpp:351-447), OSQP
solve (:340-349) and Schur marginalization (:475-713) become:

- static ring tensors over N window slots (after step T, slot j holds tick
  T−(N−1−j); interval j couples slots j and j+1);
- per-tick masked scatter for delayed VO equality activation (the ±∞
  placeholder bounds of DecentralEst.cpp:474-481 are an `active` mask here);
- an analytic slack elimination: every constraint is an equality in one slack
  (v/w/vcam — DecentralEst.cpp:460-488, 574-581), so the QP reduces to an SPD
  block-tridiagonal normal-equation system in the states alone, solved
  *exactly* in one batched block-Thomas sweep (ops/tridiag.py) — the unique
  optimum OSQP iterates toward, with no iteration count to tune;
- a closed-form arrival-cost update: marginalizing the oldest state of a
  convex quadratic is one Schur complement
      M' = D₁ − C₀₁ᵀ S⁻¹ C₀₁,   n' = l₁ − C₀₁ᵀ S⁻¹ l₀
  reproducing the reference's saddle-system elimination (MheSrb.cpp:524-651,
  both VO-active and VO-inactive branches fused via an `act` mask) — verified
  against a full-history dense KKT oracle in tests/test_mhe.py.

Everything broadcasts over leading batch axes and is scan/jit/vmap-safe;
per-step work is O(N·s³), s ∈ {9, 15, 21}.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from decentralized_ekf_mhe_tpu.config import EstimatorParams, std_to_gain
from decentralized_ekf_mhe_tpu.ops import assembly, bezier, smallmat, tridiag
from decentralized_ekf_mhe_tpu.utils.precision import full_precision


class MHEConsts(NamedTuple):
    nc: assembly.NoiseConsts
    A_meas: jnp.ndarray   # (m,s)
    P_cam: jnp.ndarray    # (3,s) position selector [I 0 …]
    Q_vo_p: jnp.ndarray   # (3,3)
    N: int
    dim_state: int
    dim_meas: int
    dt: float
    leg_odom_type: int
    num_legs: int
    # state box constraints (README.md:5 — the MHE "able to carry state
    # constraints"). None ⇒ unconstrained (exact tridiagonal solve); set ⇒
    # OSQP-semantics ADMM path (ops/admm.py) with the given iteration budget.
    x_lb: object = None       # (s,) or None
    x_ub: object = None       # (s,) or None
    admm: object = None       # admm.ADMMSettings or None


class MHEState(NamedTuple):
    # measurement at slot j
    y_meas: jnp.ndarray      # (...,N,m)
    Q_meas: jnp.ndarray      # (...,N,m,m)
    # interval j: slot j → j+1 (only j ≤ N−2 meaningful)
    A_dyn: jnp.ndarray       # (...,N,s,s)
    b_dyn: jnp.ndarray       # (...,N,s)
    Q_dyn: jnp.ndarray       # (...,N,s,s)
    b_cam: jnp.ndarray       # (...,N,3) the equality bound value (= −Δp)
    Q_cam: jnp.ndarray       # (...,N,3,3)
    cam_active: jnp.ndarray  # (...,N) bool
    # arrival cost 0.5 xᵀM_p x + n_pᵀx on the oldest live state
    M_p: jnp.ndarray         # (...,s,s)
    n_p: jnp.ndarray         # (...,s)
    T: jnp.ndarray           # int32 newest tick in the window
    bez: bezier.BezierCarry
    # previous tick's inputs, consumed by the next interval's dynamics
    # (UpdateMHE reads the stacks *before* GetMeasurement pushes tick T:
    #  DecentralEst.cpp:374-375 — i.e. R/accel/contact at T−1)
    prev_R: jnp.ndarray        # (...,3,3)
    prev_accel_s: jnp.ndarray  # (...,3)
    prev_contact: jnp.ndarray  # (...,L)
    # ADMM warm-start carry for the constrained path: last tick's primal/dual
    # iterates per window slot, shifted with the window each tick (the
    # reference runs OSQP with setWarmStart(true), DecentralEst.cpp:204).
    # Zeros (and unused) on unconstrained configs.
    z_adm: jnp.ndarray = ()    # (...,N,s)
    y_adm: jnp.ndarray = ()    # (...,N,s)


def make_consts(p: EstimatorParams, dtype=jnp.float32,
                x_lb=None, x_ub=None, admm_iters=None) -> MHEConsts:
    """Build static MHE constants. Passing x_lb/x_ub ((s,) shared or (s,B)
    PER-LANE arrays; ±inf for unconstrained dims) switches solve_window to
    the ADMM path with OSQP settings from ``p.osqp`` and a fixed iteration
    budget (default min(maxQPIter, 200) — the timeLimit analog). Per-lane
    bounds sweep the box across a B-instance fleet in one program
    (DecentralEst.cpp:222-348 per-run bound construction, fleet-lifted)."""
    from decentralized_ekf_mhe_tpu.ops import admm as admm_lib

    s = p.dim_state
    P = np.zeros((3, s))
    P[:, :3] = np.eye(3)
    constrained = x_lb is not None or x_ub is not None
    return MHEConsts(
        nc=assembly.make_noise_consts(p, dtype),
        A_meas=assembly.a_meas(p, dtype),
        P_cam=jnp.asarray(P, dtype),
        Q_vo_p=jnp.asarray(std_to_gain(p.vo_p_std), dtype),
        N=p.N,
        dim_state=s,
        dim_meas=p.dim_meas,
        dt=p.dt,
        leg_odom_type=p.leg_odom_type,
        num_legs=p.num_legs,
        x_lb=jnp.asarray(
            x_lb if x_lb is not None else np.full(s, -np.inf), dtype
        ) if constrained else None,
        x_ub=jnp.asarray(
            x_ub if x_ub is not None else np.full(s, np.inf), dtype
        ) if constrained else None,
        admm=admm_lib.ADMMSettings.from_osqp(p.osqp, admm_iters)
        if constrained else None,
    )


def _params_view(c: MHEConsts) -> EstimatorParams:
    """Static params needed by the assembly builders."""
    p = EstimatorParams()
    p.num_legs = c.num_legs
    p.leg_odom_type = c.leg_odom_type
    p.rate = int(round(1.0 / c.dt))
    return p


@full_precision
def init(
    c: MHEConsts,
    R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact,
    dtype=jnp.float32,
) -> MHEState:
    """Tick-0 initialization (InitializeMHE, DecentralEst.cpp:200-351): the
    prior cost seeds the arrival pair (M_p, n_p) = (Q_prior, −Q_prior·x̂)
    exactly as the first marginalization would (MheSrb.cpp:517-522)."""
    N, s, m = c.N, c.dim_state, c.dim_meas
    p = _params_view(c)
    y0, _, Q0 = assembly.build_measurement(
        p, c.nc, R_sb, omega_b, p_foot, J_foot, dq, contact
    )
    x_prior, Q_prior, _ = assembly.prior_state(p, c.nc, y0)
    batch = y0.shape[:-1]

    def z(shape):
        return jnp.zeros(batch + shape, dtype)

    return MHEState(
        y_meas=z((N, m)).at[..., N - 1, :].set(y0),
        Q_meas=z((N, m, m)).at[..., N - 1, :, :].set(Q0),
        A_dyn=z((N, s, s)),
        b_dyn=z((N, s)),
        Q_dyn=z((N, s, s)),
        b_cam=z((N, 3)),
        Q_cam=z((N, 3, 3)),
        cam_active=jnp.zeros(batch + (N,), bool),
        M_p=Q_prior,
        n_p=-jnp.einsum("...ij,...j->...i", Q_prior, x_prior),
        T=jnp.asarray(0, jnp.int32),
        bez=bezier.init(dtype, batch=batch),
        prev_R=R_sb,
        prev_accel_s=assembly.spatial_accel(R_sb, accel_b, c.nc),
        prev_contact=contact,
        z_adm=z((N, s)),
        y_adm=z((N, s)),
    )


def _marginalize(c: MHEConsts, st: MHEState):
    """Fold slot 0 into the arrival pair (marginalizeQP, MheSrb.cpp:475-713).

    With A=A_dyn₀, Qd=Q_dyn₀, H=A_meas, R=Q_meas₀, P=P_cam, Qc=Q_cam₀,
    c₀=b_cam₀ (the stored equality bound), y=y_meas₀, act the VO mask:
        S   = M + AᵀQdA + HᵀRH + act·PᵀQcP
        C01 = −(AᵀQd + act·PᵀQcP)
        D1  = Qd + act·PᵀQcP
        l0  = n − AᵀQd·b − HᵀR·y − act·PᵀQc·c₀
        l1  = Qd·b + act·PᵀQc·c₀
        M'  = D1 − C01ᵀ S⁻¹ C01,   n' = l1 − C01ᵀ S⁻¹ l0
    act=0 reproduces the VO-inactive branch (MheSrb.cpp:601-651) exactly.
    """
    A = st.A_dyn[..., 0, :, :]
    b = st.b_dyn[..., 0, :]
    Qd = st.Q_dyn[..., 0, :, :]
    H = c.A_meas
    R = st.Q_meas[..., 0, :, :]
    y = st.y_meas[..., 0, :]
    P = c.P_cam
    Qc = st.Q_cam[..., 0, :, :]
    c0 = st.b_cam[..., 0, :]
    act = st.cam_active[..., 0].astype(A.dtype)[..., None, None]
    act_v = st.cam_active[..., 0].astype(A.dtype)[..., None]

    AtQd = jnp.swapaxes(A, -1, -2) @ Qd
    PtQc = jnp.swapaxes(P, -1, -2) @ Qc               # (s,3)
    PtQcP = PtQc @ P                                   # (s,s)
    HtR = jnp.swapaxes(H, -1, -2) @ R

    S = st.M_p + AtQd @ A + HtR @ H + act * PtQcP
    C01 = -(AtQd + act * PtQcP)
    D1 = Qd + act * PtQcP
    l0 = (
        st.n_p
        - jnp.einsum("...ij,...j->...i", AtQd, b)
        - jnp.einsum("...ij,...j->...i", HtR, y)
        - act_v * jnp.einsum("...ij,...j->...i", PtQc, c0)
    )
    l1 = jnp.einsum("...ij,...j->...i", Qd, b) + act_v * jnp.einsum(
        "...ij,...j->...i", PtQc, c0
    )
    Sinv = smallmat.gj_inv(S)
    Sinv_C01 = Sinv @ C01
    Sinv_l0 = jnp.einsum("...ij,...j->...i", Sinv, l0)
    C01t = jnp.swapaxes(C01, -1, -2)
    M_new = D1 - C01t @ Sinv_C01
    n_new = l1 - jnp.einsum("...ij,...j->...i", C01t, Sinv_l0)
    return M_new, n_new


def _apply_vo(c: MHEConsts, st: MHEState, vo_R_pre, vo_dp, vo_tick_pre, vo_tick_now):
    """VO sync + Bezier + masked equality activation (GetMeasurement's VO
    block, DecentralEst.cpp:883-945, + UpdateVOConstraints :987-1009).

    Runs at tick T = st.T+1 against the *current* window layout (before the
    marginalize/shift/append of this tick), matching the reference's
    UpdateMHE → UpdateVOConstraints → marginalizeQP order.

    ``vo_R_pre`` is the estimator orientation at tick ``vo_tick_pre`` — the
    R_vo_sb_pre of DecentralEst.cpp:915 — supplied by the caller (the scan
    drivers gather it from the orientation sequence; the stateful facade keeps
    a bounded host-side ring), so the kernel itself never indexes history and
    tick counters stay absolute.
    """
    N = c.N
    dt = jnp.asarray(c.dt, st.prev_accel_s.dtype)
    T = st.T + 1

    R_pre = vo_R_pre
    p_accum = st.bez.p_accum + jnp.einsum("...ij,...j->...i", R_pre, vo_dp)
    bez_c = st.bez._replace(p_accum=p_accum)
    bez_c = bezier.add_way_point(bez_c, p_accum, vo_tick_now.astype(dt.dtype) * dt)

    window_start = T - jnp.minimum(N, T)
    start = jnp.maximum(window_start, vo_tick_pre)
    num = vo_tick_now - start + 1
    do_interp = jnp.logical_and(vo_tick_now > window_start, bez_c.count >= 4)

    diffs, _, node_mask = bezier.interpolate_increments(
        bez_c, start.astype(dt.dtype) * dt, num, dt, max_nodes=N + 1
    )
    # bound −diffs[i+1] targets the VO interval of tick d = start+i (i ≤ num−2);
    # current layout: slot j holds tick (T−1)−(N−1−j) ⇒ interval j ↔ tick T−N+j
    i = jnp.arange(N)
    slot = start + i - T + N
    mask = do_interp & (i <= num - 2) & (slot >= 0) & (slot <= N - 2) & node_mask[1:]
    tgt = jnp.where(mask, slot, N + 8)  # out-of-range ⇒ dropped by mode="drop"
    b_cam = st.b_cam.at[..., tgt, :].set(-diffs[..., 1:, :], mode="drop")
    cam_active = st.cam_active.at[..., tgt].set(True, mode="drop")
    return st._replace(b_cam=b_cam, cam_active=cam_active, bez=bez_c)


def _shift_set(arr, slot_axis: int, new_vals: dict):
    """Roll the slot axis left by one and write new_vals {index: value}."""
    rolled = jnp.roll(arr, -1, axis=slot_axis)
    for idx, val in new_vals.items():
        sl = [slice(None)] * arr.ndim
        sl[slot_axis if slot_axis >= 0 else arr.ndim + slot_axis] = idx
        rolled = rolled.at[tuple(sl)].set(val)
    return rolled


def assemble_normal_equations(c: MHEConsts, st: MHEState):
    """Reduce the slack-variable QP to states-only block-tridiagonal normal
    equations D/U/r with warmup masking. Returns (D (N,...,s,s), U, r, valid)."""
    N = c.N
    H = c.A_meas
    P = c.P_cam
    Ht = jnp.swapaxes(H, -1, -2)
    Pt = jnp.swapaxes(P, -1, -2)

    n_states = jnp.minimum(st.T + 1, N)
    first = N - n_states
    j = jnp.arange(N)
    state_valid = j >= first
    int_valid = (j >= first) & (j <= N - 2)

    act = (st.cam_active & int_valid).astype(st.A_dyn.dtype)
    actm = act[..., None, None]
    ivm = int_valid.astype(st.A_dyn.dtype)[..., None, None]

    AtQd = (jnp.swapaxes(st.A_dyn, -1, -2) @ st.Q_dyn) * ivm       # (...,N,s,s)
    AtQdA = AtQd @ st.A_dyn
    PtQc = (Pt @ st.Q_cam) * actm                                   # (...,N,s,3)
    PtQcP = PtQc @ P
    HtR = Ht @ st.Q_meas                                            # (...,N,s,m)
    HtRH = HtR @ H
    Qd_b = jnp.einsum("...ij,...j->...i", st.Q_dyn * ivm, st.b_dyn)
    AtQd_b = jnp.einsum("...ij,...j->...i", AtQd, st.b_dyn)
    PtQc_c = jnp.einsum("...ij,...j->...i", PtQc, st.b_cam)
    HtR_y = jnp.einsum("...ij,...j->...i", HtR, st.y_meas)

    # interval j−1 contributes Qd+PᵀQcP to D_j and −(Qd·b + PᵀQc·c) to r_j
    Qd_in = jnp.concatenate(
        [jnp.zeros_like(st.Q_dyn[..., :1, :, :]),
         (st.Q_dyn * ivm + PtQcP)[..., :-1, :, :]],
        axis=-3,
    )
    r_in = jnp.concatenate(
        [jnp.zeros_like(Qd_b[..., :1, :]), (Qd_b + PtQc_c)[..., :-1, :]], axis=-2
    )

    D = HtRH + AtQdA + PtQcP + Qd_in
    U = -(AtQd + PtQcP)
    r = HtR_y + AtQd_b + PtQc_c - r_in

    first_mask = (j == first).astype(D.dtype)
    D = D + first_mask[..., None, None] * st.M_p[..., None, :, :]
    r = r - first_mask[..., None] * st.n_p[..., None, :]
    return D, U, r, state_valid


@full_precision
def solve_window(c: MHEConsts, st: MHEState) -> jnp.ndarray:
    """Solve the current window; returns (..., N, s) states (zeros on dead slots).

    Unconstrained configs use the exact one-sweep solve; with state box
    constraints (c.x_lb/x_ub set) the OSQP-semantics ADMM runs (warm-started
    from st.z_adm/y_adm — setWarmStart(true), DecentralEst.cpp:204).
    """
    D, U, r, valid = assemble_normal_equations(c, st)
    Dl = jnp.moveaxis(D, -3, 0)
    Ul = jnp.moveaxis(U, -3, 0)[:-1]
    rl = jnp.moveaxis(r, -2, 0)
    vl = jnp.moveaxis(jnp.broadcast_to(valid, r.shape[:-1]), -1, 0)
    if c.x_lb is None:
        x = tridiag.solve(Dl, Ul, rl, valid=vl)
    else:
        from decentralized_ekf_mhe_tpu.ops import admm as admm_lib

        x = admm_lib.solve_box_tridiag(
            Dl, Ul, rl, _std_bounds(c.x_lb), _std_bounds(c.x_ub), c.admm,
            valid=vl,
            z0=jnp.moveaxis(st.z_adm, -2, 0), y0=jnp.moveaxis(st.y_adm, -2, 0),
        ).x
    return jnp.moveaxis(x, 0, -2)


def _std_bounds(b):
    """Per-lane (s,B) bounds -> standard-layout (B,s) broadcastable over
    (K,B,s) iterates; shared (s,) bounds pass through."""
    return b.T if getattr(b, "ndim", 1) == 2 else b


@full_precision
def solve_window_with_duals(c: MHEConsts, st: MHEState):
    """Constrained solve that also returns the ADMM iterates for the next
    tick's warm start: (x (...,N,s), z (...,N,s), y (...,N,s))."""
    from decentralized_ekf_mhe_tpu.ops import admm as admm_lib

    D, U, r, valid = assemble_normal_equations(c, st)
    Dl = jnp.moveaxis(D, -3, 0)
    Ul = jnp.moveaxis(U, -3, 0)[:-1]
    rl = jnp.moveaxis(r, -2, 0)
    vl = jnp.moveaxis(jnp.broadcast_to(valid, r.shape[:-1]), -1, 0)
    res = admm_lib.solve_box_tridiag(
        Dl, Ul, rl, _std_bounds(c.x_lb), _std_bounds(c.x_ub), c.admm,
        valid=vl,
        z0=jnp.moveaxis(st.z_adm, -2, 0), y0=jnp.moveaxis(st.y_adm, -2, 0),
    )
    mv = lambda a: jnp.moveaxis(a, 0, -2)
    return mv(res.x), mv(res.z), mv(res.y)


@full_precision
def step(
    c: MHEConsts,
    st: MHEState,
    R_sb, accel_b, omega_b, p_foot, J_foot, dq, contact,
    vo_active, vo_dp, vo_tick_pre, vo_tick_now,
    vo_R_pre,
):
    """One estimator tick T = st.T+1.

    Order (DecentralEst.cpp:152-198 with marginalize commuted ahead of the
    append — they touch disjoint window slots): VO bound scatter →
    marginalize-if-full → shift window and append the new interval (built
    from the previous tick's inputs) and measurement (current tick) → solve.

    ``vo_R_pre`` is the orientation at tick ``vo_tick_pre`` (see _apply_vo);
    unused when ``vo_active`` is false — pass any (...,3,3) placeholder.

    Returns (new_state, (x_T, x_window)).
    """
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

    T = st.T + 1
    M_new, n_new = jax.lax.cond(
        T >= N,
        lambda: _marginalize(c, st),
        lambda: (st.M_p, st.n_p),
    )

    A_d, b_d, _, Q_d = assembly.build_dynamics(
        p, c.nc, st.prev_R, st.prev_accel_s, st.prev_contact
    )
    Q_cam_new = st.prev_R @ c.Q_vo_p @ jnp.swapaxes(st.prev_R, -1, -2)
    y_T, _, Q_T = assembly.build_measurement(
        p, c.nc, R_sb, omega_b, p_foot, J_foot, dq, contact
    )

    nd = st.y_meas.ndim  # (...,N,m): slot axis at nd−2
    st = MHEState(
        y_meas=_shift_set(st.y_meas, nd - 2, {N - 1: y_T}),
        Q_meas=_shift_set(st.Q_meas, nd - 2, {N - 1: Q_T}),
        A_dyn=_shift_set(st.A_dyn, nd - 2, {N - 2: A_d, N - 1: jnp.zeros_like(A_d)}),
        b_dyn=_shift_set(st.b_dyn, nd - 2, {N - 2: b_d, N - 1: jnp.zeros_like(b_d)}),
        Q_dyn=_shift_set(st.Q_dyn, nd - 2, {N - 2: Q_d, N - 1: jnp.zeros_like(Q_d)}),
        b_cam=_shift_set(
            st.b_cam, nd - 2,
            {N - 2: jnp.zeros_like(st.b_cam[..., 0, :]),
             N - 1: jnp.zeros_like(st.b_cam[..., 0, :])},
        ),
        Q_cam=_shift_set(
            st.Q_cam, nd - 2,
            {N - 2: Q_cam_new, N - 1: jnp.zeros_like(Q_cam_new)},
        ),
        cam_active=_shift_set(
            st.cam_active, st.cam_active.ndim - 1, {N - 2: False, N - 1: False}
        ),
        M_p=M_new,
        n_p=n_new,
        T=T,
        bez=st.bez,
        prev_R=R_sb,
        prev_accel_s=assembly.spatial_accel(R_sb, accel_b, c.nc),
        prev_contact=contact,
        # warm-start iterates travel with their window slots; the fresh slot
        # N−1 reuses the previous newest iterate (consecutive states are
        # close at 200 Hz)
        z_adm=_shift_set(st.z_adm, nd - 2, {N - 1: st.z_adm[..., N - 1, :]}),
        y_adm=_shift_set(st.y_adm, nd - 2, {N - 1: st.y_adm[..., N - 1, :]}),
    )

    if c.x_lb is not None:
        x_window, z_w, y_w = solve_window_with_duals(c, st)
        st = st._replace(z_adm=z_w, y_adm=y_w)
    else:
        x_window = solve_window(c, st)
    x_T = x_window[..., N - 1, :]
    return st, (x_T, x_window)
