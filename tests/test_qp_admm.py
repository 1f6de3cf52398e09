"""General QP builder + OSQP-semantics ADMM vs scipy oracles."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.optimize import minimize

from decentralized_ekf_mhe_tpu.config import EstimatorParams, OSQPParams
from decentralized_ekf_mhe_tpu.ops import admm, qp


def rand_spd(rng, n, scale=1.0):
    M = rng.standard_normal((n, n))
    return scale * (M @ M.T + n * np.eye(n))


def scipy_box_qp(P, q, lb, ub):
    n = len(q)

    def f(x):
        return 0.5 * x @ P @ x + q @ x

    def g(x):
        return P @ x + q

    res = minimize(f, np.zeros(n), jac=g, method="L-BFGS-B",
                   bounds=list(zip(lb, ub)),
                   options={"maxiter": 500, "ftol": 1e-14, "gtol": 1e-12})
    return res.x


def test_admm_box_identity_constraints():
    rng = np.random.default_rng(0)
    n = 12
    P = rand_spd(rng, n)
    q = rng.standard_normal(n) * 5
    lb = np.full(n, -0.3)
    ub = np.full(n, 0.4)
    x, z, y, prim, dual = admm.solve_box_qp(
        jnp.asarray(P), jnp.asarray(q), jnp.eye(n),
        jnp.asarray(lb), jnp.asarray(ub),
        admm.ADMMSettings(rho=1.0, sigma=1e-6, alpha=1.6, iters=400),
    )[:5]
    x_ref = scipy_box_qp(P, q, lb, ub)
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-5)
    assert float(prim) < 1e-6 and float(dual) < 1e-4


def test_admm_general_inequality():
    """l ≤ Ax ≤ u with a non-identity A, checked via KKT conditions."""
    rng = np.random.default_rng(1)
    n, m = 8, 5
    P = rand_spd(rng, n)
    q = rng.standard_normal(n) * 3
    A = rng.standard_normal((m, n))
    l = np.full(m, -0.5)
    u = np.full(m, 0.5)
    x, z, y, prim, dual = admm.solve_box_qp(
        jnp.asarray(P), jnp.asarray(q), jnp.asarray(A),
        jnp.asarray(l), jnp.asarray(u),
        admm.ADMMSettings(rho=1.0, sigma=1e-6, alpha=1.6, iters=600),
    )[:5]
    x, z, y = map(np.asarray, (x, z, y))
    # KKT: stationarity, feasibility, complementarity signs
    assert np.abs(P @ x + q + A.T @ y).max() < 1e-3
    Ax = A @ x
    assert (Ax <= u + 1e-5).all() and (Ax >= l - 1e-5).all()
    inactive = (Ax > l + 1e-4) & (Ax < u - 1e-4)
    assert np.abs(y[inactive]).max() < 1e-3


def test_box_tridiag_matches_dense_admm():
    rng = np.random.default_rng(2)
    K, s = 6, 4
    D = np.stack([rand_spd(rng, s) for _ in range(K)])
    U = 0.3 * rng.standard_normal((K - 1, s, s))
    r = rng.standard_normal((K, s)) * 3
    lb = np.full(s, -0.2)
    ub = np.full(s, 0.25)
    settings = admm.ADMMSettings(rho=1.0, sigma=1e-6, alpha=1.6, iters=500)
    x, *_ = admm.solve_box_tridiag(
        jnp.asarray(D), jnp.asarray(U), jnp.asarray(r),
        jnp.asarray(lb), jnp.asarray(ub), settings,
    )
    # dense form: T as full matrix, box on every state
    T = np.zeros((K * s, K * s))
    for j in range(K):
        T[j*s:(j+1)*s, j*s:(j+1)*s] = D[j]
        if j < K - 1:
            T[j*s:(j+1)*s, (j+1)*s:(j+2)*s] = U[j]
            T[(j+1)*s:(j+2)*s, j*s:(j+1)*s] = U[j].T
    x_ref = scipy_box_qp(T, -r.ravel(), np.tile(lb, K), np.tile(ub, K))
    np.testing.assert_allclose(np.asarray(x).ravel(), x_ref, atol=1e-5)


def test_qp_problem_registry_equality():
    """Registry builder + exact KKT path on an MheSrb-style toy problem."""
    prob = qp.QPProblem()
    prob.add_variable("x", 2)
    prob.add_variable("v", 2)
    prob.add_cost("prior", np.array([1.0, 2.0]), np.eye(2))
    prob.add_cost_dependency("prior", "x", np.eye(2))
    prob.add_cost("meas", np.zeros(2), 10 * np.eye(2))
    prob.add_cost_dependency("meas", "v", np.eye(2))
    H = np.array([[1.0, 0.5], [0.0, 1.0]])
    y = np.array([0.7, -0.3])
    prob.add_constraints("m0", y, y)
    prob.add_constraint_dependency("m0", "x", H)
    prob.add_constraint_dependency("m0", "v", -np.eye(2))
    x_sol, info = prob.solve()
    assert info["method"] == "kkt"
    # analytic: min ||x-b||² + 10||Hx-y||² over x
    P = np.eye(2) + 10 * H.T @ H
    rhs = np.array([1.0, 2.0]) + 10 * H.T @ y
    np.testing.assert_allclose(prob.get_solution(x_sol, "x"),
                               np.linalg.solve(P, rhs), atol=1e-9)
    # slack equals residual
    np.testing.assert_allclose(
        prob.get_solution(x_sol, "v"),
        H @ prob.get_solution(x_sol, "x") - y, atol=1e-9)


def test_qp_problem_inf_placeholder_rows_inactive():
    """±INFTY rows (the VO placeholder idiom) must not constrain."""
    prob = qp.QPProblem()
    prob.add_variable("x", 2)
    prob.add_cost("c", np.array([3.0, -1.0]), np.eye(2))
    prob.add_cost_dependency("c", "x", np.eye(2))
    inf = np.full(2, qp.INFTY)
    prob.add_constraints("placeholder", -inf, inf)
    prob.add_constraint_dependency("placeholder", "x", np.eye(2))
    x_sol, info = prob.solve()
    np.testing.assert_allclose(prob.get_solution(x_sol, "x"), [3.0, -1.0], atol=1e-9)


def test_qp_problem_box_path():
    prob = qp.QPProblem()
    prob.add_variable("x", 3)
    prob.add_cost("c", np.array([2.0, -3.0, 0.5]), np.diag([1.0, 2.0, 4.0]))
    prob.add_cost_dependency("c", "x", np.eye(3))
    prob.add_constraints("box", np.full(3, -1.0), np.full(3, 1.0))
    prob.add_constraint_dependency("box", "x", np.eye(3))
    x_sol, info = prob.solve(OSQPParams(rho=1.0, sigma=1e-6, alpha=1.6), iters=400)
    assert info["method"] == "admm"
    np.testing.assert_allclose(x_sol, [1.0, -1.0, 0.5], atol=1e-5)


def test_qp_registry_errors():
    prob = qp.QPProblem()
    prob.add_variable("x", 2)
    prob.add_cost("c", np.zeros(2), np.eye(2))
    with pytest.raises(KeyError):
        prob.add_cost_dependency("nope", "x", np.eye(2))
    with pytest.raises(KeyError):
        prob.add_cost_dependency("c", "ghost", np.eye(2))


def test_mhe_state_constraints():
    """MHE with velocity box constraints: bounds respected, matches scipy."""
    from decentralized_ekf_mhe_tpu.io import synth
    from decentralized_ekf_mhe_tpu.ops import estimator, mhe

    p = EstimatorParams(
        num_legs=4, leg_odom_type=0, rate=200, N=8,
        osqp=OSQPParams(rho=1.0, sigma=1e-6, alpha=1.6),
        accel_input_std=[0.025, 0.025, 0.02], gyro_input_std=[0.03] * 3,
        joint_velocity_std=[0.22] * 3, foot_swing_std=[1e7] * 3,
    )
    s = p.dim_state
    x_lb = np.full(s, -np.inf)
    x_ub = np.full(s, np.inf)
    x_lb[3:6] = -0.18  # artificial tight velocity bounds
    x_ub[3:6] = 0.18
    c = mhe.make_consts(p, jnp.float64, x_lb=x_lb, x_ub=x_ub, admm_iters=600)

    log = synth.generate(synth.SynthConfig(T=40, seed=8))
    data = estimator.tickdata_from_log(log)
    d0 = jax.tree.map(lambda a: a[0], data)
    st = mhe.init(c, d0.R_sb, d0.accel_b, d0.omega_b, d0.p_foot, d0.J_foot,
                  d0.dq, d0.contact, dtype=jnp.float64)
    for k in range(1, 30):
        d = jax.tree.map(lambda a: a[k], data)
        st, (xT, xwin) = mhe.step(
            c, st, d.R_sb, d.accel_b, d.omega_b, d.p_foot, d.J_foot, d.dq,
            d.contact, False, jnp.zeros(3), 0, 0, d.R_sb,
        )
    xwin = np.asarray(xwin)
    assert (xwin[:, 3:6] <= 0.18 + 1e-6).all() and (xwin[:, 3:6] >= -0.18 - 1e-6).all()

    # cross-check the final window via exact active-set KKT: fix the bound-
    # active dims from the ADMM solution, solve the free subsystem exactly,
    # and verify KKT multiplier signs — that certifies the true optimum.
    # (scipy L-BFGS-B cannot converge at this Hessian scale ~1e10, so the
    # exact KKT refinement is the proper oracle.)
    D, U, r, valid = mhe.assemble_normal_equations(c, st)
    D, U, r = map(np.asarray, (D, U, r))
    K = c.N
    T = np.zeros((K * s, K * s))
    for j in range(K):
        T[j*s:(j+1)*s, j*s:(j+1)*s] = D[j]
        if j < K - 1:
            T[j*s:(j+1)*s, (j+1)*s:(j+2)*s] = U[j]
            T[(j+1)*s:(j+2)*s, j*s:(j+1)*s] = U[j].T
    rv = r.ravel()
    lb_full, ub_full = np.tile(x_lb, K), np.tile(x_ub, K)
    xf = xwin.ravel()
    tol = 1e-4
    act_lo = xf <= lb_full + tol
    act_hi = xf >= ub_full - tol
    act = act_lo | act_hi
    free = ~act
    x_ref = np.where(act_lo, lb_full, np.where(act_hi, ub_full, 0.0))
    x_ref[free] = np.linalg.solve(
        T[np.ix_(free, free)], rv[free] - T[np.ix_(free, act)] @ x_ref[act]
    )
    grad = T @ x_ref - rv
    assert np.abs(grad[free]).max() < 1e-3 * np.abs(rv).max()
    assert (grad[act_lo] >= -1e-3 * np.abs(rv).max()).all()   # λ ≥ 0 at lower
    assert (grad[act_hi] <= 1e-3 * np.abs(rv).max()).all()    # λ ≤ 0 at upper
    assert (x_ref >= lb_full - 1e-9).all() and (x_ref <= ub_full + 1e-9).all()
    np.testing.assert_allclose(xf, x_ref, atol=5e-4)


def test_admm_converged_freeze_and_iter_count():
    """OSQP stopping semantics (absTol/relTol, DecentralEst.cpp:213-214):
    with tolerances set, the solver freezes at convergence — iters < budget,
    and the answer matches the full-budget run."""
    rng = np.random.default_rng(5)
    n = 10
    P = rand_spd(rng, n)
    q = rng.standard_normal(n) * 4
    lb, ub = np.full(n, -0.3), np.full(n, 0.5)
    loose = admm.ADMMSettings(rho=1.0, sigma=1e-6, alpha=1.6, iters=500,
                              polish=False)
    tol = loose._replace(abs_tol=1e-8, rel_tol=1e-8)
    res_full = admm.solve_box_qp(jnp.asarray(P), jnp.asarray(q), jnp.eye(n),
                                 jnp.asarray(lb), jnp.asarray(ub), loose)
    res_tol = admm.solve_box_qp(jnp.asarray(P), jnp.asarray(q), jnp.eye(n),
                                jnp.asarray(lb), jnp.asarray(ub), tol)
    assert int(res_full.iters) == 500
    assert int(res_tol.iters) < 500          # early convergence detected
    np.testing.assert_allclose(np.asarray(res_tol.x), np.asarray(res_full.x),
                               atol=1e-6)
    # tighter tolerance costs more iterations than a looser one
    res_loose_tol = admm.solve_box_qp(
        jnp.asarray(P), jnp.asarray(q), jnp.eye(n),
        jnp.asarray(lb), jnp.asarray(ub), loose._replace(abs_tol=1e-3, rel_tol=1e-3))
    assert int(res_loose_tol.iters) <= int(res_tol.iters)


def test_admm_tridiag_converged_freeze():
    rng = np.random.default_rng(6)
    K, s = 5, 3
    D = np.stack([rand_spd(rng, s) for _ in range(K)])
    U = 0.2 * rng.standard_normal((K - 1, s, s))
    r = rng.standard_normal((K, s))
    lb, ub = np.full(s, -0.4), np.full(s, 0.4)
    base = admm.ADMMSettings(rho=1.0, sigma=1e-6, alpha=1.6, iters=400,
                             polish=False)
    res_full = admm.solve_box_tridiag(jnp.asarray(D), jnp.asarray(U),
                                      jnp.asarray(r), jnp.asarray(lb),
                                      jnp.asarray(ub), base)
    res_tol = admm.solve_box_tridiag(
        jnp.asarray(D), jnp.asarray(U), jnp.asarray(r), jnp.asarray(lb),
        jnp.asarray(ub), base._replace(abs_tol=1e-9, rel_tol=1e-9))
    assert int(res_tol.iters) < 400 and int(res_full.iters) == 400
    np.testing.assert_allclose(np.asarray(res_tol.x), np.asarray(res_full.x),
                               atol=1e-6)


def test_admm_infeasibility_certificates():
    """OSQP §3.5 certificates (primTol/dualTol, DecentralEst.cpp:215-216)."""
    # primal infeasible: x = a AND x = b with a != b
    P = np.eye(1) * 1e-6
    q = np.zeros(1)
    A = np.array([[1.0], [1.0]])
    l = np.array([0.0, 2.0])
    u = np.array([0.0, 2.0])
    res = admm.solve_box_qp(
        jnp.asarray(P), jnp.asarray(q), jnp.asarray(A), jnp.asarray(l),
        jnp.asarray(u),
        admm.ADMMSettings(rho=1.0, sigma=1e-6, alpha=1.6, iters=300,
                          polish=False, adaptive_rho=False))
    assert bool(res.pinf)
    # dual infeasible (unbounded below): P = 0, q != 0, no active bounds
    n = 2
    res2 = admm.solve_box_qp(
        jnp.zeros((n, n)), jnp.asarray(np.array([1.0, -2.0])), jnp.eye(n),
        jnp.asarray(np.full(n, -np.inf)), jnp.asarray(np.full(n, np.inf)),
        admm.ADMMSettings(rho=0.1, sigma=1e-6, alpha=1.6, iters=300,
                          polish=False, adaptive_rho=False))
    assert bool(res2.dinf)
    # a well-posed problem raises neither flag
    rng = np.random.default_rng(7)
    P3 = rand_spd(rng, 4)
    res3 = admm.solve_box_qp(
        jnp.asarray(P3), jnp.asarray(rng.standard_normal(4)), jnp.eye(4),
        jnp.asarray(np.full(4, -1.0)), jnp.asarray(np.full(4, 1.0)),
        admm.ADMMSettings(rho=1.0, sigma=1e-6, alpha=1.6, iters=300,
                          polish=False))
    assert not bool(res3.pinf) and not bool(res3.dinf)


def test_from_osqp_consumes_tolerances_and_time_limit():
    """Every OSQPParams knob a reference YAML sets must be consumed
    (config knobs that lie)."""
    p = OSQPParams(rho=0.3, alpha=1.5, sigma=2e-5, adapt_rho=False,
                   polish=True, max_iter=4000, prim_tol=1e-7, dual_tol=1e-8,
                   relative_tol=1e-6, abs_tol=1e-6, time_limit=0.0028)
    s = admm.ADMMSettings.from_osqp(p)
    assert s.rho == 0.3 and s.alpha == 1.5 and s.sigma == 2e-5
    assert s.abs_tol == 1e-6 and s.rel_tol == 1e-6
    assert s.prim_inf_tol == 1e-7 and s.dual_inf_tol == 1e-8
    assert s.iters == 200  # min(maxQPIter, default budget)
    # timeLimit analog: measured per-iteration cost converts the wall-clock
    # budget into the static trip count
    s2 = admm.ADMMSettings.from_osqp(p, per_iter_s=10e-6)
    assert s2.iters == 280  # 0.0028 / 10us
    s3 = admm.ADMMSettings.from_osqp(p, per_iter_s=1e-3)
    assert s3.iters == 2


import jax  # noqa: E402  (used in test_mhe_state_constraints)


def test_per_lane_bounds_match_vmapped_shared():
    """(s,B) PER-LANE bounds: lane b of the lanes ADMM fleet solve equals a
    separate shared-bounds solve with that lane's box."""
    import numpy as np
    from decentralized_ekf_mhe_tpu.ops import admm

    rng = np.random.default_rng(23)
    K, s, B = 6, 5, 4
    D = rng.standard_normal((K, B, s, s))
    D = D @ np.swapaxes(D, -1, -2) + 5 * np.eye(s)
    U = 0.1 * rng.standard_normal((K - 1, B, s, s))
    r = rng.standard_normal((K, B, s))
    # each lane gets its own box (the tuning-sweep story)
    bnd = np.linspace(0.1, 0.4, B)
    lb_B = np.broadcast_to(-bnd, (s, B)).copy()
    ub_B = np.broadcast_to(bnd, (s, B)).copy()
    lb_B[0, :] = -np.inf
    ub_B[-1, :] = np.inf
    st = admm.ADMMSettings(rho=0.5, sigma=1e-6, alpha=1.6, iters=60,
                           abs_tol=1e-9, rel_tol=1e-9)
    mv = lambda a: jnp.asarray(np.moveaxis(a, 1, -1))

    res_fleet = admm.solve_box_tridiag_lanes(
        mv(D), mv(U), mv(r), jnp.asarray(lb_B), jnp.asarray(ub_B), st)
    # oracle: each lane solved alone with its shared (s,) box
    for b in range(B):
        one = lambda a: jnp.asarray(np.moveaxis(a[:, b:b + 1], 1, -1))
        res_b = admm.solve_box_tridiag_lanes(
            one(D), one(U), one(r), jnp.asarray(lb_B[:, b]),
            jnp.asarray(ub_B[:, b]), st)
        np.testing.assert_allclose(np.asarray(res_fleet.x[..., b]),
                                   np.asarray(res_b.x[..., 0]),
                                   rtol=1e-8, atol=1e-10)
        # every lane's own box is respected
        xb = np.asarray(res_fleet.x[:, 1:-1, b])
        assert (np.abs(xb) <= bnd[b] + 1e-6).all()
    # ... and the tightest lane's box genuinely binds
    assert (np.abs(np.asarray(res_fleet.x[:, 1:-1, 0])) >= bnd[0] - 1e-9).any()
