"""General registry-style QP problem builder — API parity with MHEproblem (C2).

The reference's `MHEproblem` (MheSrb.hpp:58-191) exposes a string-keyed
incremental QP surface: addVariable / addCost(+Dependency) /
addConstraints(+Dependency) / updateConstraintBound / updateCostGain /
formulate / solve / reset. The structured MHE path in ops/mhe.py replaces it
with static window tensors for the hot loop; this module provides the same
*general* builder for ad-hoc problems (custom costs, extra constraints,
prototyping new robots) on top of the engine's solvers:

- equality-only problems solve exactly via the KKT system;
- box/inequality problems solve via OSQP-semantics ADMM (ops/admm.py) with
  the settings of `OSQPParams` (EstSub.cpp:182-207).

Assembly is host-side numpy (it happens once per problem *structure*); the
solve is a jitted batched kernel, so one built problem can be solved for many
right-hand-side/bound instances.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax.numpy as jnp
import numpy as np

from decentralized_ekf_mhe_tpu.config import OSQPParams
from decentralized_ekf_mhe_tpu.ops import admm, smallmat

INFTY = 1e30  # OsqpEigen::INFTY analog (MheSrb.hpp:81)


@dataclass
class _Cost:
    b: np.ndarray
    Q: np.ndarray
    deps: Dict[str, np.ndarray] = field(default_factory=dict)


@dataclass
class _Constraint:
    lb: np.ndarray
    ub: np.ndarray
    equality: bool = False
    deps: Dict[str, np.ndarray] = field(default_factory=dict)


class QPProblem:
    """String-keyed QP: min Σ ½‖A_c x − b_c‖²_{Q_c}  s.t. lb ≤ A x ≤ ub."""

    def __init__(self):
        self.reset()

    # -- registry surface (MheSrb.cpp:35-68, 216-269) ----------------------
    def add_variable(self, name: str, size: int):
        self._vars[name] = (self._nvar, size)
        self._nvar += size

    def add_cost(self, name: str, b, Q):
        self._costs[name] = _Cost(np.asarray(b, float), np.asarray(Q, float))

    def add_cost_dependency(self, name: str, var: str, A):
        if name not in self._costs:
            raise KeyError(f"cannot find the cost {name}")
        if var not in self._vars:
            raise KeyError(f"cannot find the variable {var} for cost {name}")
        self._costs[name].deps[var] = np.asarray(A, float)

    def add_constraints(self, name: str, lb, ub):
        self._cons[name] = _Constraint(np.asarray(lb, float), np.asarray(ub, float))
        self._con_order.append(name)

    def add_constraint_dependency(self, name: str, var: str, A):
        if name not in self._cons:
            raise KeyError(f"cannot find the constraint {name}")
        if var not in self._vars:
            raise KeyError(f"cannot find the variable {var} for constraint {name}")
        self._cons[name].deps[var] = np.asarray(A, float)

    def update_constraint_bound(self, name: str, lb, ub, equality: bool = False):
        """updateConstraintBound (MheSrb.cpp:233-243)."""
        c = self._cons[name]
        c.lb, c.ub, c.equality = np.asarray(lb, float), np.asarray(ub, float), equality

    def update_cost_gain(self, name: str, scale: float):
        """updateCostGain (MheSrb.cpp:244-254)."""
        self._costs[name].Q = scale * self._costs[name].Q

    def reset(self):
        """resetQP (MheSrb.cpp:734-760)."""
        self._vars: Dict[str, tuple] = {}
        self._nvar = 0
        self._costs: Dict[str, _Cost] = {}
        self._cons: Dict[str, _Constraint] = {}
        self._con_order: List[str] = []

    @property
    def num_variables(self):
        return self._nvar

    # -- assembly (assembleCost/assembleConstraints, MheSrb.cpp:82-214) ----
    def assemble(self):
        n = self._nvar
        P = np.zeros((n, n))
        q = np.zeros(n)
        for c in self._costs.values():
            for vi, Ai in c.deps.items():
                si, zi = self._vars[vi]
                for vj, Aj in c.deps.items():
                    sj, zj = self._vars[vj]
                    P[si:si + zi, sj:sj + zj] += Ai.T @ c.Q @ Aj
                q[si:si + zi] += -Ai.T @ c.Q @ c.b
        rows_A, rows_l, rows_u = [], [], []
        for name in self._con_order:
            c = self._cons[name]
            m = len(c.lb)
            A = np.zeros((m, n))
            for vi, Ai in c.deps.items():
                si, zi = self._vars[vi]
                A[:, si:si + zi] += Ai
            rows_A.append(A)
            rows_l.append(np.clip(c.lb, -INFTY, INFTY))
            rows_u.append(np.clip(c.ub, -INFTY, INFTY))
        if rows_A:
            A = np.vstack(rows_A)
            l = np.concatenate(rows_l)
            u = np.concatenate(rows_u)
        else:
            A = np.zeros((0, n))
            l = np.zeros(0)
            u = np.zeros(0)
        return P, q, A, l, u

    # -- solve --------------------------------------------------------------
    def solve(self, osqp_params: Optional[OSQPParams] = None, iters: Optional[int] = None,
              dtype=jnp.float64):
        """Solve the assembled QP. Equality-only problems (every finite row
        has lb == ub and no finite one-sided bounds) solve exactly via KKT;
        otherwise OSQP-semantics ADMM with a fixed iteration budget.

        Returns (x (n,), info dict).
        """
        P, q, A, l, u = self.assemble()
        active = (np.abs(l) < INFTY) | (np.abs(u) < INFTY)
        eq_rows = active & (l == u)
        if active.sum() == 0 or np.all(eq_rows == active):
            # exact KKT solve on the active equality rows
            Ae, ce = A[eq_rows], l[eq_rows]
            m = Ae.shape[0]
            KKT = np.block([[P, Ae.T], [Ae, np.zeros((m, m))]])
            rhs = np.concatenate([-q, ce])
            sol = np.linalg.solve(KKT, rhs)
            return sol[: self._nvar], {"method": "kkt", "iters": 0}
        settings = admm.ADMMSettings.from_osqp(osqp_params or OSQPParams(), iters)
        res = admm.solve_box_qp(
            jnp.asarray(P, dtype), jnp.asarray(q, dtype), jnp.asarray(A, dtype),
            jnp.asarray(np.where(np.abs(l) >= INFTY, -np.inf, l), dtype),
            jnp.asarray(np.where(np.abs(u) >= INFTY, np.inf, u), dtype),
            settings,
        )
        return np.asarray(res.x), {
            "method": "admm",
            "iters": int(res.iters),
            "prim_res": float(res.prim),
            "dual_res": float(res.dual),
        }

    def get_solution(self, x, name: str):
        """Slice a variable from the stacked solution (getsolution, MheSrb.cpp:715)."""
        s, z = self._vars[name]
        return x[s:s + z]
