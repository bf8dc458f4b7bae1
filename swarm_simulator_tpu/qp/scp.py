"""SCP planner — the reference's second trajectory-optimization algorithm.

Discrete-time double-integrator formulation (scp_planner.hpp, the
SP_PT_SCP path): decision variables are per-timestep accelerations
u[dim, agent, k] over K = T/h + 1 steps; positions/velocities are linear
maps of u (build_mapping_mtx :173-200); endpoints pinned
(build_eq_const :202-223); |p|,|v|,|a|,|jerk| box-limited
(build_ineq_const :225-251); inter-agent distance constraints are
sequentially convexified around the previous solution and the QP is
re-solved until the cost stabilizes (update_ineq_const :253-291,
solveQP :95-157).

Device-friendly: all constraint tensors are assembled as dense arrays once; the
SCP outer loop re-fills only the collision block (same shapes -> a single
compiled solver program), each inner solve is qp.dense ADMM on device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..core.types import Mission, Param
from . import dense

BIG = 1e8


@dataclass
class SCPResult:
    u: np.ndarray  # [3, N, K] accelerations
    pos: np.ndarray  # [3, N, K]
    vel: np.ndarray  # [3, N, K]
    h: float
    K: int
    cost: float
    iterations: int
    infos: list

    def traj_info_msg(self) -> np.ndarray:
        N = self.u.shape[1]
        return np.array([N, self.K, self.h], dtype=np.float64)

    def traj_input_msg(self) -> np.ndarray:
        return self.u.reshape(-1)


def _mapping_matrices(K: int, h: float):
    """P (p = P u + p_start), V (v = V u), J (jerk = J u) for one
    agent-axis chain of K steps (build_mapping_mtx)."""
    P = np.zeros((K, K))
    V = np.zeros((K, K))
    J = np.zeros((K, K))
    for k in range(K):
        for j in range(k):
            P[k, j] = 0.5 * h * h * (2 * (k - j) - 1)
            V[k, j] = h
        if k != 0:
            J[k, k] = 1.0 / h
            J[k, k - 1] = -1.0 / h
    return P, V, J


def plan_scp(
    mission: Mission,
    param: Param,
    *,
    horizon: float = 34.0,
    p_max: float = 5.0,
    v_max: float = 10.0,
    a_max: float = 10.0,
    j_max: float = 10.0,
    epsilon: float = 0.01,
    max_scp_iter: int = 20,
    settings: dense.DenseSettings | None = None,
) -> SCPResult:
    import jax
    import jax.numpy as jnp

    h = param.time_step
    K = int(round(horizon / h)) + 1
    N = mission.qn
    nx = 3 * N * K
    dtype = np.float64 if param.solver_dtype == "float64" else np.float32
    if settings is None:
        settings = dense.DenseSettings(max_iter=param.solver_max_iter)

    Pm, Vm, Jm = _mapping_matrices(K, h)

    # block layout: x[dim*N*K + qi*K + k]
    def blockdiag(Mk):
        out = np.zeros((nx, nx))
        for b in range(3 * N):
            out[b * K:(b + 1) * K, b * K:(b + 1) * K] = Mk
        return out

    Pfull = blockdiag(Pm)
    Vfull = blockdiag(Vm)
    Jfull = blockdiag(Jm)
    p_start = np.zeros(nx)
    for dim in range(3):
        for qi in range(N):
            p_start[dim * N * K + qi * K:dim * N * K + (qi + 1) * K] = \
                mission.start[qi, dim]
    p_goal = np.zeros(3 * N)
    for dim in range(3):
        for qi in range(N):
            p_goal[dim * N + qi] = mission.goal[qi, dim]

    # equality rows: u_0 = 0, final pos = goal, final vel = 0, u_{K-1} = 0
    pick0 = np.zeros((3 * N, nx))
    pickK = np.zeros((3 * N, nx))
    for dim in range(3):
        for qi in range(N):
            pick0[dim * N + qi, dim * N * K + qi * K] = 1.0
            pickK[dim * N + qi, dim * N * K + qi * K + K - 1] = 1.0
    A_eq = np.concatenate([pick0, pickK @ Pfull, pickK @ Vfull, pickK])
    b_eq = np.concatenate([np.zeros(3 * N), p_goal - pickK @ p_start,
                           np.zeros(3 * N), np.zeros(3 * N)])

    # dynamics rows (two-sided): P, V, A, J with box limits
    A_dyn = np.concatenate([Pfull, Vfull, np.eye(nx), Jfull])
    l_dyn = np.concatenate([
        -p_max - p_start, -np.full(nx, v_max), -np.full(nx, a_max),
        -np.full(nx, j_max)])
    u_dyn = np.concatenate([
        p_max - p_start, np.full(nx, v_max), np.full(nx, a_max),
        np.full(nx, j_max)])

    # collision rows: fixed allocation, inactive until the first SCP update
    n_pairs = N * (N - 1) // 2
    n_col = n_pairs * K

    def stack(Acol, lcol):
        A = np.concatenate([A_eq, A_dyn, Acol]).astype(dtype)
        l = np.concatenate([b_eq, l_dyn, lcol]).astype(dtype)
        u = np.concatenate([b_eq, u_dyn, np.full(n_col, BIG)]).astype(dtype)
        is_eq = np.zeros(len(l), dtype=bool)
        is_eq[:len(b_eq)] = True
        return A, l, u, is_eq

    Q = np.eye(nx, dtype=dtype)
    solve = jax.jit(
        lambda A, l, u, is_eq, x0: dense.solve_dense(
            jnp.asarray(Q), None, A, l, u, settings, is_eq, x0),
        static_argnames=())

    iu, ju = np.triu_indices(N, k=1)

    def collision_rows(u_prev: np.ndarray):
        """Linearized pairwise-distance constraints around the previous
        solution (update_ineq_const, scp_planner.hpp:253-291)."""
        p_prev = (Pfull @ u_prev + p_start).reshape(3, N, K)
        rel = p_prev[:, iu, :] - p_prev[:, ju, :]  # [3, P, K]
        dist = np.linalg.norm(rel, axis=0)  # [P, K]
        eta = rel / np.maximum(dist, 1e-12)  # [3, P, K]
        R = mission.radius[iu] + mission.radius[ju]  # [P]

        Acol = np.zeros((n_col, nx))
        lcol = np.zeros(n_col)
        for p in range(n_pairs):
            qi, qj = iu[p], ju[p]
            for k in range(K):
                row = p * K + k
                # eta . (p_i - p_j)_new >= R  (linearized):
                # row of A (for <= form the reference negates; we use l-bound)
                for dim in range(3):
                    base = dim * N * K
                    Acol[row, base + qi * K:base + (qi + 1) * K] += \
                        eta[dim, p, k] * Pm[k]
                    Acol[row, base + qj * K:base + (qj + 1) * K] -= \
                        eta[dim, p, k] * Pm[k]
                const = float(
                    sum(eta[dim, p, k] * (p_start[dim * N * K + qi * K]
                                          - p_start[dim * N * K + qj * K])
                        for dim in range(3)))
                lcol[row] = R[p] - const
        return Acol, lcol

    import jax.numpy as jnp

    u_prev = np.zeros(nx)
    Acol = np.zeros((n_col, nx))
    lcol = np.full(n_col, -BIG)
    cost_total, cost_prev = 1e9, 0.0  # SP_INFINITY (sp_const.hpp:6)
    it = 0
    infos = []
    while abs(cost_total - cost_prev) > epsilon * cost_total and it < max_scp_iter:
        A, l, ub, is_eq = stack(Acol, lcol)
        x, info = solve(jnp.asarray(A), jnp.asarray(l), jnp.asarray(ub),
                        jnp.asarray(is_eq), jnp.asarray(u_prev, dtype=dtype))
        u_prev = np.asarray(x, dtype=np.float64)
        cost_prev = cost_total
        cost_total = float(info.obj)
        infos.append(info)
        it += 1
        Acol, lcol = collision_rows(u_prev)

    u = u_prev.reshape(3, N, K)
    pos = (Pfull @ u_prev + p_start).reshape(3, N, K)
    vel = (Vfull @ u_prev).reshape(3, N, K)
    return SCPResult(u=u, pos=pos, vel=vel, h=h, K=K, cost=cost_total,
                     iterations=it, infos=infos)
