"""Diagnostic: is the FLOWN solution feasible for the corridor-REFRESHED
joint QP, and what does the refreshed problem's true optimum look like?

Round-4 finding: replan solves on refreshed RSFC normals end far above
the rotating best-response oracle (and, at 16 agents, far above the
flown solution's own jerk) even at FULL budgets.  Two candidate causes:
  (a) the refreshed constraint set is genuinely tighter (excludes the
      flown solution or its neighborhood) -> feasibility residuals of
      the flown x under the fresh (l, u, A) tell us;
  (b) ADMM fails to re-converge on the refreshed problem class.

Prints per-stage constraint residuals and (at small N) a full-joint f64
IPM optimum for the refreshed problem.  CPU, float64.
Usage: python tools/refresh_feas_probe.py [--agents 16]
"""
from __future__ import annotations

import os
import argparse
import sys
import time

import numpy as np


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=16)
    ap.add_argument("--polish", type=int, default=1)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import swarm_simulator_tpu as sst
    from swarm_simulator_tpu.corridor.rsfc import build_rsfc
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.io.mission_json import scatter_mission
    from swarm_simulator_tpu.qp import joint as qjoint
    from swarm_simulator_tpu.qp import nullspace as ns
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF
    from swarm_simulator_tpu.world.voxel import OccupancyGrid

    N = args.agents
    mission = scatter_mission(N, half=9.5, z=1.0, seed=7)
    param = sst.Param(world_x_min=-10, world_x_max=10, world_y_min=-10,
                      world_y_max=10, world_z_min=0.3, world_z_max=2.5,
                      grid_xy_res=0.5, grid_z_res=1.0,
                      sequential=True, batch_size=4, batch_iter=-1,
                      solver_dtype="float32")
    world = OccupancyGrid.empty(param.world_min, param.world_max,
                                param.world_resolution)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    M, n = plan.M, param.n
    log(f"M={M} pairs={len(plan.pair_idx)}")

    plan = qjoint.solve_trajectories(plan, mission, param,
                                     polish_rounds=args.polish)
    ctrl0 = np.asarray(plan.ctrl)
    log(f"cold obj={plan.solver_info['obj']}")

    def feas(data, tag, ctrl):
        """Constraint residuals of ctrl under data's (A, l, u)."""
        x = jnp.asarray(
            ctrl.reshape(N, M * (n + 1), 3).transpose(0, 2, 1),
            jnp.float32)
        pop = ns._pair_op(data)
        ax = ns._A_x(data, x, pop)
        l, u = ns._bounds(data, 0.0)
        for name in ("box", "pair"):
            a_, l_, u_ = (getattr(ax, name), getattr(l, name),
                          getattr(u, name))
            lo = float(jnp.max(jnp.maximum(l_ - a_, 0.0)))
            hi = float(jnp.max(jnp.maximum(a_ - u_, 0.0)))
            log(f"{tag} {name}: viol lo={lo:.3e} hi={hi:.3e}")

    data0, _ = qjoint.assemble_joint(plan, mission, param, dummy=ctrl0)
    d0 = jax.tree.map(jnp.asarray, data0)
    feas(d0, "original ", ctrl0)

    knots = np.concatenate([ctrl0[:, :, 0, :], ctrl0[:, -1:, -1, :]],
                           axis=1)
    _, normals = build_rsfc(knots, param.downwash)
    plan.pair_normals = np.asarray(normals, np.float64)
    data1, _ = qjoint.assemble_joint(plan, mission, param, dummy=ctrl0)
    d1 = jax.tree.map(jnp.asarray, data1)
    feas(d1, "refreshed", ctrl0)

    # how much did the normals move?
    n0 = np.asarray(data0.pair_n)
    n1 = np.asarray(data1.pair_n)
    cos = np.sum(n0 * n1, axis=-1) / (
        np.linalg.norm(n0, axis=-1) * np.linalg.norm(n1, axis=-1) + 1e-12)
    log(f"normal rotation: min cos={cos.min():.4f} "
        f"frac(cos<0.9)={np.mean(cos < 0.9):.3f}")

    # pair rhs comparison
    r0, r1 = np.asarray(data0.pair_rhs), np.asarray(data1.pair_rhs)
    log(f"pair_rhs: orig [{r0.min():.3f},{r0.max():.3f}] "
        f"refreshed [{r1.min():.3f},{r1.max():.3f}] "
        f"max diff={np.abs(r1 - r0).max():.3f}")

    # full-budget ADMM on the refreshed problem, from scratch vs warm
    ph = qjoint.production_phases(qjoint.budgets_for_swarm(N))
    t0 = time.perf_counter()
    x1, info = ns.solve_ns_phases(d1, ph)
    log(f"refreshed full ADMM: obj={float(info.obj):.4f} "
        f"r_prim={float(info.r_prim):.2e} r_dual={float(info.r_dual):.2e} "
        f"({time.perf_counter() - t0:.1f}s)")
    x0j, info0 = ns.solve_ns_phases(d0, ph)
    log(f"original  full ADMM: obj={float(info0.obj):.4f} "
        f"r_prim={float(info0.r_prim):.2e} r_dual={float(info0.r_dual):.2e}")


if __name__ == "__main__":
    main()
