"""32-agent FULL-JOINT best-response anchor for the 256-agent oracle:
the rotating oracle solves 4-agent
batches; this computes the exact f64 IPM optimum of a WHOLE 32-AGENT
GROUP's joint best-response QP at 256-agent density (everyone outside
the group fixed at the production solution — the same one-sided pair
rows as rbp_planner.hpp:638-684, at 8x the rotation's group size).

The 64-agent headline has an analogous 16-agent full-joint parity
point (tests/test_joint.py); this is the committed 256-agent
equivalent.  The reduced (knot-state) IPM system for 32 agents at
M=72 is ~20.4k unknowns dense — ~10s-1min per Newton factorization on
this host, tens of iterations: a one-time golden artifact, not a CI
job.

Writes benchmarks/oracle256_anchor.json.
Usage: timeout 21000 python tools/oracle256_anchor.py [--groups 0,112]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", default="0,112",
                    help="comma list of group START agents (32 each)")
    ap.add_argument("--group-size", type=int, default=32)
    ap.add_argument("--cpu", action="store_true",
                    help="solve the production joint on CPU too")
    ap.add_argument("--method", choices=["activeset", "ipm"],
                    default="activeset",
                    help="exact best-response solver: the active-set "
                         "polish (qp/activeset.py — minutes, certified"
                         ") or the f64 barrier (hours at this size: a "
                         "6600 s run died inside group 0's solve)")
    ap.add_argument("--out", default="benchmarks/oracle256_anchor.json")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from swarm_simulator_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()

    import bench
    import swarm_simulator_tpu as sst
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.io.mission_json import scatter_mission
    from swarm_simulator_tpu.qp import assemble, ipm
    from swarm_simulator_tpu.qp import joint as qjoint
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF
    from swarm_simulator_tpu.world.voxel import OccupancyGrid

    N, G = 256, args.group_size
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

    # production joint solve — THE DEFAULT PATH (auto polish for big
    # swarms, qp/joint.polish_rounds_for_swarm), device prep
    t0 = time.perf_counter()
    plan = qjoint.solve_trajectories(plan, mission, param,
                                     cold_prep="device")
    t_solve = time.perf_counter() - t0
    ctrl = np.asarray(plan.ctrl)
    ok, m = bench.gate_quality(ctrl, plan, mission, param)
    log(f"production solve {t_solve:.0f}s gate={'OK' if ok else 'FAIL'} "
        f"ratio={m['ratio']:.4f} "
        f"polish={plan.solver_info['polish_rounds']}")

    rows = []
    for start in (int(a) for a in args.groups.split(",")):
        agents = np.arange(start, start + G)
        dummy = np.asarray(ctrl, np.float64)
        data_g = assemble.assemble_batch(plan, mission, param, agents,
                                         dummy, device=False)
        data_g = jax.tree.map(
            lambda v: np.asarray(v, np.float64)
            if np.asarray(v).dtype in (np.float32, np.float64)
            else np.asarray(v), data_g)
        lb_r, ub_r = assemble.relax_thin_knot_rows(data_g.lb, data_g.ub,
                                                   param.n)
        data_g = dataclasses.replace(data_g, lb=lb_r, ub=ub_r)

        # our group objective
        Qseg = np.asarray(data_g.Qseg, np.float64)
        cg = dummy[agents]
        obj_ours = float(np.einsum("bmik,mij,bmjk->", cg, Qseg, cg)
                         * 0.5)

        t0 = time.perf_counter()
        if args.method == "ipm":
            res = ipm.solve_ipm_reduced(data_g, max_iter=120)
            t_ref = time.perf_counter() - t0
            ver = ipm.verify_optimal(data_g, res, tol=1e-5)
            Q, E, d_, C, c_, _ = ipm.build_flat(data_g)
            xo = res.x.reshape(-1)
            obj_ref = float(0.5 * xo @ (Q @ xo))
            detail = dict(ipm_iters=int(res.iters), ipm_mu=float(res.mu),
                          kkt_verified={k: float(v)
                                        for k, v in ver.items()}
                          if isinstance(ver, dict) else True)
        else:
            from swarm_simulator_tpu.qp import activeset
            cg_p, ai = activeset.polish_ctrl(data_g, cg,
                                             max_passes=300)
            t_ref = time.perf_counter() - t0
            if not ai["accepted"]:
                log(f"group {start}: polish rejected ({ai.get('reason')})"
                    " — keeping obj_ours as obj_ref bound")
            obj_ref = float(ai.get("obj_out", obj_ours))
            detail = dict(
                as_passes=ai["passes"], as_active=ai.get("n_active"),
                as_certified=bool(ai.get("kkt_optimal")),
                as_accepted=bool(ai["accepted"]),
                as_r_stat=float(ai.get("r_stat", float("inf"))),
                as_worst_slack=float(ai.get("worst_slack_out", 0.0)))
        margin = obj_ours / obj_ref if obj_ref > 0 else float("nan")
        log(f"group {start}..{start + G - 1}: ours={obj_ours:.4f} "
            f"ref={obj_ref:.4f} margin={margin:.4f} "
            f"({t_ref / 60:.1f} min, {args.method})")
        rows.append(dict(
            group_start=int(start), group_size=G, method=args.method,
            obj_ours=round(obj_ours, 5), obj_ref=round(obj_ref, 5),
            margin=round(margin, 4), ref_minutes=round(t_ref / 60, 1),
            **detail))

        # incremental write: each finished group is a committed-quality
        # anchor on its own; a wall-clock cap mid-study keeps the rows
        # already solved
        out = dict(
            agents=N, M=int(M), pairs=int(len(plan.pair_idx)),
            note=(f"{G}-agent full-joint exact best-response anchors "
                  f"({args.method}) at 256-agent density; production "
                  "path = the DEFAULT solve_trajectories recipe "
                  "(auto polish)"),
            gate_ok=bool(ok), ratio=round(m["ratio"], 4),
            solve_s=round(t_solve, 1),
            polish_rounds=plan.solver_info["polish_rounds"],
            anchors=rows,
            worst_margin=max(r["margin"] for r in rows))
        os.makedirs("benchmarks", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
