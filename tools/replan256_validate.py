"""Oracle-licensed FAST 256-agent replan.

Production flow at the top rung: cold solve + polish rounds reach the
oracle standard (tools/oracle256_study.py); the streaming replanner then refreshes the RSFC
corridors from the flown solution and re-solves WARM.  This script
measures the replan cycle (device prep + solve) at short budget
schedules, with and without kkt_refine, and gates EACH replanned
solution against the rotating IPM best-response oracle — licensing the
cheapest <5 s cycle whose worst margin stays <= 1.25.

Writes benchmarks/replan256_oracle_gpu.json.
Usage: python tools/replan256_validate.py [--cpu]
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


ORACLE_BATCHES = (0, 17, 34, 51)
ARMS = (((50, 200, 50), 0), ((50, 200, 50), 1), ((100, 300, 100), 0))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--polish", type=int, default=4)
    ap.add_argument("--out", default="benchmarks/replan256_oracle_gpu.json")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from swarm_simulator_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import bench
    import swarm_simulator_tpu as sst
    from swarm_simulator_tpu.corridor.rsfc import build_rsfc
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.io.mission_json import scatter_mission
    from swarm_simulator_tpu.qp import convert
    from swarm_simulator_tpu.qp import joint as qjoint
    from swarm_simulator_tpu.qp import nullspace
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF
    from swarm_simulator_tpu.world.voxel import OccupancyGrid

    N = 256
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
    log(f"M={plan.M} pairs={len(plan.pair_idx)}")
    M, n = plan.M, param.n

    # ---- production cold start: full budgets + polish rounds ---------
    t0 = time.perf_counter()
    plan = qjoint.solve_trajectories(plan, mission, param,
                                     cold_prep="device",
                                     polish_rounds=args.polish)
    t_cold = time.perf_counter() - t0
    ctrl0 = np.asarray(plan.ctrl)
    log(f"cold+polish({args.polish}): {t_cold:.1f}s "
        f"obj={plan.solver_info['obj'][0]:.3f}")

    # ---- corridor refresh from the flown solution ---------------------
    knots = np.concatenate([ctrl0[:, :, 0, :], ctrl0[:, -1:, -1, :]],
                           axis=1)
    _, normals = build_rsfc(knots, param.downwash)
    plan.pair_normals = np.asarray(normals, np.float64)
    data1, _ = qjoint.assemble_joint(plan, mission, param, dummy=ctrl0)
    d1_dev = jax.tree.map(jnp.asarray, data1)
    jax.block_until_ready(d1_dev.pair_rhs)

    def measure(ctrl, tag):
        ok, m = bench.gate_quality(ctrl, plan, mission, param)
        margins = {}
        for b_idx in ORACLE_BATCHES:
            obj_b0, _ = bench.batch0_objective(ctrl, plan, mission,
                                               param, b_idx)
            obj_ref, dt = bench.ipm_best_response_batch0(
                plan, mission, param, ctrl, b_idx)
            margins[b_idx] = round(obj_b0 / obj_ref, 4)
            log(f"{tag} batch {b_idx}: margin={margins[b_idx]:.3f} "
                f"({dt:.0f}s IPM)")
        return ok, m, margins

    rows = []
    for budgets, refine in ARMS:
        rph = qjoint.production_phases(budgets, kkt_refine=refine)
        prep_jit = jax.jit(lambda d, ph=rph: nullspace.prepare_ns(d, ph[0]))
        solve_jit = jax.jit(
            lambda d, o, ph=rph: nullspace.solve_ns_phases(d, ph, op=o))
        # compile pass (fresh op each time; release before re-prep)
        op_r = None
        op_r = prep_jit(d1_dev)
        jax.block_until_ready(op_r.Dinvs)
        x_r, _ = solve_jit(d1_dev, op_r)
        np.asarray(x_r)
        # timed warm cycle
        best = np.inf
        for rr in range(2):
            dj = dataclasses.replace(
                d1_dev, x0=d1_dev.x0 + jnp.float32(3.1e-6 * (rr + 1)))
            op_r = None
            t0 = time.perf_counter()
            op_r = prep_jit(dj)
            x_r, info = solve_jit(dj, op_r)
            x_r = np.asarray(x_r, np.float64)
            best = min(best, time.perf_counter() - t0)
        ctrl_r = convert.x_to_ctrl(x_r, M, n)
        tag = f"budgets={budgets} refine={refine}"
        ok, m, margins = measure(ctrl_r, tag)
        worst = max(margins.values())
        log(f"{tag}: cycle {best:.2f}s gate={'OK' if ok else 'FAIL'} "
            f"ratio={m['ratio']:.4f} worst-margin={worst:.3f}")
        rows.append(dict(budgets=list(budgets), kkt_refine=refine,
                         cycle_s=round(best, 2), gate_ok=bool(ok),
                         ratio=round(m["ratio"], 4),
                         margins={str(k): v for k, v in margins.items()},
                         worst_margin=worst,
                         iters=int(np.asarray(info.iters))))
        op_r = None

    licensed = [r for r in rows
                if r["gate_ok"] and r["worst_margin"] <= 1.25]
    licensed = (min(licensed, key=lambda r: r["cycle_s"])
                if licensed else None)
    out = dict(agents=N, M=int(M), pairs=int(len(plan.pair_idx)),
               cold_polish_rounds=args.polish,
               cold_s=round(t_cold, 1), arms=rows,
               licensed=licensed)
    os.makedirs("benchmarks", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
