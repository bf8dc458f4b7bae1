"""256-agent objective oracle: rotating-batch IPM best-response gate.

Above 64 agents the only other objective yardstick is the solver's
own full-budget solve (self-referential).  The f64 IPM best-response
oracle (bench.ipm_best_response_batch0) is tractable at 256 agents —
the reduced sparse program is ~2556 unknowns x ~450k sparse rows,
tens of seconds per VERIFIED solve on a host CPU.

This study solves the canonical 256-agent problem (scatter seed 7, as
tools/large_swarm_joint.py) at several phase-budget schedules and
gates EACH against the IPM
optimum of ROTATING 4-agent best-response QPs (stride-spread batches,
everyone else fixed at our solution).  The cheapest schedule whose
worst margin stays <= the 1.25 gate bound licenses the fast 256-agent
replan (qp/joint.budgets_for_swarm).

Usage: python tools/oracle256_study.py [--cpu] [--budgets-list ...]
Writes benchmarks/oracle256_gpu.json (or _cpu when --cpu).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


#: 8 rotating batches
#: (32 of 256 agents covered by the rotation)
ORACLE_BATCHES = (0, 9, 17, 26, 34, 43, 51, 60)   # of 64 batches


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--agents", type=int, default=256)
    ap.add_argument("--budgets-list",
                    default="200,600,100;100,400,100;100,300,100")
    ap.add_argument("--escalate", type=int, default=0,
                    help="after each schedule whose worst margin exceeds "
                         "1.25, run up to K warm polish-extension rounds "
                         "(qp/joint ESCALATION_BUDGETS, dummy=solution) "
                         "and re-measure")
    ap.add_argument("--polish", type=int, default=0,
                    help="solve with solve_trajectories(polish_rounds=K) "
                         "— the efficient in-solver escalation (operator "
                         "stays device-resident; only x0 updates); "
                         "margins measured once at the end")
    ap.add_argument("--rho-min", type=float, default=None,
                    help="override the rho-ladder floor (default 1e-5); "
                         "a lower floor deepens the objective polish")
    ap.add_argument("--out", default=None)
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
    from swarm_simulator_tpu.qp import joint as qjoint
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
    plan0 = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan0, mission.radius, param)
    log(f"M={plan0.M} pairs={len(plan0.pair_idx)}")

    schedules = [tuple(int(x) for x in b.split(","))
                 for b in args.budgets_list.split(";")]
    def measure(plan, ctrl, tag):
        ok, m = bench.gate_quality(ctrl, plan, mission, param)
        margins = {}
        ipm_s = []
        for b_idx in ORACLE_BATCHES:
            obj_b0, _ = bench.batch0_objective(ctrl, plan, mission,
                                               param, b_idx)
            t0 = time.perf_counter()
            obj_ref, dt = bench.ipm_best_response_batch0(
                plan, mission, param, ctrl, b_idx)
            ipm_s.append(dt)
            margins[b_idx] = round(obj_b0 / obj_ref, 4)
            log(f"{tag} batch {b_idx}: ours={obj_b0:.4f} "
                f"ipm={obj_ref:.4f} margin={margins[b_idx]:.3f} "
                f"({dt:.0f}s IPM)")
        return ok, m, margins, float(np.mean(ipm_s))

    rows = []
    for budgets in schedules:
        import copy
        import dataclasses as dc
        plan = copy.deepcopy(plan0)
        base = qjoint.production_settings()
        if args.rho_min is not None:
            base = dc.replace(base, rho_min=args.rho_min)
        phases = qjoint.production_phases(budgets, base=base)
        t0 = time.perf_counter()
        plan = qjoint.solve_trajectories(plan, mission, param,
                                         phases=phases,
                                         cold_prep="device",
                                         polish_rounds=args.polish)
        t_cycle = time.perf_counter() - t0
        prep_s = plan.solver_info["prep_s"]
        ctrl = np.asarray(plan.ctrl)
        ok, m, margins, ipm_mean = measure(plan, ctrl, f"budgets={budgets}")
        worst = max(margins.values())
        log(f"budgets={budgets}: gate={'OK' if ok else 'FAIL'} "
            f"ratio={m['ratio']:.4f} prep {prep_s:.1f}s solve "
            f"{t_cycle - prep_s:.1f}s worst-margin={worst:.3f}")
        row = dict(
            budgets=list(budgets), gate_ok=bool(ok),
            polish_rounds=args.polish,
            polish_s=round(plan.solver_info.get("polish_s", 0.0), 2),
            rho_min=args.rho_min,
            ratio=round(m["ratio"], 4), box_viol=float(m["box_viol"]),
            prep_s=round(prep_s, 2), solve_s=round(t_cycle - prep_s, 2),
            obj=plan.solver_info["obj"][0],
            iters=plan.solver_info["iters"],
            margins={str(k): v for k, v in margins.items()},
            worst_margin=worst,
            ipm_s_mean=round(ipm_mean, 1))

        esc_rounds = []
        for r in range(args.escalate):
            if worst <= 1.25:
                break
            esc_ph = qjoint.production_phases(qjoint.ESCALATION_BUDGETS)
            t0 = time.perf_counter()
            plan = qjoint.solve_trajectories(plan, mission, param,
                                             phases=esc_ph,
                                             cold_prep="device",
                                             dummy=ctrl)
            dt = time.perf_counter() - t0
            ctrl = np.asarray(plan.ctrl)
            ok, m, margins, ipm_mean = measure(plan, ctrl,
                                               f"esc{r} of {budgets}")
            worst = max(margins.values())
            log(f"esc{r} of {budgets}: gate={'OK' if ok else 'FAIL'} "
                f"worst-margin={worst:.3f} cycle {dt:.1f}s "
                f"obj={plan.solver_info['obj'][0]:.3f}")
            esc_rounds.append(dict(
                gate_ok=bool(ok), worst_margin=worst,
                margins={str(k): v for k, v in margins.items()},
                cycle_s=round(dt, 1), obj=plan.solver_info["obj"][0]))
        if esc_rounds:
            row["escalation_rounds"] = esc_rounds
        rows.append(row)

    def final_margin(r):
        er = r.get("escalation_rounds")
        return er[-1]["worst_margin"] if er else r["worst_margin"]

    licensed = [r["budgets"] for r in rows
                if r["gate_ok"] and final_margin(r) <= 1.25]
    licensed = min(licensed, key=lambda b: sum(b)) if licensed else None
    out = dict(agents=N, M=int(plan0.M), pairs=int(len(plan0.pair_idx)),
               oracle_batches=list(ORACLE_BATCHES), schedules=rows,
               licensed_budgets=licensed)
    path = args.out or ("benchmarks/oracle256_cpu.json" if args.cpu
                        else "benchmarks/oracle256_gpu.json")
    os.makedirs("benchmarks", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
