"""Parity sweep: every mission JSON shipped with the reference, planned
end-to-end by this framework (CPU float64, sequential batching for the
larger swarms), results to benchmarks/mission_sweep_cpu_f64.jsonl.

The reference's launch files pair missions with specific worlds; here every
mission runs in the empty default 10x10x2.5 world (the launch default,
plan_rbp_random_forest.launch:23-28), which all mission start/goal points
fit inside."""
import argparse
import glob
import json
import os
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import swarm_simulator_tpu as sst  # noqa: E402
from swarm_simulator_tpu.io.mission_json import load_mission  # noqa: E402


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--solver", choices=["admm", "nullspace"],
                    default="admm",
                    help="nullspace: the JOINT production path per "
                         "mission (qp/joint.py, float32)")
    args = ap.parse_args()
    out_path = ("benchmarks/mission_sweep_cpu_f64.jsonl"
                if args.solver == "admm"
                else "benchmarks/mission_sweep_joint_cpu.jsonl")
    os.makedirs("benchmarks", exist_ok=True)
    rows = []
    for mf in sorted(glob.glob(
            "/root/reference/swarm_planner/missions/*.json")):
        name = os.path.basename(mf)
        mission = load_mission(mf)
        N = mission.qn
        seq = N > 8
        # world AABB sized to the mission (the launch files pair each
        # mission with a world; the _aty missions span x in [-8, 8])
        pts = np.concatenate([mission.start[:, :3], mission.goal[:, :3]])
        lo = np.minimum(pts.min(axis=0) - 1.0, [-5.0, -5.0, 0.0])
        hi = np.maximum(pts.max(axis=0) + 1.0, [5.0, 5.0, 2.5])
        # EDT saturation must exceed the obstacle threshold r+margin, or
        # every cell reads as blocked (the reference hard-codes maxDist=1,
        # swarm_traj_planner_rbp.cpp:77, and genuinely fails the r=1.2
        # mission_8agents_120 this way)
        rmax = float(np.max(mission.radius))
        param = sst.Param(world_x_min=float(lo[0]), world_y_min=float(lo[1]),
                          world_z_min=0.0, world_x_max=float(hi[0]),
                          world_y_max=float(hi[1]), world_z_max=float(hi[2]),
                          solver_dtype="float64",
                          grid_xy_res=0.5, grid_z_res=1.0,
                          esdf_max_dist=max(1.0, rmax + 0.2 + 0.1),
                          sequential=seq, batch_size=4, batch_iter=-1,
                          solver=args.solver)
        if args.solver == "nullspace":
            # the production joint path (f32, host-f64 prep); ignores
            # sequential/batch_size
            import dataclasses
            param = dataclasses.replace(param, solver_dtype="float32")
        t0 = time.perf_counter()
        try:
            result, times = sst.plan(mission, param)
            metrics = sst.evaluate(result, mission, param)
            row = {"mission": name, "agents": N, "M": int(result.M),
                   "makespan": float(result.T[-1]),
                   "min_safety_ratio": round(
                       float(metrics["min_safety_ratio"]), 4),
                   "flight_distance": round(
                       float(metrics["flight_distance"]), 1),
                   "goal_err": float(metrics["goal_err"]),
                   "wall_s": round(time.perf_counter() - t0, 1),
                   "ok": bool(metrics["min_safety_ratio"] >= 1.0
                              and metrics["goal_err"] < 1e-4)}
        except Exception as e:  # infeasible search etc.
            row = {"mission": name, "agents": N, "error": str(e)[:120],
                   "wall_s": round(time.perf_counter() - t0, 1),
                   "ok": False}
        rows.append(row)
        log(row)
    with open(out_path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    n_ok = sum(r["ok"] for r in rows)
    log(f"{n_ok}/{len(rows)} missions planned collision-free")


if __name__ == "__main__":
    main()
