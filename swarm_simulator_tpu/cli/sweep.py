"""CLI: benchmark sweep over stored worlds — the test_all equivalent.

Mirrors swarm_traj_planner_rbp_test_all.cpp:49-103: run the full pipeline
over worlds/map{1..50}.bt with one mission, printing per-stage runtimes
and per-map success; adds the scenario axis the reference lacks (several
maps' QPs batched on-device).

Usage:
  python -m swarm_simulator_tpu.cli.sweep --mission m.json \
      --worlds-dir /root/reference/swarm_planner/worlds --maps 1-50
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def parse_range(spec: str) -> list[int]:
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mission", required=True)
    p.add_argument("--worlds-dir", required=True)
    p.add_argument("--maps", default="1-50")
    p.add_argument("--world-min", type=float, nargs=3,
                   default=[-5.0, -5.0, 0.0])
    p.add_argument("--world-max", type=float, nargs=3, default=[5.0, 5.0, 2.5])
    p.add_argument("--grid-xy-res", type=float, default=0.5)
    p.add_argument("--grid-z-res", type=float, default=1.0)
    p.add_argument("--ecbs-w", type=float, default=1.5)  # plan_rbp_test.launch
    p.add_argument("--sequential", action="store_true")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--solver", choices=["admm", "nullspace"],
                   default="admm",
                   help="nullspace: the production joint whole-swarm "
                        "path per map (qp/joint.py)")
    p.add_argument("--platform", default=None)
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    import swarm_simulator_tpu as sst
    from swarm_simulator_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    from swarm_simulator_tpu.io.mission_json import load_mission
    from swarm_simulator_tpu.world.btree import load_bt_world

    mission = load_mission(args.mission)
    param = sst.Param(
        world_x_min=args.world_min[0], world_y_min=args.world_min[1],
        world_z_min=args.world_min[2], world_x_max=args.world_max[0],
        world_y_max=args.world_max[1], world_z_max=args.world_max[2],
        ecbs_w=args.ecbs_w, grid_xy_res=args.grid_xy_res,
        grid_z_res=args.grid_z_res, sequential=args.sequential,
        batch_size=args.batch_size, batch_iter=-1,
        solver_dtype=args.dtype, solver=args.solver)

    rows = []
    n_ok = 0
    for mi in parse_range(args.maps):
        path = Path(args.worlds_dir) / f"map{mi}.bt"
        if not path.exists():
            continue
        t0 = time.perf_counter()
        try:
            world = load_bt_world(path, param.world_min, param.world_max)
            result, times = sst.plan(mission, param, world)
            metrics = sst.evaluate(result, mission, param)
            ok = metrics["min_safety_ratio"] >= 1.0
            n_ok += ok
            row = {"map": mi, "ok": bool(ok),
                   "ratio": round(metrics["min_safety_ratio"], 4),
                   "esdf": round(times.esdf, 3),
                   "search": round(times.init_traj, 3),
                   "corridor": round(times.corridor, 3),
                   "qp": round(times.qp, 3),
                   "total": round(time.perf_counter() - t0, 3)}
        except Exception as e:  # infeasible map for this mission
            row = {"map": mi, "ok": False, "error": f"{type(e).__name__}: {e}",
                   "total": round(time.perf_counter() - t0, 3)}
        rows.append(row)
        print(json.dumps(row) if args.json else row, flush=True)

    print(f"# success {n_ok}/{len(rows)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
