"""Virtual-mesh scaling of the SHARDED joint solve (qp/nullspace_shard).

Two measurements on the xla_force_host_platform_device_count CPU mesh:

A. 64-agent forest, full production budgets, n = 1/2/4/8 shards:
   gate-checked solution + warm solve time per n.  CAVEAT for reading
   the times: the virtual devices SHARE 4 physical cores, so sharding
   cannot show wall-clock speedup here — per-device REDUNDANT work
   (the replicated [B,3,D] updates) plus collective overhead is what
   the curve exposes.  What the mesh buys on real hardware is
   per-device pivot MEMORY (inventory/n) and matvec FLOPs/device; per-
   device bytes are reported analytically per n.

B. --full256: the BASELINE ladder top rung as ONE sharded QP —
   256 agents, 32,640 pairs, 5-rung host-f64 prep (~7.5 GB f32 pivot
   inventory, ~0.94 GB/device at n=8), full budgets, FULL safety gate.
   tools/large_swarm_joint.py's single-device solve is the quality
   reference: same seed, same recipe -> same problem (M=72).

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/shard_scale_study.py [--full256]
"""
from __future__ import annotations

import os
import argparse
import dataclasses
import json
import sys
import time

import numpy as np


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full256", action="store_true")
    ap.add_argument("--mode", default="chunk",
                    choices=["chunk", "blockrow", "spike"])
    ap.add_argument("--out", default="benchmarks/shard_scale_cpu.json")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from swarm_simulator_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    from jax.sharding import Mesh

    sys.path.insert(0, ".")
    import bench
    from swarm_simulator_tpu.qp import joint as qjoint
    from swarm_simulator_tpu.qp import nullspace, nullspace_shard

    out = {"devices": len(jax.devices()), "mode": args.mode,
           "curve64": []}

    # ---- A: 64-agent curve ------------------------------------------
    plan, mission, param = bench.build_problem(seed=0)
    data, _ = bench.assemble_joint(plan, mission, param)
    phases = qjoint.production_phases()
    t0 = time.perf_counter()
    op = nullspace.prepare_ns_np(data, phases[0])
    prep_s = time.perf_counter() - t0
    inv_bytes = int(np.asarray(op.Dinvs).nbytes)
    log(f"64-agent prep {prep_s:.1f}s, inventory {inv_bytes / 1e6:.0f} MB")

    import jax.numpy as jnp

    for n in (1, 2, 4, 8):
        if n > len(jax.devices()):
            break
        if args.mode == "spike" and n == 1:
            continue               # substructuring needs >= 2 chunks
        mesh = Mesh(np.array(jax.devices()[:n]), ("kkt",))
        if args.mode == "spike":
            # the SPIKE operator is n-specific (per-chunk chains +
            # separator Schur system)
            t0 = time.perf_counter()
            op_n = nullspace_shard.prepare_spike_np(data, phases[0], n)
            log(f"spike prep n={n}: {time.perf_counter() - t0:.1f}s")
        else:
            op_n = op
        d_dev, o_dev = nullspace_shard.place(data, op_n, mesh,
                                             mode=args.mode)
        t0 = time.perf_counter()
        x, info = nullspace_shard.solve_ns_phases_sharded(
            d_dev, phases, o_dev, mesh, mode=args.mode)
        x = np.asarray(x, np.float64)
        first_s = time.perf_counter() - t0
        times = []
        for rr in range(2):
            d2 = dataclasses.replace(
                d_dev, x0=d_dev.x0 + jnp.float32(3e-6 * (rr + 1)))
            t0 = time.perf_counter()
            x2, _ = nullspace_shard.solve_ns_phases_sharded(
                d2, phases, o_dev, mesh, mode=args.mode)
            np.asarray(x2)
            times.append(time.perf_counter() - t0)
        ctrl = x.transpose(0, 2, 1).reshape(64, plan.M, param.n + 1, 3)
        ok, m = bench.gate_quality(ctrl, plan, mission, param)
        row = dict(n=n, gate_ok=bool(ok), ratio=round(m["ratio"], 4),
                   solve_warm_s=round(min(times), 2),
                   solve_first_s=round(first_s, 2),
                   inv_mb_per_device=round(inv_bytes / n / 1e6, 1))
        if args.mode == "spike":
            row["spike_inv_mb_per_device"] = round(
                (np.asarray(o_dev.Dloc).nbytes / n
                 + np.asarray(o_dev.Ssch).nbytes
                 + np.asarray(o_dev.Soff).nbytes) / 1e6, 1)
        log(row)
        out["curve64"].append(row)

    # ---- B: 256 agents sharded --------------------------------------
    if args.full256:
        import swarm_simulator_tpu as sst
        from swarm_simulator_tpu.corridor.times import build_corridors
        from swarm_simulator_tpu.io.mission_json import scatter_mission
        from swarm_simulator_tpu.qp import assemble
        from swarm_simulator_tpu.search.planner import (
            plan_initial_trajectories)
        from swarm_simulator_tpu.world.esdf import ESDF
        from swarm_simulator_tpu.world.voxel import OccupancyGrid

        N = 256
        mission = scatter_mission(N, half=9.5, z=1.0, seed=7)
        param = sst.Param(world_x_min=-10, world_x_max=10,
                          world_y_min=-10, world_y_max=10,
                          world_z_min=0.3, world_z_max=2.5,
                          grid_xy_res=0.5, grid_z_res=1.0,
                          sequential=True, batch_size=4, batch_iter=-1,
                          solver_dtype="float32")
        world = OccupancyGrid.empty(param.world_min, param.world_max,
                                    param.world_resolution)
        esdf = ESDF(world, max_dist=param.esdf_max_dist)
        plan = plan_initial_trajectories(esdf, mission, param)
        build_corridors(esdf, plan, mission.radius, param)
        log(f"256-agent M={plan.M} pairs={len(plan.pair_idx)}")
        dummy = assemble.build_dummy(plan.init_traj, param.n)
        data = assemble.assemble_batch(plan, mission, param,
                                       np.arange(N), dummy, device=False)
        base = nullspace.NSSettings(
            max_iter=1500, check_every=50, eps_abs=2e-4, eps_rel=2e-4,
            eps_dual_abs=5e-3, tighten=2e-3, warm_start="x0",
            kkt_mode="banded", rho_min=3e-5, n_rungs=5)
        ph = (dataclasses.replace(base, max_iter=200, rho_lo=1e-3),
              dataclasses.replace(base, max_iter=600),
              dataclasses.replace(base, max_iter=100, rho_lo=1e-2))
        t0 = time.perf_counter()
        op = nullspace.prepare_ns_np(data, ph[0])
        prep256 = time.perf_counter() - t0
        inv256 = int(np.asarray(op.Dinvs).nbytes)
        log(f"256-agent prep {prep256:.0f}s, inventory "
            f"{inv256 / 1e9:.2f} GB")
        n = len(jax.devices())
        mesh = Mesh(np.array(jax.devices()[:n]), ("kkt",))
        t0 = time.perf_counter()
        x, info = nullspace_shard.solve_ns_phases_sharded(
            data, ph, op, mesh, mode=args.mode)
        x = np.asarray(x, np.float64)
        solve256 = time.perf_counter() - t0
        ctrl = x.transpose(0, 2, 1).reshape(N, plan.M, param.n + 1, 3)
        ok, m = bench.gate_quality(ctrl, plan, mission, param)
        obj = float(np.asarray(info.iters)), float(np.asarray(info.obj))
        log(f"256 sharded: gate={'OK' if ok else 'FAIL'} "
            f"solve={solve256:.0f}s ratio={m['ratio']:.4f} "
            f"box={m['box_viol']:.1e} obj={obj[1]:.3f}")
        out["sharded256"] = dict(
            n_devices=n, gate_ok=bool(ok), M=int(plan.M),
            pairs=int(len(plan.pair_idx)),
            prep_s=round(prep256, 1), solve_s=round(solve256, 1),
            ratio=round(m["ratio"], 4), box_viol=m["box_viol"],
            obj=round(obj[1], 4),
            inv_gb_total=round(inv256 / 1e9, 2),
            inv_gb_per_device=round(inv256 / n / 1e9, 3))

    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
