"""BASELINE ladder top rung: the 256-agent problem as ONE JOINT QP (all
32,640 pair constraints simultaneously active) via the knot-state
banded KKT — the segment-axis factorization whose memory is
O(R · M · (3·B·phi)²) instead of the 6.9 GB stacked dense inverses that
forced CG mode in the sequential path.

Quality gate: safety ratio >= 1, machine-exact C²/endpoints (knot-state
construction), box containment, AND total jerk objective <= the
sequential Gauss-Seidel solution's (the joint optimum must dominate the
consensus solution).  Round 4 note: the 64-agent IPM best-response
oracle turned out to be TRACTABLE at 256 agents after all (the reduced
sparse program is ~27 s/verified solve — the old "dense 18 GB" concern
predated ipm.solve_ipm_reduced's sparse Cw); tools/oracle256_study.py
now applies it with rotating batches.

Usage: python tools/large_swarm_joint.py [--agents 256] [--cpu]
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
    ap.add_argument("--agents", type=int, default=256)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rungs", type=int, default=5)
    ap.add_argument("--rho-min", type=float, default=3e-5)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from swarm_simulator_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import swarm_simulator_tpu as sst
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.eval.safety import safety_margin_ratio
    from swarm_simulator_tpu.eval.sample import (sample_times,
                                                 sample_trajectories)
    from swarm_simulator_tpu.io.mission_json import scatter_mission
    from swarm_simulator_tpu.parallel import seqbatch
    from swarm_simulator_tpu.qp import assemble, convert, nullspace
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

    t0 = time.perf_counter()
    plan = plan_initial_trajectories(esdf, mission, param)
    t_search = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_corridors(esdf, plan, mission.radius, param)
    t_corridor = time.perf_counter() - t0
    log(f"search {t_search:.1f}s corridor {t_corridor:.1f}s "
        f"M={plan.M} pairs={len(plan.pair_idx)}")

    # ---- sequential GS reference solution (objective yardstick) ------
    t0 = time.perf_counter()
    seqbatch.solve_trajectories(plan, mission, param, None)
    t_seq = time.perf_counter() - t0
    ctrl_seq = np.asarray(plan.ctrl)
    log(f"sequential GS: {t_seq:.1f}s")

    # ---- joint assembly + host-f64 banded prep -----------------------
    dummy = assemble.build_dummy(plan.init_traj, param.n)
    t0 = time.perf_counter()
    data = assemble.assemble_batch(plan, mission, param, np.arange(N),
                                   dummy, device=False)
    t_asm = time.perf_counter() - t0
    log(f"joint assembly {t_asm:.1f}s")

    base = nullspace.NSSettings(
        max_iter=1500, check_every=50, eps_abs=2e-4, eps_rel=2e-4,
        eps_dual_abs=5e-3, tighten=2e-3, warm_start="x0",
        kkt_mode="banded", rho_min=args.rho_min, n_rungs=args.rungs)
    phases = (dataclasses.replace(base, max_iter=200, rho_lo=1e-3),
              dataclasses.replace(base, max_iter=600),
              dataclasses.replace(base, max_iter=100, rho_lo=1e-2))

    t0 = time.perf_counter()
    op = nullspace.prepare_ns_np(data, phases[0])
    t_prep = time.perf_counter() - t0
    log(f"host-f64 banded prep {t_prep:.1f}s "
        f"Dinvs {op.Dinvs.shape} = {op.Dinvs.nbytes / 1e9:.1f} GB f64"
        f" -> {op.Dinvs.nbytes / 2e9:.1f} GB f32")

    t0 = time.perf_counter()
    data_dev = jax.tree.map(jnp.asarray, data)
    op_dev = jax.device_put(op)
    jax.block_until_ready(op_dev.Dinvs)
    t_xfer = time.perf_counter() - t0
    log(f"transfer {t_xfer:.1f}s")

    @jax.jit
    def joint_solve(d, o, jv):
        dd = dataclasses.replace(d, x0=d.x0 + jv)
        return nullspace.solve_ns_phases(dd, phases, op=o)

    def cycle(jv):
        x, info = joint_solve(data_dev, op_dev, jnp.float32(jv))
        return np.asarray(x, np.float64), info

    t0 = time.perf_counter()
    x, info = cycle(0.0)
    t_first = time.perf_counter() - t0
    log(f"first joint cycle (incl compile) {t_first:.1f}s "
        f"iters={int(info.iters)} rp={float(info.r_prim):.1e}")

    ctrl = x.transpose(0, 2, 1).reshape(N, plan.M, param.n + 1, 3)

    # ---- quality ------------------------------------------------------
    def total_jerk(cm):
        Qseg = np.asarray(data.Qseg, np.float64)
        c = np.asarray(cm, np.float64)
        return float(np.einsum("bmik,mij,bmjk->", c, Qseg, c) * 0.5)

    def metrics(cm):
        coef = convert.ctrl_to_coef(np.asarray(cm, np.float64), plan.T,
                                    param.n)
        ts = sample_times(np.asarray(plan.T), 0.1)
        pos = np.asarray(sample_trajectories(
            jnp.asarray(coef), jnp.asarray(np.asarray(plan.T)),
            jnp.asarray(ts), n=param.n, derivatives=1))[:, :, 0]
        ratio = float(safety_margin_ratio(
            jnp.asarray(pos), jnp.asarray(mission.radius),
            downwash=param.downwash))
        return ratio

    obj_joint = total_jerk(ctrl)
    obj_seq = total_jerk(ctrl_seq)
    ratio_joint = metrics(ctrl)
    boxes = plan.seg_boxes
    viol = float(np.maximum(boxes[:, :, None, :3] - ctrl,
                            ctrl - boxes[:, :, None, 3:]).max())
    cont = float(np.abs(ctrl[:, 1:, 0] - ctrl[:, :-1, -1]).max())
    ok = (ratio_joint >= 1.0 and viol < 1e-3 and cont < 1e-3
          and obj_joint <= obj_seq * 1.02)
    log(f"joint: ratio={ratio_joint:.4f} box_viol={viol:.1e} "
        f"cont={cont:.1e} obj={obj_joint:.3f} vs seq obj={obj_seq:.3f} "
        f"-> gate {'OK' if ok else 'FAIL'}")

    # ---- timing -------------------------------------------------------
    reps = 2
    t0 = time.perf_counter()
    for r in range(reps):
        cycle(2.7e-6 * (r + 1))
    dt = (time.perf_counter() - t0) / reps
    log(f"steady joint cycle: {dt:.2f}s")

    os.makedirs("benchmarks", exist_ok=True)
    out = {"agents": N, "M": int(plan.M), "pairs": int(len(plan.pair_idx)),
           "rungs": int(args.rungs), "bs": int(N * 9),
           "t_search_s": round(t_search, 2),
           "t_corridor_s": round(t_corridor, 2),
           "t_assemble_s": round(t_asm, 2),
           "t_prep_s": round(t_prep, 1),
           "t_transfer_s": round(t_xfer, 1),
           "t_cycle_s": round(dt, 2),
           "safety_ratio": round(ratio_joint, 4),
           "obj_joint": round(obj_joint, 4),
           "obj_sequential": round(obj_seq, 4),
           "gate_ok": bool(ok),
           "seq_cycle_ref_s": round(t_seq, 1),
           "platform": jax.default_backend()}
    path = f"benchmarks/swarm{N}_joint_{jax.default_backend()}.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    log(f"wrote {path}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
