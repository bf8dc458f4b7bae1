"""Isolate the f32 rung-inverse / f32-iteration precision wall.

Replans at 256 agents sit 1.8-3.9x above the rotating IPM
best-response oracle at short budgets, and the round-4 probe fingered
the f32 rung inverses.  This study separates the candidate walls on
ONE refreshed-corridor problem (the replan problem class):

  arm "f32-hostprep"   f32 data, host-f64 prep (prepare_ns_np),
                       full budgets       -> the cold-quality standard
  arm "f64-full"       float64 END TO END (data, prep, iteration),
                       full budgets       -> removes every f32 effect;
                       if this arm's margin is far below f32-hostprep,
                       the ITERATION dtype is a wall, not just prep
  arm "f32-devprep"    f32 data, f32 prep (prepare_ns) + refine-1 —
                       the production replan mode at short budgets
  arm "f32-devprep-r3" same, kkt_refine=3
  arm "f32-hostprep-short"  host-f64 prep at the short budgets —
                       separates budget from prep quality
  arm "f32-devprep-polish"  devprep short + 1 polish extension

Margins are vs the rotating f64 IPM best-response oracle (the same
gate bench.py applies).  CPU by default (f64 arms need it); sized for
--agents 64.

Writes benchmarks/precision_probe_cpu.json.
Usage: timeout 3000 python tools/precision_probe.py [--agents 64]
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
    ap.add_argument("--agents", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--short", default="50,200,50")
    ap.add_argument("--arms", default=None,
                    help="comma list to restrict the arms")
    ap.add_argument("--out", default="benchmarks/precision_probe_cpu.json")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import bench
    from swarm_simulator_tpu.corridor.rsfc import build_rsfc
    from swarm_simulator_tpu.qp import convert
    from swarm_simulator_tpu.qp import joint as qjoint
    from swarm_simulator_tpu.qp import nullspace

    short = tuple(int(b) for b in args.short.split(","))

    # the bench 64-agent forest problem (same geometry as the headline)
    plan, mission, param = bench.build_problem(args.seed)
    M, n, N = plan.M, param.n, mission.qn
    batches = (0, 7, 14) if N >= 64 else (0,)
    log(f"N={N} M={M} pairs={len(plan.pair_idx)}")

    def assemble_as(dtype):
        param_d = dataclasses.replace(param, solver_dtype=dtype)
        data, dummy = qjoint.assemble_joint(plan, mission, param_d)
        return data, param_d

    def measure(ctrl, tag):
        ok, m = bench.gate_quality(ctrl, plan, mission, param)
        margins = {}
        for b_idx in batches:
            obj_b0, _ = bench.batch0_objective(ctrl, plan, mission,
                                               param, b_idx)
            obj_ref, _ = bench.ipm_best_response_batch0(
                plan, mission, param, ctrl, b_idx)
            margins[b_idx] = round(obj_b0 / obj_ref, 4)
        worst = max(margins.values())
        log(f"{tag}: gate={'OK' if ok else 'FAIL'} "
            f"ratio={m['ratio']:.4f} worst={worst:.3f} {margins}")
        return dict(gate_ok=bool(ok), ratio=round(m["ratio"], 4),
                    margins={str(k): v for k, v in margins.items()},
                    worst_margin=worst)

    # ---- cold solve (production recipe) + corridor refresh -----------
    data32, param32 = assemble_as("float32")
    full_ph = qjoint.production_phases()
    op = nullspace.prepare_ns_np(data32, full_ph[0])
    x, info = nullspace.solve_ns_phases(
        jax.tree.map(jnp.asarray, data32), full_ph,
        op=jax.device_put(op))
    ctrl0 = convert.x_to_ctrl(np.asarray(x, np.float64), M, n)
    log(f"cold obj={float(np.asarray(info.obj)):.4f}")

    knots = np.concatenate([ctrl0[:, :, 0, :], ctrl0[:, -1:, -1, :]],
                           axis=1)
    _, normals = build_rsfc(knots, param.downwash)
    plan.pair_normals = np.asarray(normals, np.float64)

    rows = {"flown_on_refresh": measure(ctrl0, "flown-on-refresh")}

    def run_arm(tag, dtype, prep, budgets, refine, polish):
        if args.arms and tag not in args.arms.split(","):
            return
        data, _ = assemble_as(dtype)
        data = dataclasses.replace(
            data, x0=np.asarray(
                ctrl0.reshape(N, M * (n + 1), 3).transpose(0, 2, 1),
                np.float32 if dtype == "float32" else np.float64))
        ph = qjoint.production_phases(budgets, base=full_ph[1],
                                      kkt_refine=refine)
        t0 = time.perf_counter()
        if prep == "host":
            opa = jax.device_put(nullspace.prepare_ns_np(data, ph[0]))
        else:
            d_dev = jax.tree.map(jnp.asarray, data)
            opa = jax.jit(
                lambda d: nullspace.prepare_ns(d, ph[0]))(d_dev)
            jax.block_until_ready(opa.Dinvs)
        prep_s = time.perf_counter() - t0
        d_dev = jax.tree.map(jnp.asarray, data)
        t0 = time.perf_counter()
        x, info = nullspace.solve_ns_phases(d_dev, ph, op=opa)
        ctrl = convert.x_to_ctrl(np.asarray(x, np.float64), M, n)
        if polish:
            pol_ph = qjoint.escalation_phases(ph)
            for _ in range(polish):
                x0n = jnp.asarray(
                    ctrl.reshape(N, M * (n + 1), 3).transpose(0, 2, 1),
                    d_dev.x0.dtype)
                d_dev = dataclasses.replace(d_dev, x0=x0n)
                x, info = nullspace.solve_ns_phases(d_dev, pol_ph,
                                                    op=opa)
                ctrl = convert.x_to_ctrl(np.asarray(x, np.float64),
                                         M, n)
        solve_s = time.perf_counter() - t0
        r = measure(ctrl, tag)
        r.update(prep_s=round(prep_s, 2), solve_s=round(solve_s, 2),
                 obj=round(float(np.asarray(info.obj)), 5),
                 iters=int(np.asarray(info.iters)),
                 dtype=dtype, prep=prep, budgets=list(budgets),
                 kkt_refine=refine, polish=polish)
        rows[tag] = r

    full = tuple(p.max_iter for p in full_ph)
    run_arm("f32-hostprep", "float32", "host", full, 0, 0)
    run_arm("f64-full", "float64", "host", full, 0, 0)
    run_arm("f32-hostprep-short", "float32", "host", short, 0, 0)
    run_arm("f32-devprep", "float32", "device", short, 1, 0)
    run_arm("f32-devprep-r3", "float32", "device", short, 3, 0)
    run_arm("f32-devprep-polish", "float32", "device", short, 1, 1)
    run_arm("f64-short", "float64", "host", short, 0, 0)

    out = dict(agents=N, M=int(M), seed=args.seed,
               short=list(short), rows=rows)
    os.makedirs("benchmarks", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
