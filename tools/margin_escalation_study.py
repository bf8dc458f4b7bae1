"""Margin-triggered budget escalation on the 10-seed gate set.

The production schedule's worst oracle margin
on the extended seeds was 1.203 vs the 1.25 gate bound — thin headroom.
This study measures, per seed 0-9:

  base:      the production (200, 600, 100) schedule -> oracle margin
  escalate:  IF margin > TRIGGER (1.15), a WARM polish extension —
             re-solve warm-started from the base solution (x0 = ctrl)
             with a polish-heavy (100, 400, 100) schedule — the same
             mechanism the replan path uses, so it needs no new solver
             features, only a second compiled program
  fresh-big: (200, 1200, 100) from scratch (the brute-force arm, for
             comparison)

Escalation recomputes BOTH sides of the margin (the best-response
oracle optimum depends on the other agents' final trajectories).

CPU study (algorithmic; margins are backend-independent to ~1e-3 —
the bench re-verifies the chosen mechanism on the device).  Writes
benchmarks/margin_escalation_cpu.json.

Usage: python tools/margin_escalation_study.py [--seeds 0,...,9]
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
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7,8,9")
    ap.add_argument("--out", default="benchmarks/margin_escalation_cpu.json")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from swarm_simulator_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from bench import (assemble_joint, batch0_objective, build_problem,
                       gate_quality, ipm_best_response_batch0, ns_settings,
                       oracle_batch)

    from swarm_simulator_tpu.qp import joint as qjoint
    from swarm_simulator_tpu.qp import nullspace

    base = ns_settings()
    ph_base = qjoint.production_phases(base=base)
    ph_esc = qjoint.escalation_phases(ph_base)
    ph_big = qjoint.production_phases((200, 1200, 100), base=base)

    @jax.jit
    def solve_base(dd, oo):
        return nullspace.solve_ns_phases(dd, ph_base, op=oo)

    @jax.jit
    def solve_esc(dd, oo):
        return nullspace.solve_ns_phases(dd, ph_esc, op=oo)

    @jax.jit
    def solve_big(dd, oo):
        return nullspace.solve_ns_phases(dd, ph_big, op=oo)

    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        plan, mission, param = build_problem(seed)
        data, _ = assemble_joint(plan, mission, param)
        data_dev = jax.tree.map(jnp.asarray, data)
        op = jax.device_put(nullspace.prepare_ns_np(data, base))
        B = mission.qn
        b_idx = oracle_batch(seed, 16)

        def run(solver, dd):
            t0 = time.perf_counter()
            x, info = solver(dd, op)
            x = np.asarray(x, np.float64)
            dt = time.perf_counter() - t0
            ctrl = x.transpose(0, 2, 1).reshape(B, plan.M, param.n + 1, 3)
            obj_b0, _ = batch0_objective(ctrl, plan, mission, param, b_idx)
            obj_ref, _ = ipm_best_response_batch0(plan, mission, param,
                                                  ctrl, b_idx)
            ok, m = gate_quality(ctrl, plan, mission, param, obj_ref,
                                 obj_b0)
            return ctrl, obj_b0 / obj_ref, ok, m, dt, int(info.iters)

        ctrl0, margin0, ok0, m0, dt0, it0 = run(solve_base, data_dev)
        row = dict(seed=seed, oracle_batch=b_idx,
                   base=dict(margin=round(margin0, 4), gate_ok=bool(ok0),
                             ratio=round(m0["ratio"], 4), solve_s=round(
                                 dt0, 1), iters=it0))
        log(f"seed {seed} base: margin={margin0:.3f} "
            f"gate={'OK' if ok0 else 'FAIL'} iters={it0}")

        if margin0 > qjoint.ESCALATION_TRIGGER:
            # warm polish extension: x0 <- base solution, re-solve
            d_esc = dataclasses.replace(
                data_dev, x0=jnp.asarray(
                    ctrl0.reshape(B, plan.M * (param.n + 1), 3)
                    .transpose(0, 2, 1), jnp.float32))
            ce, me, oke, mme, dte, ite = run(solve_esc, d_esc)
            row["escalated"] = dict(
                margin=round(me, 4), gate_ok=bool(oke),
                ratio=round(mme["ratio"], 4), solve_s=round(dte, 1),
                iters=ite, extra_iters_frac=round(ite / max(it0, 1), 3))
            log(f"seed {seed} ESCALATED: margin={margin0:.3f} -> {me:.3f} "
                f"(+{ite} iters) gate={'OK' if oke else 'FAIL'}")

            cb, mb, okb, mmb, dtb, itb = run(solve_big, data_dev)
            row["fresh_big"] = dict(
                margin=round(mb, 4), gate_ok=bool(okb), solve_s=round(
                    dtb, 1), iters=itb)
            log(f"seed {seed} fresh-big: margin={mb:.3f} iters={itb}")
        rows.append(row)

    worst_base = max(r["base"]["margin"] for r in rows)
    worst_final = max(r.get("escalated", r["base"])["margin"]
                      for r in rows)
    n_esc = sum(1 for r in rows if "escalated" in r)
    out = dict(trigger=qjoint.ESCALATION_TRIGGER,
               esc_budgets=list(qjoint.ESCALATION_BUDGETS), seeds=rows,
               worst_margin_base=round(worst_base, 4),
               worst_margin_with_escalation=round(worst_final, 4),
               escalated_seeds=n_esc, total_seeds=len(rows))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
