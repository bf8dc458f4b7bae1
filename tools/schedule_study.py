"""Re-tune the phased rho-schedule budgets across all gate seeds.

The (400, 1200, 200) production schedule was tuned BEFORE the host-f64
KKT prep landed; with the better operator the solver converges much
faster (tools/warmstart_study.py: seed 4 — previously the binding seed
at polish=600 — now passes at margin 1.083 with (200, 600, 100)).
This sweep finds the new knee: smallest total budget with ALL seeds
inside the 1.25 objective-margin gate with headroom.

CPU (algorithmic study; the bench re-verifies the chosen schedule on
the device across the same seeds before any timing).

Usage: python tools/schedule_study.py [--seeds 0,1,2,3,4]
"""
from __future__ import annotations

import os
import argparse
import dataclasses
import sys
import time

import numpy as np


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# (b1, b2, b3) or (b1, b2, b3, check_every) — the cadence arm tests
# whether a faster adaptive-rho walk (check_every 50 -> 25/20) moves
# the budget knee down: per-iteration cost is identical, so a passing
# smaller budget is a direct headline win
# (b1, b2, b3[, check_every[, aa_depth]]) — the AA arms test whether
# chunk-level Anderson acceleration (NSSettings.aa_depth) moves the
# budget knee down (the cadence arms alone did not: seed 8 needs the
# polish iterations, benchmarks/cadence_study_cpu.log)
SCHEDULES = [(200, 600, 100), (200, 600, 100, 50, 5),
             (150, 400, 75, 50, 5), (100, 300, 60, 50, 5)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--device", action="store_true",
                    help="run on the default accelerator, not the CPU")
    args = ap.parse_args()

    import jax
    if not args.device:
        jax.config.update("jax_platforms", "cpu")
    from swarm_simulator_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from bench import (assemble_joint, batch0_objective, build_problem,
                       gate_quality, ipm_best_response_batch0, ns_settings)

    from swarm_simulator_tpu.qp import nullspace

    base = ns_settings()

    def phases(b1, b2, b3, ce=None, aa=0):
        b = dataclasses.replace(base, aa_depth=aa)
        if ce is not None:
            b = dataclasses.replace(b, check_every=ce)
        return (dataclasses.replace(b, max_iter=b1, rho_lo=1e-3),
                dataclasses.replace(b, max_iter=b2),
                dataclasses.replace(b, max_iter=b3, rho_lo=1e-2))

    worst = {s: 0.0 for s in SCHEDULES}
    all_ok = {s: True for s in SCHEDULES}
    for seed in [int(s) for s in args.seeds.split(",")]:
        plan, mission, param = build_problem(seed)
        data, _ = assemble_joint(plan, mission, param)
        data_dev = jax.tree.map(jnp.asarray, data)
        t0 = time.perf_counter()
        op = jax.device_put(nullspace.prepare_ns_np(data, base))
        log(f"seed {seed}: prep {time.perf_counter() - t0:.0f}s")
        B = mission.qn
        for sched in SCHEDULES:
            ph = phases(*sched)

            @jax.jit
            def go(dd, oo):
                return nullspace.solve_ns_phases(dd, ph, op=oo)

            t0 = time.perf_counter()
            x, info = go(data_dev, op)
            x = np.asarray(x, np.float64)
            dt = time.perf_counter() - t0
            ctrl = x.transpose(0, 2, 1).reshape(B, plan.M,
                                                param.n + 1, 3)
            obj_b0, _ = batch0_objective(ctrl, plan, mission, param)
            obj_ref, _ = ipm_best_response_batch0(plan, mission, param,
                                                  ctrl)
            ok, m = gate_quality(ctrl, plan, mission, param, obj_ref,
                                 obj_b0)
            margin = obj_b0 / obj_ref
            worst[sched] = max(worst[sched], margin)
            all_ok[sched] = all_ok[sched] and ok
            log(f"seed {seed} {sched}: gate={'OK' if ok else 'FAIL'} "
                f"margin={margin:.3f} ratio={m['ratio']:.4f} {dt:.0f}s")
    log("worst margins per schedule:")
    for sched, w in worst.items():
        log(f"  {sched} (total {sum(sched[:3])}): {w:.3f} "
            f"{'all-OK' if all_ok[sched] else 'HAS-FAIL'}")


if __name__ == "__main__":
    main()
