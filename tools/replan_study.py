"""Corridor-refresh replan cost study: attack the host-f64 prep wall.

The true replanning cycle is PREP-dominated — every corridor refresh
re-pays seconds of host-f64 KKT prep at 64 agents (minutes at 256)
because the rung inventory embeds the pair-normal
coupling (tools/staleop_study.py: the STALE inventory fails the gate
even with kkt_refine PCG).

Hypothesis tested here: the staleop failure was about WRONG normals,
not low precision.  Preparing the inventory ON DEVICE in f32 for the
FRESH normals (prepare_ns: one batched Schur chain on the device,
Newton-refined inverses) gives a preconditioner with the RIGHT
coupling whose only defect is f32 accuracy — and (a) it may pass the
gate directly on a warm-started replan, or (b) kkt_refine=1 PCG
w-updates against the fresh operator close the remaining gap at ~3x
iteration cost.  Either way the host-f64 prep (and its 420 MB
transfer) drops out of the replan loop entirely.

Variants, per replan round (warm-started from the round-0 solution,
RSFC refreshed from it — the qp/joint.py replan flow):
  f64host-{5,3,2}rung   fresh prepare_ns_np + transfer, full or
                        shrunken rho ladder
  f32dev-{5,3}rung      on-device prepare_ns (flat layout), kkt_refine
                        0 and 1

Usage: python tools/replan_study.py [--seed 0] [--cpu] [--budgets 200,600,100]
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--budgets", default="200,600,100")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from swarm_simulator_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    import bench
    from swarm_simulator_tpu.corridor.rsfc import build_rsfc
    from swarm_simulator_tpu.qp import joint, nullspace

    budgets = tuple(int(b) for b in args.budgets.split(","))

    # ---- round 0: cold solve (host-f64 prep, production phases) ----
    plan, mission, param = bench.build_problem(args.seed)
    data, dummy = bench.assemble_joint(plan, mission, param)
    phases = bench.ns_phases()
    op64 = nullspace.prepare_ns_np(data, phases[0])
    op_dev = jax.device_put(op64)

    solve = jax.jit(lambda d, o, ph: nullspace.solve_ns_phases(d, ph, op=o),
                    static_argnames=("ph",))
    d_dev = jax.tree.map(jnp.asarray, data)
    x, info = solve(d_dev, op_dev, phases)
    x = np.asarray(x, np.float64)
    ctrl = x.transpose(0, 2, 1).reshape(mission.qn, plan.M, param.n + 1, 3)
    ok0, m0 = bench.gate_quality(ctrl, plan, mission, param)
    log(f"round0: gate={'OK' if ok0 else 'FAIL'} ratio={m0['ratio']:.4f}")
    assert ok0, m0

    # ---- corridor refresh from the round-0 solution ----
    knots = np.concatenate([ctrl[:, :, 0, :], ctrl[:, -1:, -1, :]], axis=1)
    pair_idx, normals = build_rsfc(knots, param.downwash)
    assert np.array_equal(pair_idx, np.asarray(plan.pair_idx))
    plan.pair_normals = np.asarray(normals, np.float64)
    data1, _ = joint.assemble_joint(plan, mission, param, dummy=ctrl)
    d1_dev = jax.tree.map(jnp.asarray, data1)

    results = {}

    def run(tag, op_dev_r, rphases, prep_s, extra=None):
        t0 = time.perf_counter()
        x1, info1 = solve(d1_dev, op_dev_r, rphases)
        x1 = np.asarray(x1, np.float64)
        solve_s = time.perf_counter() - t0
        c1 = x1.transpose(0, 2, 1).reshape(mission.qn, plan.M,
                                           param.n + 1, 3)
        ok, m = bench.gate_quality(c1, plan, mission, param)
        log(f"{tag}: gate={'OK' if ok else 'FAIL'} prep={prep_s:.2f}s "
            f"solve={solve_s:.2f}s (first incl. compile) "
            f"ratio={m['ratio']:.4f} box={m['box_viol']:.2e} "
            f"iters={int(info1.iters)}")
        # warm re-time (program + inputs cached; jitter breaks caching)
        best = np.inf
        for rr in range(2):
            t0 = time.perf_counter()
            x2, _ = solve(dataclasses.replace(
                d1_dev, x0=d1_dev.x0 + jnp.float32(3.7e-6 * (rr + 1))),
                op_dev_r, rphases)
            np.asarray(x2)
            best = min(best, time.perf_counter() - t0)
        log(f"{tag}: warm solve {best:.2f}s -> replan cycle "
            f"{prep_s + best:.2f}s")
        results[tag] = dict(ok=ok, prep_s=round(prep_s, 3),
                            solve_s=round(best, 3),
                            cycle_s=round(prep_s + best, 3),
                            ratio=m["ratio"], box=m["box_viol"],
                            obj=float(np.asarray(info1.obj)),
                            **(extra or {}))

    def ladder_phases(rho_min, rho_max, n_rungs, bdg, refine=0):
        base = dataclasses.replace(
            joint.production_settings(), rho_min=rho_min, rho_max=rho_max,
            n_rungs=n_rungs)
        ph = joint.production_phases(bdg, base=base, kkt_refine=refine)
        # fences must live inside the shrunken ladder
        return (dataclasses.replace(ph[0], rho_lo=max(1e-3, rho_min)),
                ph[1],
                dataclasses.replace(ph[2], rho_lo=rho_max))

    # (a) production: fresh host-f64 prep, full 5-rung ladder
    rphases = joint.production_phases(budgets, base=phases[1])
    t0 = time.perf_counter()
    op_a = nullspace.prepare_ns_np(data1, rphases[0])
    op_a_dev = jax.device_put(op_a)
    run("f64host-5rung", op_a_dev, rphases, time.perf_counter() - t0)

    # (b) fresh host-f64 prep of a SHRUNKEN ladder: the warm-started
    # replan may not need the full 5-rung inventory — fewer rungs =
    # proportionally less Schur-chain prep and transfer
    for (rmin, rmax, nr, bdg) in ((1e-4, 1e-2, 3, budgets),
                                  (1e-3, 1e-2, 2, budgets)):
        ph_s = ladder_phases(rmin, rmax, nr, bdg)
        t0 = time.perf_counter()
        op_s = nullspace.prepare_ns_np(data1, ph_s[0])
        op_s_dev = jax.device_put(op_s)
        run(f"f64host-{nr}rung", op_s_dev, ph_s,
            time.perf_counter() - t0, extra=dict(ladder=[rmin, rmax, nr]))

    # (c) on-device f32 prep, both
    # the full ladder and a better-conditioned shrunken one (the rho=
    # 1e-5 rung's f32 Schur chain produced NaNs on the first attempt)
    for (rmin, rmax, nr, bdg) in ((1e-5, 1e-2, 5, budgets),
                                  (1e-4, 1e-2, 3, budgets)):
        ph_flat = ladder_phases(rmin, rmax, nr, bdg)
        prep_dev = jax.jit(lambda d, _s=ph_flat[0]:
                           nullspace.prepare_ns(d, _s))
        t0 = time.perf_counter()
        op_b = prep_dev(d1_dev)
        jax.block_until_ready(op_b)
        prep_compile_s = time.perf_counter() - t0
        d1_j = dataclasses.replace(
            d1_dev, pair_n=d1_dev.pair_n * (1.0 + jnp.float32(1e-7)))
        t0 = time.perf_counter()
        op_b = prep_dev(d1_j)
        jax.block_until_ready(op_b)
        prep_b_s = time.perf_counter() - t0
        log(f"f32dev-{nr}rung prep: {prep_b_s:.2f}s warm "
            f"({prep_compile_s:.1f}s first incl. compile)")
        for refine in (0, 1):
            tag = f"f32dev-{nr}rung" + (f"+r{refine}" if refine else "")
            run(tag, op_b,
                ladder_phases(rmin, rmax, nr, bdg, refine=refine),
                prep_b_s, extra=dict(ladder=[rmin, rmax, nr]))

    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
