"""Iteration-budget study: does warm-starting the JOINT knot-state solve
from a cheap sequential-batch solution let the phased rho schedule pass
the gate at a fraction of the (400, 1200, 200) budget?

Rationale: the solve core is at the measured HBM roofline
(ARCHITECTURE.md), so cycle time scales with ITERATIONS.  The current
x0 warm start is the dummy interpolation (~5e4x the optimal jerk); a
sequential Gauss-Seidel solution is near-feasible and per-batch optimal,
so the polish phase may need far fewer of its 1200 iterations.

Runs on CPU by default (algorithmic question, not a platform one);
gate + objective margin vs the f64 IPM best-response per variant.

Usage: python tools/warmstart_study.py [--seed 4] [--device]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=4)
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

    from swarm_simulator_tpu.parallel import seqbatch
    from swarm_simulator_tpu.qp import nullspace

    plan, mission, param = build_problem(args.seed)
    data, _ = assemble_joint(plan, mission, param)
    data_dev = jax.tree.map(jnp.asarray, data)
    base = ns_settings()
    t0 = time.perf_counter()
    op = jax.device_put(nullspace.prepare_ns_np(data, base))
    log(f"prep {time.perf_counter() - t0:.1f}s")

    # ---- sequential GS solution (plan.ctrl = solved control points) --
    t0 = time.perf_counter()
    seqbatch.solve_trajectories(plan, mission, param, None)
    t_seq = time.perf_counter() - t0
    ctrl_seq = np.asarray(plan.ctrl)                # [B, M, n+1, 3]
    B = ctrl_seq.shape[0]
    x_seq = jnp.asarray(ctrl_seq.transpose(0, 3, 1, 2)
                        .reshape(B, 3, -1), jnp.float32)
    ok_s, m_s = gate_quality(ctrl_seq, plan, mission, param)
    log(f"sequential GS solve: {t_seq:.1f}s gate={ok_s} "
        f"ratio={m_s['ratio']:.4f}")

    # ---- variants ----------------------------------------------------
    def phases(b1, b2, b3):
        return (dataclasses.replace(base, max_iter=b1, rho_lo=1e-3),
                dataclasses.replace(base, max_iter=b2),
                dataclasses.replace(base, max_iter=b3, rho_lo=1e-2))

    def run(tag, ph, x0=None):
        d = data_dev if x0 is None else dataclasses.replace(
            data_dev, x0=x0)

        @jax.jit
        def go(dd, oo):
            return nullspace.solve_ns_phases(dd, ph, op=oo)

        t0 = time.perf_counter()
        x, info = go(d, op)
        x = np.asarray(x, np.float64)
        dt = time.perf_counter() - t0
        ctrl = x.transpose(0, 2, 1).reshape(B, plan.M, param.n + 1, 3)
        obj_b0, _ = batch0_objective(ctrl, plan, mission, param)
        obj_ref, _ipm_s = ipm_best_response_batch0(plan, mission, param,
                                                   ctrl)
        ok, m = gate_quality(ctrl, plan, mission, param, obj_ref, obj_b0)
        log(f"{tag}: gate={'OK' if ok else 'FAIL'} "
            f"margin={obj_b0 / obj_ref:.3f} ratio={m['ratio']:.4f} "
            f"obj={float(info.obj):.3f} {dt:.0f}s "
            f"(compile incl.)")

    run("baseline  (400,1200,200) dummy", phases(400, 1200, 200))
    run("ws-full   (400,1200,200) seqGS", phases(400, 1200, 200), x_seq)
    run("short     (200, 600,100) dummy", phases(200, 600, 100))
    run("ws-short  (200, 600,100) seqGS", phases(200, 600, 100), x_seq)
    run("ws-tiny   (100, 300,100) seqGS", phases(100, 300, 100), x_seq)


if __name__ == "__main__":
    main()
