"""Which rho rungs does the production phased solve actually visit?

The host-f64 prep (prepare_ns_np) factorizes EVERY rung of the
rho ladder — the dominant replan cost (8-10 s at 64 agents, ~21 min at
256).  If the adaptive walk only ever visits a subset, the inventory
can shrink to those rungs and prep drops proportionally.

Method: re-run the production phases in check_every-sized chunks via
_iterate_ns(init=state, max_iter=check_every), recording the carried
rho index after every chunk — the walk is IDENTICAL to the production solve
(rung updates only happen at chunk boundaries) except that early
termination is ignored (the production budgets run to completion on
these problems anyway; the final objective is printed to confirm).

Usage: python tools/rung_usage.py [--seeds 0,1,2,3,4]
"""
from __future__ import annotations

import os
import argparse
import dataclasses
import sys
from collections import Counter

import numpy as np


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="0,1,2,3,4")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from swarm_simulator_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    sys.path.insert(0, ".")
    from bench import assemble_joint, build_problem, ns_phases

    from swarm_simulator_tpu.qp import nullspace

    phases = ns_phases()
    ladder = np.logspace(np.log10(phases[0].rho_min),
                         np.log10(phases[0].rho_max), phases[0].n_rungs)
    log(f"ladder: {[f'{r:.2e}' for r in ladder]}")

    visits = Counter()
    for seed in [int(s) for s in args.seeds.split(",")]:
        plan, mission, param = build_problem(seed)
        data, _ = assemble_joint(plan, mission, param)
        op = nullspace.prepare_ns_np(data, phases[0])
        data_dev = jax.tree.map(jnp.asarray, data)
        op_dev = jax.device_put(op)

        from functools import partial

        @partial(jax.jit, static_argnames=("si",))
        def chunk(d, o, state, si):
            # one check_every-sized chunk of phase si, carrying state
            with jax.default_matmul_precision("highest"):
                s = dataclasses.replace(phases[si],
                                        max_iter=phases[si].check_every)
                return nullspace._iterate_ns(d, o, s, init=state,
                                             return_state=True)

        # the walk entries are the rung ACTIVE DURING each chunk: the
        # carried rho_idx clipped into the current phase's fence at
        # chunk entry (exactly _iterate_ns's init clip; the adaptive
        # update only fires AFTER a chunk's iterations).  The first
        # chunk runs at the warm-start rung — count it too, or a rung
        # used only there would be reported unvisited and wrongly
        # dropped from the ladder.
        lad_log = np.log(ladder)

        def fence(ph):
            lo = (int(np.argmin(np.abs(lad_log - np.log(ph.rho_lo))))
                  if ph.rho_lo is not None else 0)
            hi = (int(np.argmin(np.abs(lad_log - np.log(ph.rho_hi))))
                  if ph.rho_hi is not None else len(ladder) - 1)
            return lo, hi

        carry = int(np.argmin(np.abs(lad_log - np.log(phases[0].rho))))
        state = None
        walk = []
        for si, ph in enumerate(phases):
            lo, hi = fence(ph)
            for _ in range(ph.max_iter // ph.check_every):
                walk.append(min(max(carry, lo), hi))
                x, info, state = chunk(data_dev, op_dev, state, si=si)
                carry = int(state[3])
        visits.update(walk)
        log(f"seed {seed}: obj={float(info.obj):.4f} walk={walk}")

    log("\nrung visit counts (chunks of 50 iters, all seeds):")
    for i, rho in enumerate(ladder):
        log(f"  rung {i} rho={rho:.2e}: {visits.get(i, 0)}")
    used = sorted(visits)
    log(f"visited rungs: {used} of {len(ladder)} "
        f"-> prep could drop {len(ladder) - len(used)} rungs")


if __name__ == "__main__":
    main()
