"""Profile the verified-cycle bench: host assemble vs device solve per round.

Reuses bench.py's exact problem + settings so the device executable comes
from the persistent compilation cache.
"""
import os
import dataclasses
import sys
import time

import numpy as np


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from swarm_simulator_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    import bench
    from swarm_simulator_tpu.parallel import seqbatch
    from swarm_simulator_tpu.qp import admm, assemble, convert

    plan, mission, param = bench.build_problem()
    N = mission.qn
    settings = admm.ADMMSettings(max_iter=1500, eps_abs=2e-4, eps_rel=2e-4,
                                 kkt_solver="dense", eps_dual_abs=1.5)
    batches, _ = seqbatch.make_batches(N, param)
    dummy = assemble.build_dummy(plan.init_traj, param.n)
    members = [set(int(q) for q in b) for b in batches]
    pad = max(sum(1 for (qi, qj) in np.asarray(plan.pair_idx)
                  if int(qi) in m or int(qj) in m) for m in members)

    run_round = jax.jit(lambda st_, j: admm.solve_qp_batched(
        dataclasses.replace(st_, x0=st_.x0 + j), settings)[0])

    # warm-up compile
    ds = [assemble.assemble_batch(plan, mission, param, b, dummy, pad)
          for b in batches]
    stk = jax.tree.map(lambda *a: jnp.stack(a), *ds)
    np.asarray(run_round(stk, jnp.float32(0.0)))

    dm = dummy.copy()
    for rd in range(2):
        t0 = time.perf_counter()
        ds = [assemble.assemble_batch(plan, mission, param, b, dm, pad)
              for b in batches]
        t_asm = time.perf_counter() - t0
        t0 = time.perf_counter()
        stk = jax.tree.map(lambda *a: jnp.stack(a), *ds)
        t_stack = time.perf_counter() - t0
        t0 = time.perf_counter()
        xs = np.asarray(run_round(stk, jnp.float32(3.7e-6 * (rd + 1))))
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        for l, b in enumerate(batches):
            dm[b] = convert.x_to_ctrl(xs[l], plan.M, param.n)
        t_ref = time.perf_counter() - t0
        log(f"round {rd}: assemble={t_asm:.3f}s stack={t_stack:.3f}s "
            f"device={t_dev:.3f}s refresh={t_ref:.3f}s")


if __name__ == "__main__":
    main()
