"""How many ADMM iterations does the verified 2-round cycle actually need?

Runs the bench problem on the CPU backend in float32 (same arithmetic class
as the device at matmul precision "highest", fast compiles) and reports per-round
iteration counts, residuals, and the safety ratio as max_iter shrinks.
"""
import os
import dataclasses
import sys
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import bench  # noqa: E402
from swarm_simulator_tpu.eval.safety import safety_margin_ratio  # noqa: E402
from swarm_simulator_tpu.eval.sample import (sample_times,  # noqa: E402
                                             sample_trajectories)
from swarm_simulator_tpu.parallel import seqbatch  # noqa: E402
from swarm_simulator_tpu.qp import admm, assemble, convert  # noqa: E402


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


plan, mission, param = bench.build_problem()
N = mission.qn
batches, _ = seqbatch.make_batches(N, param)
dummy0 = assemble.build_dummy(plan.init_traj, param.n)
members = [set(int(q) for q in b) for b in batches]
pad = max(sum(1 for (qi, qj) in np.asarray(plan.pair_idx)
              if int(qi) in m or int(qj) in m) for m in members)


def ratio_of(dm):
    coef = convert.ctrl_to_coef(dm, plan.T, param.n)
    ts = sample_times(np.asarray(plan.T), 0.1)
    pos = np.asarray(sample_trajectories(
        jnp.asarray(coef), jnp.asarray(np.asarray(plan.T)),
        jnp.asarray(ts), n=param.n, derivatives=1))[:, :, 0]
    return float(safety_margin_ratio(
        jnp.asarray(pos), jnp.asarray(mission.radius),
        downwash=param.downwash))


def cycle(settings, rounds=2):
    dm = dummy0.copy()
    infos = []
    for rd in range(rounds):
        ds = [assemble.assemble_batch(plan, mission, param, b, dm, pad)
              for b in batches]
        stk = jax.tree.map(lambda *a: jnp.stack(a), *ds)
        xs, info = admm.solve_qp_batched(stk, settings)
        xs = np.asarray(xs)
        infos.append(info)
        for l, b in enumerate(batches):
            dm[b] = convert.x_to_ctrl(xs[l], plan.M, param.n)
    return dm, infos


for mi in (1500, 1000, 700, 500, 300):
    settings = admm.ADMMSettings(max_iter=mi, eps_abs=2e-4, eps_rel=2e-4,
                                 kkt_solver="dense", eps_dual_abs=1.5)
    t0 = time.perf_counter()
    dm, infos = cycle(settings)
    dt = time.perf_counter() - t0
    r = ratio_of(dm)
    for rd, info in enumerate(infos):
        it = np.asarray(info.iters)
        rp = np.asarray(info.r_prim)
        log(f"  max_iter={mi} round={rd}: iters min/med/max = "
            f"{it.min()}/{int(np.median(it))}/{it.max()}  "
            f"r_prim max={rp.max():.2e}")
    log(f"max_iter={mi}: ratio={r:.4f}  wall={dt:.1f}s (cpu)")
