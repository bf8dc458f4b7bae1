"""Amdahl account of ONE production ADMM iteration: how much of an
iteration is the SERIALIZED Thomas chain vs the pair-contraction work
that divides by n devices — the number that bounds what
any multi-chip decomposition of the joint solve can buy.

Measures, on the device (XLA banded Thomas path, at the 256-agent
shape and the 64-agent shape for reference):

  t_full   one ADMM iteration (scan of K dependent steps / K)
  t_chain  one kinv_apply (the Thomas chain, scan of K dependent
           applies / K — dependent so dispatch overlap cannot hide it)
  t_pair   one A^T(A x) pair apply (the work that divides by n)
  t_other  t_full - t_chain - t_pair (replicated elementwise/N-map)

and projects the n-device bounds:

  chunk pipeline:            t_chain      + t_pair/n + t_other
  SPIKE substructuring:      2 t_chain/n  + t_sch(n) + t_pair/n + t_other
     (two parallel local solves; t_sch = the replicated separator
      Schur chain, (n-1)/Mi of a chain — counted at 2(n-1)/Mi t_chain)

Writes benchmarks/amdahl_gpu.json.
Usage: timeout 1800 python tools/amdahl_study.py [--agents 64,256]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_256():
    import swarm_simulator_tpu as sst
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.io.mission_json import scatter_mission
    from swarm_simulator_tpu.qp import assemble
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF
    from swarm_simulator_tpu.world.voxel import OccupancyGrid

    N = 256
    mission = scatter_mission(N, half=9.5, z=1.0, seed=7)
    param = sst.Param(world_x_min=-10, world_x_max=10, world_y_min=-10,
                      world_y_max=10, world_z_min=0.3, world_z_max=2.5,
                      grid_xy_res=0.5, grid_z_res=1.0,
                      sequential=True, batch_size=4, batch_iter=-1,
                      solver_dtype="float32")
    world = OccupancyGrid.empty(param.world_min, param.world_max,
                                param.world_resolution)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)
    dummy = assemble.build_dummy(plan.init_traj, param.n)
    data = assemble.assemble_batch(plan, mission, param, np.arange(N),
                                   dummy, device=False)
    return data, plan, mission, param


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", default="64,256")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="benchmarks/amdahl_gpu.json")
    args = ap.parse_args()

    import dataclasses

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from swarm_simulator_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    import bench
    from swarm_simulator_tpu.qp import joint as qjoint
    from swarm_simulator_tpu.qp import nullspace as ns

    K = args.iters
    rows = {}
    for N in (int(a) for a in args.agents.split(",")):
        if N == 64:
            plan, mission, param = bench.build_problem(0)
            from swarm_simulator_tpu.qp import assemble
            dummy = assemble.build_dummy(plan.init_traj, param.n)
            data = assemble.assemble_batch(plan, mission, param,
                                           np.arange(64), dummy,
                                           device=False)
        else:
            data, plan, mission, param = build_256()
        M = plan.M
        base = qjoint.production_phases()[1]
        t0 = time.perf_counter()
        op = ns.prepare_ns_np(data, base)
        prep_s = time.perf_counter() - t0
        log(f"N={N}: M={M} prep {prep_s:.0f}s "
            f"inv {np.asarray(op.Dinvs).nbytes / 1e9:.2f} GB")
        d_dev = jax.tree.map(jnp.asarray, data)
        op_dev = jax.device_put(op)

        B, K3, D = d_dev.lb.shape
        phi = int(op.F0.shape[1])
        nw = int(np.asarray(op.N).shape[1])
        Mi = M - 1
        from swarm_simulator_tpu.qp.admm import _pair_op

        # d/op must be jit ARGUMENTS: closed-over arrays embed as HLO
        # constants (a multi-100MB compile request)
        @jax.jit
        def run_chain(v, op_a):
            kinv = ns.make_kinv_apply(op_a, B, K3, M, phi)

            def f(c, _):
                return kinv(jnp.asarray(0), c), None
            out, _ = jax.lax.scan(f, v, None, length=K)
            return out

        @jax.jit
        def run_pair(x, d_a):
            pop = _pair_op(d_a)

            def f(c, _):
                ax = ns._A_x(d_a, c, pop)
                return ns._AT_x(d_a, ax, pop), None
            out, _ = jax.lax.scan(f, x, None, length=K)
            return out

        @jax.jit
        def run_full(w0, d_a, op_a):
            x, info = ns._iterate_ns(
                d_a, op_a,
                dataclasses.replace(base, max_iter=K, check_every=K,
                                    adaptive_rho=False, eps_abs=0.0,
                                    eps_rel=0.0, eps_dual_abs=0.0))
            return x

        v0 = jnp.asarray(np.random.RandomState(0).randn(B, K3, nw),
                         jnp.float32) * 1e-3
        x0 = jnp.asarray(np.random.RandomState(1).randn(B, K3, D),
                         jnp.float32) * 1e-3

        def timeit(f, *a):
            np.asarray(f(*a))                    # compile
            best = np.inf
            for _ in range(3):
                t0 = time.perf_counter()
                np.asarray(f(*a))
                best = min(best, time.perf_counter() - t0)
            return best / K

        t_chain = timeit(run_chain, v0, op_dev)
        t_pair = timeit(run_pair, x0, d_dev)
        t_full = timeit(run_full, v0, d_dev, op_dev)
        # XLA can OVERLAP the memory-bound Thomas chain with the pair
        # contractions inside one iteration (t_full < t_chain + t_pair),
        # so the projection model is max(chain-path, pair-path), not a
        # sum
        t_other = max(0.0, t_full - max(t_chain, t_pair))
        f_chain = t_chain / t_full

        def bound_chunk(n):
            # chunk pipeline: the chain stays serial across devices
            return t_full / (max(t_chain, t_pair / n) + t_other)

        def bound_spike(n):
            # two parallel local solves + replicated separator chain
            t_sch = 2.0 * (n - 1) / max(Mi, 1) * t_chain
            return t_full / (max(2 * t_chain / n + t_sch, t_pair / n)
                             + t_other)

        row = dict(
            M=int(M), iters=K,
            t_full_ms=round(t_full * 1e3, 3),
            t_chain_ms=round(t_chain * 1e3, 3),
            t_pair_ms=round(t_pair * 1e3, 3),
            t_other_ms=round(t_other * 1e3, 3),
            frac_chain=round(f_chain, 3),
            frac_pair=round(t_pair / t_full, 3),
            projected_speedup_chunk={n: round(bound_chunk(n), 2)
                                     for n in (2, 4, 8, 16)},
            projected_speedup_spike={n: round(bound_spike(n), 2)
                                     for n in (2, 4, 8, 16)})
        log(f"N={N}: full {t_full * 1e3:.2f} ms/iter = chain "
            f"{t_chain * 1e3:.2f} + pair {t_pair * 1e3:.2f} + other "
            f"{t_other * 1e3:.2f}  (chain {100 * f_chain:.0f}%)")
        log(f"N={N}: projected chunk {row['projected_speedup_chunk']} "
            f"spike {row['projected_speedup_spike']}")
        rows[N] = row

    out = dict(backend=jax.default_backend(), rows=rows)
    os.makedirs("benchmarks", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
