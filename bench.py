"""Benchmark: gate-verified 64-agent planning cycles/s on the canonical config.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Problem: the reference's canonical demo — 64 agents, 20-obstacle random
forest, 10x10x2.5 m world (plan_rbp_random_forest.launch:23-66) — seeded
so every run is reproducible.  One "cycle" = one complete trajectory
optimization for all 64 agents, the work the reference performs as 16
sequential CPLEX batch solves (batch_size=4, iteration=1,
rbp_planner.hpp:140-204).

Production path: the JOINT 64-agent QP (all 2016 pair constraints
simultaneously active — no sequential-batch decomposition, hence no
stale-coupling consensus error) solved by the knot-state ADMM with the
block-tridiagonal banded KKT over knots (qp/nullspace.py, kkt_mode
"banded": memory O(M (3B phi)^2), the segment-axis scaling structure).

Quality gate (checked on GATE_SEEDS distinct forests BEFORE timing; the
same compiled program, only the data changes):
  * min inter-agent ellipsoidal distance ratio >= 1 (collision-free,
    rbp_publisher.hpp:769-798)
  * C^2 knot continuity + endpoint pins (machine-exact for the knot-state
    solver by construction)
  * SFC box containment of every control point
  * jerk objective of batch-0's agents within 25% of the f64
    interior-point optimum of the batch-0 best-response QP (all other
    agents fixed at our solution) — CPLEX always returns the optimum, so
    a throughput number only counts if solution quality is comparable

Baseline (vs_baseline): the reference architecture is 16 sequential QPs,
one at a time, single CPU core, CPLEX barrier.  qp/ipm.py is exactly that
algorithm class (Mehrotra predictor-corrector, float64, KKT-verified
solutions); the denominator is 16x its measured per-batch-solve time on
this host.
"""
from __future__ import annotations

import json
import os
import sys
import time

if __name__ == "__main__":
    # the host KKT prep runs one BLAS thread per rung worker
    # (nullspace._blas_single_threaded); pin the pools before numpy
    # loads so that holds without threadpoolctl too
    for _var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                 "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, "1")

import numpy as np  # noqa: E402

GATE_SEEDS = (0, 1, 2, 3, 4)
OBS_NUM = 20
MAX_ITER = 1500          # budget; the residual check terminates earlier
CHECK_EVERY = 50


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forest_mission(seed: int = 0, forest: bool = True):
    """(mission, param, world) of the canonical 64-agent forest
    (plan_rbp_random_forest.launch knobs; the forest geometry rules of
    random_map_generator.cpp:56-113, seeded)."""
    import swarm_simulator_tpu as sst
    from swarm_simulator_tpu.io.mission_json import perimeter_swap_mission
    from swarm_simulator_tpu.world.forest import generate_forest
    from swarm_simulator_tpu.world.voxel import OccupancyGrid

    param = sst.Param(world_z_min=0.3, grid_xy_res=0.5, grid_z_res=1.0,
                      sequential=True, batch_size=4, batch_iter=-1,
                      solver_dtype="float32", solver_max_iter=1000)
    mission = perimeter_swap_mission(64, half=4.0, z=1.0, radius=0.15)
    if forest:
        world = generate_forest(mission, world_min=param.world_min,
                                world_max=param.world_max, obs_num=OBS_NUM,
                                r_min=0.3, r_max=0.3, h_min=0.0, h_max=2.5,
                                margin=0.5, seed=seed)
    else:
        world = OccupancyGrid.empty(param.world_min, param.world_max,
                                    param.world_resolution)
    return mission, param, world


def build_problem(seed: int = 0, forest: bool = True):
    """Canonical 64-agent forest problem, searched and with corridors
    built (forest_mission)."""
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF

    mission, param, world = forest_mission(seed, forest)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    t0 = time.perf_counter()
    plan = plan_initial_trajectories(esdf, mission, param)
    t1 = time.perf_counter()
    build_corridors(esdf, plan, mission.radius, param)
    t2 = time.perf_counter()
    log(f"seed {seed}: search {t1 - t0:.2f}s corridor "
        f"{t2 - t1:.2f}s M={plan.M}")
    plan.stage_s = {"search": t1 - t0, "corridor": t2 - t1}
    return plan, mission, param


def assemble_joint(plan, mission, param):
    """The joint 64-agent QP (host-side numpy; one bulk device transfer)."""
    from swarm_simulator_tpu.qp import assemble

    dummy = assemble.build_dummy(plan.init_traj, param.n)
    data = assemble.assemble_batch(plan, mission, param,
                                   np.arange(mission.qn), dummy,
                                   device=False)
    return data, dummy


def ns_settings():
    """Production settings — single source of truth is the package
    (qp/joint.py, reachable from plan()/CLI via Param.solver)."""
    from swarm_simulator_tpu.qp import joint

    return joint.production_settings(max_iter=MAX_ITER,
                                     check_every=CHECK_EVERY)


def ns_phases():
    """Production phased rho schedule (qp/joint.py production_phases):
    feasibility-first -> deep objective polish -> feasibility restore.

    Budgets re-tuned AFTER the host-f64 KKT prep landed
    (tools/schedule_study.py): (200, 600, 100) passes TEN forest seeds
    (0-9) with worst objective margin 1.173 vs the 1.25 gate bound
    (seed 8; the 5 bench seeds peak at 1.083 on seed 4);
    (150, 400, 100) fails seeds 4/8 and (100, 300, 80) fails 5 of 10 —
    the schedule sits at the knee with headroom
    (benchmarks/schedule_seeds5-9_cpu.log).  The pre-f64-prep budgets
    (400, 1200, 200) are 2x more iterations for the same gate outcome."""
    from swarm_simulator_tpu.qp import joint

    return joint.production_phases(base=ns_settings())


def gate_quality(ctrl, plan, mission, param, obj_ref=None, obj_b0=None,
                 obj_tol=1.25):
    """Full acceptance gate on solved control points [N, M, n+1, 3].

    Checks, mirroring the reference's acceptance surface:
      * collision ratio (rbp_publisher.hpp:769-798)
      * C^0/C^2 knot continuity + endpoint pins
      * SFC box containment of every control point
      * DYNAMIC LIMITS after time scaling (timeScale,
        rbp_planner.hpp:209-266): compute the global time-scale factor,
        apply it, and verify by dense sampling that max_vel/max_acc hold
        on the SCALED trajectory — the trajectory the reference would
        actually publish.

    obj_ref: optional jerk objective of the f64 IPM best-response optimum
    for one agent batch; when given, the gate also demands our objective
    for those agents (obj_b0) within obj_tol of it."""
    import jax.numpy as jnp

    from swarm_simulator_tpu.eval.safety import safety_margin_ratio
    from swarm_simulator_tpu.eval.sample import (sample_times,
                                                 sample_trajectories)
    from swarm_simulator_tpu.qp import convert, timescale

    dm = np.asarray(ctrl, dtype=np.float64)
    coef = convert.ctrl_to_coef(dm, plan.T, param.n)
    ts = sample_times(np.asarray(plan.T), 0.1)
    pos = np.asarray(sample_trajectories(
        jnp.asarray(coef), jnp.asarray(np.asarray(plan.T)),
        jnp.asarray(ts), n=param.n, derivatives=1))[:, :, 0]
    ratio = float(safety_margin_ratio(
        jnp.asarray(pos), jnp.asarray(mission.radius),
        downwash=param.downwash))

    cont = []
    d = dm.copy()
    deg = param.n
    for _ in range(3):
        cont.append(float(np.abs(d[:, 1:, 0] - d[:, :-1, -1]).max()))
        d = deg * np.diff(d, axis=2)
        deg -= 1
    start_err = float(np.abs(dm[:, 0, 0] - mission.start[:, :3]).max())
    goal_err = float(np.abs(dm[:, -1, -1] - mission.goal[:, :3]).max())
    boxes = plan.seg_boxes
    viol = float(np.maximum(boxes[:, :, None, :3] - dm,
                            dm - boxes[:, :, None, 3:]).max())

    # dynamic limits post-timescale: scale as the reference would
    # (rbp_planner.hpp:209-266; time scaling keeps the path geometry, so
    # the collision ratio above is invariant), then VERIFY independently
    # by dense per-axis sampling of the scaled trajectory.  NOTE
    # compute_time_scale only supports n=5/phi=3 (like the reference,
    # rbp_planner.hpp:210-212) — for other configs it returns 1.0 and
    # the vel/acc check judges the UNSCALED trajectory (a limit-
    # exceeding non-quintic config fails the gate rather than being
    # silently rescued; m['timescale_supported'] records which case ran)
    scale = timescale.compute_time_scale(coef, plan.T, mission.max_vel,
                                         mission.max_acc, param.n,
                                         param.phi)
    coef_s, T_s = timescale.apply_time_scale(coef, plan.T, scale, param.n)
    ts_s = sample_times(np.asarray(T_s), 0.1)
    pva = np.asarray(sample_trajectories(
        jnp.asarray(coef_s), jnp.asarray(np.asarray(T_s)),
        jnp.asarray(ts_s), n=param.n, derivatives=3))
    vel_frac = float((np.abs(pva[:, :, 1]).max(axis=1)
                      / np.asarray(mission.max_vel)).max())
    acc_frac = float((np.abs(pva[:, :, 2]).max(axis=1)
                      / np.asarray(mission.max_acc)).max())

    m = dict(ratio=ratio, cont0=cont[0], cont2=cont[2],
             endpoints=max(start_err, goal_err), box_viol=viol,
             time_scale=scale, vel_frac=vel_frac, acc_frac=acc_frac,
             timescale_supported=(param.n == 5 and param.phi == 3))
    # vel/acc bound 1.0 + slack: compute_time_scale bounds the true
    # polynomial extrema (root-based), the dense 0.1 s sampling can only
    # see less — the tiny slack covers f.p. rounding of the rescale
    ok = (ratio >= 1.0 and cont[0] < 1e-3 and cont[2] < 5e-3
          and m["endpoints"] < 1e-4 and viol < 1e-3
          and vel_frac <= 1.0 + 1e-9 and acc_frac <= 1.0 + 1e-9)

    if obj_ref is not None:
        m["obj_b0"] = obj_b0
        m["obj_ref"] = obj_ref
        ok = ok and obj_b0 <= obj_ref * obj_tol + 1e-9
    return ok, m


def batch0_objective(dm, plan, mission, param, b_idx: int = 0):
    """Jerk objective of reference batch b_idx's agents."""
    from swarm_simulator_tpu.parallel import seqbatch
    from swarm_simulator_tpu.qp import assemble

    batches, _ = seqbatch.make_batches(mission.qn, param)
    agents = batches[b_idx]
    dummy = assemble.build_dummy(plan.init_traj, param.n)
    data0 = assemble.assemble_batch(plan, mission, param, agents, dummy,
                                    device=False)
    Qseg = np.asarray(data0.Qseg).astype(np.float64)
    c = np.asarray(dm, np.float64)[agents]            # [B, M, n+1, 3]
    return float(np.einsum("bmik,mij,bmjk->", c, Qseg, c) * 0.5), data0


def oracle_batch(seed: int, n_batches: int) -> int:
    """Which agent batch the IPM best-response oracle checks for a gate
    seed.  Rotates with a stride co-prime to 16 so the 5 gate seeds
    cover 5 DISTINCT batches (0, 7, 14, 5, 12) instead of always batch
    0, so the objective gate covers more than 4 of 64 agents."""
    return (seed * 7) % n_batches


def ipm_best_response_batch0(plan, mission, param, final_ctrl,
                             b_idx: int = 0, pair_relax: float = 0.0):
    """f64 IPM optimum of batch b_idx's best-response QP: its 4 agents
    free, everyone else fixed at OUR final trajectories (the pair rhs
    refreshed from them).  The per-solve quality yardstick and the
    CPLEX-class timing baseline.  Uses the reduced
    (equality-eliminated) barrier — the FASTEST honest f64 denominator
    we can produce (a slow stand-in would inflate vs_baseline); its
    optimum is still verified by the full-space KKT residual check.
    Returns (objective, seconds/solve)."""
    import jax

    from swarm_simulator_tpu.parallel import seqbatch
    from swarm_simulator_tpu.qp import assemble, ipm

    batches, _ = seqbatch.make_batches(mission.qn, param)
    dummy = np.asarray(final_ctrl, np.float64)
    with jax.default_device(jax.devices("cpu")[0]):
        data0 = assemble.assemble_batch(plan, mission, param,
                                        batches[b_idx],
                                        dummy, device=False)
        data0 = jax.tree.map(
            lambda x: np.asarray(x, np.float64)
            if np.asarray(x).dtype in (np.float32, np.float64)
            else np.asarray(x), data0)
    # barrier slack on zero-width duplicated knot rows (assembly stores
    # TRUE bounds since round 5); 5e-4 stays under the 1e-3 gate bound
    import dataclasses as _dc
    lb_r, ub_r = assemble.relax_thin_knot_rows(data0.lb, data0.ub,
                                               param.n)
    data0 = _dc.replace(data0, lb=lb_r, ub=ub_r)
    if pair_relax:
        # an EXACT-optimal final_ctrl can leave pair rows with zero
        # slack against the fixed neighbors — the barrier then has no
        # strict interior and the Cholesky escalation dies.  A 1e-6
        # relaxation biases obj_ref DOWN (margins read conservatively
        # high); callers evaluating active-set-polished solutions pass
        # it on retry
        data0 = _dc.replace(data0, pair_rhs=np.asarray(data0.pair_rhs)
                            - pair_relax)
    t0 = time.perf_counter()
    res = ipm.solve_ipm_reduced(data0)
    dt = time.perf_counter() - t0
    try:
        ipm.verify_optimal(data0, res, tol=1e-5)
    except AssertionError:
        # marginal instances can pass the solver's own termination test
        # while the FULL-space complementarity (recomputed slacks) is
        # still settling — retry tighter rather than loosen the check
        # (observed: forest seed 3, comp 1.3e-4 at mu 9.8e-7).  dt is
        # the VERIFIED solve's own time (a cumulative double-solve time
        # would inflate the vs_baseline denominator in our favor)
        t0 = time.perf_counter()
        res = ipm.solve_ipm_reduced(data0, tol=1e-12, max_iter=120)
        dt = time.perf_counter() - t0
        ipm.verify_optimal(data0, res, tol=1e-5)
    Q, E, d_, C, c_, _ = ipm.build_flat(data0)
    xo = res.x.reshape(-1)
    return float(0.5 * xo @ (Q @ xo)), dt


def main():
    import jax

    from swarm_simulator_tpu.utils import runtime

    dev = runtime.require_gpu()
    runtime.enable_compile_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    log(f"device: {device}")

    import jax.numpy as jnp

    from swarm_simulator_tpu.qp import joint as qjoint
    from swarm_simulator_tpu.qp import nullspace

    phases = ns_phases()
    esc_phases = qjoint.escalation_phases(phases)

    # ONE executable for the cold solve AND the escalation extension
    # (round-5 compile-wall cure): budgets/fences are jit ARGUMENTS,
    # the while-body is traced once (nullspace.solve_ns_schedule)
    sched = nullspace.schedule_arrays(phases)
    esc_sched = nullspace.schedule_arrays(esc_phases)
    assert sched is not None and esc_sched[0] == sched[0], \
        "production schedules must share a normalized base"
    s_base = sched[0]
    # device-resident schedule arrays: passing host numpy would add 3
    # tiny host->device transfers PER DISPATCH
    sched = (s_base,) + tuple(jax.device_put(a) for a in sched[1:])
    esc_sched = (s_base,) + tuple(jax.device_put(a)
                                  for a in esc_sched[1:])

    @jax.jit
    def joint_solve_sched(data, op, jit_val, it_k, lo_k, hi_k):
        import dataclasses
        d = dataclasses.replace(data, x0=data.x0 + jit_val)
        return nullspace.solve_ns_schedule(d, op, s_base, it_k, lo_k,
                                           hi_k)

    def joint_solve(data, op, jit_val):
        return joint_solve_sched(data, op, jit_val, *sched[1:])

    def joint_solve_esc(data, op):
        return joint_solve_sched(data, op, jnp.float32(0.0),
                                 *esc_sched[1:])

    def run_cycle(data_dev, op_dev, M, npp, jit_val=0.0):
        x, info = joint_solve(data_dev, op_dev, jnp.float32(jit_val))
        x = np.asarray(x, dtype=np.float64)
        N = x.shape[0]
        return x.transpose(0, 2, 1).reshape(N, M, npp, 3), info

    def run_escalation(data_dev, op_dev, ctrl, M, npp):
        """Warm polish extension (qp/joint.py ESCALATION_*): x0 <- the
        solution whose oracle margin exceeded the trigger, re-solve with
        the polish-heavy schedule."""
        import dataclasses
        N = ctrl.shape[0]
        d = dataclasses.replace(
            data_dev, x0=jnp.asarray(
                ctrl.reshape(N, M * npp, 3).transpose(0, 2, 1),
                jnp.float32))
        x, info = joint_solve_esc(d, op_dev)
        x = np.asarray(x, dtype=np.float64)
        return x.transpose(0, 2, 1).reshape(N, M, npp, 3), info

    # ---- gate across seeds (one compiled program; data changes only) ----
    per_seed = {}
    first = {}
    escalated_seeds = []
    first_cycle_s = None
    stacked = []          # gated (data_dev, op_dev) sharing seed-0's M
    for seed in GATE_SEEDS:
        plan, mission, param = build_problem(seed)
        t_asm0 = time.perf_counter()
        data, dummy = assemble_joint(plan, mission, param)
        data_dev = jax.tree.map(jnp.asarray, data)
        jax.block_until_ready(data_dev.pair_rhs)
        asm_s = time.perf_counter() - t_asm0
        t0 = time.perf_counter()
        # host-f64 KKT prep, rounded once to f32 (see prepare_ns_np):
        # dummy-independent, so production replans amortize it
        op = nullspace.prepare_ns_np(data, phases[0])
        op_dev = jax.device_put(op)
        prep_s = time.perf_counter() - t0
        log(f"seed {seed}: host-f64 prep+transfer {prep_s:.1f}s")
        t0 = time.perf_counter()
        ctrl, info = run_cycle(data_dev, op_dev, plan.M, param.n + 1)
        cyc_s = time.perf_counter() - t0
        if first_cycle_s is None:
            first_cycle_s = cyc_s          # includes the main compile
        log(f"seed {seed}: cycle (incl. compile on first) "
            f"{cyc_s:.1f}s iters={int(info.iters)} "
            f"rp={float(info.r_prim):.1e}")
        # rotate the best-response oracle batch across seeds so the
        # objective gate covers distinct agents
        from swarm_simulator_tpu.parallel import seqbatch
        n_batches = len(seqbatch.make_batches(mission.qn, param)[0])
        b_idx = oracle_batch(seed, n_batches)
        obj_b0, _ = batch0_objective(ctrl, plan, mission, param, b_idx)
        obj_ref, ipm_s = ipm_best_response_batch0(plan, mission, param,
                                                  ctrl, b_idx)
        log(f"seed {seed}: IPM best-response batch {b_idx} "
            f"obj={obj_ref:.4f} ours={obj_b0:.4f} "
            f"({ipm_s:.1f}s/IPM solve f64 CPU)")
        # BENCH_ESC_TRIGGER overrides the production trigger (1.15) so
        # the escalation path can be FORCED to fire in a device run —
        # the artifact then carries the warm-escalation compile + cycle
        # cost and the post-escalation gate measured on the device
        esc_trigger = float(os.environ.get("BENCH_ESC_TRIGGER",
                                           qjoint.ESCALATION_TRIGGER))
        if obj_b0 > esc_trigger * obj_ref:
            # margin-triggered warm polish extension (round-4): both
            # sides of the margin are recomputed — the best-response
            # optimum depends on the other agents' final trajectories
            log(f"seed {seed}: margin {obj_b0 / obj_ref:.3f} > "
                f"{esc_trigger} — escalating "
                f"({qjoint.ESCALATION_BUDGETS} warm polish)")
            ctrl, info = run_escalation(data_dev, op_dev, ctrl, plan.M,
                                        param.n + 1)
            obj_b0, _ = batch0_objective(ctrl, plan, mission, param,
                                         b_idx)
            obj_ref, ipm_s = ipm_best_response_batch0(
                plan, mission, param, ctrl, b_idx)
            escalated_seeds.append(seed)
            log(f"seed {seed}: escalated margin "
                f"{obj_b0 / obj_ref:.3f} (+{int(info.iters)} iters)")
        ok, m = gate_quality(ctrl, plan, mission, param, obj_ref, obj_b0)
        log(f"seed {seed}: gate={'OK' if ok else 'FAIL'} {m}")
        per_seed[seed] = (ok, m)
        if seed == GATE_SEEDS[0]:
            first = dict(data_dev=data_dev, op_dev=op_dev, plan=plan,
                         ipm_s=ipm_s, prep_s=prep_s, op=op,
                         iters=int(info.iters), ctrl=ctrl,
                         mission=mission, param=param, asm_s=asm_s,
                         n_batches=n_batches)
        if plan.M == first["plan"].M and seed not in escalated_seeds:
            # keep for the aggregate-throughput interleave below
            # (~232 MB pivot inventory per seed on device).  Escalated
            # seeds are EXCLUDED: the rotation re-runs the base solve,
            # whose output passed the oracle-margin gate only after the
            # escalation extension — timing it alone would claim gate
            # quality the base dispatch does not deliver
            stacked.append((data_dev, op_dev))
        if not ok:
            log(f"seed {seed} FAILED the gate — benchmark aborts "
                f"(no timing without quality)")
            print(json.dumps({
                "metric": "plan_cycles_per_s_64agents_forest",
                "value": 0.0, "unit": "cycles/s", "vs_baseline": 0.0,
                "gate_failed_seed": seed, "oracle_batch": b_idx, **m}))
            return

    # ---- timing on seed 0 (quality already verified on all seeds) ----
    plan = first["plan"]
    data_dev = first["data_dev"]
    reps = 3
    t0 = time.perf_counter()
    for rr in range(reps):
        run_cycle(data_dev, first["op_dev"], plan.M, 6,
                  jit_val=4.3e-6 * (rr + 1))
    dt_cycle = (time.perf_counter() - t0) / reps
    log(f"cycle (sequential latency): {dt_cycle:.3f}s")

    # throughput: depth-2 software pipeline — materialize cycle r while
    # r+1 runs on the device.  The synchronous protocol above pays one
    # full dispatch+readback round trip per cycle; a streaming planner
    # overlaps that, which is what a deployed replanner does.  Both numbers go in the
    # JSON: cycle_warm_s (latency) and the pipelined headline.
    def dispatch_cycle(jit_val):
        x, _ = joint_solve(data_dev, first["op_dev"],
                           jnp.float32(jit_val))
        return x

    # DISPERSION GUARD: host-side contention can swing a single 10-rep
    # mean run-to-run.  Measure k=4 independent 10-dispatch pipelined
    # windows;
    # the HEADLINE is the MEDIAN window, value_best is the best, and
    # the JSON carries the per-window rates + relative spread so a
    # contaminated run is visible in the artifact itself.
    preps, k_windows = 10, 4
    win_rates = []
    for w in range(k_windows):
        prev = None
        t0 = time.perf_counter()
        for rr in range(preps):
            h = dispatch_cycle(7.7e-7 * (w * preps + rr + 1))
            if prev is not None:
                np.asarray(prev)
            prev = h
        np.asarray(prev)
        win_rates.append(preps / (time.perf_counter() - t0))
    win_rates.sort()
    cycles_per_s = float(np.median(win_rates))
    cycles_best = win_rates[-1]
    dispersion = (win_rates[-1] - win_rates[0]) / cycles_per_s
    dt_pipe = 1.0 / cycles_per_s
    log(f"cycle: {dt_pipe:.3f}s pipelined (depth-2, median of "
        f"{k_windows} windows) -> {cycles_per_s:.2f} gate-verified "
        f"64-agent planning cycles/s (best {cycles_best:.2f}, spread "
        f"{100 * dispersion:.0f}%, {1.0 / dt_cycle:.2f} synchronous)")
    if dispersion > 0.15:
        log(f"WARNING: window spread {100 * dispersion:.0f}% > 15% — "
            f"host contention likely; median reported, treat "
            f"value_best as the uncontended capability")

    # ---- aggregate throughput: round-robin interleave over the gated,
    # NON-escalated seed problems (distinct forests, one M bucket, one
    # executable) — the scenario-stacking dimension of SURVEY §2:
    # 3 x S depth-2 dispatches per window, median of k windows.
    agg_cycles_per_s = agg_best = None
    if len(stacked) >= 2:
        agg_rates = []
        for w in range(3):
            n_disp = 3 * len(stacked)
            prev = None
            t0 = time.perf_counter()
            for rr in range(n_disp):
                d_s, o_s = stacked[rr % len(stacked)]
                h, _ = joint_solve(d_s, o_s,
                                   jnp.float32(7.7e-7 * (rr + 1)))
                if prev is not None:
                    np.asarray(prev)
                prev = h
            np.asarray(prev)
            agg_rates.append(n_disp / (time.perf_counter() - t0))
        agg_rates.sort()
        agg_cycles_per_s = float(np.median(agg_rates))
        agg_best = agg_rates[-1]
        log(f"aggregate (interleave over {len(stacked)} gated "
            f"forests, median of 3 windows): "
            f"{agg_cycles_per_s:.2f} cycles/s (best {agg_best:.2f})")

    # ---- baseline: CPLEX-class barrier, 16 sequential solves, CPU ----
    # The denominator is itself noisy on a contended host (one sample
    # has swung vs_baseline 2x) — time the seed-0 oracle IPM
    # solve 2 more times and use the MEDIAN of 3, reporting the spread.
    ipm_times = [first["ipm_s"]]
    b0 = oracle_batch(GATE_SEEDS[0], first["n_batches"])
    for _ in range(2):
        _, dt_i = ipm_best_response_batch0(
            first["plan"], first["mission"], first["param"],
            first["ctrl"], b0)
        ipm_times.append(dt_i)
    ipm_times.sort()
    ipm_med = float(np.median(ipm_times))
    base_cycle_s = 16.0 * ipm_med
    log(f"baseline: f64 interior-point {ipm_med:.1f}s/batch-solve "
        f"(3 timings {ipm_times[0]:.1f}-{ipm_times[-1]:.1f}s) "
        f"x 16 batches -> {base_cycle_s:.1f}s/cycle (single CPU core "
        f"class)")

    # cold cycle: everything a first plan pays (search + corridor +
    # QP assembly + data transfer + host-f64 prep + transfer + solve);
    # warm = solve-only on the device-resident operator (both are
    # reported)
    stage = getattr(first["plan"], "stage_s", {})
    cycle_cold_s = (stage.get("search", 0.0) + stage.get("corridor", 0.0)
                    + first["asm_s"] + first["prep_s"] + dt_cycle)

    # ---- corridor-refresh REPLAN cycle (the production "device" mode:
    # on-device f32 prep of the FRESH operator + kkt_refine=1 PCG,
    # tools/replan_study.py) — the true outer-iteration cost
    # the reference pays per rbp_planner.hpp:140 round ----
    import dataclasses

    from swarm_simulator_tpu.corridor.rsfc import build_rsfc
    from swarm_simulator_tpu.qp import joint as qjoint

    plan0, mission0, param0 = first["plan"], first["mission"], \
        first["param"]
    ctrl0 = first["ctrl"]
    knots = np.concatenate([ctrl0[:, :, 0, :], ctrl0[:, -1:, -1, :]],
                           axis=1)
    _, normals = build_rsfc(knots, param0.downwash)
    plan0.pair_normals = np.asarray(normals, np.float64)
    data1, _ = qjoint.assemble_joint(plan0, mission0, param0, dummy=ctrl0)
    d1_dev = jax.tree.map(jnp.asarray, data1)
    rphases = qjoint.production_phases(kkt_refine=1)
    prep_jit = jax.jit(lambda d: nullspace.prepare_ns(d, rphases[0]))
    rsolve = jax.jit(lambda d, o: nullspace.solve_ns_phases(
        d, rphases, op=o))
    # first call compiles; time warm prep + warm solve
    op_r = prep_jit(d1_dev)
    x_r, _ = rsolve(d1_dev, op_r)
    np.asarray(x_r)
    best = np.inf
    for rr in range(2):
        dj = dataclasses.replace(
            d1_dev, pair_n=d1_dev.pair_n * (1.0 + jnp.float32(1e-7)),
            x0=d1_dev.x0 + jnp.float32(3.1e-6 * (rr + 1)))
        t0 = time.perf_counter()
        op_r = prep_jit(dj)
        x_r, _ = rsolve(dj, op_r)
        x_r = np.asarray(x_r, np.float64)
        best = min(best, time.perf_counter() - t0)
    ctrl_r = x_r.transpose(0, 2, 1).reshape(x_r.shape[0], plan0.M, 6, 3)
    rok, rm = gate_quality(ctrl_r, plan0, mission0, param0)
    log(f"replan (device prep + refine-1): {best:.2f}s/cycle "
        f"gate={'OK' if rok else 'FAIL'} ratio={rm['ratio']:.4f}")

    # cold-start, DEVICE-prep mode (cold_prep="device" in
    # qp/joint.solve_trajectories): time-to-first-plan = host stages +
    # on-device f32 prep + refine-1 solve.  The prep+solve program is
    # the replan program just timed (same shapes, same phases), so
    # `best` IS its warm cost; first-compile walls are reported
    # separately (both cold modes + compile are in the JSON).
    cycle_cold_device_s = (stage.get("search", 0.0)
                           + stage.get("corridor", 0.0)
                           + first["asm_s"] + best)
    compile_s = max(0.0, first_cycle_s - dt_cycle)
    log(f"cold-start: host-prep {cycle_cold_s:.2f}s / device-prep "
        f"{cycle_cold_device_s:.2f}s; main-program compile "
        f"{compile_s:.1f}s (persistent cache "
        f"{'hit' if compile_s < 5.0 else 'miss'})")

    m0 = per_seed[GATE_SEEDS[0]][1]
    worst_margin = max(mm["obj_b0"] / mm["obj_ref"]
                       for _, mm in per_seed.values()
                       if "obj_ref" in mm)
    out = {
        "metric": "plan_cycles_per_s_64agents_forest",
        "value": round(cycles_per_s, 3),
        "unit": "cycles/s",
        "vs_baseline": round(cycles_per_s * base_cycle_s, 1),
        # dispersion guard: value = MEDIAN of k pipelined windows;
        # high_variance flags host contention
        "value_best": round(cycles_best, 3),
        "value_windows": [round(r, 2) for r in win_rates],
        "dispersion": round(dispersion, 3),
        "high_variance": bool(dispersion > 0.15),
        "ipm_baseline_s": [round(t, 2) for t in ipm_times],
        "gate_seeds": len(GATE_SEEDS),
        "ratio_seed0": m0["ratio"],
        "obj_vs_ipm": round(m0["obj_b0"] / m0["obj_ref"], 3),
        "oracle_batches": [oracle_batch(s, first["n_batches"])
                           for s in GATE_SEEDS],
        "worst_margin": round(worst_margin, 3),
        "escalated_seeds": escalated_seeds,
        "cycle_warm_s": round(dt_cycle, 3),
        "cycle_warm_pipelined_s": round(dt_pipe, 3),
        "cycle_cold_s": round(cycle_cold_s, 3),
        "cycle_cold_device_s": round(cycle_cold_device_s, 3),
        "compile_main_s": round(compile_s, 1),
        "replan_cycle_s": round(best, 3),
        "replan_gate_ok": bool(rok),
        "time_scale_seed0": m0["time_scale"],
        "device": device,
    }
    if agg_cycles_per_s is not None:
        out["aggregate_cycles_per_s"] = round(agg_cycles_per_s, 3)
        out["aggregate_cycles_per_s_best"] = round(agg_best, 3)
        out["aggregate_problems"] = len(stacked)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
