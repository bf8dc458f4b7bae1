"""Joint all-agent trajectory optimization: the production device path.

Where the reference decomposes the swarm QP into sequential CPLEX
batches with dummy coupling (rbp_planner.hpp:140-204), the joint path
solves the WHOLE swarm as ONE QP — every SFC box and every RSFC pair
constraint simultaneously active — via the knot-state ADMM over the
block-tridiagonal banded KKT (qp/nullspace.py, kkt_mode="banded").
This removes the sequential path's stale-coupling consensus error
(measured 82x in objective at 256 agents) and is the benchmark
headline path (bench.py).

The recipe:
  1. assemble the joint QP on host (one bulk device transfer),
  2. host-f64 KKT rung inventory (prepare_ns_np), rounded once to f32,
  3. phased rho schedule (feasibility -> polish -> restore) on device.

Outer corridor iteration (replans): the reference's outer loop
re-solves with refreshed coupling (rbp_planner.hpp:140); here a replan
rebuilds the RSFC normals from the previous solution and re-solves
WITHOUT re-running the expensive prep — refresh_ns_op_np recomputes
the endpoint-dependent leaves in milliseconds and NSSettings.kkt_refine
(preconditioned-CG w-updates against the fresh constraints) absorbs
the stale inventory metric (tools/staleop_study.py).
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial

import jax
import numpy as np

from ..core.types import Mission, Param, PlanResult
from . import assemble, convert, nullspace

#: phase budgets tuned on the canonical 64-agent forest
#: (tools/schedule_study.py: (200, 600, 100) passes ten forest seeds;
#: shorter schedules fail seeds 4/8 — see bench.py ns_phases)
PRODUCTION_BUDGETS = (200, 600, 100)

#: margin-triggered escalation (round-4): when a solution's objective
#: margin vs the IPM best-response oracle exceeds ESCALATION_TRIGGER,
#: re-solve warm-started from it (x0 <- solution) with these budgets —
#: a polish extension reusing the replan mechanism, no new solver
#: features.  Measured on forest seeds 0-9
#: (benchmarks/margin_escalation_cpu.json): triggering seeds drop
#: below the bound at ~0.67x the base solve's extra cost.  The bench
#: gate applies this; production callers without an oracle can trigger
#: on their own margin estimate.
ESCALATION_TRIGGER = 1.15
ESCALATION_BUDGETS = (100, 400, 100)


def budgets_for_swarm(qn: int) -> tuple[int, int, int]:
    """Default phase budgets by swarm size.  <= 64 agents keep the
    10-seed-tuned PRODUCTION_BUDGETS.  Larger swarms currently keep the
    same schedule — tools/oracle256_study.py measures what the budget
    dial costs against the rotating IPM best-response oracle at 256
    agents; a cheaper schedule is only adopted here once that margin is
    <= the 1.25 gate bound."""
    del qn
    return PRODUCTION_BUDGETS


def polish_rounds_for_swarm(qn: int) -> int:
    """Default warm polish extensions after the cold solve.  Big swarms
    (>= 128 agents) NEED them to reach the 64-agent objective-margin
    standard: against the 256-agent rotating IPM best-response oracle
    only cold+polish(4) came under the 1.25 bar (tools/oracle256_study.py)
    — so polish(4) IS the production default there, not an opt-in flag
    (matches the reference's always-optimal CPLEX solve,
    rbp_planner.hpp:158).  Small swarms meet the bar without polish."""
    return 4 if qn >= 128 else 0


#: short per-round replan budgets for big swarms (>= 128 agents),
#: EXPLICIT OPT-IN ONLY (the production default remains the FULL
#: phase budgets).  The budget/margin frontier measured with an 8-batch
#: rotating oracle (tools/replan256_chain.py): per-round worst margin
#: is a pure function of the iteration budget, and a short solve plus a
#: polish extension lands WORSE than the same budget spent contiguously
#: (the split restarts the feasibility phases) — so the short schedule
#: is the best contiguous point (100, 600, 100).  No arm met the 1.25
#: licensing bar; benchmarks/oracle256_anchor.json calibrates
#: how much of the residual margin is looseness of the best-response
#: BOUND itself (a rotating 4-agent best-response optimum is a lower
#: bound the exact joint optimum also cannot reach).
REPLAN_BUDGETS_LARGE = (100, 600, 100)

#: per-round warm polish extensions when the short large-swarm replan
#: schedule is chosen (solve_trajectories replan_polish auto).
#: SPLIT budgets measured strictly worse than the same budget spent
#: contiguously, so the auto default is 0; the mechanism stays
#: for callers escalating a specific round on a margin estimate.
REPLAN_POLISH_LARGE = 0


def escalation_phases(base_phases) -> tuple:
    """Warm polish-extension schedule derived from ``base_phases``:
    same settings, ESCALATION_BUDGETS, warm_start='x0' (callers
    set data.x0 to the solution being escalated)."""
    b = dataclasses.replace(base_phases[1], warm_start="x0")
    return tuple(
        dataclasses.replace(b, max_iter=mi, rho_lo=lo)
        for mi, lo in zip(ESCALATION_BUDGETS, (1e-3, None, 1e-2)))


def production_settings(max_iter: int = 1500,
                        check_every: int = 50) -> nullspace.NSSettings:
    """The production joint-solver settings (bench.py's gate-passing
    configuration): banded KKT, 5-rung rho ladder, tighten margin for
    first-order residual infeasibility at the strict ratio >= 1 gate.

    Ladder: logspace(1e-5, 1e-2, 5) — the exact bottom five rungs of
    the original 9-rung logspace(1e-5, 1e1, 9).  tools/rung_usage.py
    (seeds 0-4, production phases): the ADAPTIVE walk only ever visits
    rungs {1e-5, 5.6e-5, 1.78e-3, 1e-2}.  One behavioral change rides
    along: the warm-start rung (nearest to NSSettings.rho=0.1) was
    5.6e-2 on the old ladder and is 1e-2 here, so the first
    check_every chunk runs one rung lower — covered by the 10-seed
    gate re-validation (benchmarks/rung5_gate10_cpu.log)."""
    return nullspace.NSSettings(
        max_iter=max_iter, check_every=check_every,
        eps_abs=2e-4, eps_rel=2e-4, eps_dual_abs=5e-3, tighten=2e-3,
        warm_start="x0", kkt_mode="banded",
        rho_min=1e-5, rho_max=1e-2, n_rungs=5)


def production_phases(budgets: tuple[int, int, int] = PRODUCTION_BUDGETS,
                      base: nullspace.NSSettings | None = None,
                      kkt_refine: int = 0,
                      ) -> tuple[nullspace.NSSettings, ...]:
    """Phased rho schedule: feasibility-first (low rungs fenced out) ->
    objective polish (unfenced) -> feasibility restore (fenced high).
    Every backend runs the XLA banded Thomas path of
    nullspace.make_kinv_apply."""
    b = base if base is not None else production_settings()
    b = dataclasses.replace(b, kkt_refine=kkt_refine)
    return (dataclasses.replace(b, max_iter=budgets[0], rho_lo=1e-3),
            dataclasses.replace(b, max_iter=budgets[1]),
            dataclasses.replace(b, max_iter=budgets[2], rho_lo=1e-2))


def rescue_box_batches(plan, mission, param, ctrl, tol: float = 1e-3):
    """f64 IPM best-response rescue for box-stalled agents.

    SFC boxes can be DEGENERATE (a 1-cell corridor minus the agent
    clearance collapses to a zero-width slot, e.g. 64-agent forest
    seed 17 agent 61 segment 13: y in [1.5, 1.5]).  The instance stays
    FEASIBLE — CPLEX/IPM solve it exactly (rbp_planner.hpp:158) — but
    first-order ADMM converges sublinearly against a measure-zero face
    (measured: box residual 8.2e-3 at 900 iters, 4.5e-3 at 4200; a
    high-rho rescue ladder also stalls).  Production response, the
    reference's own sequential-batch architecture as a FALLBACK: find
    agents violating their boxes beyond ``tol``, re-solve ONLY their
    batches' best-response QPs with the exact f64 interior-point
    solver (everyone else fixed at the joint solution — identical
    one-sided pair rows to rbp_planner.hpp:638-684), splice, and let
    the caller re-gate.  Cost: ~3 s per rescued batch at 64 agents on
    host CPU; rescued agents leave with IPM-exact boxes AND a
    per-batch optimal objective.

    Returns (ctrl, rescued_batch_indices)."""
    from ..parallel import seqbatch
    from . import ipm

    boxes = np.asarray(plan.seg_boxes)
    dm = np.asarray(ctrl, np.float64)
    viol = np.maximum(boxes[:, :, None, :3] - dm,
                      dm - boxes[:, :, None, 3:]).max(axis=(1, 2, 3))
    bad = np.where(viol > tol)[0]
    if bad.size == 0:
        return dm, []
    batches, _ = seqbatch.make_batches(mission.qn, param)
    bad_b = sorted({i for i, b in enumerate(batches)
                    if np.intersect1d(np.asarray(b), bad).size})
    out = dm.copy()
    for bi in bad_b:
        agents = np.asarray(batches[bi])
        data_b = assemble.assemble_batch(plan, mission, param, agents,
                                         out, device=False)
        data_b = jax.tree.map(
            lambda v: np.asarray(v, np.float64)
            if np.asarray(v).dtype in (np.float32, np.float64)
            else np.asarray(v), data_b)
        # relax zero-width duplicated knot rows by 5e-4 (IPM needs
        # positive slack on every inequality; the residual face
        # excursion stays under the 1e-3 gate bound).  Do NOT relax or
        # tighten any other row — a blanket lb+t/ub-t collides with the
        # equality-pinned endpoints sitting on box faces and the IPM
        # diverges (mu -> inf, an infeasibility certificate)
        lb_r, ub_r = assemble.relax_thin_knot_rows(
            np.asarray(data_b.lb), np.asarray(data_b.ub), param.n)
        data_b = dataclasses.replace(data_b, lb=lb_r, ub=ub_r)
        res = ipm.solve_ipm_reduced(data_b)
        ipm.verify_optimal(data_b, res, tol=1e-5)
        out[agents] = convert.x_to_ctrl(res.x, plan.M, param.n)
    return out, bad_b


def assemble_joint(plan: PlanResult, mission: Mission, param: Param,
                   dummy: np.ndarray | None = None):
    """The joint all-agent QP as host numpy (one bulk device transfer
    later).  dummy (the warm start, build_dummy's initTraj midpoint
    interpolation by default — rbp_planner.hpp:513-549) also seeds
    x0."""
    if dummy is None:
        dummy = assemble.build_dummy(plan.init_traj, param.n, plan.M)
    data = assemble.assemble_batch(plan, mission, param,
                                   np.arange(mission.qn), dummy,
                                   device=False)
    return data, dummy


@partial(jax.jit, static_argnames=("phases",))
def _solve_phases_jit(data, op, phases):
    """Each distinct phase schedule compiles once per process; replan
    rounds and repeated solves reuse the executable."""
    return nullspace.solve_ns_phases(data, phases, op=op)


@partial(jax.jit, static_argnames=("s_base",))
def _solve_schedule_jit(data, op, s_base, it_k, lo_k, hi_k):
    """Schedule-array solve: budgets/fences are jit ARGUMENTS, so the
    cold, warm-polish, and escalation schedules (same normalized
    s_base) share ONE executable — the cold-compile cure (a
    three-phase-body program traces the chunk body three times)."""
    return nullspace.solve_ns_schedule(data, op, s_base, it_k, lo_k,
                                       hi_k)


#: device-resident schedule arrays per phase tuple (tiny; avoids 3
#: host->device transfers on every dispatch)
_SCHED_CACHE: dict = {}


def _run_schedule(data_dev, op_dev, phases):
    """Dispatch: schedule-compatible phase tuples go through the
    shared-executable path; anything else falls back to the static
    per-phase program."""
    cached = _SCHED_CACHE.get(phases)
    if cached is None:
        sched = nullspace.schedule_arrays(phases)
        if sched is not None:
            sched = (sched[0],) + tuple(jax.device_put(a)
                                        for a in sched[1:])
        _SCHED_CACHE[phases] = cached = (sched,)
    (sched,) = cached
    if sched is not None:
        s0, it_k, lo_k, hi_k = sched
        return _solve_schedule_jit(data_dev, op_dev, s0, it_k, lo_k,
                                   hi_k)
    return _solve_phases_jit(data_dev, op_dev, phases=phases)


def solve_trajectories(plan: PlanResult, mission: Mission, param: Param,
                       phases: tuple[nullspace.NSSettings, ...] | None = None,
                       replan_budgets: tuple[int, int, int] | None = None,
                       replan_polish: int | None = None,
                       replan_prep: str | None = None,
                       cold_prep: str = "host",
                       dummy: np.ndarray | None = None,
                       polish_rounds: int | None = None,
                       exact_polish: bool = False,
                       ) -> PlanResult:
    """Pipeline entry for Param.solver == "nullspace": fills plan.ctrl /
    plan.coef / plan.solver_info like seqbatch.solve_trajectories.

    exact_polish: finish every round (cold solve and each replan) with
    the host-f64 ACTIVE-SET polish (qp/activeset.py): the ADMM-
    identified active set defines an equality-constrained QP solved by
    one sparse KKT factorization — the KKT-certified EXACT optimum when
    the certificate holds, i.e. what CPLEX returns every solve
    (rbp_planner.hpp:158).  The polish only ever replaces the solution
    with a feasible, certified-or-improving point; its cost and
    certificate land in plan.solver_info["exact_polish"].

    polish_rounds None = auto (polish_rounds_for_swarm: 4 for >= 128
    agents, 0 below).  > 0 runs warm polish extensions after the cold
    solve:
    x0 <- the previous solution (only the x0 leaf changes — the KKT
    inventory stays device-resident, the pair data is unchanged), with
    the ESCALATION_BUDGETS schedule.  The 256-agent oracle study
    (tools/oracle256_study.py) measures what each round buys against
    rotating IPM best-response optima — this is how big swarms reach
    the 64-agent objective-margin standard.

    param.iteration > 1 runs the outer corridor iteration: each extra
    round rebuilds the RSFC separating planes from the PREVIOUS round's
    trajectories (tighter coupling than the initTraj planes, the joint
    analog of the reference's dummy refresh, rbp_planner.hpp:140-204)
    and re-solves warm-started from that round's solution.

    replan_prep — how each round's KKT rung inventory is produced:
      "device"  ON-DEVICE f32 prep of the FRESH operator + kkt_refine=1
                PCG w-updates (tools/replan_study.py): far cheaper than
                fresh host prep, and the precondition quality lost to
                f32 inverses is recovered by PCG against the fresh
                operator.  (prepare_ns pins matmul precision itself —
                without it the low-rho rung inverses come out wrong
                and the solve NaNs.)
      "fresh"   re-runs the host-f64 prep each round — maximum polish
                quality (the bench-headline cold-start mode).
      "stale"   reuses the round-0 inventory via refresh_ns_op_np +
                kkt_refine=1 — milliseconds, but ONLY safe for small
                corridor perturbations; a full RSFC refresh fails the
                gate on the stale inventory (tools/staleop_study.py).
      None      auto: "device" on accelerator backends, "fresh" on CPU.

    cold_prep — the ROUND-0 inventory:
      "host"    host-f64 prep (default): the maximum-polish operator
                (bench headline) at a seconds-class 64-agent host cost.
      "device"  on-device f32 prep + kkt_refine=1 phases for round 0
                too: time-to-first-plan collapses (at 256 agents host
                prep takes minutes; objective parity with host prep
                under refine) at a modestly slower warm cycle (three
                KKT applies per iteration instead of one).
    """
    import jax.numpy as jnp

    from ..corridor.rsfc import build_rsfc

    if polish_rounds is None:
        polish_rounds = polish_rounds_for_swarm(mission.qn)
    if phases is None:
        phases = production_phases()
    if replan_prep is None:
        replan_prep = ("device" if jax.default_backend() != "cpu"
                       else "fresh")
    if replan_prep not in ("fresh", "stale", "device"):
        raise ValueError(f"replan_prep: unknown mode {replan_prep!r}")
    n, M, N = param.n, plan.M, mission.qn

    if cold_prep not in ("host", "device"):
        raise ValueError(f"cold_prep: unknown mode {cold_prep!r}")
    if cold_prep == "device" and replan_prep == "stale":
        raise ValueError("replan_prep='stale' needs the host-resident "
                         "round-0 operator (cold_prep='host')")
    # dummy: the warm start (and x0 seed).  None = the reference's
    # initTraj midpoint interpolation; callers escalating or streaming
    # replans pass the PREVIOUS solution's control points here
    data, dummy = assemble_joint(plan, mission, param, dummy=dummy)
    if cold_prep == "device":
        # low-latency first plan: f32 prep on device + refine-1 phases
        # (quality recovered by PCG against the fresh operator — same
        # recipe as replan_prep="device")
        phases = production_phases(
            tuple(s.max_iter for s in phases), base=phases[1],
            kkt_refine=1)
        t0 = time.perf_counter()
        op = None
        op_dev = jax.jit(
            lambda d: nullspace.prepare_ns(d, phases[0]))(
            jax.tree.map(jnp.asarray, data))
        jax.block_until_ready(op_dev.Dinvs)
        prep_s = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        op = nullspace.prepare_ns_np(data, phases[0])   # host f64, once
        prep_s = time.perf_counter() - t0
        op_dev = jax.device_put(op)     # pivot inventory uploaded ONCE

    def run(data_h, op_d, ph):
        x, info = _run_schedule(jax.tree.map(jnp.asarray, data_h),
                                op_d, ph)
        return convert.x_to_ctrl(np.asarray(x, np.float64), M, n), info

    def run_exact_polish(data_h, ctrl_in):
        from . import activeset
        ctrl2, ainfo = activeset.polish_ctrl(data_h, ctrl_in)
        keep = {k: ainfo.get(k) for k in (
            "accepted", "kkt_optimal", "passes", "n_active", "obj_in",
            "obj_out", "worst_slack_out", "pinned_box_viol", "t_s")}
        return np.asarray(ctrl2, np.float64), keep

    ctrl, info = run(data, op_dev, phases)

    as_info = None
    polish_s = 0.0
    if polish_rounds:
        # warm polish extensions: same problem, same device-resident
        # operator — only the x0 leaf changes (dummy only seeds x0 in
        # the joint solve; there are no fixed-agent pair rows to fold)
        pphases = escalation_phases(phases)
        data_dev = jax.tree.map(jnp.asarray, data)
        for _ in range(polish_rounds):
            t0 = time.perf_counter()
            x0n = jnp.asarray(
                ctrl.reshape(N, M * (n + 1), 3).transpose(0, 2, 1),
                jnp.float32)
            data_dev = dataclasses.replace(data_dev, x0=x0n)
            x, info = _run_schedule(data_dev, op_dev, pphases)
            ctrl = convert.x_to_ctrl(np.asarray(x, np.float64), M, n)
            polish_s += time.perf_counter() - t0

    if exact_polish:
        ctrl, as_info = run_exact_polish(data, ctrl)

    replan_rounds = 0

    if param.iteration > 1:
        # replan phases compile once and are reused across rounds.
        # DEFAULT = the cold phases' FULL budgets at every swarm size:
        # the budget/margin frontier (tools/replan256_chain.py) shows
        # per-round oracle margin is a pure function of iteration
        # budget, no short arm met the 1.25 licensing bar, so short
        # schedules
        # are explicit opt-in via replan_budgets (best contiguous
        # point: REPLAN_BUDGETS_LARGE) — and then forced to
        # kkt_refine>=1 at >= 128 agents (refine-1 recovers host-prep
        # quality exactly; precision_probe_cpu.json).  State-warm
        # (carrying ADMM duals) measured indistinguishable from
        # x0-warm under refine-1.
        rb = (replan_budgets if replan_budgets is not None
              else tuple(s.max_iter for s in phases))
        short = (replan_budgets is not None
                 and sum(rb) < sum(s.max_iter for s in phases))
        rphases = production_phases(
            rb, base=phases[1],
            kkt_refine=1 if (replan_prep in ("stale", "device")
                             or (short and mission.qn >= 128)) else 0)
        prep_jit = (jax.jit(lambda d: nullspace.prepare_ns(d, rphases[0]))
                    if replan_prep == "device" else None)
        # per-round warm polish extensions: the controlled probe
        # (benchmarks/precision_probe_cpu.json) showed replan margin is
        # ITERATION-BUDGET-limited, not precision-limited — polish
        # extensions on the round's own operator are how a short round
        # reaches the licensed margin (see REPLAN_BUDGETS_LARGE)
        rp_polish = (replan_polish
                     if replan_polish is not None
                     else (REPLAN_POLISH_LARGE
                           if mission.qn >= 128 and short else 0))
        rpol_phases = escalation_phases(rphases) if rp_polish else None
        for _ in range(param.iteration - 1):
            knots = np.concatenate(
                [ctrl[:, :, 0, :], ctrl[:, -1:, -1, :]], axis=1)
            try:
                pair_idx, normals = build_rsfc(knots, param.downwash)
            except ValueError:
                # a residually-colliding pair leaves no separating
                # plane — keep the best solved round instead of dying
                break
            assert np.array_equal(pair_idx, np.asarray(plan.pair_idx))
            plan.pair_normals = np.asarray(normals, np.float64)
            data, _ = assemble_joint(plan, mission, param, dummy=ctrl)
            if replan_prep == "stale":
                # only the endpoint-dependent leaves change; the
                # multi-100MB pivot inventory stays device-resident
                op = nullspace.refresh_ns_op_np(op, data)
                op_dev = op_dev._replace(
                    x_pin=jnp.asarray(op.x_pin),
                    g=jnp.asarray(op.g))
            elif replan_prep == "device":
                # fresh-operator prep ON DEVICE (f32 inverses; the
                # kkt_refine=1 PCG in rphases recovers the polish
                # quality against the fresh operator).  Release the
                # PREVIOUS round's inventory first: at 256 agents each
                # is 7.5 GB, and holding both while the fresh one is
                # computed doubles the peak device memory
                t0 = time.perf_counter()
                op_dev = None
                op_dev = prep_jit(jax.tree.map(jnp.asarray, data))
                jax.block_until_ready(op_dev.Dinvs)
                prep_s += time.perf_counter() - t0
            else:
                t0 = time.perf_counter()
                op = nullspace.prepare_ns_np(data, rphases[0])
                prep_s += time.perf_counter() - t0
                op_dev = None          # see replan_prep="device" note
                op_dev = jax.device_put(op)
            ctrl, info = run(data, op_dev, rphases)
            for _ in range(rp_polish):
                # x0 <- the round's solution; same round operator
                data = dataclasses.replace(
                    data, x0=np.asarray(
                        ctrl.reshape(N, M * (n + 1), 3).transpose(
                            0, 2, 1), np.float32))
                ctrl, info = run(data, op_dev, rpol_phases)
            if exact_polish:
                ctrl, as_info = run_exact_polish(data, ctrl)
            replan_rounds += 1

    plan.ctrl = ctrl
    plan.coef = convert.ctrl_to_coef(ctrl, plan.T, n)

    from ..utils.timing import ProblemSize
    psize = ProblemSize.of_batch(N, M, n, param.phi,
                                 len(np.asarray(plan.pair_idx)))
    if param.log:
        print(psize)
        from pathlib import Path
        Path("log").mkdir(exist_ok=True)
        assemble.export_qp_npz("log/qp_joint.npz", data)
    plan.solver_info = {
        "iters": [int(np.asarray(info.iters))],
        "r_prim": [float(np.asarray(info.r_prim))],
        "r_dual": [float(np.asarray(info.r_dual))],
        "obj": [float(np.asarray(info.obj))],
        "mode": "joint-nullspace",
        "solved": np.ones(N, dtype=bool),
        "prep_s": prep_s,
        "polish_rounds": polish_rounds,
        "polish_s": polish_s,
        "replan_rounds": replan_rounds,
        "problem_size": str(psize),
    }
    if as_info is not None:
        plan.solver_info["exact_polish"] = as_info
    return plan
