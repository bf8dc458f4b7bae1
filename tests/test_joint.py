"""The production joint-solve path, gated in CI.

The headline bench (bench.py) solves the canonical 64-agent 20-obstacle
forest as ONE joint QP (all 2016 pair constraints active, banded KKT) —
this test pins that exact path at CPU float32 so a regression in solver,
corridor, or assembly code cannot silently lose the gate.  Runtime is
dominated by the 900-iteration phased solve (~30 s CPU).
"""
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def test_joint_64agent_forest_gate():
    import jax

    import bench
    from swarm_simulator_tpu.qp import nullspace

    plan, mission, param = bench.build_problem(seed=0)
    data, dummy = bench.assemble_joint(plan, mission, param)
    with jax.default_device(jax.devices("cpu")[0]):
        x, info = jax.jit(
            lambda d: nullspace.solve_ns_phases(d, bench.ns_phases()))(data)
    x = np.asarray(x, np.float64)
    ctrl = x.transpose(0, 2, 1).reshape(64, plan.M, param.n + 1, 3)
    ok, m = bench.gate_quality(ctrl, plan, mission, param)
    assert ok, m
    # the gate itself asserts ratio >= 1, continuity, endpoints, boxes;
    # additionally pin the objective region (catches silent rho-schedule
    # regressions: the single-walk solver produced 5.8 here, the phased
    # schedule 2.8-3.1)
    assert float(info.obj) < 4.0, float(info.obj)


def test_sweep_artifacts_regression():
    """The committed mission/map sweep artifacts are CI contracts: 21/22
    reference missions and 43/50 stored maps collision-free (asserted,
    not just committed)."""
    import json

    root = ROOT / "benchmarks"
    missions = [json.loads(line) for line in
                (root / "mission_sweep_cpu_f64.jsonl").read_text()
                .splitlines() if line.strip()]
    ok = [m for m in missions if m.get("ok")]
    assert len(missions) == 22, len(missions)
    assert len(ok) >= 21, len(ok)

    maps = [json.loads(line) for line in
            (root / "sweep50_8agents_cpu_f64.jsonl").read_text()
            .splitlines() if line.strip() and line.startswith("{")]
    ok_maps = [m for m in maps if m.get("ok")]
    assert len(maps) == 50, len(maps)
    assert len(ok_maps) >= 43, len(ok_maps)

    # the JOINT production path matches the sequential contract on the
    # same mission suite (tools/mission_sweep.py --solver nullspace);
    # the single failure is mission_8agents_120 (r=1.2 agents cannot
    # fit the ECBS grid — infeasible for the reference too)
    joint = [json.loads(line) for line in
             (root / "mission_sweep_joint_cpu.jsonl").read_text()
             .splitlines() if line.strip()]
    ok_joint = [m for m in joint if m.get("ok")]
    assert len(joint) == 22, len(joint)
    assert len(ok_joint) >= 21, len(ok_joint)

    # ... and the 50-map contract (cli/sweep --solver nullspace): the
    # same 43/50, failing on exactly the 7 mission-infeasible maps
    jm = [json.loads(line) for line in
          (root / "sweep50_joint_cpu.jsonl").read_text().splitlines()
          if line.strip()]
    ok_jm = [m for m in jm if m.get("ok")]
    assert len(jm) == 50, len(jm)
    assert len(ok_jm) >= 43, len(ok_jm)


def test_production_recipe_pinned():
    """The production joint recipe is a measured artifact — pin its
    load-bearing constants so refactors cannot silently drift them:
    phase budgets (200, 600, 100) = the 10-seed knee
    (benchmarks/schedule_seeds5-9_cpu.log, cadence_study_cpu.log), the
    5-rung ladder logspace(1e-5, 1e-2) (rung_usage_cpu.log), banded
    KKT, and the rho fences."""
    import numpy as np

    from swarm_simulator_tpu.qp import joint, nullspace

    s = joint.production_settings()
    assert s.kkt_mode == "banded"
    assert (s.n_rungs, s.rho_min, s.rho_max) == (5, 1e-5, 1e-2)
    assert s.tighten == 2e-3 and s.warm_start == "x0"
    assert s.aa_depth == 0 and s.kkt_refine == 0  # measured defaults
    # the solver's whole option surface: one KKT-apply path per mode,
    # no kernel-selection knobs
    import dataclasses
    assert {f.name for f in dataclasses.fields(nullspace.NSSettings)} == {
        "rho", "sigma", "alpha", "max_iter", "eps_abs", "eps_rel",
        "eps_dual_abs", "check_every", "adaptive_rho", "rho_min",
        "rho_max", "n_rungs", "adapt_threshold", "rho_lo", "rho_hi",
        "warm_start", "kkt_mode", "tighten", "kkt_refine", "aa_depth"}
    ladder = np.logspace(np.log10(s.rho_min), np.log10(s.rho_max),
                         s.n_rungs)
    old9 = np.logspace(-5, 1, 9)
    np.testing.assert_allclose(ladder, old9[:5], rtol=1e-12)

    ph = joint.production_phases()
    assert tuple(p.max_iter for p in ph) == (200, 600, 100)
    assert (ph[0].rho_lo, ph[1].rho_lo, ph[2].rho_lo) == (1e-3, None,
                                                          1e-2)
    # every phase shares one base: the schedule compiles to ONE
    # executable, and the escalation schedule reuses it
    s0, _, _, _ = nullspace.schedule_arrays(ph)
    assert nullspace.schedule_arrays(joint.escalation_phases(ph))[0] == s0
    # replan schedules derived with kkt_refine keep everything else
    r = joint.production_phases(base=ph[1], kkt_refine=1)
    assert all(p.kkt_refine == 1 for p in r)
    assert tuple(p.max_iter for p in r) == (200, 600, 100)


def test_large_swarm_defaults_are_licensed_recipe():
    """Policy pins: a plain solve_trajectories caller at >= 128 agents
    gets the ORACLE-LICENSED recipe by default — polish(4) after the
    cold solve (only cold+polish(4) came under the 1.25 bar,
    tools/oracle256_study.py) — and large-swarm replans default to
    FULL budgets (the short REPLAN_BUDGETS_LARGE schedule never met
    the 1.25 licensing bar)."""
    from swarm_simulator_tpu.qp import joint

    assert joint.polish_rounds_for_swarm(256) == 4
    assert joint.polish_rounds_for_swarm(128) == 4
    assert joint.polish_rounds_for_swarm(64) == 0
    assert joint.polish_rounds_for_swarm(2) == 0

    # the auto default flows through solve_trajectories: a tiny solve
    # reports polish_rounds 0 (auto), an explicit request is honored
    from __graft_entry__ import _tiny_plan

    from swarm_simulator_tpu.core.types import Param

    plan, mission, dummy = _tiny_plan(n_agents=2, M=4)
    param = Param(solver_dtype="float32", time_scale=False)
    phases = joint.production_phases((30, 60, 30))
    p1 = joint.solve_trajectories(plan, mission, param, phases=phases)
    assert p1.solver_info["polish_rounds"] == 0
    p2 = joint.solve_trajectories(plan, mission, param, phases=phases,
                                  polish_rounds=1)
    assert p2.solver_info["polish_rounds"] == 1


def test_kkt_path_autoselection(monkeypatch):
    """One KKT path for every backend: whatever jax.default_backend()
    reports, solve_trajectories runs the same banded phases through
    XLA's Thomas scan (nullspace.make_kinv_apply) — no backend name
    routes the solve to a device-specific kernel."""
    import jax

    from __graft_entry__ import _tiny_plan

    from swarm_simulator_tpu.core.types import Param
    from swarm_simulator_tpu.qp import joint, nullspace

    param = Param(solver_dtype="float32", time_scale=False)
    phases = joint.production_phases((30, 60, 30))
    seen = {}
    run = joint._run_schedule

    def spy(data_dev, op_dev, ph):
        seen.setdefault(jax.default_backend(), []).append(
            (ph, op_dev.Dinvs.shape))
        return run(data_dev, op_dev, ph)

    monkeypatch.setattr(joint, "_run_schedule", spy)
    ctrls = {}
    for backend in ("cpu", "gpu", "cuda", "rocm"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        plan, mission, _ = _tiny_plan(n_agents=2, M=4)
        joint.solve_trajectories(plan, mission, param, phases=phases)
        ctrls[backend] = plan.ctrl
    # same schedules, same [R, Mi, bs, bs] banded pivot layout, same
    # solution on every backend name
    ref = seen["cpu"]
    assert all(p.kkt_mode == "banded" for ph, _ in ref for p in ph)
    assert ref[0][1] == (5, 3, 18, 18)
    for backend, calls in seen.items():
        assert calls == ref, backend
        np.testing.assert_array_equal(ctrls[backend], ctrls["cpu"])
    # and the banded apply is the only one a banded operator gets
    op = nullspace.prepare_ns_np(
        joint.assemble_joint(plan, mission, param)[0], phases[0])
    assert op.Kinvs is None and op.Dinvs.ndim == 4


def test_replan_prep_device_collision_free():
    """replan_prep='device' (the accelerator-default replan mode:
    on-device f32 prep of the fresh operator + kkt_refine=1 PCG) must
    plan a corridor-refresh round collision-free — CPU twin of the
    device mode (tools/replan_study.py)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import swarm_simulator_tpu as sst
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.eval.safety import safety_margin_ratio
    from swarm_simulator_tpu.eval.sample import (sample_times,
                                                 sample_trajectories)
    from swarm_simulator_tpu.qp import joint
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF
    from swarm_simulator_tpu.world.forest import generate_forest
    from test_parity_ipm import mission_8agents

    mission = mission_8agents()
    param = sst.Param(world_z_min=0.0, solver_dtype="float32",
                      grid_xy_res=0.5, grid_z_res=0.5,
                      solver="nullspace", iteration=2)
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=6,
                            h_min=1.0, h_max=2.5, margin=0.5, seed=3)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)

    joint.solve_trajectories(plan, mission, param, replan_prep="device")
    assert plan.solver_info["replan_rounds"] == 1

    ts = sample_times(np.asarray(plan.T), 0.1)
    pos = np.asarray(sample_trajectories(
        jnp.asarray(plan.coef), jnp.asarray(np.asarray(plan.T)),
        jnp.asarray(ts), n=param.n, derivatives=1))[:, :, 0]
    ratio = float(safety_margin_ratio(
        jnp.asarray(pos), jnp.asarray(mission.radius),
        downwash=param.downwash))
    assert ratio >= 1.0, ratio
    goal_err = np.abs(plan.ctrl[:, -1, -1] - mission.goal[:, :3]).max()
    assert goal_err < 1e-4, goal_err


def test_cold_prep_device_collision_free():
    """cold_prep='device': the low-latency first plan (on-device f32
    prep + refine-1 phases for round 0) must land collision-free with
    goal pins — the time-to-first-plan mode (at 256 agents host prep
    takes minutes)."""
    import jax.numpy as jnp

    import swarm_simulator_tpu as sst
    from swarm_simulator_tpu.corridor.times import build_corridors
    from swarm_simulator_tpu.eval.safety import safety_margin_ratio
    from swarm_simulator_tpu.eval.sample import (sample_times,
                                                 sample_trajectories)
    from swarm_simulator_tpu.qp import joint
    from swarm_simulator_tpu.search.planner import plan_initial_trajectories
    from swarm_simulator_tpu.world.esdf import ESDF
    from swarm_simulator_tpu.world.forest import generate_forest
    from test_parity_ipm import mission_8agents

    mission = mission_8agents()
    param = sst.Param(world_z_min=0.0, solver_dtype="float32",
                      grid_xy_res=0.5, grid_z_res=0.5, solver="nullspace")
    world = generate_forest(mission, world_min=param.world_min,
                            world_max=param.world_max, obs_num=6,
                            h_min=1.0, h_max=2.5, margin=0.5, seed=3)
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    plan = plan_initial_trajectories(esdf, mission, param)
    build_corridors(esdf, plan, mission.radius, param)

    joint.solve_trajectories(plan, mission, param, cold_prep="device")
    ts = sample_times(np.asarray(plan.T), 0.1)
    pos = np.asarray(sample_trajectories(
        jnp.asarray(plan.coef), jnp.asarray(np.asarray(plan.T)),
        jnp.asarray(ts), n=param.n, derivatives=1))[:, :, 0]
    ratio = float(safety_margin_ratio(
        jnp.asarray(pos), jnp.asarray(mission.radius),
        downwash=param.downwash))
    assert ratio >= 1.0, ratio
    assert np.abs(plan.ctrl[:, -1, -1] - mission.goal[:, :3]).max() < 1e-4

    import pytest

    with pytest.raises(ValueError, match="stale"):
        joint.solve_trajectories(plan, mission, param,
                                 cold_prep="device", replan_prep="stale")


def test_degenerate_box_guard_and_rescue():
    """Degenerate SFC boxes (zero-width slot / face-only overlap) must
    not make the QP infeasible, and the IPM rescue must restore gate-
    clean boxes.  Mechanism discovered on 64-agent forest seed 17:
    agent 61 segment 13 expands to y in [1.5, 1.5] (a 1-cell corridor
    minus the agent clearance), the solver's blanket 2e-3 tightening
    inverted every row of that segment, and ADMM stalled at box
    residual ~8e-3 for ANY budget (sublinear against a measure-zero
    face — a 600-iteration escalation did not fix it, the exact-IPM
    batch re-solve did)."""
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _tiny_plan

    from swarm_simulator_tpu.core.types import Param
    from swarm_simulator_tpu.qp import assemble, joint, nullspace

    plan, mission, dummy = _tiny_plan(n_agents=2, M=4)
    # agent 0, segment 1: zero-width slot in z at the flight altitude;
    # segment 2: face-only overlap with segment 1 in z
    plan.seg_boxes[0, 1, 2] = plan.seg_boxes[0, 1, 5] = 0.5
    plan.seg_boxes[0, 2, 2] = 0.5
    param = Param(solver_dtype="float64", time_scale=False)

    data = assemble.assemble_batch(plan, mission, param,
                                   np.array([0, 1]), dummy,
                                   device=False)
    # round-5: assembly stores the TRUE bounds (no relaxation) — the
    # tighten-aware knot-face relaxation moved to nullspace._bounds
    n = param.n
    lbv = np.asarray(data.lb).reshape(2, 3, plan.M, n + 1)
    ubv = np.asarray(data.ub).reshape(2, 3, plan.M, n + 1)
    g = assemble.KNOT_FACE_GUARD
    assert lbv[0, 2, 1, 0] == ubv[0, 2, 1, 0] == 0.5  # knot seg0/seg1
    # interior control points of the slot segment stay width-0
    assert lbv[0, 2, 1, 2] == ubv[0, 2, 1, 2] == 0.5

    # solver layer at production tighten: thin knot rows relaxed by
    # min(t, guard) = g around the true intersection, then tightened
    # back — the NET constraint is the exact intersection; no inverted
    # rows anywhere
    l, u = nullspace._bounds(
        jax.tree.map(jnp.asarray, data), tighten=2e-3)
    lbt = np.asarray(l.box).reshape(2, 3, plan.M, n + 1)
    ubt = np.asarray(u.box).reshape(2, 3, plan.M, n + 1)
    assert np.isclose(lbt[0, 2, 1, 0], 0.5) and np.isclose(
        ubt[0, 2, 1, 0], 0.5)
    assert float(jnp.min(u.box - l.box)) >= 0.0
    # tighten=0 consumers (IPM oracle, plain solve_ns) see TRUE bounds
    l0, u0 = nullspace._bounds(jax.tree.map(jnp.asarray, data), 0.0)
    assert np.array_equal(np.asarray(l0.box), np.asarray(data.lb))
    assert np.array_equal(np.asarray(u0.box), np.asarray(data.ub))
    # barrier consumers get positive slack via relax_thin_knot_rows
    lb_r, ub_r = assemble.relax_thin_knot_rows(
        np.asarray(data.lb), np.asarray(data.ub), n)
    rv = lb_r.reshape(2, 3, plan.M, n + 1)
    assert np.isclose(rv[0, 2, 1, 0], 0.5 - 5e-4)

    # the production phases solve it gate-clean (feasible by
    # construction: the straight z=0.5 line satisfies the slot)
    phases = joint.production_phases((50, 150, 50))
    x, info = nullspace.solve_ns_phases(
        jax.tree.map(jnp.asarray, data), phases)
    ctrl = np.asarray(x, np.float64).transpose(0, 2, 1).reshape(
        2, plan.M, n + 1, 3)
    boxes = plan.seg_boxes
    viol = float(np.maximum(boxes[:, :, None, :3] - ctrl,
                            ctrl - boxes[:, :, None, 3:]).max())
    assert viol < 1e-3, viol

    # rescue: perturb the slot segment out of its box and demand the
    # IPM batch re-solve restore gate-clean boxes without moving the
    # untouched agent
    bad = ctrl.copy()
    bad[0, 1, :, 2] += 0.01
    out, rescued = joint.rescue_box_batches(plan, mission, param, bad)
    assert rescued == [0]
    viol = float(np.maximum(boxes[:, :, None, :3] - out,
                            out - boxes[:, :, None, 3:]).max())
    assert viol < 1e-3, viol
    # both agents share batch 0, so both were re-solved exactly:
    # endpoints must still pin to the mission
    assert np.abs(out[:, 0, 0] - mission.start[:, :3]).max() < 1e-6
    assert np.abs(out[:, -1, -1] - mission.goal[:, :3]).max() < 1e-6
