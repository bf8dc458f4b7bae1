"""Time-scaling unit tests (timeScale, rbp_planner.hpp:209-266)."""
import numpy as np

from swarm_simulator_tpu.core import bernstein
from swarm_simulator_tpu.qp import timescale


def _coef_from_ctrl(ctrl, T, n=5):
    return bernstein.bernstein_to_power(ctrl, np.diff(T), n)


def test_no_scale_when_feasible():
    # gentle straight line: well within limits
    T = np.array([0.0, 1.0, 2.0])
    ctrl = np.zeros((1, 2, 6, 3))
    ctrl[0, 0, :, 0] = np.linspace(0, 0.3, 6)
    ctrl[0, 1, :, 0] = np.linspace(0.3, 0.6, 6)
    coef = _coef_from_ctrl(ctrl[0], T)[None]
    s = timescale.compute_time_scale(
        coef, T, np.full((1, 3), 1.7), np.full((1, 3), 6.2), 5, 3)
    assert s == 1.0


def test_scales_until_limits_met():
    # aggressive segment: exceeds both velocity and acceleration limits
    rng = np.random.default_rng(0)
    T = np.array([0.0, 1.0])
    ctrl = rng.normal(size=(1, 1, 6, 3)) * 4.0
    coef = _coef_from_ctrl(ctrl[0], T)[None]
    max_vel = np.full((1, 3), 1.0)
    max_acc = np.full((1, 3), 2.0)
    s = timescale.compute_time_scale(coef, T, max_vel, max_acc, 5, 3)
    assert s > 1.0
    # 1.1^k grid (reference growth rule)
    k = round(np.log(s) / np.log(1.1))
    assert abs(s - 1.1 ** k) < 1e-9

    coef2, T2 = timescale.apply_time_scale(coef, T, s, 5)
    # dense sampling: limits satisfied after scaling
    ts = np.linspace(0, T2[-1], 500)
    n = 5
    powers = np.arange(n, -1, -1)
    vals_v = np.zeros((len(ts), 3))
    vals_a = np.zeros((len(ts), 3))
    for i, t in enumerate(ts):
        for k3 in range(3):
            c = coef2[0, 0, :, k3]
            dc = np.polyder(c)
            ddc = np.polyder(c, 2)
            vals_v[i, k3] = np.polyval(dc, t)
            vals_a[i, k3] = np.polyval(ddc, t)
    assert np.all(np.abs(vals_v) <= max_vel[0] + 1e-6), np.abs(vals_v).max()
    assert np.all(np.abs(vals_a) <= max_acc[0] + 1e-6), np.abs(vals_a).max()


def test_apply_scale_preserves_endpoints():
    rng = np.random.default_rng(1)
    T = np.array([0.0, 1.0, 2.5])
    ctrl = rng.normal(size=(2, 6, 3))
    coef = _coef_from_ctrl(ctrl, T)[None]
    coef2, T2 = timescale.apply_time_scale(coef, T, 1.331, 5)
    # value at t=0 of each segment unchanged (constant term)
    np.testing.assert_allclose(coef2[..., 5, :], coef[..., 5, :])
    np.testing.assert_allclose(T2, T * 1.331)


def test_bench_gate_applies_time_scaling():
    """bench.gate_quality must compute the reference's timeScale pass
    and verify max_vel/max_acc on the SCALED trajectory: with
    tightened limits the gate reports a
    scale > 1 and still passes; an identical trajectory judged against
    generous limits reports scale == 1."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent.parent))
    import bench
    from __graft_entry__ import _tiny_plan

    from swarm_simulator_tpu.core.types import Param
    from swarm_simulator_tpu.parallel import seqbatch

    plan, mission, dummy = _tiny_plan(n_agents=2, M=4)
    param = Param(solver_dtype="float64", time_scale=False)
    seqbatch.solve_trajectories(plan, mission, param)
    ctrl = np.asarray(plan.ctrl)

    ok, m = bench.gate_quality(ctrl, plan, mission, param)
    assert ok and m["time_scale"] == 1.0, m

    # tighten the velocity limit below the unscaled peak: the gate must
    # scale time until the limit holds and still PASS (scaling keeps
    # the path geometry, so every other check is invariant)
    vmax = m["vel_frac"] * mission.max_vel.max()
    mission.max_vel[:] = 0.5 * vmax
    ok2, m2 = bench.gate_quality(ctrl, plan, mission, param)
    assert ok2, m2
    assert m2["time_scale"] > 1.0
    assert m2["vel_frac"] <= 1.0 + 1e-9
