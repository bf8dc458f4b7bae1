"""RE-EXECUTED sweep contracts: small missions and several forest
worlds are PLANNED ANEW in CI for both solver paths — a code regression
that breaks planning fails here even though the committed JSONL
artifacts are untouched (tests/test_joint.py::
test_sweep_artifacts_regression keeps asserting the full-sweep
numbers).

Mirrors swarm_traj_planner_rbp_test_all.cpp:49-103 (maps, w=1.5 per
plan_rbp_test.launch) and the mission suite the launch files pair with
each world.  The reference's mission files and stored .bt worlds are
not part of this repository, so seeded stand-ins take their place: the
antipodal swaps of io/mission_json.swap_mission with the reference
missions' agent counts and radii, and world/forest.generate_forest
worlds.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import swarm_simulator_tpu as sst
from swarm_simulator_tpu.io.mission_json import swap_mission
from swarm_simulator_tpu.world.forest import generate_forest

sys.path.insert(0, str(Path(__file__).parent))

from test_parity_ipm import mission_8agents  # noqa: E402

#: small/medium missions — one per agent-count tier below the 64-agent
#: gate test (which already re-runs end-to-end in test_joint.py): the
#: 2-agent r = 0.25 m, 4-agent r = 0.15 m and 8-agent r = 0.12 m swaps
CI_MISSIONS = {
    "swap2": lambda: swap_mission(2, z=0.5, span=1.0, radius=0.25),
    "swap4": lambda: swap_mission(4, z=1.0, span=2.0, radius=0.15),
    "swap8": mission_8agents,
}
CI_MAPS = (1, 2, 3, 4, 5)


def _mission_param(mission, solver):
    # the tools/mission_sweep.py recipe: AABB sized to the mission,
    # EDT saturation above the obstacle threshold
    pts = np.concatenate([mission.start[:, :3], mission.goal[:, :3]])
    lo = np.minimum(pts.min(axis=0) - 1.0, [-5.0, -5.0, 0.0])
    hi = np.maximum(pts.max(axis=0) + 1.0, [5.0, 5.0, 2.5])
    rmax = float(np.max(mission.radius))
    param = sst.Param(world_x_min=float(lo[0]), world_y_min=float(lo[1]),
                      world_z_min=0.0, world_x_max=float(hi[0]),
                      world_y_max=float(hi[1]), world_z_max=float(hi[2]),
                      solver_dtype="float64", grid_xy_res=0.5,
                      grid_z_res=1.0,
                      esdf_max_dist=max(1.0, rmax + 0.2 + 0.1),
                      sequential=mission.qn > 8, batch_size=4,
                      batch_iter=-1, solver=solver)
    if solver == "nullspace":
        param = dataclasses.replace(param, solver_dtype="float32")
    return param


@pytest.mark.parametrize("solver", ["admm", "nullspace"])
@pytest.mark.parametrize("name", CI_MISSIONS)
def test_mission_replanned(name, solver):
    mission = CI_MISSIONS[name]()
    param = _mission_param(mission, solver)
    result, _ = sst.plan(mission, param)
    metrics = sst.evaluate(result, mission, param)
    assert metrics["min_safety_ratio"] >= 1.0, (name, solver, metrics)
    assert metrics["goal_err"] < 1e-4, (name, solver, metrics)
    assert metrics["knot_continuity_err"] < 1e-3, (name, solver, metrics)


@pytest.mark.parametrize("solver", ["admm", "nullspace"])
def test_maps_replanned(solver):
    """Five seeded forest worlds, full pipeline, 8-agent mission — the
    test_all sweep contract re-executed (w=1.5, plan_rbp_test.launch)."""
    mission = mission_8agents()
    param = sst.Param(world_z_min=0.0, ecbs_w=1.5, grid_xy_res=0.5,
                      grid_z_res=1.0, sequential=False, batch_size=4,
                      batch_iter=-1,
                      solver_dtype=("float32" if solver == "nullspace"
                                    else "float64"),
                      solver=solver)
    for mi in CI_MAPS:
        world = generate_forest(mission, world_min=param.world_min,
                                world_max=param.world_max, obs_num=6,
                                h_min=1.0, h_max=2.5, margin=0.5, seed=mi)
        result, _ = sst.plan(mission, param, world)
        metrics = sst.evaluate(result, mission, param)
        assert metrics["min_safety_ratio"] >= 1.0, (mi, solver, metrics)
        assert metrics["goal_err"] < 1e-4, (mi, solver, metrics)
