"""End-to-end RBP planning pipeline.

The JAX equivalent of the swarm_traj_planner_rbp main loop
(src/swarm_traj_planner_rbp.cpp:69-127):

  occupancy world -> ESDF -> ECBS initial paths -> SFC/RSFC corridors
  -> batched ADMM QP -> time scaling -> coefficients + metrics
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .core.types import Mission, Param, PlanResult
from .corridor.times import build_corridors
from .eval import safety, sample
from .parallel import seqbatch
from .qp import admm, timescale
from .search.planner import plan_initial_trajectories
from .world.esdf import ESDF
from .world.voxel import OccupancyGrid


@dataclass
class StageTimes:
    esdf: float = 0.0
    init_traj: float = 0.0
    corridor: float = 0.0
    qp: float = 0.0
    timescale: float = 0.0
    total: float = 0.0
    extra: dict = field(default_factory=dict)


def plan(
    mission: Mission,
    param: Param,
    world: OccupancyGrid | None = None,
    *,
    settings: admm.ADMMSettings | None = None,
    search_backend: str = "auto",
    ns_phases: tuple | None = None,
) -> tuple[PlanResult, StageTimes]:
    times = StageTimes()
    t_all = time.perf_counter()

    if world is None:
        world = OccupancyGrid.empty(param.world_min, param.world_max,
                                    param.world_resolution)

    t0 = time.perf_counter()
    esdf = ESDF(world, max_dist=param.esdf_max_dist)
    times.esdf = time.perf_counter() - t0

    t0 = time.perf_counter()
    result = plan_initial_trajectories(esdf, mission, param,
                                       backend=search_backend)
    times.init_traj = time.perf_counter() - t0

    t0 = time.perf_counter()
    if param.corridor_mode == "flat":
        from .corridor.flat import build_flat_corridors
        build_flat_corridors(esdf, result, mission, param)
    else:
        build_corridors(esdf, result, mission.radius, param)
    times.corridor = time.perf_counter() - t0

    t0 = time.perf_counter()
    if param.solver == "nullspace":
        from .qp import joint
        joint.solve_trajectories(result, mission, param, phases=ns_phases,
                                 polish_rounds=param.polish_rounds,
                                 replan_budgets=param.replan_budgets,
                                 replan_polish=param.replan_polish,
                                 replan_prep=param.replan_prep,
                                 cold_prep=param.cold_prep,
                                 exact_polish=param.exact_polish)
        times.extra["ns_prep"] = result.solver_info["prep_s"]
    else:
        seqbatch.solve_trajectories(result, mission, param, settings)
    times.qp = time.perf_counter() - t0

    if param.time_scale:
        t0 = time.perf_counter()
        scale = timescale.compute_time_scale(
            result.coef, result.T, mission.max_vel, mission.max_acc,
            param.n, param.phi)
        result.coef, result.T = timescale.apply_time_scale(
            result.coef, result.T, scale, param.n)
        if scale != 1.0:
            result.sfc = [[(box, t * scale) for box, t in agent_sfc]
                          for agent_sfc in result.sfc]
            if result.rsfc:
                result.rsfc = {k: [(nv, t * scale) for nv, t in v]
                               for k, v in result.rsfc.items()}
        times.extra["time_scale"] = scale
        times.timescale = time.perf_counter() - t0

    times.total = time.perf_counter() - t_all
    return result, times


def evaluate(result: PlanResult, mission: Mission, param: Param,
             step: float = 0.1) -> dict:
    """Acceptance metrics (RBPPublisher::plot, rbp_publisher.hpp:117-127)."""
    import jax.numpy as jnp

    ts = sample.sample_times(result.T, step)
    states = np.asarray(sample.sample_trajectories(
        jnp.asarray(result.coef), jnp.asarray(np.asarray(result.T)),
        jnp.asarray(ts), n=param.n))
    pos, vel, acc = states[:, :, 0], states[:, :, 1], states[:, :, 2]

    ratio = float(safety.safety_margin_ratio(
        jnp.asarray(pos), jnp.asarray(mission.radius),
        downwash=param.downwash)) if mission.qn > 1 else np.inf
    return {
        "min_safety_ratio": ratio,
        "flight_distance": float(safety.flight_distance(jnp.asarray(pos))),
        "knot_continuity_err": safety.knot_continuity_error(
            result.coef, result.T, param.n, param.phi),
        "dynamic_violation": safety.dynamic_limit_violation(
            vel, acc, mission.max_vel, mission.max_acc),
        "start_err": float(np.max(np.abs(pos[:, 0] - mission.start[:, :3]))),
        "goal_err": float(np.max(np.abs(pos[:, -1] - mission.goal[:, :3]))),
    }
