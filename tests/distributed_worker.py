"""Worker process for the multi-process distributed tests.

Run as:  python tests/distributed_worker.py <coordinator> <nproc> <pid> \
             [jacobi|joint]

jacobi (default): each process owns 4 virtual CPU devices; together
they form the global (scenario=nproc, batch=4) mesh.  Process p preps
scenario p on its host (scenario_shard), contributes it to the global
stack with stack_across_processes
(jax.make_array_from_process_local_data — the branch single-process
tests cannot reach), and all processes jointly execute a vmapped
jacobi_sweep over the sharded stack.  Each process then verifies the
physical quality of ITS scenario's result and prints a PASS line the
parent asserts on.

joint: ONE joint banded solve (qp/nullspace_shard, default chunk mode)
partitioned over the global 8-device mesh SPANNING BOTH PROCESSES —
the pivot inventory's knot chunks and the pair constraints live on
devices of different processes, so the ppermute carries / pair psum /
solution all_gather cross the process boundary (the host network in
real multi-host deployments).  Each process checks the sharded result against its own
single-device solve.
"""
import os
import sys

coord, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
mode = sys.argv[4] if len(sys.argv) > 4 else "jacobi"

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4").strip()

import jax  # noqa: E402

# CPU only, like tests/conftest.py: test workers never open the GPU (a
# JAX process reserves most of a card's memory, so a second one fails)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from swarm_simulator_tpu.parallel import (  # noqa: E402
    distributed, mesh as pmesh, seqbatch)
from swarm_simulator_tpu.qp import admm, assemble, convert  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from test_parallel import _setup  # noqa: E402

distributed.initialize(coordinator_address=coord, num_processes=nproc,
                       process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert jax.local_device_count() == 4
assert jax.device_count() == 4 * nproc

if mode == "joint":
    import dataclasses

    from jax.sharding import Mesh

    from swarm_simulator_tpu.qp import nullspace, nullspace_shard

    sys.path.insert(0, os.path.dirname(__file__))
    from test_nullspace import _data

    data, _ = _data(n_agents=8, M=8)
    data = jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        if np.asarray(a).dtype == np.float64 else np.asarray(a), data)
    # adapt_threshold pins the rung (see tests/test_shard.py::_phases —
    # the cross-path equality must not hinge on a reduction-order ulp)
    s0 = nullspace.NSSettings(kkt_mode="banded", max_iter=100,
                              check_every=50, eps_abs=0.0, eps_rel=0.0,
                              eps_dual_abs=0.0, rho_min=1e-4,
                              rho_max=1e-1, n_rungs=4,
                              adapt_threshold=1e9)
    op = nullspace.prepare_ns_np(data, s0)

    # local single-device reference (plain XLA scan path)
    x_ref, info_ref = nullspace.solve_ns_phases(
        jax.tree.map(jnp.asarray, data), (s0,),
        op=jax.device_put(op, jax.local_devices()[0]))
    x_ref = np.asarray(x_ref, np.float64)

    # global mesh over ALL devices of BOTH processes: bs=72 rows / 8
    # devices, pair axis 28 -> padded 32 over 8 shards; the Thomas
    # all_gathers and the pair psum cross the process boundary
    mesh = Mesh(np.array(jax.devices()), ("kkt",))
    x_sh, info_sh = nullspace_shard.solve_ns_phases_sharded(
        data, (s0,), op, mesh)
    x_sh = np.asarray(x_sh, np.float64)

    err = np.abs(x_ref - x_sh).max() / max(1.0, np.abs(x_ref).max())
    ok = (err < 5e-5
          and int(np.asarray(info_sh.iters)) == int(
              np.asarray(info_ref.iters)))
    print(f"WORKER{pid} joint-shard err={err:.2e} "
          f"iters={int(np.asarray(info_sh.iters))} "
          f"devices={jax.device_count()} {'PASS' if ok else 'FAIL'}",
          flush=True)
    sys.exit(0 if ok else 1)

N_AGENTS, M = 8, 4
mesh = distributed.global_mesh(n_scenario=nproc, n_batch=4)
assert mesh.shape == {"scenario": nproc, "batch": 4}


def build_scenario(s: int):
    """Deterministic per-scenario problem: scenario s shifts the agent
    lane spacing so every scenario has a distinct solution."""
    plan, mission, param = _setup(n_agents=N_AGENTS, M=M, batch_size=2)
    shift = 0.05 * s
    mission.start[:, 1] *= (1.0 + shift)
    mission.goal[:, 1] *= (1.0 + shift)
    plan.init_traj[:, :, 1] *= (1.0 + shift)
    batches, _ = seqbatch.make_batches(N_AGENTS, param)
    dummy = assemble.build_dummy(plan.init_traj, param.n)
    datas = [assemble.assemble_batch(plan, mission, param, b, dummy,
                                     device=False) for b in batches]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *datas)
    return stacked, dummy, plan, mission, param


# host prep: each process preps only ITS scenarios
mine = distributed.scenario_shard(nproc)
assert list(mine) == [pid], mine
local = [build_scenario(int(s)) for s in mine]
local_stacked = jax.tree.map(lambda *xs: np.stack(xs),
                             *[sc[0] for sc in local])
local_dummy = np.stack([sc[1] for sc in local])

gdata = distributed.stack_across_processes(local_stacked, mesh,
                                           axes=("scenario",))
gdummy = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("scenario")), local_dummy)

settings = admm.ADMMSettings(max_iter=400, eps_abs=1e-6, eps_rel=1e-6,
                             eps_dual_abs=1e-3, kkt_solver="dense")

sweep = jax.jit(
    jax.vmap(lambda st, dm: pmesh.jacobi_sweep.__wrapped__(
        st, dm, settings, rounds=2)),
    in_shardings=(NamedSharding(mesh, P("scenario")),
                  NamedSharding(mesh, P("scenario"))),
    out_shardings=NamedSharding(mesh, P("scenario")))

ctrl, info = sweep(gdata, gdummy)
jax.block_until_ready(ctrl)

# every process checks its own scenario's physics
_, _, plan, mission, param = local[0]
local_ctrl = np.asarray(
    [s.data for s in ctrl.addressable_shards][0])[0]  # [N, M, n+1, 3]
start_err = np.abs(local_ctrl[:, 0, 0, :] - mission.start[:, :3]).max()
goal_err = np.abs(local_ctrl[:, -1, -1, :] - mission.goal[:, :3]).max()
cont_err = np.abs(local_ctrl[:, 1:, 0] - local_ctrl[:, :-1, -1]).max()

from swarm_simulator_tpu.eval.safety import safety_margin_ratio  # noqa: E402
from swarm_simulator_tpu.eval.sample import (  # noqa: E402
    sample_times, sample_trajectories)

coef = convert.ctrl_to_coef(local_ctrl, plan.T, param.n)
ts = sample_times(np.asarray(plan.T), 0.1)
pos = np.asarray(sample_trajectories(
    jnp.asarray(coef), jnp.asarray(np.asarray(plan.T)), jnp.asarray(ts),
    n=param.n, derivatives=1))[:, :, 0]
ratio = float(safety_margin_ratio(jnp.asarray(pos),
                                  jnp.asarray(mission.radius),
                                  downwash=param.downwash))

ok = (start_err < 1e-6 and goal_err < 1e-6 and cont_err < 1e-5
      and ratio >= 1.0)
print(f"WORKER{pid} start={start_err:.2e} goal={goal_err:.2e} "
      f"cont={cont_err:.2e} ratio={ratio:.4f} "
      f"devices={jax.device_count()} {'PASS' if ok else 'FAIL'}",
      flush=True)
sys.exit(0 if ok else 1)
