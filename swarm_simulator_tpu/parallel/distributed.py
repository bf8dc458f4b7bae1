"""Multi-host (multi-process) runtime glue — the distributed backend.

The reference has no distributed layer at all (single-threaded C++ node,
SURVEY §5); this framework scales across hosts with JAX's standard
multi-controller SPMD model:

  * every process calls :func:`initialize` once (jax.distributed handles
    the coordination service), then sees the GLOBAL device set;
  * :func:`global_mesh` factors all devices into the framework's
    (scenario, batch) axes — scenario spans hosts (embarrassingly
    parallel Monte-Carlo), batch stays within a host so the
    dummy-exchange all-gather of jacobi_sweep rides the host's
    device-to-device links;
  * :func:`scenario_shard` gives each process its slice of a scenario
    list, and :func:`stack_across_processes` assembles per-process QPData
    stacks into one global jax.Array without any host ever holding the
    full batch (jax.make_array_from_process_local_data).

Single-process use degenerates to the local mesh (no coordinator needed),
so every code path here is exercised by the test suite on the virtual
8-device CPU mesh; real multi-host runs only add the initialize() call.
"""
from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..qp import assemble
from . import mesh as _mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the multi-controller runtime (no-op when single-process).

    With no arguments, defers to JAX's environment autodetection (set
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, or
    pass them here: a host with no cluster manager needs all three,
    e.g. ``localhost:<port>``).
    """
    if num_processes == 1 or (
            coordinator_address is None and num_processes is None
            and process_id is None
            and "JAX_COORDINATOR_ADDRESS" not in os.environ
            and "COORDINATOR_ADDRESS" not in os.environ):
        # single controller: nothing to coordinate
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def global_mesh(n_scenario: int | None = None,
                n_batch: int | None = None) -> Mesh:
    """(scenario, batch) mesh over the GLOBAL device set.

    batch-axis size should divide the per-host device count so the
    jacobi_sweep all-gather stays on ICI; the scenario axis then spans
    hosts over DCN.
    """
    return _mesh.make_mesh(n_scenario=n_scenario, n_batch=n_batch,
                           devices=jax.devices())


def scenario_shard(n_scenarios: int, process_id: int | None = None,
                   num_processes: int | None = None) -> np.ndarray:
    """Indices of the scenarios THIS process preps on its host (CPU-side
    ESDF/ECBS/corridors are per-host work; contiguous blocks, remainder
    spread over the leading processes)."""
    pid = jax.process_index() if process_id is None else process_id
    nproc = jax.process_count() if num_processes is None else num_processes
    counts = np.full(nproc, n_scenarios // nproc, dtype=int)
    counts[: n_scenarios % nproc] += 1
    starts = np.concatenate([[0], np.cumsum(counts)])
    return np.arange(starts[pid], starts[pid + 1])


def stack_across_processes(local_stacked: assemble.QPData, mesh: Mesh,
                           axes: tuple[str | None, ...] = ("scenario",),
                           ) -> assemble.QPData:
    """Assemble per-process QPData stacks into one global jax.Array.

    local_stacked's leading axis holds this process's scenarios; the
    result behaves like the full [n_scenario_total, ...] stack sharded
    over ``axes`` — no host ever materializes the global batch.  With a
    single process this is exactly shard_stacked.
    """
    if jax.process_count() == 1:
        return _mesh.shard_stacked(local_stacked, mesh, axes=axes)
    spec = P(*axes)
    return jax.tree.map(
        lambda x: jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), np.asarray(x)),
        local_stacked)
