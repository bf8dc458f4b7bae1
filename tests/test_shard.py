"""Cross-device decomposition of ONE joint banded solve
(qp/nullspace_shard.py): SURVEY §5's communication row — pivot
inventory knot-chunk-sharded (ppermute pipeline), block-row-sharded or
SPIKE-partitioned, pair constraints P-sharded — validated on the
8-virtual-CPU-device mesh against the single-device path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from test_nullspace import _data

from swarm_simulator_tpu.qp import nullspace, nullspace_shard


def _mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), ("kkt",))


def _f32(data):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32)
        if np.asarray(a).dtype == np.float64 else np.asarray(a), data)


def _phases(max_iters=(100, 100), **kw):
    # adapt_threshold=1e9 pins the rho rung: the sharded path's psum /
    # all_gather re-associate the f32 reductions, and a residual ratio
    # landing exactly on an adaptation boundary could flip the rung on
    # one path only — the exact-equality comparison must not depend on
    # that coin toss (zero tolerances already force full budgets)
    kw.setdefault("check_every", 50)
    base = nullspace.NSSettings(kkt_mode="banded",
                                eps_abs=0.0, eps_rel=0.0, eps_dual_abs=0.0,
                                rho_min=1e-4, rho_max=1e-1, n_rungs=4,
                                adapt_threshold=1e9, **kw)
    return tuple(dataclasses.replace(base, max_iter=mi) for mi in max_iters)


@pytest.mark.parametrize("mode", ["chunk", "blockrow"])
def test_sharded_matches_single_device(mode):
    """8-way sharded phased solve == the single-device XLA scan path on
    the same prepared operator, to f32 reduction tolerance (psum /
    all_gather / ppermute re-associate the pair and matvec sums).  Zero
    tolerances pin identical iteration counts on both paths."""
    data, _ = _data(n_agents=8, M=8)
    data = _f32(data)
    phases = _phases()
    op = nullspace.prepare_ns_np(data, phases[0])

    x_ref, info_ref = nullspace.solve_ns_phases(
        jax.tree.map(jnp.asarray, data), phases, op=jax.device_put(op))
    x_ref = np.asarray(x_ref, np.float64)

    mesh = _mesh(8)
    x_sh, info_sh = nullspace_shard.solve_ns_phases_sharded(
        data, phases, op, mesh, mode=mode)
    x_sh = np.asarray(x_sh, np.float64)

    assert int(info_sh.iters) == int(info_ref.iters)
    scale = max(1.0, np.abs(x_ref).max())
    err = np.abs(x_ref - x_sh).max() / scale
    assert err < 5e-5, err


def test_sharded_chunk_uneven_knots():
    """Mi = 7 over 8 devices: the knot axis zero-pads to 8 (one knot per
    device); pads must not perturb the solution vs the 1-device chunk
    run (and vs a 4-device run where L=2)."""
    data, _ = _data(n_agents=8, M=8)       # Mi = 7
    data = _f32(data)
    phases = _phases((50,))
    op = nullspace.prepare_ns_np(data, phases[0])

    x1, _ = nullspace_shard.solve_ns_phases_sharded(
        data, phases, op, _mesh(1), mode="chunk")
    x4, _ = nullspace_shard.solve_ns_phases_sharded(
        data, phases, op, _mesh(4), mode="chunk")
    x8, _ = nullspace_shard.solve_ns_phases_sharded(
        data, phases, op, _mesh(8), mode="chunk")
    for xo in (x4, x8):
        err = np.abs(np.asarray(x1, np.float64)
                     - np.asarray(xo, np.float64)).max()
        assert err < 5e-5, err


def test_sharded_kkt_refine_matches_single_device():
    """kkt_refine=1 PCG (the production replan mode) sharded over 8
    devices == the single-device refine path: the fresh-K applies ride
    the sharded A/A^T psum, the PCG scalars are replicated."""
    data, _ = _data(n_agents=8, M=8)
    data = _f32(data)
    phases = tuple(dataclasses.replace(p, kkt_refine=1)
                   for p in _phases((50,)))
    op = nullspace.prepare_ns_np(data, phases[0])

    x_ref, info_ref = nullspace.solve_ns_phases(
        jax.tree.map(jnp.asarray, data), phases, op=jax.device_put(op))
    x_sh, info_sh = nullspace_shard.solve_ns_phases_sharded(
        data, phases, op, _mesh(8), mode="chunk")
    assert int(info_sh.iters) == int(info_ref.iters)
    scale = max(1.0, float(np.abs(np.asarray(x_ref)).max()))
    err = float(np.abs(np.asarray(x_ref, np.float64)
                       - np.asarray(x_sh, np.float64)).max()) / scale
    assert err < 5e-5, err


def test_sharded_pair_padding_inactive():
    """P=28 pairs at 8 agents pads to 32 over 8 devices; the pad rows
    must never bind (solution identical to the 4-device run where P=28
    pads to 28)."""
    data, _ = _data(n_agents=8, M=8)
    data = _f32(data)
    phases = _phases((50,))
    op = nullspace.prepare_ns_np(data, phases[0])

    mesh4 = _mesh(4)   # 28 % 4 == 0: no padding
    x4, _ = nullspace_shard.solve_ns_phases_sharded(data, phases, op, mesh4)
    mesh8 = _mesh(8)   # pads 28 -> 32
    x8, _ = nullspace_shard.solve_ns_phases_sharded(data, phases, op, mesh8)
    err = np.abs(np.asarray(x4, np.float64)
                 - np.asarray(x8, np.float64)).max()
    assert err < 5e-5, err


def test_sharded_rejects_unshardable():
    data, _ = _data(n_agents=8, M=8)
    data = _f32(data)
    phases = _phases((50,))
    op = nullspace.prepare_ns_np(data, phases[0])
    mesh = _mesh(8)

    bad = tuple(dataclasses.replace(p, kkt_mode="dense") for p in phases)
    with pytest.raises(ValueError, match="banded"):
        nullspace_shard.solve_ns_phases_sharded(data, bad, op, mesh)

    aa = tuple(dataclasses.replace(p, aa_depth=2) for p in phases)
    with pytest.raises(ValueError, match="aa_depth"):
        nullspace_shard.solve_ns_phases_sharded(data, aa, op, mesh)

    with pytest.raises(ValueError, match="unknown shard mode"):
        nullspace_shard.solve_ns_phases_sharded(data, phases, op, mesh,
                                                mode="rows")
    # block-row sharding splits each pivot block's rows: bs = 72 does
    # not divide over 5 devices
    with pytest.raises(ValueError, match="must divide"):
        nullspace_shard.solve_ns_phases_sharded(data, phases, op,
                                                _mesh(5), mode="blockrow")
    # SPIKE needs its own operator
    with pytest.raises(ValueError, match="prepare_spike_np"):
        nullspace_shard.solve_ns_phases_sharded(data, phases, op, mesh,
                                                mode="spike")


def test_spike_matches_single_device():
    """SPIKE substructuring: the PARALLEL decomposition of the
    banded Thomas solve (independent per-chunk solves + separator Schur
    chain) must match the single-device path to f32 reduction
    tolerance, on both an exactly-partitioned knot axis (Mi = 15, n=4,
    Lq=3) and a zero-padded one (Mi = 7, n=3, Lq=2, 1 pad knot)."""
    for (M, nmesh) in ((16, 4), (8, 3)):
        data, _ = _data(n_agents=8, M=M)
        data = _f32(data)
        phases = _phases()
        op = nullspace.prepare_ns_np(data, phases[0])
        x_ref, info_ref = nullspace.solve_ns_phases(
            jax.tree.map(jnp.asarray, data), phases,
            op=jax.device_put(op))
        x_ref = np.asarray(x_ref, np.float64)

        sop = nullspace_shard.prepare_spike_np(data, phases[0], nmesh)
        mesh = _mesh(nmesh)
        x_sh, info_sh = nullspace_shard.solve_ns_phases_sharded(
            data, phases, sop, mesh, mode="spike")
        x_sh = np.asarray(x_sh, np.float64)
        assert int(info_sh.iters) == int(info_ref.iters), (
            M, nmesh, int(info_sh.iters), int(info_ref.iters))
        scale = max(1.0, np.abs(x_ref).max())
        err = np.abs(x_ref - x_sh).max() / scale
        assert err < 5e-5, (M, nmesh, err)


def test_spike_prep_guards():
    import pytest

    data, _ = _data(n_agents=4, M=5)       # Mi = 4
    data = _f32(data)
    phases = _phases((50,))
    with pytest.raises(ValueError, match="Mi >= 2n"):
        nullspace_shard.prepare_spike_np(data, phases[0], 4)
    sop = nullspace_shard.prepare_spike_np(data, phases[0], 2)
    with pytest.raises(ValueError, match="prepared for"):
        nullspace_shard.solve_ns_phases_sharded(
            data, phases, sop, _mesh(4), mode="spike")
