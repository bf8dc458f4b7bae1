"""Knot-state (null-space) formulation: exactness of the elimination.

The maps must reproduce the SAME constraint system as qp/assemble.build_aeq
(continuity + endpoint pins, mirroring build_Aeq_base,
rbp_planner.hpp:353-405): Aeq @ N == 0 and Aeq @ x_pin == deq to machine
precision, and the x <-> knot-state roundtrip must be exact on
continuity-feasible trajectories.
"""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent))

from test_qp import _tiny_problem  # noqa: E402


def _data(n_agents=3, M=5, nonuniform=False):
    from swarm_simulator_tpu.qp import assemble

    plan, mission, param = _tiny_problem(n_agents=n_agents, M=M)
    if nonuniform:
        T = np.concatenate([[0.0], np.cumsum(0.5 + np.arange(M) * 0.3)])
        plan.T = T
    dummy = assemble.build_dummy(plan.init_traj, param.n)
    return assemble.assemble_batch(plan, mission, param,
                                   np.arange(n_agents), dummy), param


def test_N_spans_the_aeq_null_space():
    from swarm_simulator_tpu.qp import nullspace

    for nonuniform in (False, True):
        data, param = _data(nonuniform=nonuniform)
        s = nullspace.NSSettings()
        op = nullspace.prepare_ns(data, s)
        N = np.asarray(op.N)
        Aeq = np.asarray(data.Aeq)
        # exact elimination: every column of N satisfies the homogeneous
        # continuity + endpoint system
        assert np.abs(Aeq @ N).max() < 1e-10
        # dimension: full null space, nothing lost
        assert N.shape[1] == Aeq.shape[1] - Aeq.shape[0]
        assert np.linalg.matrix_rank(N) == N.shape[1]
        # pinned trajectory satisfies the inhomogeneous system
        x_pin = np.asarray(op.x_pin)
        B, K3, D = x_pin.shape
        err = np.einsum("rd,bkd->bkr", Aeq, x_pin) - np.asarray(data.deq)
        assert np.abs(err).max() < 1e-10


def test_knot_state_roundtrip():
    from swarm_simulator_tpu.qp import nullspace

    data, param = _data(nonuniform=True)
    s = nullspace.NSSettings()
    op = nullspace.prepare_ns(data, s)
    rng = np.random.default_rng(0)
    B = np.asarray(data.lb).shape[0]
    nw = op.N.shape[1]
    w = rng.normal(size=(B, 3, nw))
    x = nullspace._x_of(op, w)
    w2 = np.asarray(nullspace._w_from_x(op, x, phi=param.phi))
    assert np.abs(w2 - w).max() < 1e-9


def test_solve_ns_respects_tightening():
    from swarm_simulator_tpu.qp import ipm, nullspace

    data, _ = _data()
    t = 1e-2
    x = np.asarray(nullspace.solve_ns(
        data, nullspace.NSSettings(max_iter=2000, check_every=100,
                                   tighten=t)))
    Q, E, d, C, c, _ = ipm.build_flat(data)
    xf = x.reshape(-1)
    # true constraints satisfied strictly (violation of the tightened
    # problem stays below the margin)
    assert np.maximum(c - C @ xf, 0.0).max() < t
    assert np.abs(E @ xf - d).max() < 1e-9


def test_banded_kinv_matches_dense():
    """The block-tridiagonal Thomas mode must solve the SAME KKT system as
    the dense-inverse mode: pair/box terms are exactly knot-diagonal and
    only the jerk cost couples adjacent knots, so the two factorizations
    agree to solver precision on every rho rung."""
    import dataclasses

    from swarm_simulator_tpu.qp import nullspace

    data, param = _data(n_agents=3, M=6, nonuniform=True)
    s_dense = nullspace.NSSettings()
    s_band = dataclasses.replace(s_dense, kkt_mode="banded")
    op_d = nullspace.prepare_ns(data, s_dense)
    op_b = nullspace.prepare_ns(data, s_band)

    B, K3, D = np.asarray(data.lb).shape
    M = np.asarray(data.Qseg).shape[0]
    phi = np.asarray(data.Aeq).shape[0] // (M + 1)
    ap_d = nullspace.make_kinv_apply(op_d, B, K3, M, phi)
    ap_b = nullspace.make_kinv_apply(op_b, B, K3, M, phi)

    rng = np.random.default_rng(0)
    rhs = rng.normal(size=(B, K3, op_d.N.shape[1]))
    for r in range(int(np.asarray(op_d.ladder).shape[0])):
        xd = np.asarray(ap_d(r, rhs))
        xb = np.asarray(ap_b(r, rhs))
        scale = max(1.0, np.abs(xd).max())
        assert np.abs(xd - xb).max() < 1e-8 * scale, (r, np.abs(xd - xb).max())


def test_banded_solve_matches_dense_solution():
    """End-to-end: the banded production path lands on the same solution
    as the dense path (same settings, same problem)."""
    import dataclasses

    from swarm_simulator_tpu.qp import nullspace

    data, _ = _data(n_agents=3, M=5)
    s = nullspace.NSSettings(max_iter=2000, check_every=100,
                             eps_abs=1e-8, eps_rel=1e-8, eps_dual_abs=1e-6)
    xd = np.asarray(nullspace.solve_ns(data, s))
    xb = np.asarray(nullspace.solve_ns(
        data, dataclasses.replace(s, kkt_mode="banded")))
    assert np.abs(xd - xb).max() < 1e-5, np.abs(xd - xb).max()


def test_prepare_ns_np_matches_jax():
    """Host-f64 prep twin (the production joint path's operator source)
    must agree with the on-device prep in both KKT modes.  The unit
    suite runs CPU float64, so both preps compute in f64 and the match
    is tight."""
    from swarm_simulator_tpu.qp import nullspace

    for mode in ("dense", "banded"):
        data, param = _data(n_agents=3, M=5, nonuniform=(mode == "dense"))
        s = nullspace.NSSettings(kkt_mode=mode)
        op_j = nullspace.prepare_ns(data, s)
        op_n = nullspace.prepare_ns_np(data, s)
        assert np.allclose(op_n.N, op_j.N, atol=1e-10)
        assert np.allclose(op_n.x_pin, op_j.x_pin, atol=1e-10)
        assert np.allclose(op_n.g, op_j.g, atol=1e-9)
        assert np.allclose(float(op_n.c_s), float(op_j.c_s), rtol=1e-12)
        assert np.allclose(op_n.ladder, op_j.ladder, rtol=1e-12)
        if mode == "banded":
            assert np.allclose(op_n.Kos, op_j.Kos, atol=1e-10)
            # the JAX path Newton-refines its inverses; both should be
            # accurate f64 inverses here, so compare through the action
            assert np.allclose(op_n.Dinvs, op_j.Dinvs, rtol=5e-6,
                               atol=1e-8)
        else:
            assert np.allclose(op_n.Kinvs, op_j.Kinvs, rtol=5e-6,
                               atol=1e-8)


def test_solve_ns_phases_accepts_host_op():
    """solve_ns_phases(op=prepare_ns_np(...)) must land on the same
    solution as the on-device prep."""
    import dataclasses

    import jax

    from swarm_simulator_tpu.qp import nullspace

    data, param = _data(n_agents=3, M=5)
    base = nullspace.NSSettings(kkt_mode="banded", max_iter=300,
                                check_every=50)
    phases = (dataclasses.replace(base, rho_lo=1e-2),
              dataclasses.replace(base))
    x_dev, _ = jax.jit(
        lambda d: nullspace.solve_ns_phases(d, phases))(data)
    op = nullspace.prepare_ns_np(data, phases[0])
    x_host, _ = jax.jit(
        lambda d, o: nullspace.solve_ns_phases(d, phases, op=o))(data, op)
    assert np.allclose(np.asarray(x_dev), np.asarray(x_host), atol=1e-8)


def test_refresh_ns_op_np():
    """Stale-operator replan support: refresh_ns_op_np must reproduce a
    full prepare_ns_np's endpoint-dependent leaves exactly (same time
    grid), share the rung inventory by reference, and reject a changed
    time grid."""
    import dataclasses

    import pytest

    from swarm_simulator_tpu.qp import nullspace

    data, _ = _data(n_agents=3, M=5)
    s = nullspace.NSSettings(kkt_mode="banded", n_rungs=3)
    op = nullspace.prepare_ns_np(data, s)

    # identity refresh: exact reproduction
    op_r = nullspace.refresh_ns_op_np(op, data)
    assert np.allclose(op_r.x_pin, op.x_pin, atol=1e-12)
    assert np.allclose(op_r.g, op.g, atol=1e-12)
    assert op_r.Dinvs is op.Dinvs

    # perturbed endpoints (a replan toward shifted goals): the refresh
    # must equal a full re-prep of the perturbed problem in x_pin/g
    deq = np.asarray(data.deq).copy()
    deq[:, :, 3] += 0.05          # goal positions (phi=3: orders 0..2)
    data2 = dataclasses.replace(data, deq=deq)
    op_r2 = nullspace.refresh_ns_op_np(op, data2)
    op_f2 = nullspace.prepare_ns_np(data2, s)
    assert np.allclose(op_r2.x_pin, op_f2.x_pin, atol=1e-10)
    assert np.allclose(op_r2.g, op_f2.g, atol=1e-10)
    assert np.allclose(op_r2.Dinvs, op_f2.Dinvs, rtol=1e-6, atol=1e-9)

    # changed time grid: the inventory is tied to dt/M -> must raise
    data3 = dataclasses.replace(data, dt=np.asarray(data.dt) * 1.1)
    with pytest.raises(ValueError, match="time grid"):
        nullspace.refresh_ns_op_np(op, data3)


def test_kkt_refine_noop_on_fresh_op():
    """kkt_refine Richardson steps re-anchor the w-update to the FRESH
    constraint data; when the inventory was prepared for this very data
    the matrix-free K apply and the factorized system are the same
    matrix, so refinement must be a numerical no-op."""
    import dataclasses

    from swarm_simulator_tpu.qp import nullspace

    data, _ = _data(n_agents=3, M=5)
    s0 = nullspace.NSSettings(kkt_mode="banded", max_iter=300,
                              check_every=50)
    s1 = dataclasses.replace(s0, kkt_refine=1)
    x0 = np.asarray(nullspace.solve_ns(data, s0))
    x1 = np.asarray(nullspace.solve_ns(data, s1))
    assert np.abs(x0 - x1).max() < 1e-6, np.abs(x0 - x1).max()


def test_aa_depth_converges_tiny():
    """Chunk-level Anderson acceleration (NSSettings.aa_depth) reaches
    the same solution as the plain loop on a small banded problem.
    (At PRODUCTION scale it is measured harmful — see the field's
    docstring and benchmarks/aa_study_cpu.log — so it ships off; this
    pins the mechanism itself.)"""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from swarm_simulator_tpu.qp import nullspace

    data, _ = _data(n_agents=3, M=5)
    s0 = nullspace.NSSettings(kkt_mode="banded", max_iter=300,
                              check_every=50)
    op = nullspace.prepare_ns_np(data, s0)

    def solve(s):
        x, _ = jax.jit(lambda d, o: nullspace.solve_ns_phases(
            d, (s,), op=o))(jax.tree.map(jnp.asarray, data),
                            jax.device_put(op))
        return np.asarray(x)

    x0 = solve(s0)
    x1 = solve(dataclasses.replace(s0, aa_depth=3))
    assert np.abs(x0 - x1).max() < 1e-4, np.abs(x0 - x1).max()


def test_schedule_scan_matches_per_phase_path():
    """Compile-wall path: solve_ns_schedule (ONE lax.scan'd
    while-body, budgets/fences as traced arrays) must be BIT-IDENTICAL
    to the legacy per-phase loop — same chunk math, same rho walk,
    same early-exit semantics — and schedule_arrays must normalize the
    base settings so cold/polish/escalation schedules share one jit
    key."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from swarm_simulator_tpu.qp import joint, nullspace as ns

    data, param = _data(n_agents=4, M=6)
    d = jax.tree.map(jnp.asarray, data)
    phases = joint.production_phases((100, 200, 100))
    op = jax.device_put(ns.prepare_ns_np(data, phases[0]))

    # legacy path (force by per-phase _iterate_ns)
    with jax.default_matmul_precision("highest"):
        state, x1, i1 = None, None, None
        total = 0
        for s in phases:
            x1, i1, state = ns._iterate_ns(d, op, s, init=state,
                                           return_state=True)
            total += int(i1.iters)

    sched = ns.schedule_arrays(phases)
    assert sched is not None
    s0, it_k, lo_k, hi_k = sched
    x2, i2 = ns.solve_ns_schedule(d, op, s0, it_k, lo_k, hi_k)
    assert int(i2.iters) == total
    assert float(jnp.max(jnp.abs(x1 - x2))) == 0.0

    # normalized base: escalation schedule shares the SAME static key
    esc = joint.escalation_phases(phases)
    s0e, _, _, _ = ns.schedule_arrays(esc)
    assert s0e == s0

    # replan (kkt_refine) schedules get a DIFFERENT base (different
    # math), and incompatible tuples are rejected
    rep = joint.production_phases((50, 100, 50), base=phases[1],
                                  kkt_refine=1)
    s0r, _, _, _ = ns.schedule_arrays(rep)
    assert s0r != s0
    bad = (phases[0], dataclasses.replace(phases[1], check_every=25))
    assert ns.schedule_arrays(bad) is None

    # solve_ns_phases dispatches through the scan path transparently
    x3, i3 = ns.solve_ns_phases(d, phases, op=op)
    assert float(jnp.max(jnp.abs(x1 - x3))) == 0.0
