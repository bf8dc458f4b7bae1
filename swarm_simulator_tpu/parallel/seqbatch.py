"""Sequential batch planning: agent-group decomposition of the joint QP.

The reference solves agents in contiguous batches of ``batch_size``, holding
all other agents fixed at their latest ``dummy`` control points
(setBatch/build_dummy/solveQP, rbp_planner.hpp:140-204, 513-549, 849-872).
This is a Gauss-Seidel sweep over agent groups — and the natural sharding
axis on a device mesh:

  * ``gauss-seidel``: batches solved in order, each seeing earlier batches'
    fresh solutions (reference-faithful; feasibility guaranteed after one
    sweep because every pair constraint is enforced by the later batch).
  * ``jacobi``: all batches solved concurrently against the previous
    dummy state (vmap/pjit across devices), iterated; final safety is
    checked by the evaluator.
"""
from __future__ import annotations

import numpy as np

from ..core.types import Mission, Param, PlanResult
from ..qp import admm, assemble, convert


def make_batches(N: int, param: Param) -> tuple[list[np.ndarray], int]:
    """Mirror setBatch (rbp_planner.hpp:849-872): contiguous groups; returns
    (batches, batch_iter) where batch_iter counts how many run."""
    if param.sequential:
        batch_size = param.batch_size
        batch_max_iter = int(np.ceil(N / batch_size))
        batch_iter = param.batch_iter
        if batch_iter < 0 or batch_iter > batch_max_iter:
            batch_iter = batch_max_iter
    else:
        batch_size = N
        batch_max_iter = 1
        batch_iter = 1
    batches = [np.arange(l * batch_size, min((l + 1) * batch_size, N))
               for l in range(batch_max_iter)]
    return batches, batch_iter


def solve_trajectories(
    plan: PlanResult,
    mission: Mission,
    param: Param,
    settings: admm.ADMMSettings | None = None,
) -> PlanResult:
    """Solve all agent batches; fills plan.coef [N, M, n+1, 3]."""
    N = mission.qn
    if settings is None:
        kkt = param.solver_kkt
        if kkt == "auto":
            # dense: one big matmul per iteration — wins for small
            # batch QPs (the CG inner loop is ~70 tiny sequential ops per
            # iteration, launch-latency-bound on an accelerator).  cg:
            # O(D^2) memory — the only viable mode for large joint
            # problems.  The memory that matters is the STACKED dense
            # inverses: the device-resident sweeps hold every batch's
            # [nx, nx] inverse in device memory at once (64 batches of 4
            # agents at M=72 -> 6.9 GB).
            B_eff = param.batch_size if param.sequential else N
            n_groups = int(np.ceil(N / B_eff)) if param.sequential else 1
            nx = 3 * B_eff * plan.M * (param.n + 1)
            kkt = "dense" if n_groups * nx * nx * 4 < 2e9 else "cg"
        settings = admm.ADMMSettings(max_iter=param.solver_max_iter,
                                     eps_abs=param.solver_eps_abs,
                                     eps_rel=param.solver_eps_rel,
                                     eps_dual_abs=param.solver_eps_dual,
                                     adaptive_rho=param.solver_adaptive_rho,
                                     kkt_solver=kkt)
    n = param.n
    M = plan.M
    dummy = assemble.build_dummy(plan.init_traj, n, M)  # [N, M, n+1, 3]
    ctrl = dummy.copy()
    batches, batch_iter = make_batches(N, param)
    batch_max_iter = len(batches)

    infos = []
    if param.sequential and batch_iter == 0:
        # publish the initial trajectory (rbp_planner.hpp:119-138)
        plan.ctrl = ctrl
        plan.coef = convert.ctrl_to_coef(ctrl, plan.T, n)
        plan.solver_info = {"iters": [], "mode": "init-only"}
        return plan

    # pad pair rows so every batch QP has identical shapes (one XLA program)
    pair_counts = []
    for batch in batches[:batch_iter]:
        members = set(int(q) for q in batch)
        cnt = sum(1 for (qi, qj) in np.asarray(plan.pair_idx)
                  if int(qi) in members or int(qj) in members)
        pair_counts.append(cnt)
    pad_pairs = max(pair_counts) if pair_counts else 0

    # problem-size counters, printed by the reference after each solve
    # (rbp_planner.hpp:58-60); exposed in solver_info and on param.log
    from ..utils.timing import ProblemSize
    B_eff = param.batch_size if param.sequential else N
    psize = ProblemSize.of_batch(min(B_eff, N), M, n, param.phi, pad_pairs)
    if param.log:
        print(psize)

    def _maybe_export(datas):
        # QP-model export on log, like the reference's exportModel to
        # log/ (rbp_planner.hpp:150-153)
        if not param.log:
            return
        from pathlib import Path
        d = Path("log")
        d.mkdir(exist_ok=True)
        for l, dd in enumerate(datas):
            assemble.export_qp_npz(str(d / f"qp_batch{l}.npz"), dd)

    solved = np.zeros(N, dtype=bool)
    if param.parallel_mode == "gauss-seidel" and batch_iter > 0:
        # reference GS semantics as ONE compiled device program (scan over
        # batches with the dummy carried on-device) — a host-driven loop
        # pays per-dispatch overhead on remote backends
        import jax
        import jax.numpy as jnp

        from . import mesh as pmesh
        datas = [assemble.assemble_batch(plan, mission, param, b, dummy,
                                         pad_pairs)
                 for b in batches[:batch_iter]]
        _maybe_export(datas)
        stacked = _stack_qpdata(datas)
        ctrl_dev, info = pmesh.gauss_seidel_sweep(
            stacked, jnp.asarray(dummy), settings,
            rounds=max(1, param.iteration))
        ctrl_dev = np.asarray(ctrl_dev, dtype=np.float64)
        for b in batches[:batch_iter]:
            ctrl[b] = ctrl_dev[b]
            solved[b] = True
        plan.ctrl = ctrl
        plan.coef = convert.ctrl_to_coef(ctrl, plan.T, n)
        plan.solver_info = {
            "iters": [int(i) for i in np.asarray(info.iters)],
            "r_prim": [float(v) for v in np.asarray(info.r_prim)],
            "r_dual": [float(v) for v in np.asarray(info.r_dual)],
            "obj": [float(v) for v in np.asarray(info.obj)],
            "mode": "gauss-seidel-device", "solved": solved,
            "problem_size": str(psize),
        }
        return plan

    for it in range(param.iteration):
        if param.parallel_mode == "jacobi" and batch_iter > 1:
            datas = [assemble.assemble_batch(plan, mission, param, b, dummy,
                                             pad_pairs)
                     for b in batches[:batch_iter]]
            if it == 0:
                _maybe_export(datas)
            stacked = _stack_qpdata(datas)
            xs, info = admm.solve_qp_batched(stacked, settings)
            xs = np.asarray(xs)
            for l, batch in enumerate(batches[:batch_iter]):
                cb = convert.x_to_ctrl(xs[l][: len(batch)], M, n)
                ctrl[batch] = cb
                solved[batch] = True
            dummy = ctrl.copy()
            infos.append(info)
        else:
            for l, batch in enumerate(batches[:batch_iter]):
                data = assemble.assemble_batch(plan, mission, param, batch,
                                               dummy, pad_pairs)
                if it == 0 and l == 0:
                    _maybe_export([data])
                x, info = admm.solve_qp(data, settings)
                cb = convert.x_to_ctrl(np.asarray(x), M, n)
                ctrl[batch] = cb
                dummy[batch] = cb  # Gauss-Seidel dummy refresh (:183)
                solved[batch] = True
                infos.append(info)

    # agents never solved keep their dummy trajectory (rbp_planner.hpp:187-192)
    plan.ctrl = ctrl
    plan.coef = convert.ctrl_to_coef(ctrl, plan.T, n)

    def flat(field):
        out = []
        for i in infos:
            v = np.atleast_1d(np.asarray(getattr(i, field)))
            out.extend(v.tolist())
        return out

    plan.solver_info = {
        "iters": [int(v) for v in flat("iters")],
        "r_prim": flat("r_prim"),
        "r_dual": flat("r_dual"),
        "obj": flat("obj"),
        "mode": param.parallel_mode if param.sequential else "joint",
        "solved": solved,
        "problem_size": str(psize),
    }
    return plan


def _stack_qpdata(datas: list[assemble.QPData]) -> assemble.QPData:
    """Stack batch QPs on a leading axis.  numpy leaves stay numpy (one
    deferred device transfer for the whole stack); jnp leaves stack on
    device."""
    import jax
    import jax.numpy as jnp

    xp = np if isinstance(datas[0].lb, np.ndarray) else jnp
    # batches may differ in agent count (last batch); pad agents by
    # repeating the first agent with free bounds and no pairs
    Bmax = max(d.lb.shape[0] for d in datas)
    padded = [_pad_agents(d, Bmax, xp) for d in datas]
    return jax.tree.map(lambda *xs: xp.stack(xs), *padded)


def _pad_agents(d: assemble.QPData, Bmax: int, xp=None) -> assemble.QPData:
    import dataclasses

    import jax.numpy as jnp

    if xp is None:
        xp = np if isinstance(d.lb, np.ndarray) else jnp
    B = d.lb.shape[0]
    if B == Bmax:
        return d
    pad = Bmax - B

    def padB(a):
        return xp.concatenate([a, xp.repeat(a[-1:], pad, axis=0)], axis=0)

    big = assemble.BIG
    lb = xp.concatenate([d.lb, xp.full((pad,) + d.lb.shape[1:], -big,
                                       d.lb.dtype)], axis=0)
    ub = xp.concatenate([d.ub, xp.full((pad,) + d.ub.shape[1:], big,
                                       d.ub.dtype)], axis=0)
    # padded agents get a sentinel id so coupling scatters drop them
    agents = xp.concatenate([
        d.agents, xp.full((pad,), 2**30, dtype=d.agents.dtype)])
    return dataclasses.replace(d, deq=padB(d.deq), lb=lb, ub=ub,
                               x0=padB(d.x0), agents=agents)
