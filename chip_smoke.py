"""Smoke test of the planner on NVIDIA GPUs, at the sizes users fly.

    python chip_smoke.py               # one card: phases 0-5
    python chip_smoke.py --four-cards  # one joint solve sharded over 4 cards

One card drives the main path through its library entry point,
``swarm_simulator_tpu.plan``:

  0. device check: refuses to run unless JAX's first device is a GPU;
  1. the canonical 64-agent forest (plan_rbp_random_forest.launch) as
     one joint QP, seeds 0 and 1: full quality gate plus the float64
     IPM best-response oracle margin <= 1.25;
  2. a 64-agent corridor-refresh replan round (device prep, kkt_refine);
  3. 256 agents as one joint QP (device prep, warm polish rounds);
  4. the default Param.solver="admm" sequential-batch path, 64 agents;
  5. the banded KKT apply on the GPU against the same apply in float64
     on the CPU, on the pivot inventories of phases 1 and 3.

``--four-cards`` runs only the sharded joint solve (qp/nullspace_shard,
chunk and SPIKE modes) and the single-device solve it is compared with.

Every phase prints one line with its wall, compile and solve seconds.
A failed phase raises, so the script exits non-zero and never prints
the last line, one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: the 64-agent oracle bound of bench.gate_quality
MARGIN_BOUND = 1.25
#: phase 5: the GPU apply's error against float64 may be at most this
#: many times the CPU float32 apply's own error (sums run in another
#: order on the card), and never needs to beat ERR_FLOOR
ERR_FACTOR = 10.0
ERR_FLOOR = 1e-6


def say(*a):
    print(*a, flush=True)


class CompileMeter:
    """Compilation seconds and persistent-cache hits/misses, read from
    jax.monitoring events."""

    COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                      "/jax/core/compile/jaxpr_to_mlir_module_duration",
                      "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.secs, self.hits, self.misses = 0.0, 0, 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, secs, **_):
        if event in self.COMPILE_EVENTS:
            self.secs += secs

    def _event(self, event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def snapshot(self):
        return self.secs, self.hits, self.misses


class Phase:
    """Times one phase and prints its line: wall, compile seconds, cache
    hits/misses, and the fields the phase adds to ``info``."""

    def __init__(self, meter: CompileMeter, name: str):
        self.meter, self.name, self.info = meter, name, {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = self.meter.snapshot()
        return self

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self.t0
        secs, hits, misses = (b - a for a, b in
                              zip(self.c0, self.meter.snapshot()))
        cache = "miss" if misses else ("hit" if hits else "none")
        fields = " ".join(f"{k}={_fmt(v)}" for k, v in self.info.items())
        state = "FAILED" if exc_type else "ok"
        say(f"phase {self.name}: {state} wall={wall:.2f}s "
            f"compile={secs:.2f}s cache={cache}({hits} hits, "
            f"{misses} misses) {fields}")
        return False


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _check(ok: bool, what: str, detail) -> None:
    if not ok:
        raise RuntimeError(f"{what}: {detail}")


def device_check():
    """Phase 0: the first JAX device must be a GPU.  Returns the device
    dict of the result line."""
    import jax

    from swarm_simulator_tpu.utils import runtime

    dev = runtime.require_gpu()
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def card_names() -> list[str]:
    """Each card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


# ---- problems ---------------------------------------------------------


def forest64(seed: int, **overrides):
    """The canonical 64-agent forest of bench.forest_mission
    (plan_rbp_random_forest.launch: perimeter swap, 20 obstacles of
    radius 0.3 m), with the joint solver."""
    import dataclasses

    import bench

    mission, param, world = bench.forest_mission(seed)
    overrides.setdefault("solver", "nullspace")
    return mission, dataclasses.replace(param, **overrides), world


def scatter256():
    """256 agents scattered over a 20 m x 20 m world
    (tools/large_swarm_joint.py), solved as one joint QP with device
    prep: host prep at this size takes minutes."""
    import swarm_simulator_tpu as sst
    from swarm_simulator_tpu.io.mission_json import scatter_mission

    param = sst.Param(world_x_min=-10, world_x_max=10, world_y_min=-10,
                      world_y_max=10, world_z_min=0.3, world_z_max=2.5,
                      grid_xy_res=0.5, grid_z_res=1.0, sequential=True,
                      batch_size=4, batch_iter=-1, solver_dtype="float32",
                      solver="nullspace", cold_prep="device")
    return scatter_mission(256, half=9.5, z=1.0, seed=7), param, None


class KeepOperator:
    """Keeps the device KKT operator of the last joint solve, so phase 5
    can check the very pivot inventory a phase solved with."""

    def __enter__(self):
        from swarm_simulator_tpu.qp import joint

        self.op = None
        self._orig = joint._run_schedule

        def run(data_dev, op_dev, phases):
            self.op = op_dev
            return self._orig(data_dev, op_dev, phases)

        joint._run_schedule = run
        return self

    def __exit__(self, *exc):
        from swarm_simulator_tpu.qp import joint

        joint._run_schedule = self._orig
        return False


def plan_and_gate(mission, param, world, oracle_batch=None):
    """Run the pipeline's entry point, then the bench quality gate on
    what it returns.  With ``oracle_batch`` the gate also computes the
    float64 IPM best-response margin of that agent batch."""
    import swarm_simulator_tpu as sst

    import bench

    result, times = sst.plan(mission, param, world)
    ok, m = bench.gate_quality(result.ctrl, result, mission, param)
    # the library's own acceptance metrics agree on collisions
    ok = ok and sst.evaluate(result, mission, param)[
        "min_safety_ratio"] >= 1.0
    if oracle_batch is not None:
        obj_b, _ = bench.batch0_objective(result.ctrl, result, mission,
                                          param, oracle_batch)
        obj_ref, _ = bench.ipm_best_response_batch0(
            result, mission, param, result.ctrl, oracle_batch)
        m["margin"] = obj_b / obj_ref
    return result, times, ok, m


# ---- phase 5 ------------------------------------------------------------


def kkt_apply_errors(op, B: int, M: int, phi: int, seed: int = 0,
                     device=None) -> list[dict]:
    """Per rung, relative max-norm errors of the banded KKT apply
    (nullspace.make_kinv_apply) on ``device`` (default: JAX's default
    device), against the same apply in float64 on the CPU device on the
    same pivots cast to float64:

      err_highest  device apply under matmul precision "highest"
      err_default  device apply at default precision (shows TF32 use)
      err_cpu32    the CPU float32 apply (the reference's own error)
      bound        max(ERR_FACTOR * err_cpu32, ERR_FLOOR)
      ok           err_highest <= bound
    """
    import jax
    import numpy as np

    from swarm_simulator_tpu.qp import nullspace

    cpu = jax.devices("cpu")[0]
    device = device if device is not None else jax.devices()[0]
    nw = (M - 1) * phi
    rhs = np.random.default_rng(seed).standard_normal((B, 3, nw))
    kos = np.asarray(op.Kos)

    @jax.jit
    def apply(dinvs, k, r):
        one = op._replace(Dinvs=dinvs, Kos=k, Kinvs=None)
        return nullspace.make_kinv_apply(one, B, 3, M, phi)(0, r)

    def run(dev, dinv, k, r, precision):
        args = (jax.device_put(a, dev) for a in (dinv, k, r))
        with jax.default_matmul_precision(precision):
            return np.asarray(apply(*args), np.float64)

    out = []
    for rung in range(op.Dinvs.shape[0]):
        # one rung at a time on the host: the 256-agent inventory is
        # 7.5 GB on the card
        dinv = np.asarray(op.Dinvs[rung])[None]
        with jax.enable_x64(True):
            x64 = run(cpu, dinv.astype(np.float64),
                      kos.astype(np.float64), rhs, "highest")
        r32 = rhs.astype(np.float32)
        scale = float(np.abs(x64).max())

        def rel(x):
            return float(np.abs(x - x64).max()) / scale

        e = {"err_highest": rel(run(device, dinv, kos, r32, "highest")),
             "err_default": rel(run(device, dinv, kos, r32, "default")),
             "err_cpu32": rel(run(cpu, dinv, kos, r32, "highest"))}
        e["bound"] = max(ERR_FACTOR * e["err_cpu32"], ERR_FLOOR)
        e["ok"] = e["err_highest"] <= e["bound"]
        out.append(e)
    return out


def kkt_apply_ms(op, B: int, M: int, phi: int, reps: int = 50) -> float:
    """Warm device time (ms) of one banded KKT apply on the default
    device, as inside the solve: the whole rung inventory resident, the
    rung index traced, and ``reps`` dependent applies in one program so
    that no dispatch is counted (each apply's output is max-normalized
    before it feeds the next)."""
    import jax
    import jax.numpy as jnp

    from swarm_simulator_tpu.qp import nullspace

    @jax.jit
    def chain(rung, dinvs, kos, r):
        one = op._replace(Dinvs=dinvs, Kos=kos, Kinvs=None)
        kinv = nullspace.make_kinv_apply(one, B, 3, M, phi)

        def step(c, _):
            y = kinv(rung, c)
            return y / jnp.max(jnp.abs(y)), None

        return jax.lax.scan(step, r, None, length=reps)[0]

    args = (jnp.asarray(0), op.Dinvs, op.Kos,
            jnp.ones((B, 3, (M - 1) * phi), jnp.float32))
    with jax.default_matmul_precision("highest"):
        chain(*args).block_until_ready()
        t0 = time.perf_counter()
        chain(*args).block_until_ready()
    return 1e3 * (time.perf_counter() - t0) / reps


# ---- one card ------------------------------------------------------------


def one_card(meter: CompileMeter) -> None:
    import numpy as np

    import bench
    import swarm_simulator_tpu as sst
    from swarm_simulator_tpu.parallel import seqbatch

    inventories = {}
    for seed in (0, 1):
        with Phase(meter, f"1 64-agent joint plan seed {seed}") as ph:
            mission, param, world = forest64(seed)
            n_batches = len(seqbatch.make_batches(mission.qn, param)[0])
            b_idx = bench.oracle_batch(seed, n_batches)
            with KeepOperator() as keep:
                result, times, ok, m = plan_and_gate(mission, param, world,
                                                     b_idx)
            info = result.solver_info
            ph.info.update(
                M=result.M, iters=info["iters"][0],
                r_prim=info["r_prim"][0], ratio=m["ratio"],
                box_viol=m["box_viol"], oracle_batch=b_idx,
                margin=m["margin"], host_prep_s=info["prep_s"],
                solve_cold_s=times.qp - info["prep_s"])
            if seed == 0:
                # warm solve: the same problem again, every program
                # already compiled
                _, times2 = sst.plan(mission, param, world)
                ph.info["solve_warm_s"] = (
                    times2.qp - times2.extra["ns_prep"])
                inventories["64"] = (keep.op, mission.qn, result.M)
            _check(ok, "gate", m)
            _check(m["margin"] <= MARGIN_BOUND, "oracle margin", m)

    with Phase(meter, "2 64-agent replan round") as ph:
        mission, param, world = forest64(0, iteration=2)
        result, times, ok, m = plan_and_gate(mission, param, world)
        info = result.solver_info
        ph.info.update(replan_rounds=info["replan_rounds"],
                       iters=info["iters"][0], r_prim=info["r_prim"][0],
                       ratio=m["ratio"], box_viol=m["box_viol"],
                       prep_s=info["prep_s"], qp_s=times.qp)
        _check(ok, "gate", m)
        _check(info["replan_rounds"] == 1, "replan rounds", info)

    with Phase(meter, "3 256-agent joint plan") as ph:
        mission, param, world = scatter256()
        with KeepOperator() as keep:
            result, times, ok, m = plan_and_gate(mission, param, world)
        info = result.solver_info
        n_pairs = len(np.asarray(result.pair_idx))
        ph.info.update(M=result.M, pairs=n_pairs,
                       pivot_gb=keep.op.Dinvs.nbytes / 1e9,
                       iters=info["iters"][0], r_prim=info["r_prim"][0],
                       polish_rounds=info["polish_rounds"],
                       ratio=m["ratio"], box_viol=m["box_viol"],
                       device_prep_s=info["prep_s"],
                       polish_s=info["polish_s"], qp_s=times.qp)
        inventories["256"] = (keep.op, mission.qn, result.M)
        _check(ok, "gate", m)
        # the oracle margin at this size is reported, not gated
        obj_b, _ = bench.batch0_objective(result.ctrl, result, mission,
                                          param, 0)
        obj_ref, ipm_s = bench.ipm_best_response_batch0(
            result, mission, param, result.ctrl, 0)
        ph.info.update(margin_batch0=obj_b / obj_ref, ipm_s=ipm_s)

    with Phase(meter, "4 64-agent default admm path") as ph:
        mission, param, world = forest64(0, solver="admm")
        result, times, ok, m = plan_and_gate(mission, param, world)
        ph.info.update(mode=result.solver_info.get("mode"),
                       ratio=m["ratio"], box_viol=m["box_viol"],
                       qp_s=times.qp)
        _check(ok, "gate", m)

    for width, (op, qn, M) in inventories.items():
        with Phase(meter, f"5 KKT apply {width} agents") as ph:
            ph.info.update(bs=op.Dinvs.shape[-1], knots=op.Dinvs.shape[1])
            errs = kkt_apply_errors(op, qn, M, 3)
            for rung, e in enumerate(errs):
                ph.info.update({f"r{rung}_{k}": v for k, v in e.items()
                                if k != "ok"})
            ph.info["apply_ms"] = kkt_apply_ms(op, qn, M, 3)
            _check(all(e["ok"] for e in errs), "apply error", errs)


# ---- four cards ----------------------------------------------------------


def four_cards(meter: CompileMeter) -> None:
    """The 64-agent forest solve sharded over jax.devices()[:4] in
    chunk and SPIKE modes, against the single-device solve: the same
    pinned-rung, fixed-iteration program must agree to the relative
    tolerance of tests/test_shard.py, and the production schedule must
    pass the safety gate on every layout."""

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    import bench
    from swarm_simulator_tpu.qp import joint, nullspace, nullspace_shard

    _check(len(jax.devices()) >= 4, "devices", jax.devices())
    mesh = Mesh(np.array(jax.devices()[:4]), ("kkt",))
    plan, mission, param = bench.build_problem(seed=0)
    data, _ = bench.assemble_joint(plan, mission, param)
    prod = joint.production_phases(base=bench.ns_settings())
    # the comparison of tests/test_shard.py: one 50-iteration phase,
    # zero tolerances so that both layouts run the full budget, and
    # adapt_threshold pinning the rung so that both walk the same rungs
    pinned = (nullspace.NSSettings(kkt_mode="banded", eps_abs=0.0,
                                   eps_rel=0.0, eps_dual_abs=0.0,
                                   rho_min=1e-4, rho_max=1e-1, n_rungs=4,
                                   adapt_threshold=1e9, check_every=50,
                                   max_iter=50),)
    ops = {"chunk": (nullspace.prepare_ns_np(data, prod[0]),
                     nullspace.prepare_ns_np(data, pinned[0])),
           "spike": (nullspace_shard.prepare_spike_np(data, prod[0], 4),
                     nullspace_shard.prepare_spike_np(data, pinned[0], 4))}
    op, op_pin = ops["chunk"]
    N, M, npp = mission.qn, plan.M, param.n + 1
    solve_single = jax.jit(nullspace.solve_ns_phases,
                           static_argnames=("phases",))
    data_dev = jax.tree.map(jnp.asarray, data)

    def single(phases, o):
        return solve_single(data_dev, phases=phases, op=jax.device_put(o))

    def gate(x):
        ctrl = np.asarray(x, np.float64).transpose(0, 2, 1).reshape(
            N, M, npp, 3)
        return bench.gate_quality(ctrl, plan, mission, param)

    def timed(fn):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        return out, time.perf_counter() - t0

    with Phase(meter, "four-cards single-device reference") as ph:
        (x_ref, i_ref), cold = timed(lambda: single(prod, op))
        (x_pin, i_pin), _ = timed(lambda: single(pinned, op_pin))
        _, warm = timed(lambda: single(prod, op))
        ok, m = gate(x_ref)
        ph.info.update(iters=int(i_ref.iters), ratio=m["ratio"],
                       box_viol=m["box_viol"], solve_cold_s=cold,
                       solve_warm_s=warm)
        _check(ok, "gate", m)

    x_pin = np.asarray(x_pin, np.float64)
    x_ref = np.asarray(x_ref, np.float64)
    for mode, (o, o_pin) in ops.items():
        with Phase(meter, f"four-cards sharded {mode}") as ph:
            d_dev, o_dev = nullspace_shard.place(data, o, mesh, mode=mode)
            pivots = o_dev.Dloc if mode == "spike" else o_dev.Dinvs
            shares = sorted((s.device.id, s.data.nbytes)
                            for s in pivots.addressable_shards)
            say(f"  {mode} pivot shares (device id, MB): "
                + ", ".join(f"({d}, {b / 1e6:.1f})" for d, b in shares))
            _check(len({d for d, _ in shares}) == 4, "pivot placement",
                   shares)

            def solve(phases, o_dev):
                return nullspace_shard.solve_ns_phases_sharded(
                    d_dev, phases, o_dev, mesh, mode=mode)

            (x_s, i_s), cold = timed(lambda: solve(prod, o_dev))
            _, warm = timed(lambda: solve(prod, o_dev))
            (x_sp, i_sp), _ = timed(lambda: solve(pinned, o_pin))
            ok, m = gate(x_s)
            x_sp = np.asarray(x_sp, np.float64)
            err = float(np.abs(x_sp - x_pin).max()) / max(
                1.0, float(np.abs(x_pin).max()))
            err_prod = float(np.abs(np.asarray(x_s, np.float64)
                                    - x_ref).max()) / max(
                1.0, float(np.abs(x_ref).max()))
            ph.info.update(iters=int(i_s.iters), ratio=m["ratio"],
                           box_viol=m["box_viol"], pinned_rel_err=err,
                           production_rel_err=err_prod,
                           solve_cold_s=cold, solve_warm_s=warm)
            _check(ok, "gate", m)
            _check(int(i_sp.iters) == int(i_pin.iters), "pinned iters",
                   (int(i_sp.iters), int(i_pin.iters)))
            _check(err < 5e-5, "pinned solve vs single device", err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded joint solve on 4 cards")
    args = ap.parse_args(argv)
    if not (ROOT / "swarm_simulator_tpu").is_dir():
        raise SystemExit("chip_smoke.py runs from a checkout of the "
                         "repository")
    sys.path.insert(0, str(ROOT))

    import jax

    from swarm_simulator_tpu.utils import runtime

    device = device_check()
    cache_dir = runtime.enable_compile_cache()
    meter = CompileMeter()
    try:
        import threadpoolctl  # noqa: F401
        tpc = "importable"
    except ImportError:
        tpc = "missing"
    import jaxlib

    from swarm_simulator_tpu.search.native_binding import build_native

    # the C++ host runtime (ECBS, EDT, SFC) is built from source at
    # first use; the build is set-up time
    t0 = time.perf_counter()
    build_native()
    native_s = time.perf_counter() - t0
    say(f"phase 0 device: ok kind={device['kind']} "
        f"count={device['count']} jax={jax.__version__} "
        f"jaxlib={jaxlib.__version__} cache_dir={cache_dir} "
        f"threadpoolctl={tpc} "
        f"blas_threads={os.environ.get('OPENBLAS_NUM_THREADS')} "
        f"native_build_s={native_s:.2f}")
    for card in card_names():
        say(f"card: {card}")

    if args.four_cards:
        four_cards(meter)
    else:
        one_card(meter)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    # the host KKT prep runs one BLAS thread per rung worker
    # (nullspace._blas_single_threaded); pin the pools before numpy
    # loads so that holds without threadpoolctl too
    for _var in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                 "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, "1")
    sys.exit(main())
