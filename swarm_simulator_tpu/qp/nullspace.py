"""Knot-state (equality-eliminated) ADMM — the production trajectory solver.

The vanilla OSQP splitting (qp/admm.py) treats the C^phi continuity and
endpoint equalities as penalized constraint rows (rho_eq ~ 1e3 rho).  On
this problem class (singular jerk Hessian + stiff equality block) its
objective convergence has an O(1/k) tail: measured on the canonical
64-agent batch QP it is still 3.4x the true optimum after 32k float64
iterations, while feasibility converges quickly — trajectories pass the
safety gate but carry far more jerk than the reference's CPLEX solutions
(solveQP, rbp_planner.hpp:111-206).

This module removes the equalities *exactly* instead.  For the canonical
n + 1 == 2*phi case (n=5, phi=3 — the only case the reference supports,
rbp_planner.hpp:210-212) the feasible set of

    Aeq x = deq      (continuity + endpoint pins, build_aeq)

has a closed-form parametrization by **knot states**: the derivative
values s_m = (p, p', .., p^(phi-1)) at each knot.  Every Bernstein control
point is an affine function of exactly ONE knot state:

    c[m, 0:phi]  = L[m] @ s[m]        (segment start)
    c[m, phi: ]  = R[m] @ s[m+1]      (segment end)

where L/R invert the endpoint-derivative maps (the same A_0/A_T rows that
build_aeq uses, so the elimination is exact w.r.t. the same constraint
system).  s_0 and s_M are pinned by the mission start/goal states; the
free variables are the interior knot states w = s[1..M-1]  — 3*(M-1) per
(agent, axis) vs 6*M control points, and continuity holds to machine
precision BY CONSTRUCTION.

Why this formulation:
  * measured on the 64-agent batch QP: reaches the IPM-verified optimum
    (0.2% objective gap at 1500 iterations, f32 == f64 to 4 digits)
    where the vanilla splitting stalls at 3-8x the optimum;
  * no Ruiz equilibration needed: the jerk Hessian in knot coordinates is
    naturally f32-well-conditioned (no dt^-2phi cost rows vs unit box
    rows, no 1e3-scaled equality block);
  * the reduced KKT matrix is block-tridiagonal over knots with
    [phi*3B x phi*3B] blocks (the jerk cost couples adjacent knots only;
    box/pair terms are knot-diagonal) — the banded structure is the
    segment-axis scaling path;
  * rho adaptation quantizes to a precomputed ladder of KKT inverses, so
    the compiled loop contains no inversion.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import bernstein
from .admm import PairOp, SolveInfo, _build_coupling, _pair_op
from .assemble import BIG, QPData


@dataclass(frozen=True)
class NSSettings:
    rho: float = 0.1
    sigma: float = 1e-6
    alpha: float = 1.6
    max_iter: int = 1500
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    eps_dual_abs: float | None = None
    check_every: int = 50
    # rho ladder (adaptive): quantized rungs of precomputed KKT inverses.
    # rho is RELATIVE to the cost-normalized problem (the Hessian is
    # rescaled to unit column norm, see prepare_ns): congested batches
    # carry ~100x the jerk cost of sparse ones, and without normalization
    # a single rho range cannot serve both (measured: the congested
    # batch-3 forest QP stalls at 7e-2 pair violation while batch 0
    # converges).  The upper rungs give feasibility-enforcing strength on
    # tightly-active problems, the lower rungs polish the objective.
    # Default range favors feasibility-first convergence at production
    # budgets (the joint 64-agent forest solve passes the safety gate at
    # 300 iters with 1e-3..1e1, fails with a 1e-5 floor — the adaptive
    # walk dips too low too early); for deep objective polish extend the
    # floor explicitly (rho_min=1e-5, n_rungs=9 reaches obj 1.002x the
    # IPM optimum at 3000 iters on the 8-agent parity problem).
    adaptive_rho: bool = True
    rho_min: float = 1e-3
    rho_max: float = 1e1
    n_rungs: int = 7
    adapt_threshold: float = 5.0
    # clamp the adaptive walk to a sub-range of the ladder WITHOUT
    # re-preparing the op (rho_min/rho_max/n_rungs define the precomputed
    # rung inventory; rho_lo/rho_hi fence which rungs a phase may visit).
    # Phased schedules (solve_ns_schedule) use this: feasibility-first at
    # high rho, deep objective polish unfenced, short feasibility-restore
    # fenced high again — the measured cure for the joint forest solve
    # where a single adaptive walk either stalls at 1.6x the optimal jerk
    # (fenced ladder) or ends 3.6e-3 outside the boxes (deep ladder).
    rho_lo: float | None = None
    rho_hi: float | None = None
    # warm start: "smooth" starts at w=0 (the equality-pinned minimum-jerk
    # trajectory -- measured far better than the reference's staircase
    # dummy, which carries ~5e4x the optimal jerk cost); "x0" projects
    # data.x0 onto the knot states
    warm_start: str = "smooth"
    # KKT linear-system strategy:
    #   "dense":  materialize K(rho)^-1 per rung [B3*nw x B3*nw] — one
    #             matmul per iteration; right for small agent batches
    #   "banded": block-tridiagonal Thomas factorization over knots
    #             ([phi*3B x phi*3B] blocks; the jerk cost couples
    #             adjacent knots only, box/pair terms are knot-diagonal)
    #             — memory O(M (phi 3B)^2) instead of O((M phi 3B)^2),
    #             the segment-axis scaling path; right for JOINT solves
    #             (the 64-agent joint KKT would be a 20160^2 dense
    #             inverse = 1.6 GB per rung)
    kkt_mode: str = "dense"
    # constraint tightening (meters): the optimum sits ON the separation
    # planes, so a first-order solver's residual infeasibility would tip
    # the strict min-distance-ratio >= 1 acceptance.  Tightening pair rhs
    # and shrinking boxes by this margin keeps the TRUE constraints
    # satisfied as long as the solve's violation stays below it (CPLEX
    # needs no margin because it solves to 1e-9, rbp_planner.hpp:158)
    tighten: float = 0.0
    # Preconditioned-CG refinement steps on the w-update against the
    # FRESH KKT operator (applied matrix-free from the problem data),
    # with the prepared rung inventory as preconditioner.  0 = trust
    # the inventory (exact when it was prepared for this data).  For
    # STALE-OPERATOR replans (inventory prepared for different pair
    # normals) each step contracts the w-update error toward the fresh
    # solve — PCG, not Richardson, because the stale-preconditioned
    # spectrum exceeds 2 once normals rotate (Richardson NaN'd; PCG
    # converges for any SPD (P, K) pair).  Measured on the 64-agent
    # forest FULL RSFC refresh (tools/staleop_study.py): box violation
    # 17 m (refine 0) -> 1.4 (1) -> 0.36 (2) — monotone but the full
    # refresh stays out of gate reach at practical step counts; use
    # fresh prep there.  Each step costs one extra inventory stream +
    # one fresh-constraint apply.
    kkt_refine: int = 0
    # Anderson acceleration (type II) applied at CHUNK level: the map
    # G(v) = check_every ADMM iterations on the packed state
    # v = (w, z, y), accelerated with a depth-aa_depth rolling history.
    # One chunk = one map evaluation, so acceleration costs only the
    # tiny m x m least squares per chunk.  The history RESETS whenever the
    # rho rung changes (different map), at phase boundaries (state
    # re-enters fresh), or when the chunk residual ||G(v) - v|| grows
    # (safeguard: the extrapolation misled, fall back to the plain
    # iterate).  0 = off — and MEASURED HARMFUL at production scale
    # (benchmarks/aa_study_cpu.log, seeds 8/2/4/7): objective margins
    # degrade at EQUAL budget (seed 8: 1.22 -> 1.29, breaking the
    # gate) and collapse at shorter ones; the phased projection-heavy
    # fixed point with a moving rho rung is exactly AA's weak regime.
    # Kept as a tested research knob; do not enable in production.
    aa_depth: int = 0


class NSConstr(NamedTuple):
    box: jnp.ndarray   # [B, 3, D]
    pair: jnp.ndarray  # [P, D]


class NSOp(NamedTuple):
    """Static per-problem pieces (dummy-state independent, so Jacobi
    sweeps hoist this out of the rounds loop)."""
    N: jnp.ndarray        # [D, nw] knot-state -> control-point map
    x_pin: jnp.ndarray    # [B, 3, D] contribution of the pinned endpoints
    g: jnp.ndarray        # [B, 3, nw] linear cost term c_s N^T Q x_pin
    F0: jnp.ndarray       # [M, phi, phi] ctrl -> knot state (left)
    FT: jnp.ndarray       # [M, phi, phi] ctrl -> knot state (right)
    c_s: jnp.ndarray      # scalar cost normalization (1/||H|| class)
    ladder: jnp.ndarray   # [R] rho rungs
    # dense mode:
    Kinvs: jnp.ndarray | None   # [R, nw3, nw3] KKT inverses per rung
    # banded mode (block-tridiagonal Thomas over knots):
    Dinvs: jnp.ndarray | None   # [R, Mi, bs, bs] pivot-block inverses
    # off-diagonal blocks are I_B3 (x) Ho with Ho [phi, phi] (the jerk
    # cost couples adjacent knots within one agent/axis only) — stored
    # SMALL and applied through the Kronecker structure: materializing
    # [Mi-1, bs, bs] dense blocks would stream mostly-zeros from device
    # memory on every iteration
    Kos: jnp.ndarray | None     # [Mi-1, phi, phi] off-diag small blocks


def knot_maps(dt: jnp.ndarray, n: int, phi: int):
    """(L, R, F0, FT): per-segment affine maps between the phi boundary
    control points and the knot state (derivative orders 0..phi-1).

    F0[m][j, i] = fall(n, j) dt_m^-j A0[j, i]  (rows of build_aeq),
    L = F0^-1; likewise FT/R at the segment end.  Requires n+1 == 2*phi.
    """
    A0, AT = bernstein.endpoint_derivative_matrices(n)
    dtv = jnp.asarray(dt)
    M = dtv.shape[0]
    fall = []
    nn = 1.0
    for j in range(phi):
        fall.append(nn)
        nn *= (n - j)
    fall = jnp.asarray(fall, dtv.dtype)                      # [phi]
    powers = dtv[:, None] ** (-jnp.arange(phi, dtype=dtv.dtype))  # [M, phi]
    scale = fall[None, :] * powers                           # [M, phi]
    A0_b = jnp.asarray(A0[:phi, :phi], dtv.dtype)
    AT_b = jnp.asarray(AT[:phi, n + 1 - phi:], dtv.dtype)
    F0 = scale[:, :, None] * A0_b[None]                      # [M, phi, phi]
    FT = scale[:, :, None] * AT_b[None]
    L = jnp.linalg.inv(F0)
    R = jnp.linalg.inv(FT)
    return L, R, F0, FT


def _build_N(L: jnp.ndarray, R: jnp.ndarray, n: int, phi: int) -> jnp.ndarray:
    """Dense map N [D, (M-1)*phi]: x = x_pin + N @ w (shared per agent/axis).

    Control point (m, i<phi) belongs to knot m (interior index m-1);
    (m, i>=phi) to knot m+1 (interior index m)."""
    M = L.shape[0]
    npp = n + 1
    Mi = M - 1
    N = jnp.zeros((M, npp, Mi, phi), L.dtype)
    if Mi == 0:
        return N.reshape(M * npp, 0)
    seg = jnp.arange(1, M)
    N = N.at[seg, :phi, seg - 1, :].set(L[1:])
    N = N.at[seg - 1, phi:, seg - 1, :].set(R[:M - 1])
    return N.reshape(M * npp, Mi * phi)


def _apply_Qseg(Qseg: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """blockdiag(Qseg) @ v along the last (D) axis."""
    M, npp, _ = Qseg.shape
    shape = v.shape
    vs = v.reshape(shape[:-1] + (M, npp))
    out = jnp.einsum("mij,...mj->...mi", Qseg, vs)
    return out.reshape(shape)


def _inv_spd_np(S):
    """Inverse of a symmetric positive-definite matrix via Cholesky
    (LAPACK potrf+potri: ~2n^3/3 FLOPs vs ~2n^3 for LU inv), falling
    back to LU if the factorization fails.  The KKT pivot blocks are
    Schur complements of an SPD matrix, so potrf succeeds in practice;
    the fallback guards degenerate test problems."""
    import numpy as onp
    from scipy.linalg.lapack import dpotrf, dpotri

    c, info = dpotrf(S, lower=1, overwrite_a=0)
    if info != 0:
        x = onp.linalg.inv(S)
        return 0.5 * (x + x.T)
    x, info = dpotri(c, lower=1, overwrite_c=1)
    if info != 0:
        x = onp.linalg.inv(S)
        return 0.5 * (x + x.T)
    # potri fills the lower triangle only (dpotrf clean=1 zeroed the
    # upper), so mirroring it is EXACTLY symmetric — callers can rely
    # on bit-level symmetry of the result
    return x + onp.tril(x, -1).T


class _blas_single_threaded:
    """Pin BLAS pools to one thread for the scope (no-op without
    threadpoolctl).  Measured on this 4-core host: OpenBLAS's own
    threading LOSES by 30-100x at the prep block sizes (576^2 LU inv:
    27.7 ms at 1 thread, 890 ms at 4 — spin contention), and the rung
    thread pool multiplies the oversubscription.  One BLAS thread per
    rung worker is the fast configuration."""

    def __enter__(self):
        try:
            from threadpoolctl import threadpool_limits
            self._ctx = threadpool_limits(limits=1)
        except Exception:
            self._ctx = None
        return self

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
        return False


def _banded_kd_builder_np(Qseg, L, R, C, c_s, sigma):
    """Host builder of the banded KKT's [bs, bs] diagonal blocks:
    returns (make_Kd(k, rho), Ho [Mi-1, phi, phi], bs).  Shared by
    prepare_ns_np and the SPIKE substructuring prep
    (qp/nullspace_shard.prepare_spike_np); Kd is formed per (rung,
    knot) as one transient — materializing the Kronecker operands was
    multi-GB at 256 agents."""
    import numpy as onp

    M, npp, _ = Qseg.shape
    phi = npp // 2
    B3 = C.shape[-1]
    WL = onp.einsum("mia,mib->mab", L, L)
    WR = onp.einsum("mia,mib->mab", R, R)
    Q00 = onp.einsum("mia,mij,mjb->mab", L, Qseg[:, :phi, :phi], L)
    Q11 = onp.einsum("mia,mij,mjb->mab", R, Qseg[:, phi:, phi:], R)
    Q01 = onp.einsum("mia,mij,mjb->mab", L, Qseg[:, :phi, phi:], R)
    Hd = c_s * (Q00[1:M] + Q11[0:M - 1])
    NtN_k = WL[1:M] + WR[0:M - 1]
    Ho = c_s * Q01[1:M - 1]
    bs = B3 * phi
    sigI = sigma * onp.eye(phi)
    Hds = Hd + sigI                     # [Mi, phi, phi]
    C1, C0 = C[1:M], C[0:M - 1]         # [Mi, B3, B3]
    WL1, WR0 = WL[1:M], WR[0:M - 1]     # [Mi, phi, phi]
    diag_idx = onp.arange(B3)

    def make_Kd(k, rho):
        K4 = C1[k][:, None, :, None] * (rho * WL1[k])[None, :,
                                                      None, :]
        K4 += C0[k][:, None, :, None] * (rho * WR0[k])[None, :,
                                                       None, :]
        K4[diag_idx, :, diag_idx, :] += Hds[k] + rho * NtN_k[k]
        return K4.reshape(bs, bs)

    return make_Kd, Ho, bs


def _host_prep_ctx_np(data: QPData, s: NSSettings) -> dict:
    """Shared host-f64 front of the banded preps: knot maps, null-space
    map N, pinned trajectory, cost normalization, rho ladder, and the
    pair coupling C.  Used by prepare_ns_np and the SPIKE
    substructuring prep (qp/nullspace_shard.prepare_spike_np)."""
    import numpy as onp

    if data.dt is None:
        raise ValueError("QPData.dt required for the knot-state solver")
    Qseg = onp.asarray(data.Qseg, onp.float64)
    M, npp, _ = Qseg.shape
    n = npp - 1
    phi = onp.asarray(data.Aeq).shape[0] // (M + 1)
    if npp != 2 * phi:
        raise ValueError("knot-state formulation needs n+1 == 2*phi")
    D = M * npp
    lb = onp.asarray(data.lb)
    B = lb.shape[0]
    B3 = 3 * B
    dt_ = lb.dtype

    from .ipm import _knot_maps_np
    L, R, F0, FT = _knot_maps_np(onp.asarray(data.dt), n, phi)

    Mi = M - 1
    nw = Mi * phi
    N = onp.zeros((M, npp, Mi, phi))
    if Mi:
        for m in range(1, M):
            N[m, :phi, m - 1, :] = L[m]
            N[m - 1, phi:, m - 1, :] = R[m - 1]
    N = N.reshape(D, nw)

    deq = onp.asarray(data.deq, onp.float64)
    s_all = onp.zeros((B, 3, M + 1, phi))
    s_all[:, :, 0, :] = deq[:, :, :phi]
    s_all[:, :, M, :] = deq[:, :, phi:2 * phi]
    left = onp.einsum("mij,bkmj->bkmi", L, s_all[:, :, :M])
    right = onp.einsum("mij,bkmj->bkmi", R, s_all[:, :, 1:])
    x_pin = onp.concatenate([left, right], axis=-1).reshape(B, 3, D)

    def apply_Q(v):
        vs = v.reshape(v.shape[:-1] + (M, npp))
        return onp.einsum("mij,...mj->...mi", Qseg,
                          vs).reshape(v.shape)

    H_raw = N.T @ apply_Q(N.T).T
    c_s = 1.0 / onp.clip(onp.mean(onp.max(onp.abs(H_raw), axis=0)),
                         1e-12, None)
    g = c_s * onp.einsum("da,bkd->bka", N, apply_Q(x_pin))

    if s.adaptive_rho:
        ladder = onp.logspace(onp.log10(s.rho_min), onp.log10(s.rho_max),
                              s.n_rungs)
    else:
        ladder = onp.asarray([s.rho], onp.float64)

    from concurrent.futures import ThreadPoolExecutor
    import os
    n_workers = min(4, os.cpu_count() or 1)

    # pair coupling [M, B3, B3] (f64 twin of admm._build_coupling):
    # C_m = A_m^T A_m where row p of A_m is Cp[p,:] (x) pn[p,m,:] with
    # only TWO nonzero agent blocks (bi, bj) — so accumulate the four
    # 3x3 block contributions per pair directly instead of the dense
    # [P, B3] dgemm (at 256 agents the dense form was ~1.5e12 f64
    # FLOPs, the second-largest prep cost; the scatter is O(P*M*9))
    pm = onp.asarray(data.pair_mask, onp.float64)
    bi = onp.asarray(data.pair_bi)
    bj = onp.asarray(data.pair_bj)
    pn = onp.asarray(data.pair_n, onp.float64)        # [P, M, 3]
    wj = (bj >= 0) * pm
    wi = -((bi >= 0) * pm)
    ji = onp.clip(bj, 0, None)
    ii = onp.clip(bi, 0, None)
    wjj, wii, wij = wj * wj, wi * wi, wi * wj
    C = onp.zeros((M, B3, B3))

    def fill_C(m):
        Gp = pn[:, m, :, None] * pn[:, m, None, :]    # [P, 3, 3]
        C4 = onp.zeros((B, B, 3, 3))
        onp.add.at(C4, (ji, ji), wjj[:, None, None] * Gp)
        onp.add.at(C4, (ii, ii), wii[:, None, None] * Gp)
        Gij = wij[:, None, None] * Gp
        onp.add.at(C4, (ii, ji), Gij)
        onp.add.at(C4, (ji, ii), Gij)
        C[m] = C4.transpose(0, 2, 1, 3).reshape(B3, B3)

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        list(ex.map(fill_C, range(M)))

    return dict(Qseg=Qseg, M=M, npp=npp, phi=phi, D=D, B=B, B3=B3,
                dt_=dt_, L=L, R=R, F0=F0, FT=FT, Mi=Mi, nw=nw, N=N,
                x_pin=x_pin, c_s=c_s, g=g, ladder=ladder, C=C,
                n_workers=n_workers, H_raw=H_raw)


def prepare_ns_np(data: QPData, s: NSSettings) -> NSOp:
    """Host float64 twin of prepare_ns (numpy), leaves cast to the
    problem dtype at the end.

    Why it exists: the KKT rung inverses are the one prep quantity whose
    f32 on-device computation measurably degrades solution quality.  A
    cross-platform swap experiment isolated it — f64-prep + f32 device
    iterations match CPU-f64 polish quality, f32 device prep + CPU
    iterations do not — and one on-device Newton refinement step only
    partially closes the gap (the residual matmuls themselves run in
    f32).  Computing the inverses in host f64 and rounding ONCE to f32 gives
    the best representable f32 operator; prep is dummy-independent and
    amortized over the whole phased solve."""
    import numpy as onp
    from concurrent.futures import ThreadPoolExecutor

    ctx = _host_prep_ctx_np(data, s)
    Qseg, M, npp, phi = ctx["Qseg"], ctx["M"], ctx["npp"], ctx["phi"]
    B, B3, dt_, Mi, nw = (ctx["B"], ctx["B3"], ctx["dt_"], ctx["Mi"],
                          ctx["nw"])
    L, R, F0, FT = ctx["L"], ctx["R"], ctx["F0"], ctx["FT"]
    N, x_pin, c_s, g = ctx["N"], ctx["x_pin"], ctx["c_s"], ctx["g"]
    ladder, C, n_workers = ctx["ladder"], ctx["C"], ctx["n_workers"]
    H_raw = ctx["H_raw"]

    def finish(**kw):
        # leaves stay HOST numpy (cast once to the problem dtype): the
        # caller decides when/where to transfer (one bulk device_put).
        # copy=False: Dinvs is already stored in dt_ (multi-GB at 256
        # agents — a redundant astype copy doubled peak RSS)
        cast = {k: (None if v is None else
                    onp.asarray(v).astype(dt_, copy=False))
                for k, v in kw.items()}
        return NSOp(N=cast["N"], x_pin=cast["x_pin"], g=cast["g"],
                    F0=cast["F0"], FT=cast["FT"], c_s=cast["c_s"],
                    ladder=cast["ladder"], Kinvs=cast["Kinvs"],
                    Dinvs=cast["Dinvs"], Kos=cast["Kos"])

    if s.kkt_mode == "banded":
        make_Kd, Ho, bs = _banded_kd_builder_np(Qseg, L, R, C, c_s,
                                                s.sigma)

        # pivot inventory stored directly in the problem dtype (the
        # chain itself stays f64): at 256 agents the f64 inventory is
        # 13.4 GB — storing rounded blocks halves peak RSS
        Dinvs = onp.zeros((len(ladder), Mi, bs, bs), dtype=dt_)

        def fill_rung(r):
            # rungs are independent; LAPACK/BLAS release the GIL, so a
            # thread pool parallelizes the dominant cost — with BLAS
            # pinned to ONE thread per worker (_blas_single_threaded:
            # OpenBLAS's own threading loses by 30x+ here and the pool
            # multiplied the oversubscription; 64-agent prep measured
            # 243 s before this configuration, ~3 s after).  Kd is
            # formed per KNOT so each thread's transient is one
            # [bs, bs] block, not the full [Mi, bs, bs] operand
            rho = ladder[r]
            Dprev = _inv_spd_np(make_Kd(0, rho))
            Dinvs[r, 0] = Dprev
            for k in range(1, Mi):
                # sandwich (I (x) Ho)^T Dprev (I (x) Ho) as
                # [B3, B3]-batched phi x phi matmuls (the
                # einsum/tensordot form spent ~7 ms/knot in reshape
                # copies for a 4-MFLOP contraction)
                D4 = Dprev.reshape(B3, phi, B3,
                                   phi).transpose(0, 2, 1, 3)
                s4 = Ho[k - 1].T @ D4 @ Ho[k - 1]
                sand = s4.transpose(0, 2, 1, 3).reshape(bs, bs)
                Dprev = _inv_spd_np(make_Kd(k, rho) - sand)
                # _inv_spd_np returns an EXACTLY symmetric matrix, so
                # row-vector matvecs (v @ Dinv) equal the column form
                # without a second symmetrization pass
                Dinvs[r, k] = Dprev

        # worker count: with 5 rungs on 4 cores, one-worker-per-core
        # leaves a straggler round (wall = 2 chains); oversubscribing
        # to one worker PER RUNG timeslices all chains concurrently
        # (wall ~ 5/4 chain, measured 3.13 -> 2.73 s at 64 agents).
        # Only mild oversubscription: 9 concurrent chains thrash the
        # shared cache (round-2 measured 10.2-13.4 s vs 9.3-10.3 s)
        rung_workers = (len(ladder) if len(ladder) <= n_workers + 2
                        else n_workers)
        with _blas_single_threaded():
            with ThreadPoolExecutor(max_workers=rung_workers) as ex:
                list(ex.map(fill_rung, range(len(ladder))))
        return finish(N=N, x_pin=x_pin, g=g, F0=F0, FT=FT, c_s=c_s,
                      ladder=ladder, Kinvs=None, Dinvs=Dinvs, Kos=Ho)

    H = c_s * H_raw + s.sigma * onp.eye(nw)
    NtN = N.T @ N
    K0 = onp.einsum("ab,de->adbe", onp.eye(B3), H)
    K1 = onp.einsum("ab,de->adbe", onp.eye(B3), NtN)
    Nm = N.reshape(M, npp, nw)
    W = onp.einsum("mda,mdb->mab", Nm, Nm)
    K1 = K1 + onp.einsum("mab,mij->iajb", W, C)
    nx = B3 * nw
    K0 = K0.reshape(nx, nx)
    K1 = K1.reshape(nx, nx)
    Ks = K0[None] + ladder[:, None, None] * K1[None]
    Kinvs = onp.empty_like(Ks)

    def fill_kinv(r):
        Kinvs[r] = _inv_spd_np(Ks[r])

    with _blas_single_threaded():
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            list(ex.map(fill_kinv, range(len(ladder))))
    return finish(N=N, x_pin=x_pin, g=g, F0=F0, FT=FT, c_s=c_s,
                  ladder=ladder, Kinvs=Kinvs, Dinvs=None, Kos=None)


def refresh_ns_op_np(op: NSOp, data: QPData) -> NSOp:
    """Cheap host refresh of the endpoint-dependent NSOp leaves (x_pin,
    g) for a REPLAN that keeps the time grid (same M, dt — asserted via
    F0) and reuses the prepared KKT rung inventory (Dinvs/Kinvs).

    The rung inventory embeds the previous corridors' pair-normal
    coupling (C = A^T A of the separating directions, the expensive
    host-f64 prep), so solving fresh data with it is an inexact-metric
    ADMM: the constraint projections and dual updates use the FRESH
    normals/bounds — only the w-update metric is stale.  VALIDITY
    (measured, tools/staleop_study.py): exact for endpoint-only and
    SFC-bound-only replans (neither enters the inventory).  A FULL
    RSFC refresh from the previous solution rotates the coupling too
    far: the stale replan fails the acceptance gate (box violation
    17 m naive; still 0.36 m with kkt_refine=2 PCG w-updates; rho
    fencing does not save it) — corridor-refresh replans must re-run
    prepare_ns_np (qp/joint.py replan_prep="fresh", the default).

    op must be host-resident (numpy leaves, as returned by
    prepare_ns_np); milliseconds of work.
    """
    import numpy as onp

    if data.dt is None:
        raise ValueError("QPData.dt required for the knot-state solver")
    M, npp, _ = onp.asarray(data.Qseg).shape
    n = npp - 1
    phi = onp.asarray(data.Aeq).shape[0] // (M + 1)
    lb = onp.asarray(data.lb)
    B = lb.shape[0]
    dt_ = lb.dtype

    from .ipm import _knot_maps_np
    L, R, F0, FT = _knot_maps_np(onp.asarray(data.dt), n, phi)
    if (onp.asarray(op.F0).shape != F0.shape
            or not onp.allclose(onp.asarray(op.F0, onp.float64), F0,
                                rtol=1e-5, atol=1e-8)):
        raise ValueError(
            "refresh_ns_op_np: time grid changed (F0 mismatch) — the "
            "KKT rung inventory is tied to dt/M; re-run prepare_ns_np")
    if onp.asarray(op.x_pin).shape[0] != B:
        raise ValueError("refresh_ns_op_np: agent count changed")

    D = M * npp
    Mi = M - 1
    N = onp.zeros((M, npp, Mi, phi))
    if Mi:
        for m in range(1, M):
            N[m, :phi, m - 1, :] = L[m]
            N[m - 1, phi:, m - 1, :] = R[m - 1]
    N = N.reshape(D, Mi * phi)

    deq = onp.asarray(data.deq, onp.float64)
    s_all = onp.zeros((B, 3, M + 1, phi))
    s_all[:, :, 0, :] = deq[:, :, :phi]
    s_all[:, :, M, :] = deq[:, :, phi:2 * phi]
    left = onp.einsum("mij,bkmj->bkmi", L, s_all[:, :, :M])
    right = onp.einsum("mij,bkmj->bkmi", R, s_all[:, :, 1:])
    x_pin = onp.concatenate([left, right], axis=-1).reshape(B, 3, D)

    Qseg = onp.asarray(data.Qseg, onp.float64)
    vs = x_pin.reshape(B, 3, M, npp)
    Qx = onp.einsum("mij,bkmj->bkmi", Qseg, vs).reshape(B, 3, D)
    c_s = float(onp.asarray(op.c_s, onp.float64))
    g = c_s * onp.einsum("da,bkd->bka", N, Qx)

    return op._replace(x_pin=x_pin.astype(dt_), g=g.astype(dt_))


def prepare_ns(data: QPData, s: NSSettings) -> NSOp:
    """All dummy-independent prep: maps, linear term, KKT inverse ladder.

    Pins matmul precision itself: at default precision the GPU may run
    the Kd-forming einsums and the Schur-chain sandwiches as TF32
    matmuls (about three decimal digits), which wrecks the rung
    inverses when a caller jits this bare."""
    with jax.default_matmul_precision("highest"):
        return _prepare_ns_impl(data, s)


def _prepare_ns_impl(data: QPData, s: NSSettings) -> NSOp:
    if data.dt is None:
        raise ValueError("QPData.dt required for the knot-state solver")
    M, npp, _ = data.Qseg.shape
    n = npp - 1
    phi = data.Aeq.shape[0] // (M + 1)
    if npp != 2 * phi:
        raise ValueError(f"knot-state formulation needs n+1 == 2*phi "
                         f"(got n={n}, phi={phi})")
    D = M * npp
    B = data.lb.shape[0]
    B3 = 3 * B
    dt_ = data.lb.dtype

    L, R, F0, FT = knot_maps(data.dt.astype(dt_), n, phi)
    N = _build_N(L, R, n, phi)                   # [D, nw]
    nw = N.shape[1]

    # pinned-endpoint trajectory: s interior = 0, s_0 / s_M from deq
    s_all = jnp.zeros((B, 3, M + 1, phi), dt_)
    s_all = s_all.at[:, :, 0, :].set(data.deq[:, :, :phi])
    s_all = s_all.at[:, :, M, :].set(data.deq[:, :, phi:2 * phi])
    left = jnp.einsum("mij,bkmj->bkmi", L, s_all[:, :, :M])
    right = jnp.einsum("mij,bkmj->bkmi", R, s_all[:, :, 1:])
    x_pin = jnp.concatenate([left, right], axis=-1).reshape(B, 3, D)

    # scalar cost normalization: congested batches carry orders of
    # magnitude more jerk cost than sparse ones; dividing the Hessian by
    # its mean column norm puts every problem's useful rho in one ladder
    QbN = _apply_Qseg(data.Qseg, N.T).T          # [D, nw]
    H_raw = N.T @ QbN
    c_s = 1.0 / jnp.clip(jnp.mean(jnp.max(jnp.abs(H_raw), axis=0)),
                         1e-12, None)
    g = c_s * jnp.einsum("da,bkd->bka", N, _apply_Qseg(data.Qseg, x_pin))

    if s.adaptive_rho:
        ladder = jnp.logspace(jnp.log10(s.rho_min), jnp.log10(s.rho_max),
                              s.n_rungs).astype(dt_)
    else:
        ladder = jnp.asarray([s.rho], dt_)
    C = _build_coupling(data, s)                 # [M, B3, B3]
    Mi = M - 1
    eyeB3 = jnp.eye(B3, dtype=dt_)

    if s.kkt_mode == "banded":
        # block-tridiagonal blocks over interior knots, row index
        # (agent*3+axis)*phi + comp:
        #   Kd[k] = I_B3 (x) (c_s Hd_k + sigma I + rho NtN_k)
        #           + rho (C_k (x) WL_k + C_{k-1} (x) WR_{k-1})
        #   Ko[k] = I_B3 (x) (c_s Ho_k)              (rho-independent)
        Qs = data.Qseg
        WL = jnp.einsum("mia,mib->mab", L, L)            # [M, phi, phi]
        WR = jnp.einsum("mia,mib->mab", R, R)
        Q00 = jnp.einsum("mia,mij,mjb->mab", L, Qs[:, :phi, :phi], L)
        Q11 = jnp.einsum("mia,mij,mjb->mab", R, Qs[:, phi:, phi:], R)
        Q01 = jnp.einsum("mia,mij,mjb->mab", L, Qs[:, :phi, phi:], R)
        Hd = c_s * (Q00[1:M] + Q11[0:M - 1])             # [Mi, phi, phi]
        NtN_k = WL[1:M] + WR[0:M - 1]
        Ho = c_s * Q01[1:M - 1]                          # [Mi-1, phi, phi]

        def kron_b(Cb, Wb):  # [.., B3, B3] x [.., phi, phi] -> [.., bs, bs]
            out = jnp.einsum("...ij,...ab->...iajb", Cb, Wb)
            bs = B3 * phi
            return out.reshape(out.shape[:-4] + (bs, bs))

        sigI = s.sigma * jnp.eye(phi, dtype=dt_)
        # The Kd blocks are built ONE KNOT AT A TIME inside the Thomas
        # scan below: materializing base_d/rho_d as [Mi, bs, bs] arrays
        # kept a ~3x-inventory transient alive through the whole rung
        # ladder (at 256 agents in the M=80 bucket, tens of GB);
        # per-knot construction caps the transient at a few [bs, bs]
        # blocks.
        Hd_s = Hd + sigI                                 # [Mi, phi, phi]
        CL, CR = C[1:M], C[0:M - 1]                      # [Mi, B3, B3]
        WLk, WRk = WL[1:M], WR[0:M - 1]                  # [Mi, phi, phi]

        def kd_knot(rho, k_in):
            Hd_k, NtN_kk, CL_k, WL_k, CR_k, WR_k = k_in
            return (kron_b(eyeB3, Hd_k + rho * NtN_kk)
                    + rho * (kron_b(CL_k, WL_k) + kron_b(CR_k, WR_k)))

        def ko_sandwich(Dinv, Ho_k):
            # (I (x) Ho)^T Dinv (I (x) Ho) via the small blocks
            Dr = Dinv.reshape(B3, phi, B3, phi)
            out = jnp.einsum("ai,xayb,bj->xiyj", Ho_k, Dr, Ho_k)
            return out.reshape(B3 * phi, B3 * phi)

        def inv_refined(S_):
            # one Newton step X <- X (2I - S X) on the f32 inverse: the
            # rung condition number reaches ~1/rho_min and a raw f32
            # inverse loses ~cond*eps relative accuracy per apply, which
            # measurably degrades the low-rho polish phase in f32
            X = jnp.linalg.inv(S_)
            I2 = 2.0 * jnp.eye(S_.shape[-1], dtype=S_.dtype)
            return X @ (I2 - S_ @ X)

        def factor(rho):
            def step(Dinv_prev, inp):
                k_in, Ho_prev = inp
                Kd_k = kd_knot(rho, k_in)
                S_ = Kd_k - ko_sandwich(Dinv_prev, Ho_prev)
                Dinv_k = inv_refined(S_)
                return Dinv_k, Dinv_k

            k0 = (Hd_s[0], NtN_k[0], CL[0], WLk[0], CR[0], WRk[0])
            Dinv0 = inv_refined(kd_knot(rho, k0))
            ks = (Hd_s[1:], NtN_k[1:], CL[1:], WLk[1:], CR[1:], WRk[1:])
            _, Ds = jax.lax.scan(step, Dinv0, (ks, Ho))
            return jnp.concatenate([Dinv0[None], Ds], axis=0)

        # sequential over rungs (lax.map, not vmap): the per-rung Kd
        # transient is [Mi, bs, bs] — vmapping materialized all R rungs
        # at once, which at 256 agents is a 7.5 GB transient on top of
        # the 7.5 GB Dinvs output; rungs are serial but
        # each is itself a big batched-inverse pipeline
        Dinvs = jax.lax.map(factor, ladder)      # [R, Mi, bs, bs]
        return NSOp(N=N, x_pin=x_pin, g=g, F0=F0, FT=FT, c_s=c_s,
                    ladder=ladder, Kinvs=None, Dinvs=Dinvs, Kos=Ho)

    # dense mode: K(rho) = K0 + rho K1, both [B3*nw, B3*nw]:
    #   K0 = I_B3 (x) (c_s N^T Qb N + sigma I)
    #   K1 = I_B3 (x) (N^T N)  +  knot-block-diag pair coupling sandwich
    H = c_s * H_raw + s.sigma * jnp.eye(nw, dtype=dt_)
    NtN = N.T @ N
    K0 = jnp.einsum("ab,de->adbe", eyeB3, H)
    K1 = jnp.einsum("ab,de->adbe", eyeB3, NtN)
    # coupling sandwich: the pair normals are constant per segment, so
    # Sigma_d N[d,a] N[d,b] C_seg(d)[i,j] contracts over (segment, point)
    Nm = N.reshape(M, npp, nw)
    W = jnp.einsum("mda,mdb->mab", Nm, Nm)       # [M, nw, nw]
    K1 = K1 + jnp.einsum("mab,mij->iajb", W, C)
    nx = B3 * nw
    K0 = K0.reshape(nx, nx)
    K1 = K1.reshape(nx, nx)
    Ks = K0[None] + ladder[:, None, None] * K1[None]
    Kinvs = jnp.linalg.inv(Ks)
    # one Newton refinement step (see banded inv_refined)
    I2 = 2.0 * jnp.eye(nx, dtype=dt_)
    Kinvs = jnp.einsum("rab,rbc->rac", Kinvs, I2[None] - jnp.einsum(
        "rab,rbc->rac", Ks, Kinvs))
    return NSOp(N=N, x_pin=x_pin, g=g, F0=F0, FT=FT, c_s=c_s,
                ladder=ladder, Kinvs=Kinvs, Dinvs=None, Kos=None)


def make_kinv_apply(op: NSOp, B: int, K3: int, M: int, phi: int):
    """KKT-system solver `(rho_idx, rhs [B, K3, nw]) -> [B, K3, nw]` for
    whichever mode the op was prepared in (dense inverse matmul, or
    block-tridiagonal Thomas over knots)."""
    if op.Kinvs is not None:
        def kinv_apply(rho_idx, rhs):
            Kinv = op.Kinvs[rho_idx]
            return (rhs.reshape(-1) @ Kinv.T).reshape(rhs.shape)
        return kinv_apply

    Mi = M - 1
    bs = B * K3 * phi
    B3 = B * K3

    def kinv_apply(rho_idx, rhs):
        # block-tridiagonal Thomas solve over knots; block vector at
        # knot k holds all (agent, axis, comp) entries.  Off-diagonal
        # blocks I_B3 (x) Ho are applied through the Kronecker structure
        # (per-agent [phi, phi] contraction) — only the dense pivot
        # inverses stream from HBM
        Dinv = op.Dinvs[rho_idx]                    # [Mi, bs, bs]
        Ho = op.Kos                                 # [Mi-1, phi, phi]
        b = rhs.reshape(B, K3, Mi, phi).transpose(2, 0, 1, 3)
        b = b.reshape(Mi, bs)

        def koT(Ho_k, v):     # (I (x) Ho)^T v
            return jnp.einsum("ai,xa->xi", Ho_k,
                              v.reshape(B3, phi)).reshape(bs)

        def ko(Ho_k, v):      # (I (x) Ho) v
            return jnp.einsum("ab,xb->xa", Ho_k,
                              v.reshape(B3, phi)).reshape(bs)

        def fwd(y_prev, inp):
            b_k, Ho_prev, Dinv_prev = inp
            y_k = b_k - koT(Ho_prev, Dinv_prev @ y_prev)
            return y_k, y_k

        _, ys = jax.lax.scan(fwd, b[0], (b[1:], Ho, Dinv[:-1]),
                             unroll=4)
        y = jnp.concatenate([b[:1], ys], axis=0)
        x_last = Dinv[-1] @ y[-1]

        def bwd(x_next, inp):
            y_k, Ho_k, Dinv_k = inp
            x_k = Dinv_k @ (y_k - ko(Ho_k, x_next))
            return x_k, x_k

        _, xs = jax.lax.scan(bwd, x_last, (y[:-1], Ho, Dinv[:-1]),
                             reverse=True, unroll=4)
        x = jnp.concatenate([xs, x_last[None]], axis=0)  # [Mi, bs]
        x = x.reshape(Mi, B, K3, phi).transpose(1, 2, 0, 3)
        return x.reshape(rhs.shape)

    return kinv_apply


def _x_of(op: NSOp, w: jnp.ndarray) -> jnp.ndarray:
    """x [B, 3, D] from interior knot states w [B, 3, nw]."""
    return op.x_pin + jnp.einsum("da,bka->bkd", op.N, w)


def _w_from_x(op: NSOp, x: jnp.ndarray, phi: int) -> jnp.ndarray:
    """Project a control-point trajectory onto knot states (average of the
    left/right derivative readings; exact if x is continuity-feasible)."""
    B, K3, D = x.shape
    M = op.F0.shape[0]
    npp = D // M
    c = x.reshape(B, K3, M, npp)
    s_right = jnp.einsum("mij,bkmj->bkmi", op.F0, c[..., :phi])   # knot m
    s_left = jnp.einsum("mij,bkmj->bkmi", op.FT, c[..., phi:])    # knot m+1
    s_int = 0.5 * (s_left[:, :, :M - 1] + s_right[:, :, 1:])
    return s_int.reshape(B, K3, (M - 1) * phi)


def _A_x(data: QPData, x: jnp.ndarray, pop: PairOp) -> NSConstr:
    xs = jnp.einsum("pb,bkd->pkd", pop.S, x)
    pair = jnp.einsum("pkd,pkd->pd", pop.n_d, xs)
    return NSConstr(box=x, pair=pair)


def _AT_x(data: QPData, y: NSConstr, pop: PairOp) -> jnp.ndarray:
    contrib = pop.n_d * y.pair[:, None, :]
    return y.box + jnp.einsum("pb,pkd->bkd", pop.S, contrib)


def _bounds(data: QPData, tighten: float = 0.0) -> tuple[NSConstr, NSConstr]:
    from .assemble import KNOT_FACE_GUARD

    big = jnp.asarray(BIG, data.lb.dtype)
    t = jnp.asarray(tighten, data.lb.dtype)
    pair_l = jnp.where(data.pair_rhs > -BIG / 2, data.pair_rhs + t,
                       data.pair_rhs)
    lb, ub = data.lb, data.ub
    # knot-face pre-relaxation (tighten-aware; see assemble.
    # KNOT_FACE_GUARD): the duplicated knot rows bind to the
    # INTERSECTION of consecutive SFC boxes, which may be zero-width
    # where boxes share only a face.  Tightening would invert such a
    # pair of rows into infeasibility; instead relax BOTH rows by
    # g = min(t, guard) so the post-tightening constraint recovers the
    # true intersection EXACTLY (production t == guard == 2e-3), while
    # tighten=0 consumers see the true bounds untouched.  The relaxed
    # interval stays inside the union of the two obstacle-free boxes.
    M = data.Qseg.shape[-3]
    if M > 1 and float(tighten) > 0.0:
        g = jnp.minimum(t, jnp.asarray(KNOT_FACE_GUARD, lb.dtype))
        sh = lb.shape[:-1] + (M, lb.shape[-1] // M)
        lbv, ubv = lb.reshape(sh), ub.reshape(sh)
        ilo = jnp.maximum(lbv[..., :-1, -1], lbv[..., 1:, 0])
        ihi = jnp.minimum(ubv[..., :-1, -1], ubv[..., 1:, 0])
        thin = (ihi - ilo) < 2 * KNOT_FACE_GUARD
        lbv = lbv.at[..., :-1, -1].set(jnp.where(thin, ilo - g,
                                                 lbv[..., :-1, -1]))
        lbv = lbv.at[..., 1:, 0].set(jnp.where(thin, ilo - g,
                                               lbv[..., 1:, 0]))
        ubv = ubv.at[..., :-1, -1].set(jnp.where(thin, ihi + g,
                                                 ubv[..., :-1, -1]))
        ubv = ubv.at[..., 1:, 0].set(jnp.where(thin, ihi + g,
                                               ubv[..., 1:, 0]))
        lb, ub = lbv.reshape(lb.shape), ubv.reshape(ub.shape)
    # per-row clamp: never tighten a box row beyond its own midpoint.
    # SFC boxes can be DEGENERATE in one axis (a narrow slot between
    # obstacles expands to ymin == ymax — 64-agent forest seed 17,
    # agent 61 segment 13), and a blanket lb+t/ub-t then INVERTS every
    # control-point row of that segment: the QP turns infeasible by
    # 2t, ADMM stalls at a least-violation point, and the box gate
    # fails.  CPLEX applies no tightening to these rows
    # (rbp_planner.hpp:585-600), so width-0 rows must stay width-0.
    t_box = jnp.minimum(t, 0.5 * (ub - lb))
    l = NSConstr(box=lb + t_box, pair=pair_l)
    u = NSConstr(box=ub - t_box,
                 pair=jnp.full_like(data.pair_rhs, big))
    return l, u


def _iterate_ns(data: QPData, op: NSOp, s: NSSettings, init=None,
                return_state: bool = False, schedule=None):
    """ADMM loop in knot-state coordinates.  init: (w, z, y, rho_idx)
    from a previous call (Jacobi round) via return_state=True.

    schedule: optional (max_iters [K], idx_lo [K], idx_hi [K]) int
    arrays — run K fenced phases as ONE lax.scan whose body contains
    the single compiled while-loop, with the per-phase budget and rho
    fences as TRACED scalars.  This is the compile-wall path: a
    3-phase production schedule would otherwise trace three copies of
    the chunk body; the scan form traces it once, and schedules that share a
    base NSSettings (cold / polish / escalation) can share one
    EXECUTABLE by passing the arrays as jit arguments.  s.max_iter /
    s.rho_lo / s.rho_hi are ignored in this mode."""
    B, K3, D = data.lb.shape
    dt_ = data.lb.dtype
    M = op.F0.shape[0]
    phi = op.F0.shape[1]
    nw = op.N.shape[1]

    pop = _pair_op(data)
    l, u = _bounds(data, s.tighten)
    tmap = jax.tree.map

    sigma = jnp.asarray(s.sigma, dt_)
    alpha = jnp.asarray(s.alpha, dt_)
    eps_abs = jnp.asarray(s.eps_abs, dt_)
    eps_dual = jnp.asarray(
        s.eps_abs if s.eps_dual_abs is None else s.eps_dual_abs, dt_)
    eps_rel = jnp.asarray(s.eps_rel, dt_)

    # rho-rung fence (see NSSettings.rho_lo/rho_hi)
    lad_log = jnp.log(op.ladder)
    idx_lo = (jnp.argmin(jnp.abs(lad_log - jnp.log(s.rho_lo)))
              if s.rho_lo is not None else 0)
    idx_hi = (jnp.argmin(jnp.abs(lad_log - jnp.log(s.rho_hi)))
              if s.rho_hi is not None else op.ladder.shape[0] - 1)

    if init is None:
        if s.warm_start == "x0":
            w = _w_from_x(op, data.x0, phi)
        else:
            w = jnp.zeros((B, K3, nw), dt_)
        z = tmap(jnp.clip, _A_x(data, _x_of(op, w), pop), l, u)
        y = tmap(jnp.zeros_like, z)
        rho_idx = jnp.argmin(jnp.abs(lad_log
                                     - jnp.log(jnp.asarray(s.rho, dt_))))
    else:
        w, z, y, rho_idx = init
        z = tmap(jnp.clip, z, l, u)
    rho_idx = jnp.clip(rho_idx, idx_lo, idx_hi)

    kinv_apply = make_kinv_apply(op, B, K3, M, phi)

    def K_fresh(v, rho_s):
        # matrix-free apply of the CURRENT problem's KKT operator
        # K(rho) v = sigma v + c_s N^T Q N v + rho N^T (A^T A) N v —
        # the same system the prepared inventory factorizes (see
        # prepare_ns K0/K1), but built from the FRESH normals/data
        x_v = jnp.einsum("da,bka->bkd", op.N, v)
        qx = op.c_s * _apply_Qseg(data.Qseg, x_v)
        aax = _AT_x(data, _A_x(data, x_v, pop), pop)
        return sigma * v + jnp.einsum("da,bkd->bka", op.N,
                                      qx + rho_s * aax)

    def admm_step(carry, _):
        w, z, y, rho_idx = carry
        rho_s = op.ladder[rho_idx]
        rhs_x = tmap(lambda zz, yy: rho_s * zz - yy, z, y)
        rhs_w = sigma * w - op.g + jnp.einsum(
            "da,bkd->bka", op.N, _AT_x(data, rhs_x, pop))
        w_t = kinv_apply(rho_idx, rhs_w)
        if s.kkt_refine:
            # PCG on K_fresh w = rhs_w, preconditioner = the prepared
            # rung inventory, initial guess = the plain inventory solve
            # above.  tiny guards: at exact convergence (fresh op) the
            # residual is ~0 and the unguarded steps are 0/0
            tiny = jnp.asarray(1e-30, dt_)
            r_c = rhs_w - K_fresh(w_t, rho_s)
            z_c = kinv_apply(rho_idx, r_c)
            p_c = z_c
            rz = jnp.vdot(r_c, z_c)
            for _ in range(s.kkt_refine):
                Kp = K_fresh(p_c, rho_s)
                a_c = rz / jnp.maximum(jnp.vdot(p_c, Kp), tiny)
                w_t = w_t + a_c * p_c
                r_c = r_c - a_c * Kp
                z_c = kinv_apply(rho_idx, r_c)
                rz_new = jnp.vdot(r_c, z_c)
                p_c = z_c + (rz_new / jnp.maximum(rz, tiny)) * p_c
                rz = rz_new
        x_t = _x_of(op, w_t)
        ax_t = _A_x(data, x_t, pop)
        w_new = alpha * w_t + (1 - alpha) * w
        v = tmap(lambda a_, zz, yy: alpha * a_ + (1 - alpha) * zz
                 + yy / rho_s, ax_t, z, y)
        z_new = tmap(jnp.clip, v, l, u)
        y_new = tmap(lambda vv, zz: rho_s * (vv - zz), v, z_new)
        return (w_new, z_new, y_new, rho_idx), None

    def residuals(w, z, y):
        x = _x_of(op, w)
        ax = _A_x(data, x, pop)
        # duals y live in the cost-normalized problem (c_s Qx + A^T y = 0);
        # termination must be judged in ORIGINAL units or eps_dual is
        # effectively loosened by 1/c_s: raw duals are y / c_s, so the raw
        # stationarity gradient is (c_s Qx + A^T y) / c_s
        px = _apply_Qseg(data.Qseg, x)
        aty = _AT_x(data, y, pop) / op.c_s
        grad_w = jnp.einsum("da,bkd->bka", op.N, px + aty)
        def tmax(t):
            vals = [jnp.max(jnp.abs(v)) for v in t if v.size > 0]
            return jnp.max(jnp.array(vals)) if vals else jnp.asarray(0., dt_)
        r_prim = tmax(tmap(lambda a_, zz: a_ - zz, ax, z))
        r_dual = jnp.max(jnp.abs(grad_w))
        n_prim = jnp.maximum(tmax(ax), tmax(z))
        n_dual = jnp.maximum(
            jnp.max(jnp.abs(jnp.einsum("da,bkd->bka", op.N, px))),
            jnp.max(jnp.abs(jnp.einsum("da,bkd->bka", op.N, aty))))
        return r_prim, r_dual, n_prim, n_dual

    # ---- chunk-level Anderson acceleration (type II) ----
    # G(v) = one check_every chunk on the packed iterate; one chunk =
    # one map evaluation, so AA costs only an m x m least squares.
    aa = int(s.aa_depth)
    zb_sh, zp_sh = z.box.shape, z.pair.shape
    w_sh = w.shape
    import math
    sizes = [math.prod(w_sh), math.prod(zb_sh), math.prod(zp_sh),
             math.prod(zb_sh), math.prod(zp_sh)]
    offs = [0]
    for sz in sizes:
        offs.append(offs[-1] + sz)
    Lv = offs[-1]

    def _pack(w_, z_, y_):
        return jnp.concatenate([
            w_.reshape(-1), z_.box.reshape(-1), z_.pair.reshape(-1),
            y_.box.reshape(-1), y_.pair.reshape(-1)])

    def _unpack(v):
        w_ = v[offs[0]:offs[1]].reshape(w_sh)
        z_ = NSConstr(box=v[offs[1]:offs[2]].reshape(zb_sh),
                      pair=v[offs[2]:offs[3]].reshape(zp_sh))
        y_ = NSConstr(box=v[offs[3]:offs[4]].reshape(zb_sh),
                      pair=v[offs[4]:offs[5]].reshape(zp_sh))
        return w_, z_, y_

    def chunk_map(w_, z_, y_, rho_idx_):
        (w_, z_, y_, _), _ = jax.lax.scan(
            admm_step, (w_, z_, y_, rho_idx_), None,
            length=s.check_every)
        return w_, z_, y_

    def rho_update(rho_idx, done, r_prim, r_dual, n_prim, n_dual,
                   lo=None, hi=None):
        if not s.adaptive_rho:
            return rho_idx
        lo = idx_lo if lo is None else lo
        hi = idx_hi if hi is None else hi
        tiny = jnp.asarray(1e-10, dt_)
        rho_s = op.ladder[rho_idx]
        ratio = jnp.sqrt(
            (r_prim / jnp.maximum(n_prim, tiny))
            / jnp.maximum(r_dual / jnp.maximum(n_dual, tiny), tiny))
        cand = jnp.clip(rho_s * ratio, s.rho_min, s.rho_max)
        change = (cand > s.adapt_threshold * rho_s) | \
                 (cand < rho_s / s.adapt_threshold)
        cand_idx = jnp.clip(
            jnp.argmin(jnp.abs(lad_log - jnp.log(cand))),
            lo, hi)
        return jnp.where(done | ~change, rho_idx, cand_idx)

    def run_phase(state0, lo, hi, max_it):
        """One fenced phase: while_loop of check_every chunks.  lo/hi/
        max_it may be TRACED scalars — the schedule path scans over
        them with ONE compiled body (the round-5 compile-wall cure)."""

        def cond(st):
            return (st[4] < max_it) & ~st[5]

        def body(st):
            w, z, y, rho_idx, it, _ = st
            w, z, y = chunk_map(w, z, y, rho_idx)
            r_prim, r_dual, n_prim, n_dual = residuals(w, z, y)
            done = (r_prim <= eps_abs + eps_rel * n_prim) & \
                   (r_dual <= eps_dual + eps_rel * n_dual)
            rho_idx = rho_update(rho_idx, done, r_prim, r_dual,
                                 n_prim, n_dual, lo, hi)
            return w, z, y, rho_idx, it + s.check_every, done

        return jax.lax.while_loop(cond, body, state0)

    def outer_body(state):
        w, z, y, rho_idx, it, _ = state
        w, z, y = chunk_map(w, z, y, rho_idx)
        r_prim, r_dual, n_prim, n_dual = residuals(w, z, y)
        done = (r_prim <= eps_abs + eps_rel * n_prim) & \
               (r_dual <= eps_dual + eps_rel * n_dual)
        rho_idx = rho_update(rho_idx, done, r_prim, r_dual,
                             n_prim, n_dual)
        return w, z, y, rho_idx, it + s.check_every, done

    def outer_body_aa(state):
        (w, z, y, rho_idx, it, _, Fh, Gh, nh, fprev) = state
        v_in = _pack(w, z, y)
        rho_before = rho_idx
        w, z, y = chunk_map(w, z, y, rho_idx)
        r_prim, r_dual, n_prim, n_dual = residuals(w, z, y)
        done = (r_prim <= eps_abs + eps_rel * n_prim) & \
               (r_dual <= eps_dual + eps_rel * n_dual)
        rho_idx = rho_update(rho_idx, done, r_prim, r_dual,
                             n_prim, n_dual)

        g_vec = _pack(w, z, y)
        f = g_vec - v_in
        fn = jnp.linalg.norm(f)
        # safeguard: a residual that GREW means the last extrapolation
        # misled the map — drop the history; a rung change invalidates
        # it outright (different map)
        reset = (fn > fprev) | (rho_idx != rho_before)
        nh = jnp.where(reset, 0, nh)
        Fh = jnp.roll(Fh, 1, axis=0).at[0].set(f)
        Gh = jnp.roll(Gh, 1, axis=0).at[0].set(g_vec)
        nh = jnp.minimum(nh + 1, aa + 1)

        # AA-II on the newest-first rolling history: minimize
        # ||f - dF theta||, v_next = g - dG theta
        dF = Fh[:aa] - Fh[1:]
        dG = Gh[:aa] - Gh[1:]
        valid = (jnp.arange(aa) < nh - 1).astype(dt_)
        dFm = dF * valid[:, None]
        A = dFm @ dFm.T
        lam = 1e-8 * jnp.trace(A) / aa + jnp.asarray(1e-12, dt_)
        A = A + lam * jnp.eye(aa, dtype=dt_)
        theta = jnp.linalg.solve(A, dFm @ f)
        v_aa = g_vec - theta @ (dG * valid[:, None])
        # only extrapolate when another chunk will run: the returned
        # iterate must always be a plain map output (verified by its
        # own residuals), never an unevaluated extrapolation
        it = it + s.check_every
        use_aa = (~done) & (it < s.max_iter) & (nh >= 2)
        v_next = jnp.where(use_aa, v_aa, g_vec)
        w, z, y = _unpack(v_next)
        return (w, z, y, rho_idx, it, done, Fh, Gh, nh,
                jnp.where(reset, jnp.asarray(jnp.inf, fn.dtype), fn))

    def outer_cond(state):
        it, done = state[4], state[5]
        return (it < s.max_iter) & ~done

    if schedule is not None:
        if aa:
            raise ValueError("schedule mode does not support aa_depth")
        it_k, lo_k, hi_k = (jnp.asarray(a) for a in schedule)

        def phase_step(carry, ph):
            w, z, y, rho_idx, total = carry
            max_it, lo, hi = ph
            st0 = (w, z, y, jnp.clip(rho_idx, lo, hi),
                   jnp.asarray(0), jnp.asarray(False))
            w, z, y, rho_idx, it, _ = run_phase(st0, lo, hi, max_it)
            return (w, z, y, rho_idx, total + it), None

        (w, z, y, rho_idx, it), _ = jax.lax.scan(
            phase_step, (w, z, y, rho_idx, jnp.asarray(0)),
            (it_k, lo_k, hi_k))
    elif aa:
        Fh0 = jnp.zeros((aa + 1, Lv), dt_)
        state = (w, z, y, rho_idx, jnp.asarray(0), jnp.asarray(False),
                 Fh0, Fh0, jnp.asarray(0), jnp.asarray(jnp.inf, dt_))
        out = jax.lax.while_loop(outer_cond, outer_body_aa, state)
        w, z, y, rho_idx, it = out[0], out[1], out[2], out[3], out[4]
    else:
        state = (w, z, y, rho_idx, jnp.asarray(0), jnp.asarray(False))
        w, z, y, rho_idx, it, _ = jax.lax.while_loop(
            outer_cond, outer_body, state)

    r_prim, r_dual, _, _ = residuals(w, z, y)
    x = _x_of(op, w)
    obj = 0.5 * jnp.vdot(x, _apply_Qseg(data.Qseg, x))
    info = SolveInfo(iters=it, r_prim=r_prim, r_dual=r_dual, obj=obj)
    if return_state:
        return x, info, (w, z, y, rho_idx)
    return x, info


def solve_single_ns(data: QPData, s: NSSettings):
    with jax.default_matmul_precision("highest"):
        op = prepare_ns(data, s)
        return _iterate_ns(data, op, s)


def schedule_arrays(phases: tuple[NSSettings, ...]):
    """(s_base, max_iters [K], idx_lo [K], idx_hi [K]) for a phase
    tuple whose members differ ONLY in max_iter / rho_lo / rho_hi —
    the production shape (feasibility -> polish -> restore) — or None
    if the tuple is not schedule-compatible.  The fence indices are
    computed on host from the STATIC ladder definition (rho_min /
    rho_max / n_rungs are settings floats), so the arrays can be jit
    ARGUMENTS: schedules sharing s_base (cold / warm-polish /
    escalation) then share one compiled executable."""
    import dataclasses

    import numpy as onp

    s0 = phases[0]
    if s0.aa_depth:
        return None
    neutral = lambda p: dataclasses.replace(  # noqa: E731
        p, max_iter=0, rho_lo=None, rho_hi=None)
    if any(neutral(p) != neutral(s0) for p in phases[1:]):
        return None
    if s0.adaptive_rho:
        ladder = onp.logspace(onp.log10(s0.rho_min),
                              onp.log10(s0.rho_max), s0.n_rungs)
    else:
        ladder = onp.asarray([s0.rho])
    llog = onp.log(ladder)

    def fence(r, default):
        if r is None:
            return default
        return int(onp.argmin(onp.abs(llog - onp.log(r))))

    it_k = onp.asarray([p.max_iter for p in phases], onp.int32)
    lo_k = onp.asarray([fence(p.rho_lo, 0) for p in phases], onp.int32)
    hi_k = onp.asarray([fence(p.rho_hi, len(ladder) - 1)
                        for p in phases], onp.int32)
    # NORMALIZED base (budget/fence fields zeroed): schedules that
    # differ only in budgets/fences — cold vs warm-polish vs
    # escalation — hash to the SAME static jit argument and share one
    # compiled executable
    return neutral(s0), it_k, lo_k, hi_k


def solve_ns_schedule(data: QPData, op: NSOp, s_base: NSSettings,
                      it_k, lo_k, hi_k, init=None,
                      return_state: bool = False):
    """Phased solve with the per-phase budgets/fences as (possibly
    traced) ARRAYS — one compiled while-body for the whole schedule;
    see _iterate_ns(schedule=...).  SolveInfo.iters is the total
    across phases."""
    with jax.default_matmul_precision("highest"):
        return _iterate_ns(data, op, s_base, init=init,
                           return_state=return_state,
                           schedule=(it_k, lo_k, hi_k))


def solve_ns_phases(data: QPData, phases: tuple[NSSettings, ...],
                    return_state: bool = False, op: NSOp | None = None,
                    init=None):
    """Phased rho schedule sharing ONE prepared op (the KKT rung
    inventory comes from phases[0]; later phases fence the adaptive walk
    via rho_lo/rho_hi and carry the full ADMM state across phases).

    init: optional (w, z, y, rho_idx) ADMM state from a previous
    solve_ns_phases(..., return_state=True) — the STATE-WARM replan
    path: a corridor refresh keeps every shape ([P] pairs, M knots)
    and only rotates pair normals / bounds, so the previous cycle's
    primal AND duals remain a near-feasible starting point (z is
    re-clipped to the fresh bounds inside _iterate_ns).  Measured at
    256 agents (tools/replan256_chain.py): dual restarts were the
    reason short warm replans sat 2-4x above the rotating best-response
    oracle.

    The production joint-solve recipe (measured on the 64-agent forest):
      1. feasibility-first  (rho_lo fences out the low rungs)
      2. objective polish   (unfenced — the deep rungs do the work)
      3. feasibility restore (fenced high again; starts near-optimal so
         the boxes pull in with little objective damage)

    op: optionally a precomputed NSOp (e.g. prepare_ns_np's host-f64
    inverses — the production joint path) instead of preparing on device.
    """
    with jax.default_matmul_precision("highest"):
        if op is None:
            op = prepare_ns(data, phases[0])
        sched = schedule_arrays(phases) if len(phases) > 1 else None
        if sched is not None:
            # ONE traced while-body for the whole schedule (round-5
            # compile-wall path; budgets/fences become scan operands)
            s0, it_k, lo_k, hi_k = sched
            x, info, state = _iterate_ns(data, op, s0, init=init,
                                         return_state=True,
                                         schedule=(it_k, lo_k, hi_k))
            if return_state:
                return x, info, state
            return x, info
        state = init
        x = info = None
        iters_total = 0
        for s in phases:
            x, info, state = _iterate_ns(data, op, s, init=state,
                                         return_state=True)
            iters_total = iters_total + info.iters
        # report TOTAL iterations across the phase schedule (each
        # phase's SolveInfo.iters alone undercounts the cycle ~9x at
        # production budgets — round-3 bench utilization bug)
        info = info._replace(iters=iters_total)
    if return_state:
        return x, info, state
    return x, info


@partial(jax.jit, static_argnames=("settings",))
def solve_ns(data: QPData, settings: NSSettings = NSSettings()):
    """Solve one batch QP in knot-state coordinates.  Returns (x, info)
    with x [B, 3, D]; continuity/endpoint equalities hold to machine
    precision by construction."""
    x, info = solve_single_ns(data, settings)
    return x


@partial(jax.jit, static_argnames=("settings", "prep_chunk"))
def solve_ns_batched(data: QPData, settings: NSSettings = NSSettings(),
                     prep_chunk: int = 4):
    """Solve a stack of batch QPs (leading axis on every leaf)."""
    with jax.default_matmul_precision("highest"):
        ops = jax.lax.map(lambda d: prepare_ns(d, settings), data,
                          batch_size=prep_chunk)
        return jax.vmap(
            lambda d, o: _iterate_ns(d, o, settings))(data, ops)
