"""Cross-device decomposition of ONE joint knot-state ADMM solve.

This module partitions the ONE banded KKT solve across a device mesh
axis, so the pivot inventory (the memory wall: ~232 MB at 64 agents,
~7.5 GB at 256 in the 5-rung recipe) and the O(N^2 M) pair-constraint
work (the FLOPs wall at 256 agents) are both sharded, with XLA
collectives carrying the coupling — the device-mesh generalization of
the reference's sequential-batch dummy exchange
(rbp_planner.hpp:140-204) to the JOINT all-pair QP.  The mesh is a
flat 1-D axis: it follows the algorithm alone, with no assumption
about the interconnect's topology.

Three decompositions of the Thomas sweeps (per mesh axis of n devices;
``mode="spike"`` is described with its prep at the end of the file):

``mode="chunk"`` (default) — the KNOT axis is sharded into n
contiguous chunks (``op.Dinvs [R, Mi_p, bs, bs]`` split on dim 1,
zero-block padded to a multiple of n).  The sweeps flow
device-to-device: each device runs its local chunk with the same XLA
scan as the single-device path, then hands one [bs] boundary row to
its neighbor via ``ppermute``.  Collectives per KKT apply: n fwd + n
bwd ppermutes of [bs] floats + ONE tiled all_gather of the [Mi_p/n,
bs] solution chunks — CONSTANT in M (the block-row mode pays
2(Mi-1) per-knot gathers).  The chain itself stays sequential (that
is the algorithm's critical path; cyclic reduction was measured-
rejected, see ARCHITECTURE.md), so wall-clock tracks the single-device
chain speed while per-device pivot memory drops by n and the pair-axis
work divides.  Works for ANY bs (no divisibility constraint).

``mode="blockrow"`` — each device holds bs/n ROWS of every pivot
inverse; every knot's matvec is reassembled with a tiled all_gather.
2(Mi-1)+2 collectives per iteration of bs/n floats: with
microsecond-latency links this divides the dominant pivot stream n
ways and can beat the chunk mode at large bs; on the virtual CPU mesh
the per-knot rendezvous dominates (measured inverting 2x at n=8,
benchmarks/shard_scale_cpu.json) — which is why it is no longer the
default.  Requires bs % n == 0 and supports the plain XLA scan only.

Both modes shard the pair leaves (``pair_n/pair_rhs/...`` and the pair
halves of the ADMM z/y state) along P (dim 0, padded to a multiple of
n with inactive rows): A^T y needs one ``psum`` per apply; A x is
row-local.  Everything else (w, z.box, y.box, x_pin, N, g, Qseg,
bounds) is replicated — the [B, 3, D] state is sub-MB even at 256
agents.

Numerics: identical algorithm to nullspace._iterate_ns (same rung
ladder, same phased schedule); sums are re-associated by psum /
all_gather so results match the single-device path to f32 reduction
tolerance, not bitwise.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .admm import SolveInfo, _pair_op
from .assemble import BIG, QPData
from .nullspace import (NSConstr, NSOp, NSSettings, _apply_Qseg, _bounds,
                        _w_from_x, _x_of)


def pad_pairs(data: QPData, mult: int) -> QPData:
    """Pad the pair axis to a multiple of ``mult`` with INACTIVE rows
    (mask 0, zero normals, -BIG rhs -> bounds clamp to (-BIG, BIG), the
    constraint never binds and its dual stays 0).  Host-side numpy; a
    tree whose pair axis is already a multiple (e.g. placed via
    ``place``) returns unchanged without touching the leaves."""
    Pq = data.pair_n.shape[0]
    Pp = ((Pq + mult - 1) // mult) * mult
    if Pp == Pq:
        return data
    pad = Pp - Pq

    def padi(a, val):
        a = np.asarray(a)
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], val, a.dtype)], axis=0)

    return dataclasses.replace(
        data,
        pair_bi=padi(data.pair_bi, -1), pair_bj=padi(data.pair_bj, -1),
        pair_n=padi(data.pair_n, 0.0),
        pair_rhs=padi(data.pair_rhs, -BIG),
        pair_mask=padi(data.pair_mask, 0.0),
        pair_qi=padi(data.pair_qi, -1), pair_qj=padi(data.pair_qj, -1),
        pair_rsum=padi(data.pair_rsum, 0.0))


def pad_knots(op: NSOp, mult: int) -> NSOp:
    """Zero-block pad the pivot inventory's KNOT axis to a multiple of
    ``mult`` (chunk mode).  Zero pivot blocks + zero rhs rows propagate
    exact zeros through both sweeps, so the padded chain solves the
    original system with x = 0 on the pad knots — this also makes the
    last-pivot step uniform (the real last knot's backward correction
    multiplies the pad's x = 0).  Host numpy or jax arrays; idempotent
    when the knot axis already divides."""
    Mi = op.Dinvs.shape[1]
    Mp = ((Mi + mult - 1) // mult) * mult
    if Mp == Mi:
        return op
    if isinstance(op.Dinvs, jax.Array):
        R, _, b1, b2 = op.Dinvs.shape
        d = jnp.zeros((R, Mp, b1, b2), op.Dinvs.dtype)
        d = d.at[:, :Mi].set(op.Dinvs)
    else:
        d = np.zeros((op.Dinvs.shape[0], Mp) + op.Dinvs.shape[2:],
                     op.Dinvs.dtype)
        d[:, :Mi] = op.Dinvs
    return op._replace(Dinvs=d)


def _specs(data: QPData, op: NSOp, axis: str, mode: str = "chunk"):
    """(data_specs, op_specs) PartitionSpec pytrees: pair leaves over
    ``axis`` (dim 0), pivot inventory over its knot axis (chunk mode)
    or block-row dim (blockrow mode), the rest replicated."""
    dspec = jax.tree.map(lambda _: P(), data)
    dspec = dataclasses.replace(
        dspec, pair_bi=P(axis), pair_bj=P(axis), pair_n=P(axis),
        pair_rhs=P(axis), pair_mask=P(axis), pair_qi=P(axis),
        pair_qj=P(axis), pair_rsum=P(axis))
    ospec = jax.tree.map(lambda _: P(), op)
    if mode == "spike":
        # SpikeOp: per-chunk interior chains sharded on the chunk dim,
        # separator Schur chain replicated (tiny)
        ospec = ospec._replace(Dloc=P(None, axis))
    elif mode == "chunk":
        ospec = ospec._replace(Dinvs=P(None, axis))
    else:
        ospec = ospec._replace(Dinvs=P(None, None, axis))
    return dspec, ospec


def _iterate_ns_sharded(data: QPData, op: NSOp, s: NSSettings, axis: str,
                        n: int = 1, mode: str = "blockrow", init=None):
    """shard_map body: one phase of the knot-state ADMM with LOCAL pair
    shards and sharded pivots (knot-chunk pipeline, block-row or
    SPIKE).  Mirrors nullspace._iterate_ns incl. kkt_refine PCG
    (fresh-K applies ride the sharded A/A^T); no AA — asserted by the
    entry."""
    sop = None
    if mode == "spike":
        sop = op
        op = sop.base
    B, K3, D = data.lb.shape
    dt_ = data.lb.dtype
    M = op.F0.shape[0]
    phi = op.F0.shape[1]
    nw = op.N.shape[1]
    Mi = M - 1
    B3 = B * K3
    bs = B3 * phi

    pop = _pair_op(data)          # local: S [Pl, B], n_d [Pl, 3, D]
    l, u = _bounds(data, s.tighten)
    tmap = jax.tree.map

    sigma = jnp.asarray(s.sigma, dt_)
    alpha = jnp.asarray(s.alpha, dt_)
    eps_abs = jnp.asarray(s.eps_abs, dt_)
    eps_dual = jnp.asarray(
        s.eps_abs if s.eps_dual_abs is None else s.eps_dual_abs, dt_)
    eps_rel = jnp.asarray(s.eps_rel, dt_)

    lad_log = jnp.log(op.ladder)
    idx_lo = (jnp.argmin(jnp.abs(lad_log - jnp.log(s.rho_lo)))
              if s.rho_lo is not None else 0)
    idx_hi = (jnp.argmin(jnp.abs(lad_log - jnp.log(s.rho_hi)))
              if s.rho_hi is not None else op.ladder.shape[0] - 1)

    def A_x(x):
        # pair rows are shard-local; box is the replicated identity
        xs = jnp.einsum("pb,bkd->pkd", pop.S, x)
        return NSConstr(box=x, pair=jnp.einsum("pkd,pkd->pd", pop.n_d, xs))

    def AT_x(y):
        # ONE psum gathers the pair-shard contributions; the box term is
        # replicated and must be added exactly once (outside the psum)
        contrib = pop.n_d * y.pair[:, None, :]
        part = jnp.einsum("pb,pkd->bkd", pop.S, contrib)
        return y.box + jax.lax.psum(part, axis)

    def koT(Ho_k, v):
        return jnp.einsum("ai,xa->xi", Ho_k,
                          v.reshape(B3, phi)).reshape(v.shape)

    def ko(Ho_k, v):
        return jnp.einsum("ab,xb->xa", Ho_k,
                          v.reshape(B3, phi)).reshape(v.shape)

    def kinv_apply_blockrow(rho_idx, rhs):
        # block-tridiagonal Thomas over knots with block-ROW-sharded
        # pivots: each device computes its bs/n rows of Dinv @ v, one
        # tiled all_gather per knot reassembles the full block vector
        Dinv = op.Dinvs[rho_idx]               # [Mi, bs/n, bs] local
        Ho = op.Kos                            # [Mi-1, phi, phi] repl.
        b = rhs.reshape(B, K3, Mi, phi).transpose(2, 0, 1, 3)
        b = b.reshape(Mi, bs)

        def gather(v_loc):
            return jax.lax.all_gather(v_loc, axis, tiled=True)

        def fwd(y_prev, inp):
            b_k, Ho_prev, Dinv_prev = inp
            t = gather(Dinv_prev @ y_prev)
            y_k = b_k - koT(Ho_prev, t)
            return y_k, y_k

        _, ys = jax.lax.scan(fwd, b[0], (b[1:], Ho, Dinv[:-1]), unroll=4)
        y = jnp.concatenate([b[:1], ys], axis=0)
        x_last = gather(Dinv[-1] @ y[-1])

        def bwd(x_next, inp):
            y_k, Ho_k, Dinv_k = inp
            x_k = gather(Dinv_k @ (y_k - ko(Ho_k, x_next)))
            return x_k, x_k

        _, xs = jax.lax.scan(bwd, x_last, (y[:-1], Ho, Dinv[:-1]),
                             reverse=True, unroll=4)
        x = jnp.concatenate([xs, x_last[None]], axis=0)
        x = x.reshape(Mi, B, K3, phi).transpose(1, 2, 0, 3)
        return x.reshape(rhs.shape)

    def kinv_apply_chunk(rho_idx, rhs):
        # knot-chunk pipeline: each device solves its contiguous chunk
        # of the chain and hands one [bs] boundary row to its neighbor —
        # n fwd + n bwd ppermutes + ONE all_gather per apply, constant
        # in M (see module docstring)
        Dloc = op.Dinvs[rho_idx]               # [L, bs, bs] local
        L = Dloc.shape[0]
        Mp = L * n

        idx = jax.lax.axis_index(axis)
        # per-knot incoming/outgoing couplings, zero at the global ends
        # and on pad knots (op.Kos is [Mi-1, phi, phi], replicated/tiny)
        zpad = jnp.zeros((Mp - Mi + 1,) + op.Kos.shape[1:], op.Kos.dtype)
        kin = jnp.concatenate([zpad[:1], op.Kos, zpad[1:]], axis=0)
        kout = jnp.concatenate([op.Kos, zpad], axis=0)
        kin_l = jax.lax.dynamic_slice_in_dim(kin, idx * L, L)
        kout_l = jax.lax.dynamic_slice_in_dim(kout, idx * L, L)

        b = rhs.reshape(B, K3, Mi, phi).transpose(2, 0, 1, 3)
        b = b.reshape(Mi, bs)
        b_full = jnp.zeros((Mp, bs), dt_).at[:Mi].set(b)
        b_loc = jax.lax.dynamic_slice_in_dim(b_full, idx * L, L)

        def chunk_fwd(t_in):
            # y-form scan (single-device make_kinv_apply math): step
            # k uses Dinv_{k-1}; the chunk's first step consumes the
            # carried t = Dinv y of the neighbor's last knot
            y0 = b_loc[0] - koT(kin_l[0], t_in)

            def f(y_prev, inp):
                b_k, kin_k, Dinv_prev = inp
                y_k = b_k - koT(kin_k, Dinv_prev @ y_prev)
                return y_k, y_k

            _, ys = jax.lax.scan(
                f, y0, (b_loc[1:], kin_l[1:], Dloc[:-1]), unroll=4)
            ys = jnp.concatenate([y0[None], ys], axis=0)
            t_out = Dloc[-1] @ ys[-1]
            return t_out, ys

        def chunk_bwd(x_in, ys):
            def f(x_next, inp):
                y_k, kout_k, Dinv_k = inp
                x_k = Dinv_k @ (y_k - ko(kout_k, x_next))
                return x_k, x_k

            _, xs = jax.lax.scan(f, x_in, (ys, kout_l, Dloc),
                                 reverse=True, unroll=4)
            return xs[0], xs

        fwd_perm = [(d, (d + 1) % n) for d in range(n)]
        bwd_perm = [(d, (d - 1) % n) for d in range(n)]
        zrow = jnp.zeros(bs, dt_)
        zrows = jnp.zeros((L, bs), dt_)

        def fwd_step(step, carry):
            t_carry, rows = carry
            t_new, rows_new = jax.lax.cond(
                step == idx, chunk_fwd, lambda t: (t, rows), t_carry)
            rows = jnp.where(step == idx, rows_new, rows)
            t_carry = jax.lax.ppermute(t_new, axis, fwd_perm)
            return t_carry, rows

        _, rows_loc = jax.lax.fori_loop(0, n, fwd_step, (zrow, zrows))

        def bwd_step(j, carry):
            step = n - 1 - j
            x_carry, xs_acc = carry
            x_new, xs_new = jax.lax.cond(
                step == idx, lambda x: chunk_bwd(x, rows_loc),
                lambda x: (x, xs_acc), x_carry)
            xs_acc = jnp.where(step == idx, xs_new, xs_acc)
            x_carry = jax.lax.ppermute(x_new, axis, bwd_perm)
            return x_carry, xs_acc

        _, xs_loc = jax.lax.fori_loop(0, n, bwd_step, (zrow, zrows))

        x = jax.lax.all_gather(xs_loc, axis, tiled=True)  # [Mp, bs]
        x = x[:Mi].reshape(Mi, B, K3, phi).transpose(1, 2, 0, 3)
        return x.reshape(rhs.shape)

    def kinv_apply_spike(rho_idx, rhs):
        # SPIKE substructuring (module footer): two PARALLEL local
        # chunk solves + a replicated (n-1)-step separator Schur chain;
        # collectives per apply: 1 tip all_gather + 1 solution
        # all_gather — and NO cross-device serialization
        Lq = sop.Dloc.shape[2]
        Dl = sop.Dloc[rho_idx][0]            # local [Lq, bs, bs]
        Ss = sop.Ssch[rho_idx]               # [n-1, bs, bs] replicated
        So = sop.Soff[rho_idx]               # [n-2|1, bs, bs]
        Ho0 = op.Kos[0]
        idx = jax.lax.axis_index(axis)
        Mp = n * Lq + (n - 1)

        b = rhs.reshape(B, K3, Mi, phi).transpose(2, 0, 1, 3)
        b = b.reshape(Mi, bs)
        b_full = jnp.zeros((Mp, bs), dt_).at[:Mi].set(b)
        b_loc = jax.lax.dynamic_slice_in_dim(b_full, idx * (Lq + 1), Lq)
        sep_rows = (jnp.arange(n - 1) * (Lq + 1)) + Lq
        b_sep = b_full[sep_rows]             # [n-1, bs] replicated

        def local_solve(b_l):
            def f(y_prev, inp):
                b_k, Dprev = inp
                return (lambda y: (y, y))(
                    b_k - koT(Ho0, Dprev @ y_prev))

            _, ys = jax.lax.scan(f, b_l[0], (b_l[1:], Dl[:-1]),
                                 unroll=2)
            ys = jnp.concatenate([b_l[:1], ys], axis=0)
            x_last = Dl[-1] @ ys[-1]

            def gstep(x_next, inp):
                y_k, Dk = inp
                x_k = Dk @ (y_k - ko(Ho0, x_next))
                return x_k, x_k

            _, xs = jax.lax.scan(gstep, x_last, (ys[:-1], Dl[:-1]),
                                 reverse=True, unroll=2)
            return jnp.concatenate([xs, x_last[None]], axis=0)

        u = local_solve(b_loc)               # [Lq, bs]
        tips = jnp.stack([u[0], u[-1]])      # [2, bs]
        tips_all = jax.lax.all_gather(tips, axis)   # [n, 2, bs]
        uF, uL = tips_all[:, 0], tips_all[:, 1]     # [n, bs]

        # separator rhs: r_j = b_sep_j - Lo uL_j - Up uF_{j+1}
        r_sep = (b_sep
                 - jax.vmap(lambda v: koT(Ho0, v))(uL[:n - 1])
                 - jax.vmap(lambda v: ko(Ho0, v))(uF[1:]))

        def sfwd(y_prev, inp):
            r_j, So_prev, Ss_prev = inp
            y_j = r_j - So_prev.T @ (Ss_prev @ y_prev)
            return y_j, y_j

        if n > 2:
            _, ys_s = jax.lax.scan(sfwd, r_sep[0],
                                   (r_sep[1:], So[:n - 2], Ss[:n - 2]))
            y_s = jnp.concatenate([r_sep[:1], ys_s], axis=0)
        else:
            y_s = r_sep
        x_last_s = Ss[-1] @ y_s[-1]

        def sbwd(x_next, inp):
            y_j, So_j, Ss_j = inp
            x_j = Ss_j @ (y_j - So_j @ x_next)
            return x_j, x_j

        if n > 2:
            _, xs_s = jax.lax.scan(sbwd, x_last_s,
                                   (y_s[:-1], So[:n - 2], Ss[:n - 2]),
                                   reverse=True)
            x_sep = jnp.concatenate([xs_s, x_last_s[None]], axis=0)
        else:
            x_sep = x_last_s[None]           # [n-1, bs]

        # correction solve: boundary rhs from the separator values
        zrow_ = jnp.zeros(bs, dt_)
        xs_left = jnp.where(idx > 0,
                            x_sep[jnp.clip(idx - 1, 0, n - 2)], zrow_)
        xs_right = jnp.where(idx < n - 1,
                             x_sep[jnp.clip(idx, 0, n - 2)], zrow_)
        corr = jnp.zeros((Lq, bs), dt_)
        corr = corr.at[0].add(koT(Ho0, xs_left))
        corr = corr.at[Lq - 1].add(ko(Ho0, xs_right))
        x_loc = u - local_solve(corr)

        x_chunks = jax.lax.all_gather(x_loc, axis)   # [n, Lq, bs]
        x_full = jnp.zeros((Mp, bs), dt_)
        rows = (jnp.arange(n)[:, None] * (Lq + 1)
                + jnp.arange(Lq)[None, :]).reshape(-1)
        x_full = x_full.at[rows].set(x_chunks.reshape(n * Lq, bs))
        x_full = x_full.at[sep_rows].set(x_sep)
        x = x_full[:Mi].reshape(Mi, B, K3, phi).transpose(1, 2, 0, 3)
        return x.reshape(rhs.shape)

    kinv_apply = (kinv_apply_chunk if mode == "chunk"
                  else kinv_apply_spike if mode == "spike"
                  else kinv_apply_blockrow)

    if init is None:
        if s.warm_start == "x0":
            w = _w_from_x(op, data.x0, phi)
        else:
            w = jnp.zeros((B, K3, nw), dt_)
        z = tmap(jnp.clip, A_x(_x_of(op, w)), l, u)
        y = tmap(jnp.zeros_like, z)
        rho_idx = jnp.argmin(jnp.abs(lad_log
                                     - jnp.log(jnp.asarray(s.rho, dt_))))
    else:
        w, z, y, rho_idx = init
        z = tmap(jnp.clip, z, l, u)
    rho_idx = jnp.clip(rho_idx, idx_lo, idx_hi)

    def K_fresh(v, rho_s):
        # matrix-free fresh-operator apply (mirrors nullspace._iterate_ns
        # K_fresh); the pair coupling inside A^T A rides the sharded
        # AT_x's psum
        x_v = jnp.einsum("da,bka->bkd", op.N, v)
        qx = op.c_s * _apply_Qseg(data.Qseg, x_v)
        aax = AT_x(A_x(x_v))
        return sigma * v + jnp.einsum("da,bkd->bka", op.N,
                                      qx + rho_s * aax)

    def admm_step(carry, _):
        w, z, y, rho_idx = carry
        rho_s = op.ladder[rho_idx]
        rhs_x = tmap(lambda zz, yy: rho_s * zz - yy, z, y)
        rhs_w = sigma * w - op.g + jnp.einsum(
            "da,bkd->bka", op.N, AT_x(rhs_x))
        w_t = kinv_apply(rho_idx, rhs_w)
        if s.kkt_refine:
            # PCG against the fresh operator, preconditioned by the
            # prepared inventory (nullspace._iterate_ns semantics); the
            # r/z/p iterates are replicated, so the vdots need no
            # collectives
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
                b_c = rz_new / jnp.maximum(rz, tiny)
                p_c = z_c + b_c * p_c
                rz = rz_new
        x_t = _x_of(op, w_t)
        ax_t = A_x(x_t)
        w_new = alpha * w_t + (1 - alpha) * w
        v = tmap(lambda a_, zz, yy: alpha * a_ + (1 - alpha) * zz
                 + yy / rho_s, ax_t, z, y)
        z_new = tmap(jnp.clip, v, l, u)
        y_new = tmap(lambda vv, zz: rho_s * (vv - zz), v, z_new)
        return (w_new, z_new, y_new, rho_idx), None

    def pmax(v):
        return jax.lax.pmax(v, axis)

    def residuals(w, z, y):
        x = _x_of(op, w)
        ax = A_x(x)
        px = _apply_Qseg(data.Qseg, x)
        aty = AT_x(y) / op.c_s
        grad_w = jnp.einsum("da,bkd->bka", op.N, px + aty)

        def nmax(c):
            # box part replicated, pair part shard-local -> pmax
            vb = (jnp.max(jnp.abs(c.box)) if c.box.size else
                  jnp.asarray(0.0, dt_))
            vp = (pmax(jnp.max(jnp.abs(c.pair))) if c.pair.size else
                  jnp.asarray(0.0, dt_))
            return jnp.maximum(vb, vp)

        r_prim = nmax(tmap(lambda a_, zz: a_ - zz, ax, z))
        r_dual = jnp.max(jnp.abs(grad_w))
        n_prim = jnp.maximum(nmax(ax), nmax(z))
        n_dual = jnp.maximum(
            jnp.max(jnp.abs(jnp.einsum("da,bkd->bka", op.N, px))),
            jnp.max(jnp.abs(jnp.einsum("da,bkd->bka", op.N, aty))))
        return r_prim, r_dual, n_prim, n_dual

    def rho_update(rho_idx, done, r_prim, r_dual, n_prim, n_dual):
        if not s.adaptive_rho:
            return rho_idx
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
            idx_lo, idx_hi)
        return jnp.where(done | ~change, rho_idx, cand_idx)

    def outer_body(state):
        w, z, y, rho_idx, it, _ = state
        (w, z, y, _), _ = jax.lax.scan(
            admm_step, (w, z, y, rho_idx), None, length=s.check_every)
        r_prim, r_dual, n_prim, n_dual = residuals(w, z, y)
        done = (r_prim <= eps_abs + eps_rel * n_prim) & \
               (r_dual <= eps_dual + eps_rel * n_dual)
        rho_idx = rho_update(rho_idx, done, r_prim, r_dual,
                             n_prim, n_dual)
        return w, z, y, rho_idx, it + s.check_every, done

    def outer_cond(state):
        it, done = state[4], state[5]
        return (it < s.max_iter) & ~done

    state = (w, z, y, rho_idx, jnp.asarray(0), jnp.asarray(False))
    w, z, y, rho_idx, it, _ = jax.lax.while_loop(
        outer_cond, outer_body, state)

    r_prim, r_dual, _, _ = residuals(w, z, y)
    x = _x_of(op, w)
    obj = 0.5 * jnp.vdot(x, _apply_Qseg(data.Qseg, x))
    info = SolveInfo(iters=it, r_prim=r_prim, r_dual=r_dual, obj=obj)
    return x, info, (w, z, y, rho_idx)


def _check_phases(phases, mode: str):
    for p in phases:
        if p.aa_depth:
            raise ValueError(
                "sharded joint solve does not support aa_depth phases")
        if p.kkt_refine and mode == "spike":
            # kkt_refine composes mathematically (the preconditioner is
            # just the spike apply) but is untested in this mode
            raise ValueError("mode='spike' does not support kkt_refine "
                             "phases yet")
        if p.kkt_mode != "banded":
            raise ValueError("sharded joint solve requires kkt_mode="
                             "'banded' (knot-chunk / block-row sharding)")


#: jitted solvers keyed on (mesh, axis, phases, mode):
#: rebuilding the shard_map closure per call would defeat the jit cache
#: — every solve would re-trace the 3-phase while-loop program
_JIT_CACHE: dict = {}


def _jitted(mesh, axis: str, phases, dspec, ospec, mode: str):
    key = (mesh, axis, phases, mode)
    fn = _JIT_CACHE.get(key)
    if fn is not None:
        return fn

    try:
        from jax import shard_map
    except ImportError:          # older JAX
        from jax.experimental.shard_map import shard_map

    n = mesh.shape[axis]

    def body(d, o):
        with jax.default_matmul_precision("highest"):
            state = None
            x = info = None
            iters_total = 0
            for s in phases:
                x, info, state = _iterate_ns_sharded(
                    d, o, s, axis, n=n, mode=mode, init=state)
                iters_total = iters_total + info.iters
            # TOTAL iterations across phases (mirrors solve_ns_phases)
            info = info._replace(iters=iters_total)
        return x, info

    try:                          # jax >= 0.8: check_vma
        sm = shard_map(body, mesh=mesh, in_specs=(dspec, ospec),
                       out_specs=(P(), P()), check_vma=False)
    except TypeError:             # older jax: check_rep
        sm = shard_map(body, mesh=mesh, in_specs=(dspec, ospec),
                       out_specs=(P(), P()), check_rep=False)
    fn = jax.jit(sm)
    _JIT_CACHE[key] = fn
    return fn


def place(data: QPData, op: NSOp, mesh, axis: str = "kkt",
          mode: str = "chunk"):
    """Pad the pair axis (and, chunk mode, the knot axis) and device_put
    (data, op) onto the mesh ONCE — callers that solve repeatedly
    (replans, timing reps) should place once and pass the placed trees
    to solve_ns_phases_sharded, or the multi-GB pivot inventory
    re-uploads every call."""
    n = mesh.shape[axis]
    data = pad_pairs(data, n)
    if mode == "chunk":
        op = pad_knots(op, n)
    dspec, ospec = _specs(data, op, axis, mode)

    def put(leaf, spec):
        sh = NamedSharding(mesh, spec)
        if isinstance(leaf, jax.Array) and leaf.sharding == sh:
            return leaf
        return jax.device_put(jnp.asarray(leaf), sh)

    return (jax.tree.map(put, data, dspec),
            jax.tree.map(put, op, ospec))


def solve_ns_phases_sharded(data: QPData, phases, op: NSOp, mesh,
                            axis: str = "kkt", mode: str = "chunk"):
    """Run the phased knot-state ADMM with ONE problem partitioned over
    ``mesh[axis]``: pivot inventory knot-chunk-sharded (mode="chunk",
    default), block-row-sharded (mode="blockrow") or SPIKE-partitioned
    (mode="spike", op from prepare_spike_np), pair constraints
    P-sharded, coupling carried by ppermute / psum / all_gather
    collectives.

    data/op: HOST leaves (numpy) as produced by assemble + prepare_ns_np
    (flat banded layout), or trees already placed via ``place`` (these
    skip padding/transfer).  Returns (x [B, 3, D], SolveInfo),
    replicated.  The jitted program is cached per (mesh, axis, phases,
    mode).
    """
    _check_phases(phases, mode)
    if mode not in ("chunk", "blockrow", "spike"):
        raise ValueError(f"unknown shard mode {mode!r}")
    n = mesh.shape[axis]
    if mode == "spike":
        if not isinstance(op, SpikeOp):
            raise ValueError("mode='spike' needs an operator prepared "
                             "with prepare_spike_np(data, s, n)")
        if int(op.Dloc.shape[1]) != n:
            raise ValueError(
                f"SPIKE operator was prepared for "
                f"{int(op.Dloc.shape[1])} chunks, mesh axis has {n}")
        d_dev, o_dev = place(data, op, mesh, axis, mode)
        dspec, ospec = _specs(d_dev, o_dev, axis, mode)
        return _jitted(mesh, axis, tuple(phases), dspec,
                       ospec, mode)(d_dev, o_dev)
    bs = int(op.Dinvs.shape[-1])
    if mode == "blockrow" and bs % n != 0:
        raise ValueError(f"pivot block size {bs} must divide over "
                         f"{n} devices (pad agents, change the mesh, or "
                         "use mode='chunk')")
    d_dev, o_dev = place(data, op, mesh, axis, mode)
    dspec, ospec = _specs(d_dev, o_dev, axis, mode)
    return _jitted(mesh, axis, tuple(phases), dspec, ospec, mode)(
        d_dev, o_dev)


# ======================================================================
# SPIKE-style substructuring: a PARALLEL decomposition of the
# banded Thomas solve — vs the chunk pipeline's sequential
# device-to-device chain.
#
# The knot axis is split into n interior chunks SEPARATED by single
# separator knots.  Each device owns one chunk and factors/solves it
# INDEPENDENTLY (no incoming carry — the chunk pipeline's
# critical path is gone); the n-1 separator unknowns satisfy a small
# block-tridiagonal Schur system whose per-rung factorization is
# precomputed at prep, exactly like the main pivot inventory.  Per
# apply:
#
#   1. local interior solve      (parallel; streams Dloc_c once fwd+bwd)
#   2. one all_gather of 2 [bs] tip rows per device
#   3. replicated separator Schur chain (n-1 tiny sequential steps)
#   4. local CORRECTION solve against the separator values (parallel)
#   5. one tiled all_gather of the solution chunks
#
# Cost model vs the chunk pipeline: ~2x the block-apply FLOPs/stream
# (two local solves instead of one) for n-way parallelism of the chain
# — the classic SPIKE trade (Polizzi & Sameh).  The single-device
# cyclic-reduction rejection (ARCHITECTURE.md) does NOT apply here:
# across devices the aggregate memory bandwidth is n x.
# ======================================================================


class SpikeOp(NamedTuple):
    # every field is a pytree leaf (shard_map specs / device_put): the
    # chunk length Lq and chunk count n are DERIVED (Dloc.shape)
    base: NSOp            # shared leaves (N, x_pin, g, ..., Kos); Dinvs None
    Dloc: object          # [R, n, Lq, bs, bs] per-chunk interior chains
    Ssch: object          # [R, n-1, bs, bs] separator Schur pivots
    Soff: object          # [R, max(n-2, 1), bs, bs] S_{j, j+1} blocks


def prepare_spike_np(data: QPData, s: NSSettings, n: int) -> SpikeOp:
    """Host-f64 SPIKE prep: per-chunk interior Schur chains + the
    separator Schur system's own chain, per rung.  Requires uniform
    segment durations (constant off-diagonal Ho).  Total pivot memory
    equals the plain inventory (the chunks repartition it); the
    separator chain adds (n-1)/Mi more."""
    import numpy as onp
    from concurrent.futures import ThreadPoolExecutor

    from .nullspace import (_banded_kd_builder_np, _blas_single_threaded,
                            _host_prep_ctx_np, _inv_spd_np)

    ctx = _host_prep_ctx_np(data, s)
    Qseg, phi, B3, dt_ = (ctx["Qseg"], ctx["phi"], ctx["B3"],
                          ctx["dt_"])
    Mi, ladder, C, c_s = ctx["Mi"], ctx["ladder"], ctx["C"], ctx["c_s"]
    make_Kd, Ho, bs = _banded_kd_builder_np(Qseg, ctx["L"], ctx["R"],
                                            C, c_s, s.sigma)
    if Mi > 1 and not onp.allclose(Ho, Ho[:1], atol=1e-12):
        raise ValueError("SPIKE substructuring requires uniform segment "
                         "durations (constant off-diagonal Ho)")
    if Mi < 2 * n:
        raise ValueError(f"SPIKE needs Mi >= 2n (Mi={Mi}, n={n})")
    Up = onp.kron(onp.eye(B3), Ho[0])          # [bs, bs]; Lo = Up.T
    Lq = -(-(Mi - (n - 1)) // n)
    Mp = n * Lq + (n - 1)

    def gpos(c, i):
        return c * (Lq + 1) + i

    def sep_pos(j):
        return j * (Lq + 1) + Lq

    R_ = len(ladder)
    Dloc = onp.zeros((R_, n, Lq, bs, bs), dtype=dt_)
    Ssch = onp.zeros((R_, n - 1, bs, bs), dtype=dt_)
    Soff = onp.zeros((R_, max(n - 2, 1), bs, bs), dtype=dt_)

    def fill_rung(r):
        rho = ladder[r]
        corners = []                 # per chunk: (VF, WF, WL)
        for c in range(n):
            # interior chain (restarted Schur recursion; pad knots stay 0)
            Dc = [None] * Lq
            prev = None
            for i in range(Lq):
                g = gpos(c, i)
                if g >= Mi:
                    break
                Kd = make_Kd(g, rho)
                if prev is not None:
                    Kd = Kd - Up.T @ prev @ Up
                prev = _inv_spd_np(Kd)
                Dc[i] = prev
                Dloc[r, c, i] = prev
            Lr = sum(d is not None for d in Dc)    # real knots in chunk
            if Lr == 0:
                corners.append((onp.zeros((bs, bs)),) * 3)
                continue
            Dc = Dc[:Lr]
            # corner blocks of A_c^-1 via block solves with E_first /
            # E_last RHS on the chain: VF = (A^-1)_FF, WF = (A^-1)_FL,
            # WL = (A^-1)_LL
            #  E_last: fwd leaves Y = e_last -> X_last = D_last;
            #          bwd cascade to row 0
            X = Dc[-1]
            WL = X
            for i in range(Lr - 2, -1, -1):
                X = Dc[i] @ (-(Up @ X))
            WF = X
            #  E_first: fwd cascade Y_i = (-Up^T D_{i-1}) Y_{i-1};
            #          bwd from X_last back to row 0
            Ys = [onp.eye(bs)]
            for i in range(1, Lr):
                Ys.append(-(Up.T @ (Dc[i - 1] @ Ys[-1])))
            X = Dc[-1] @ Ys[-1]
            for i in range(Lr - 2, -1, -1):
                X = Dc[i] @ (Ys[i] - Up @ X)
            VF = X
            corners.append((VF, WF, WL))

        # separator Schur system (block tridiagonal over j)
        Sdiag = []
        for j in range(n - 1):
            p = sep_pos(j)
            if p >= Mi:
                Sdiag.append(None)
                continue
            VF_r, _, _ = corners[j + 1]
            _, _, WL_l = corners[j]
            Sjj = make_Kd(p, rho) - Up.T @ WL_l @ Up - Up @ VF_r @ Up.T
            Sdiag.append(Sjj)
            if j < n - 2:
                _, WF_r, _ = corners[j + 1]
                Soff[r, j] = -(Up @ WF_r @ Up)
        prev = None
        for j in range(n - 1):
            if Sdiag[j] is None:
                continue
            Sjj = Sdiag[j]
            if prev is not None:
                So = Soff[r, j - 1].astype(onp.float64)
                Sjj = Sjj - So.T @ prev @ So
            prev = _inv_spd_np(Sjj)
            Ssch[r, j] = prev

    with _blas_single_threaded():
        workers = min(R_, max(1, (ctx["n_workers"])))
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(fill_rung, range(R_)))

    cast = dict(N=ctx["N"], x_pin=ctx["x_pin"], g=ctx["g"],
                F0=ctx["F0"], FT=ctx["FT"], c_s=ctx["c_s"],
                ladder=ladder)
    cast = {k: onp.asarray(v).astype(dt_, copy=False)
            for k, v in cast.items()}
    base = NSOp(Kinvs=None, Dinvs=None, Kos=Ho.astype(dt_, copy=False),
                **cast)
    return SpikeOp(base=base, Dloc=Dloc, Ssch=Ssch, Soff=Soff)
