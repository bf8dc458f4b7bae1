"""Structure-preserving Ruiz equilibration for the trajectory QP.

float32 cannot Cholesky-factor the raw KKT system: the jerk cost
carries dt^(1-2*phi) ~ 1e3-scale entries and the continuity rows carry
n!/(n-phi)! * dt^-phi factors up to 60 (squared via A^T rho A), giving
condition numbers beyond f32's ~1e7 range.  Modified Ruiz scaling (as in
OSQP) fixes this — and with two structural choices the scaled problem has
*exactly* the same block structure as the original, so the solver's
matvecs don't change at all:

  * variable scaling d[D] is shared across agents and axes (the problem is
    homogeneous in (b, k): same Q, same Aeq, meter-scale boxes), so
    Qseg_bar = c * diag(d_m) Qseg diag(d_m) stays [M, n+1, n+1] and
    Aeq_bar stays [Re, D];
  * box rows are scaled by e_box = 1/d, keeping the box block an identity;
    pair rows by 1/(d * max_k |n|), which folds entirely into pair_n and
    pair_rhs.

Unscaling: x = d * x_bar.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp

from .assemble import QPData

_MIN_SCALE = 1e-4
_MAX_SCALE = 1e4


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Scaling:
    c: jnp.ndarray  # scalar cost scaling
    d: jnp.ndarray  # [D] variable scaling (shared over agents/axes)
    e_eq: jnp.ndarray  # [Re] equality row scaling
    pair_row: jnp.ndarray  # [P, D] pair row scaling = 1/(d * max|n|)


def _dense_P_template(Qseg: jnp.ndarray) -> jnp.ndarray:
    """|blockdiag(Qseg)| as [D, D] magnitudes for norm computation."""
    M, npp, _ = Qseg.shape
    D = M * npp
    P = jnp.zeros((M, npp, M, npp), Qseg.dtype)
    ids = jnp.arange(M)
    P = P.at[ids, :, ids, :].add(jnp.abs(Qseg))
    return P.reshape(D, D)


def equilibrate(data: QPData, iters: int = 10) -> tuple[QPData, Scaling]:
    dt = data.lb.dtype
    M, npp, _ = data.Qseg.shape
    D = M * npp
    Re = data.Aeq.shape[0]

    P_abs = _dense_P_template(data.Qseg)
    A_abs = jnp.abs(data.Aeq)

    d = jnp.ones(D, dt)
    e_eq = jnp.ones(Re, dt)
    c = jnp.asarray(1.0, dt)

    def clipped_inv_sqrt(v):
        v = jnp.clip(v, _MIN_SCALE, _MAX_SCALE)
        return 1.0 / jnp.sqrt(v)

    for _ in range(iters):
        # column infinity norms of the scaled [P; Aeq; I] stack
        col_P = jnp.max(c * d[:, None] * P_abs * d[None, :], axis=0)
        col_eq = jnp.max(e_eq[:, None] * A_abs * d[None, :], axis=0)
        col_box = jnp.ones(D, dt)  # e_box*d == 1 by construction
        col = jnp.maximum(jnp.maximum(col_P, col_eq), col_box)
        d = d * clipped_inv_sqrt(col)

        row_eq = jnp.max(e_eq[:, None] * A_abs * d[None, :], axis=1)
        e_eq = e_eq * clipped_inv_sqrt(row_eq)

        # cost scaling (OSQP: 1/mean of P column norms; q == 0 here)
        colP = jnp.max(c * d[:, None] * P_abs * d[None, :], axis=0)
        gamma = 1.0 / jnp.clip(jnp.mean(colP), _MIN_SCALE, _MAX_SCALE)
        c = c * gamma

    # pair rows: entries n[p, m(d), k] * d[d]; normalize row inf-norm to 1
    n_max = jnp.max(jnp.abs(data.pair_n), axis=-1)  # [P, M]
    n_max_d = jnp.repeat(n_max, npp, axis=1)  # [P, D]
    pair_row = 1.0 / jnp.clip(n_max_d * d[None, :], 1e-8, None)

    dm = d.reshape(M, npp)
    sdata = replace(
        data,
        Qseg=c * dm[:, :, None] * data.Qseg * dm[:, None, :],
        Aeq=e_eq[:, None] * data.Aeq * d[None, :],
        deq=data.deq * e_eq,
        lb=data.lb / d,
        ub=data.ub / d,
        pair_n=data.pair_n / jnp.clip(n_max[..., None], 1e-8, None),
        pair_rhs=jnp.where(data.pair_mask[:, None] > 0,
                           data.pair_rhs * pair_row,
                           jnp.asarray(-1e8, dt)),
        x0=data.x0 / d,
    )
    return sdata, Scaling(c=c, d=d, e_eq=e_eq, pair_row=pair_row)
