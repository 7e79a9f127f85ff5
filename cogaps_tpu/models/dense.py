"""Dense normal data model — batched formulation.

Capability parity with the reference's DenseNormalModel
(reference: src/gibbs_sampler/DenseNormalModel.{h,cpp}), re-derived for
batched evaluation instead of per-proposal SIMD loops.

The reference computes, per proposal at factor element (r, c), over the
full data row (DenseNormalModel.cpp:162-183):

    s    = sum_i other[i,c]^2             / S[r,i]^2
    s_mu = sum_i other[i,c]*(D - AP)[r,i] / S[r,i]^2

Batched re-derivation: within one batched sweep every proposal is evaluated
at the batch-start state (row-disjoint proposals commute — see
ops/sweep.py), and the partner factor is frozen for a whole update phase
(samplers alternate, reference: GapsRunner.cpp:202-222). All reductions
over the data dimension therefore collapse into small precomputed
tables, gathered per proposal:

  * s      = SQ[r, c]          SQ = invS2 @ other^2        (per phase)
  * s_mu   = Y[r, c]           Y  = R @ other              (per sweep*)
  * pair x = Z[r, c1, c2]      Z[r,c,c'] = sum_i o_ic o_ic' invS2[r,i]
                                                           (per phase)
  * alphaParametersWithChange(r,c,ch): s_mu' = s_mu - ch*s (identity)
  * two-element alphaParameters (cpp:186-214): s_mu(pair) = smu1 - smu2
    (the sign flip is AlphaParameters::operator+, AlphaParameters.cpp:
    11-14); s(pair) = s1 + s2 for distinct rows, s1 + s2 - 2*Z[r,c1,c2]
    for a shared row.

(*) Y is maintained *incrementally* across sweeps: an accepted matrix
change (r, c, delta) shifts the residual row r, so
Y[r, c'] -= delta * Z[r, c, c'] for all c' — a (k,)-wide row update that
replaces the reference's updateAPMatrix rank-1 row update over the full
data row (DenseNormalModel.cpp:243-258). The residual R itself is only
materialized between update phases (engine.py rebuilds it from
D - A P^T, the analog of extraInitialization, cpp:38-54).

This reformulation makes every per-proposal quantity a flat (B,) gather
from a table of size n_bins (SQ, Y) or n_bins*k (Z) — there are no
O(batch x data_dim) operations anywhere in the sweep: a per-proposal
row gather of the (n_rows, m) residual would move m floats per proposal
instead of one.

The uncertainty default is S = max(0.1*D, 0.1)
(reference: DenseNormalModel.h:73, MatrixMath.cpp:74-82); we precompute
invS2 = 1/S^2 once. lambda = alpha * sqrt(k / mean_nonzero(D)) and
maxGibbsMass scales by 1/lambda (reference: DenseNormalModel.h:79-81).

Every matrix product here passes precision=HIGHEST: a float32 product
without it may run in TF32 on GPUs, which keeps about three decimal
digits and would perturb every acceptance test. The products are
(n_rows x m) by (m x k) with k <= 50, so full precision costs little.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass

HIGHEST = jax.lax.Precision.HIGHEST


@pytree_dataclass
class DenseCache:
    """Mutable model state during one sampler's update call: the
    conditional-mean table Y = R @ other, maintained incrementally (the
    analog of the reference's AP cache, DenseNormalModel.h:60)."""

    Y: jnp.ndarray  # (n_rows, k) float32


class DensePhase(NamedTuple):
    """Per-update-phase constants derived from the *frozen* partner
    factor (recomputed after each sync, reference:
    DenseNormalModel.cpp:20-36)."""

    SQ: jnp.ndarray  # (n_rows, k) = invS2 @ other^2 — all s values
    Z: jnp.ndarray  # (n_rows * k, k): Z[r*k+c, c'] = sum_i o_ic o_ic' invS2[r,i]
    col_nz: jnp.ndarray  # (k,) bool — canUseGibbs per column (cpp:100-103)


class AlphaBatch(NamedTuple):
    """Batched alphaParameters. err1/err_pair are fp32 noise-floor
    estimates for smu1/smu_pair: when |smu| falls below its floor the
    value is rounding noise and Gibbs draws must fail (the conditioning
    analog of the reference's far-tail OptionalFloat failure). The dense
    model's Y table is maintained post-cancellation so its floor is ~0;
    the sparse closed form reconstructs large cancelling sums per
    proposal and supplies real floors (models/sparse.py)."""

    s1: jnp.ndarray
    smu1: jnp.ndarray
    s_pair: jnp.ndarray
    smu_pair: jnp.ndarray
    err1: jnp.ndarray = 0.0
    err_pair: jnp.ndarray = 0.0


def default_uncertainty(D: np.ndarray) -> np.ndarray:
    """S = pmax(0.1*D, 0.1) (reference: DenseNormalModel.h:73)."""
    return np.maximum(0.1 * D, 0.1).astype(np.float32)


def compute_lambda(D: np.ndarray, alpha: float, n_patterns: int) -> float:
    """lambda = alpha*sqrt(k/meanNonZero(D)) (reference: DenseNormalModel.h:79-80)."""
    nz = D[D != 0]
    mean_nz = float(nz.mean()) if nz.size else 1.0
    return float(alpha) * float(np.sqrt(n_patterns / mean_nz))


@jax.named_scope("rebuild")
def make_phase(invS2: jnp.ndarray, other_M: jnp.ndarray,
               axis_name=None) -> DensePhase:
    """`axis_name` handles gene-sharded runs (parallel/sharded.py): the
    partner factor's rows live across devices, so the per-phase
    reductions (SQ, Z, canUseGibbs) are psum/pmax collectives over the
    mesh axis."""
    k = other_M.shape[1]
    sq = jnp.dot(invS2, other_M * other_M,
                 preferred_element_type=jnp.float32, precision=HIGHEST)
    # outer products o_c * o_c' as an (m, k*k) matrix -> Z (n_rows, k, k)
    oo = (other_M[:, :, None] * other_M[:, None, :]).reshape(
        other_M.shape[0], k * k)
    z = jnp.dot(invS2, oo, preferred_element_type=jnp.float32,
                precision=HIGHEST)
    col_max = jnp.max(other_M, axis=0)
    if axis_name is not None:
        sq = jax.lax.psum(sq, axis_name)
        z = jax.lax.psum(z, axis_name)
        col_max = jax.lax.pmax(col_max, axis_name)
    return DensePhase(
        SQ=sq,
        Z=z.reshape(invS2.shape[0] * k, k),
        col_nz=col_max > 0.0,
    )


def residual(D: jnp.ndarray, invS2: jnp.ndarray, M: jnp.ndarray,
             other_M: jnp.ndarray) -> jnp.ndarray:
    """Exact weighted residual R = (D - M other^T) * invS2 — the analog
    of extraInitialization's full AP rebuild (DenseNormalModel.cpp:38-54).
    Only materialized between update phases."""
    ap = jnp.dot(M, other_M.T, preferred_element_type=jnp.float32,
                 precision=HIGHEST)
    return (D - ap) * invS2


@jax.named_scope("rebuild")
def rebuild_cache(D: jnp.ndarray, invS2: jnp.ndarray, M: jnp.ndarray,
                  other_M: jnp.ndarray, axis_name=None) -> DenseCache:
    """Y = R @ other at the current state (start of an update call).
    With `axis_name`, the reduction dimension (the partner rows) is
    device-sharded and the partial Y tables are psum'd."""
    R = residual(D, invS2, M, other_M)
    Y = jnp.dot(R, other_M, preferred_element_type=jnp.float32,
                precision=HIGHEST)
    if axis_name is not None:
        Y = jax.lax.psum(Y, axis_name)
    return DenseCache(Y=Y)


def alpha_batch(cache: DenseCache, phase: DensePhase, invS2: jnp.ndarray,
                addr, axis_name=None) -> AlphaBatch:
    """Batched alphaParameters for B proposals (single + pair forms):
    three flat (B,) gathers from the SQ/Y/Z tables. `invS2` is unused
    (kept for signature compatibility with differential tests). With
    `axis_name`, the tables were already psum'd at phase build, so no
    per-proposal collective is needed."""
    del invS2, axis_name
    k = phase.SQ.shape[1]
    SQ_flat = phase.SQ.reshape(-1)
    Y_flat = cache.Y.reshape(-1)
    e1 = addr.r1 * k + addr.c1
    e2 = addr.r2 * k + addr.c2
    s1 = SQ_flat[e1]
    s2 = SQ_flat[e2]
    smu1 = Y_flat[e1]
    smu2 = Y_flat[e2]
    same_row = (addr.r1 == addr.r2).astype(jnp.float32)
    x = phase.Z.reshape(-1)[e1 * k + addr.c2]
    return AlphaBatch(
        s1=s1,
        smu1=smu1,
        s_pair=s1 + s2 - 2.0 * x * same_row,
        smu_pair=smu1 - smu2,
    )


def apply_updates(cache: DenseCache, phase: DensePhase, invS2: jnp.ndarray,
                  upd) -> DenseCache:
    """Y[r, :] -= delta * Z[r, c, :] for each applied matrix change —
    the conditional-mean form of updateAPMatrix (reference:
    DenseNormalModel.cpp:243-258). `upd.deltas` are the *actual*
    (clamp-adjusted) deltas, matching safelyChangeMatrix (cpp:117-123);
    non-applied lanes carry delta exactly 0, so their scatter-adds are
    no-ops.

    The primary and second elements go in two scatters, in that order: a
    same-row move/exchange lane updates one row twice, and within one
    scatter a GPU applies duplicate indices with atomics in no fixed
    order. Split, each scatter adds at most one nonzero row per index,
    so the result is the same on every run and backend."""
    del invS2
    k = phase.SQ.shape[1]
    zrows = phase.Z[upd.rows * k + upd.cols]  # (2B, k)
    dz = -upd.deltas[:, None] * zrows
    B = upd.rows.shape[0] // 2
    Y = cache.Y.at[upd.rows[:B]].add(dz[:B])
    return DenseCache(Y=Y.at[upd.rows[B:]].add(dz[B:]))


class DenseModel(NamedTuple):
    """Trace-time adapter handed to the generic sweep (ops/sweep.py):
    closes over the per-update-phase constants (frozen partner factor
    tables); the mutable mstate is the DenseCache Y table."""

    col_nz: jnp.ndarray  # (k,) float32 in {0, 1}
    alpha: object  # fn(mstate, M, addr: AddrBatch) -> AlphaBatch
    apply: object  # fn(mstate, upd: ApplyBatch) -> mstate  (cache update)


def make_model(phase: DensePhase, invS2: jnp.ndarray,
               axis_name=None) -> DenseModel:
    def alpha(mstate: DenseCache, M, addr):
        del M  # the dense model reads the Y table, not M
        return alpha_batch(mstate, phase, invS2, addr, axis_name=axis_name)

    def apply(mstate: DenseCache, upd):
        return apply_updates(mstate, phase, invS2, upd)

    return DenseModel(col_nz=phase.col_nz.astype(jnp.float32),
                      alpha=alpha, apply=apply)


def chisq_from_state(D: jnp.ndarray, invS2: jnp.ndarray, M_a: jnp.ndarray,
                     M_p: jnp.ndarray) -> jnp.ndarray:
    """chi^2 = sum ((D-AP)/S)^2 = sum R^2 / invS2 (reference:
    DenseNormalModel.cpp:56-68), computed from the factor matrices."""
    R = residual(D, invS2, M_a, M_p)
    return jnp.sum(jnp.where(invS2 > 0, R * R / invS2, 0.0))
