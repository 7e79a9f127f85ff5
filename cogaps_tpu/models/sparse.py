"""Sparse normal data model — batched formulation.

Capability parity with the reference's SparseNormalModel
(reference: src/gibbs_sampler/SparseNormalModel.{h,cpp}), re-derived for
batched evaluation.

The zero-storage trick (SparseNormalModel.cpp:153-192): the sparse sampler
assumes the implied uncertainty S = 0.1*D on nonzeros and S = 0.1 on zeros
(mBeta = 100 = 1/0.1^2, h:77; custom uncertainty is rejected,
R/HelperFunctions.R:223-224). The normal-likelihood reductions then
decompose into closed-form all-elements terms via the lookup tables

    Z1[c]    = sum_rows other[:, c]^2          (cpp:294-311)
    Z2[c,c'] = other^T @ other

plus corrections over the nonzeros of the data row only:

    s    = beta * ( Z1[c] + sum_nnz ((v/d)^2 - v^2) )
    s_mu = beta * ( -M[r] . Z2[:, c]
                    + sum_nnz ( v/d + (v - (v/d)/d) * (M[r] . other[j]) ) )

where v = other[j, c] and d the nonzero data value. The reference iterates
nonzeros with 64-bit popcount bitmask intersection (cpp:12-15); here the
nonzeros live in a padded ELL layout (row -> fixed-width index/value
arrays) so a proposal batch becomes (B, L, k) gathers + elementwise
reductions, with the (B, L) reconstruction dots as one batched einsum.

The withChange identity s_mu(ch) = s_mu - ch*s holds exactly (the
reference's extra terms telescope: Z2[c,c] - sum_nnz(v^2 - (v/d)^2) =
Z1[c] + sum_nnz((v/d)^2 - v^2) since Z2[c,c] = Z1[c]), so the generic
sweep's death lane needs no model-specific path.

chi^2 closed form (cpp:39-60): beta * ( <A^T A, P^T P>
    + sum_nnz (1 + dot*(dot - 2d - d^2*dot)/d^2) ),
with the all-elements term collapsing to a k x k Frobenius product.

The model keeps NO residual/AP cache — apply() is the identity; M itself
is the only mutable state (matching the reference, which recomputes the
reconstruction per nonzero from the live factors).

Every matrix product here passes precision=HIGHEST: a float32 product
without it may run in TF32 on GPUs, which keeps about three decimal
digits and would perturb every acceptance test.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .dense import AlphaBatch

BETA = 100.0  # 1/0.1^2 (reference: SparseNormalModel.h:77)
HIGHEST = jax.lax.Precision.HIGHEST

# fp32 noise floor per unit of absolute-value accumulation: ~2^-24 per
# rounding, with headroom for the reduction length. |s_mu| below
# NOISE_EPS * (abs-sum of its constituent terms) is indistinguishable from
# rounding noise of the closed form's cancelling sums; Gibbs draws at such
# proposals are rejected rather than sampled from garbage.
NOISE_EPS = 1.0e-6


class EllMatrix(NamedTuple):
    """Padded row-major sparse layout: for row r, idx[r, :] are the column
    indices of its nonzeros (-1 padding) and val[r, :] the values."""

    idx: jnp.ndarray  # (n_rows, L) int32, -1 padded
    val: jnp.ndarray  # (n_rows, L) float32, 0 padded

    @property
    def n_rows(self) -> int:
        return self.idx.shape[0]


def to_ell(D: np.ndarray) -> EllMatrix:
    """Dense (rows, cols) -> ELL via the vectorized COO path."""
    D = np.asarray(D, np.float32)
    rows, cols = np.nonzero(D)
    return coo_to_ell(rows.astype(np.int32), cols.astype(np.int32),
                      D[rows, cols], D.shape[0])


def coo_to_ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               n_rows: int) -> EllMatrix:
    """COO -> ELL without densifying (atlas-scale ingestion path)."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n_rows)
    L = max(int(counts.max()), 1)
    idx = np.full((n_rows, L), -1, np.int32)
    val = np.zeros((n_rows, L), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    offsets = np.arange(len(rows)) - starts[rows]
    idx[rows, offsets] = cols
    val[rows, offsets] = vals
    return EllMatrix(idx=jnp.asarray(idx), val=jnp.asarray(val))


class SparsePhase(NamedTuple):
    """Per-update-phase constants derived from the frozen partner factor
    (regenerated on every sync, reference: SparseNormalModel.cpp:294-311)."""

    Z1: jnp.ndarray  # (k,)
    Z2: jnp.ndarray  # (k, k)
    other: jnp.ndarray  # (m, k) the partner factor
    col_nz: jnp.ndarray  # (k,) bool


@jax.named_scope("rebuild")
def make_sparse_phase(other_M: jnp.ndarray) -> SparsePhase:
    z2 = jnp.dot(other_M.T, other_M, preferred_element_type=jnp.float32,
                 precision=HIGHEST)
    return SparsePhase(Z1=jnp.diagonal(z2), Z2=z2, other=other_M,
                       col_nz=jnp.max(other_M, axis=0) > 0.0)


def _row_terms(ell: EllMatrix, phase: SparsePhase, M: jnp.ndarray, r, c):
    """Per-(proposal, nonzero) ingredients for data rows r: masked value
    columns, reconstruction dots, and the single-element (s, s_mu).

    Numerical stability: the reference accumulates
    s = Z1[c] + sum_nnz((v/d)^2 - v^2) (SparseNormalModel.cpp:153-192),
    which cancels catastrophically in fp32 once the partner factor holds
    large transient masses (cold-start Exp(lambda) births have mean
    1/lambda) — noise around small true s flips it negative and the Gibbs
    draws diverge. We regroup algebraically-identically into
        s = [Z1[c] - sum_nnz v^2]_+  +  sum_nnz (v/d)^2
    where the bracket is the zero-element part (mathematically >= 0, so
    clamping loses nothing) and the second term is exact and positive."""
    gi = ell.idx[r]  # (B, L)
    d = ell.val[r]  # (B, L)
    mask = gi >= 0
    o_rows = phase.other[jnp.maximum(gi, 0)]  # (B, L, k)
    Mr = M[r]  # (B, k)
    ap = jnp.einsum("blk,bk->bl", o_rows, Mr,
                    preferred_element_type=jnp.float32, precision=HIGHEST)
    v = jnp.take_along_axis(o_rows, c[:, None, None], axis=2)[..., 0]  # (B,L)
    d_safe = jnp.where(mask, d, 1.0)
    t1 = v / d_safe
    s_zero = phase.Z1[c] - jnp.sum(jnp.where(mask, v * v, 0.0), axis=-1)
    s = jnp.maximum(s_zero, 0.0) + jnp.sum(
        jnp.where(mask, t1 * t1, 0.0), axis=-1)
    z2_terms = Mr * phase.Z2[:, c].T  # (B, k)
    nnz_terms = t1 + (v - t1 / d_safe) * ap
    smu = (-jnp.sum(z2_terms, axis=-1)
           + jnp.sum(jnp.where(mask, nnz_terms, 0.0), axis=-1))
    # noise floor: accumulate PRE-cancellation magnitudes — (v - t1/d)
    # itself cancels at d ~ 1, so its rounding error scales with |v*ap|,
    # not with the residual term
    nnz_abs = t1 + (v + t1 / d_safe) * ap
    err = NOISE_EPS * (jnp.sum(z2_terms, axis=-1)
                       + jnp.sum(jnp.where(mask, nnz_abs, 0.0), axis=-1))
    return o_rows, d_safe, mask, ap, v, s, smu, err


class SparseModel(NamedTuple):
    col_nz: jnp.ndarray
    alpha: object
    apply: object


def make_model(ell: EllMatrix, phase: SparsePhase) -> SparseModel:
    """Sweep adapter (see ops/sweep.py protocol)."""

    def alpha(mstate, M, addr) -> AlphaBatch:
        del mstate
        r1, c1, r2, c2 = addr.r1, addr.c1, addr.r2, addr.c2
        o1, d1, mask1, ap1, v11, s1, smu1, err1 = _row_terms(
            ell, phase, M, r1, c1)
        _, _, _, _, _, s2, smu2, err2 = _row_terms(
            ell, phase, M, r2, c2)

        # same-row pair (reference: SparseNormalModel.cpp:242-292), with the
        # same stable regrouping as _row_terms: the zero-element part
        # ||col1 - col2||^2 - sum_nnz vdiff^2 is mathematically >= 0
        v12 = jnp.take_along_axis(o1, c2[:, None, None], axis=2)[..., 0]
        dr = 1.0 / d1
        w = 1.0 - dr * dr
        vdiff = v11 - v12
        z2d = phase.Z2[:, c1].T - phase.Z2[:, c2].T  # (B, k)
        s_same_zero = (phase.Z1[c1] - 2.0 * phase.Z2[c1, c2] + phase.Z1[c2]
                       - jnp.sum(jnp.where(mask1, vdiff * vdiff, 0.0),
                                 axis=-1))
        s_same = jnp.maximum(s_same_zero, 0.0) + jnp.sum(
            jnp.where(mask1, (vdiff * dr) ** 2, 0.0), axis=-1)
        z2d_terms = M[r1] * z2d  # (B, k)
        same_nnz = vdiff * (ap1 * w + dr)
        smu_same = (-jnp.sum(z2d_terms, axis=-1)
                    + jnp.sum(jnp.where(mask1, same_nnz, 0.0), axis=-1))
        # pre-cancellation magnitudes: z2d = Z2[:,c1]-Z2[:,c2], w = 1-1/d^2,
        # and vdiff = v1-v2 all cancel — bound by their unsigned parts
        z2d_abs = M[r1] * (phase.Z2[:, c1].T + phase.Z2[:, c2].T)
        same_abs = (v11 + v12) * (ap1 * (1.0 + dr * dr) + dr)
        err_same = NOISE_EPS * (
            jnp.sum(z2d_abs, axis=-1)
            + jnp.sum(jnp.where(mask1, same_abs, 0.0), axis=-1))
        same = r1 == r2
        s_pair = jnp.where(same, s_same, s1 + s2)
        smu_pair = jnp.where(same, smu_same, smu1 - smu2)
        err_pair = jnp.where(same, err_same, err1 + err2)
        return AlphaBatch(s1=BETA * s1, smu1=BETA * smu1,
                          s_pair=BETA * s_pair, smu_pair=BETA * smu_pair,
                          err1=BETA * err1, err_pair=BETA * err_pair)

    def apply(mstate, upd):
        return mstate  # no cache (reference: extraInitialization is a nop)

    return SparseModel(col_nz=phase.col_nz.astype(jnp.float32),
                       alpha=alpha, apply=apply)


def sparse_chisq(ell_a: EllMatrix, M_a: jnp.ndarray, M_p: jnp.ndarray
                 ) -> jnp.ndarray:
    """Closed-form chi^2 (reference: SparseNormalModel.cpp:39-60), regrouped
    for fp32 stability into two nonnegative parts:
        chi^2/beta = [<Z2a, Z2p> - sum_nnz dot^2]_+  +  sum_nnz (1 - dot/d)^2
    (the bracket is sum over zero elements of dot^2, so clamping is exact)."""
    z2a = jnp.dot(M_a.T, M_a, preferred_element_type=jnp.float32,
                  precision=HIGHEST)
    z2p = jnp.dot(M_p.T, M_p, preferred_element_type=jnp.float32,
                  precision=HIGHEST)
    all_term = jnp.sum(z2a * z2p)

    mask = ell_a.idx >= 0
    o = M_p[jnp.maximum(ell_a.idx, 0)]  # (G, L, k)
    dot = jnp.einsum("glk,gk->gl", o, M_a,
                     preferred_element_type=jnp.float32, precision=HIGHEST)
    d = jnp.where(mask, ell_a.val, 1.0)
    zero_part = all_term - jnp.sum(jnp.where(mask, dot * dot, 0.0))
    nnz_part = jnp.sum(jnp.where(mask, (1.0 - dot / d) ** 2, 0.0))
    return BETA * (jnp.maximum(zero_part, 0.0) + nnz_part)


def sparsity(D: np.ndarray) -> float:
    return float((np.asarray(D) == 0).mean())
