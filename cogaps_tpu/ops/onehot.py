"""Gather/scatter-free one-hot/triangular-matmul primitives, plain jnp.

The engines use one of them: write_at, the compare-select that records
history and snapshot slots without a scatter. The others (exact integer
transport through fp32 matmuls at HIGHEST precision, two-level rank
selection, prefix-sum tiling) are alternative formulations of sweep
bookkeeping, checked against ops/sweep.py's native gathers and scatters
by tests/test_sweep_equivalence.py; no engine path calls them.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

HI = jax.lax.Precision.HIGHEST
LANE = 128

# int values are moved through fp32 matmuls in 12-bit halves: each half
# is < 4096 and one-hot sums are disjoint, so every product and sum is
# exact in fp32 (values < 2^24)
_HALF_BITS = 12
_HALF_MASK = (1 << _HALF_BITS) - 1


def onehot(idx: jnp.ndarray, n: int) -> jnp.ndarray:
    """(B,) int32 -> (B, n) fp32 one-hot; out-of-range rows are all-zero."""
    return (idx[:, None] == jnp.arange(n, dtype=idx.dtype)[None, :]).astype(
        jnp.float32)


def matmul(a, b):
    return jnp.dot(a, b, precision=HI)


# ----------------------------------------------------------------------
# row-indexed dense access
# ----------------------------------------------------------------------
def gather_rows(A: jnp.ndarray, oh: jnp.ndarray) -> jnp.ndarray:
    """A (n, m), oh (B, n) -> (B, m). Exact (one term per output row)."""
    return matmul(oh, A)


def scatter_add_rows(A: jnp.ndarray, oh: jnp.ndarray, upd: jnp.ndarray
                     ) -> jnp.ndarray:
    """A (n, m) += oh^T (n, B) @ upd (B, m). Row-disjoint lanes => exact."""
    return A + matmul(oh.T, upd)


def select_cols(rows: jnp.ndarray, ohc: jnp.ndarray) -> jnp.ndarray:
    """rows (B, k), ohc (B, k) one-hot -> (B,) element rows[i, c_i]."""
    return jnp.sum(rows * ohc, axis=-1)


# ----------------------------------------------------------------------
# triangular-matmul prefix sums
# ----------------------------------------------------------------------
def _tri_incl(n: int) -> jnp.ndarray:
    """(n, n) fp32 with T[i, j] = 1 iff i <= j (x @ T = inclusive prefix)."""
    i = jnp.arange(n)
    return (i[:, None] <= i[None, :]).astype(jnp.float32)


def lane_cumsum(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix sum over the last axis of a small array via one
    triangular matmul (exact for integer-valued fp32 < 2^24)."""
    return matmul(x, _tri_incl(x.shape[-1]))


def _block_cumsum(v: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix sum of a (n,) fp32 vector, recursing on the
    (n/LANE, LANE) tiling so the triangular constants stay <= LANE^2
    (capacity can be 2^22: a flat triangle would be 4 GB)."""
    n = v.shape[0]
    if n <= LANE:
        return matmul(v[None, :], _tri_incl(n))[0]
    nb = n // LANE
    v2 = v.reshape(nb, LANE)
    within = lane_cumsum(v2)
    totals = within[:, LANE - 1]
    prior = _block_cumsum(totals) - totals  # exclusive block prefix
    return (within + prior[:, None]).reshape(n)


class LiveIndex(NamedTuple):
    """Per-sweep index structure over the atom table's (C/128, 128) tiling:
    inclusive prefix counts of live slots, block-level cumulative counts,
    and their free-slot complements."""

    cum2d: jnp.ndarray  # (C/128, 128) inclusive cumsum of live mask
    bcum: jnp.ndarray  # (C/128,) inclusive per-block cumulative totals
    free2d: jnp.ndarray  # (C/128, 128) inclusive cumsum of free mask
    fbcum: jnp.ndarray  # (C/128,)


def live_index(elem: jnp.ndarray) -> LiveIndex:
    """elem (C,) int32 (-1 = hole) -> LiveIndex. Replaces the flat cumsum +
    searchsorted structure (ops/atoms.py live_cumsum/rank_to_slot)."""
    C = elem.shape[0]
    nb = C // LANE
    live2 = (elem >= 0).reshape(nb, LANE).astype(jnp.float32)
    within = lane_cumsum(live2)
    totals = within[:, LANE - 1]
    bprior = _block_cumsum(totals) - totals
    cum2d = within + bprior[:, None]
    bcum = bprior + totals
    pos1 = (jnp.arange(nb, dtype=jnp.float32)[:, None] * LANE
            + jnp.arange(LANE, dtype=jnp.float32)[None, :] + 1.0)
    free2d = pos1 - cum2d
    fbcum = free2d[:, LANE - 1]
    return LiveIndex(cum2d=cum2d, bcum=bcum, free2d=free2d, fbcum=fbcum)


class SlotRef(NamedTuple):
    """One-hot factorized reference to B atom-table slots."""

    ohh: jnp.ndarray  # (B, C/128)
    ohl: jnp.ndarray  # (B, LANE)
    slot: jnp.ndarray  # (B,) int32 (= C for not-found; one-hots all zero)


def _two_level_select(cum2d, bcum, ranks) -> SlotRef:
    """Slot of the (rank+1)-th set element under the given inclusive
    prefix counts (left-searchsorted semantics)."""
    r1 = ranks.astype(jnp.float32)[:, None] + 1.0
    blk = jnp.sum((bcum[None, :] < r1).astype(jnp.int32), axis=1)
    ohh = onehot(blk, bcum.shape[0])
    within = matmul(ohh, cum2d)  # (B, LANE)
    off = jnp.sum((within < r1).astype(jnp.int32), axis=1)
    ohl = onehot(off, LANE)
    return SlotRef(ohh=ohh, ohl=ohl, slot=blk * LANE + off)


def rank_to_slot(idx: LiveIndex, ranks: jnp.ndarray) -> SlotRef:
    """Slot of the (rank+1)-th LIVE atom (ranks must be < n)."""
    return _two_level_select(idx.cum2d, idx.bcum, ranks)


def free_rank_to_slot(idx: LiveIndex, ranks: jnp.ndarray) -> SlotRef:
    """Slot of the (rank+1)-th FREE slot (ranks must be < C - n)."""
    return _two_level_select(idx.free2d, idx.fbcum, ranks)


# ----------------------------------------------------------------------
# factorized 1-D table access
# ----------------------------------------------------------------------
def table_gather_f32(x: jnp.ndarray, ref: SlotRef) -> jnp.ndarray:
    """x (C,) fp32 -> (B,) x[slot] (0 for all-zero one-hots)."""
    C = x.shape[0]
    t = matmul(ref.ohh, x.reshape(C // LANE, LANE))
    return jnp.sum(t * ref.ohl, axis=1)


def table_gather_i32(x: jnp.ndarray, ref: SlotRef, *, sentinel: int = 0
                     ) -> jnp.ndarray:
    """x (C,) int32 (values >= -1) -> (B,) x[slot]; `sentinel` is returned
    for all-zero one-hots. Values move as 12-bit halves, exactly."""
    xs = (x + 1).astype(jnp.float32)  # >= 0 so halves stay nonneg
    lo = jnp.mod(xs, float(1 << _HALF_BITS))
    hi = jnp.floor(xs / float(1 << _HALF_BITS))
    glo = table_gather_f32(lo, ref)
    ghi = table_gather_f32(hi, ref)
    got = table_gather_f32(jnp.ones_like(xs), ref) > 0.5
    v = (ghi * (1 << _HALF_BITS) + glo).astype(jnp.int32) - 1
    return jnp.where(got, v, sentinel)


def _hit_and_sum(ref: SlotRef, valid, vals):
    ohh = ref.ohh * valid[:, None].astype(jnp.float32)
    sv = matmul(ohh.T, ref.ohl * vals[:, None])
    hit = matmul(ohh.T, ref.ohl)
    return hit, sv


def table_set_f32(x: jnp.ndarray, ref: SlotRef, valid: jnp.ndarray,
                  vals: jnp.ndarray) -> jnp.ndarray:
    """x (C,) fp32 with x[slot_i] = vals_i where valid_i. Slots of valid
    lanes must be distinct (conflict resolution guarantees it)."""
    C = x.shape[0]
    hit, sv = _hit_and_sum(ref, valid, vals)
    x2 = x.reshape(C // LANE, LANE)
    return (x2 * (1.0 - hit) + sv).reshape(C)


def table_set_i32(x: jnp.ndarray, ref: SlotRef, valid: jnp.ndarray,
                  vals: jnp.ndarray) -> jnp.ndarray:
    """x (C,) int32 (values >= -1) with x[slot_i] = vals_i where valid_i."""
    C = x.shape[0]
    vs = (vals + 1).astype(jnp.float32)
    lo = jnp.mod(vs, float(1 << _HALF_BITS))
    hi = jnp.floor(vs / float(1 << _HALF_BITS))
    hit, slo = _hit_and_sum(ref, valid, lo)
    _, shi = _hit_and_sum(ref, valid, hi)
    v = (shi * (1 << _HALF_BITS) + slo).astype(jnp.int32) - 1
    x2 = x.reshape(C // LANE, LANE)
    return jnp.where(hit > 0.5, v, x2).reshape(C)


def concat_refs(*parts) -> SlotRef:
    """Stack SlotRefs into one (for a single fused table write)."""
    return SlotRef(ohh=jnp.concatenate([p.ohh for p in parts]),
                   ohl=jnp.concatenate([p.ohl for p in parts]),
                   slot=jnp.concatenate([p.slot for p in parts]))


# ----------------------------------------------------------------------
# misc hot-path helpers
# ----------------------------------------------------------------------
def first_wins(pairwise_conflict: jnp.ndarray) -> jnp.ndarray:
    """keep_i = no conflict with any earlier lane j < i (the one-hot analog
    of the scatter-min priority rule). pairwise_conflict is (B, B) bool."""
    B = pairwise_conflict.shape[0]
    i = jnp.arange(B)
    earlier = i[None, :] < i[:, None]
    return ~jnp.any(pairwise_conflict & earlier, axis=1)


def write_at(arr: jnp.ndarray, idx: jnp.ndarray, value: jnp.ndarray
             ) -> jnp.ndarray:
    """arr[idx] = value as compare-select (no scatter); idx out of range
    (e.g. -1 or len(arr)) writes nothing. value broadcasts over trailing
    dims for multi-dim arr."""
    n = arr.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    m = (iota == idx).reshape((n,) + (1,) * (arr.ndim - 1))
    return jnp.where(m, value, arr)
