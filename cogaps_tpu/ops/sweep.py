"""Vectorized conflict-free Gibbs proposal sweep.

This is the batched replacement for the reference's two execution engines:
the sequential proposal loop (reference:
src/gibbs_sampler/SingleThreadedGibbsSampler.h:114-257) and the
ProposalQueue + OpenMP parallel-for machinery
(reference: src/atomic/ProposalQueue.cpp:53-283,
AsynchronousGibbsSampler.h:89-121).

Parallelization argument (same as the reference's, SURVEY.md §2.3 P2): a
proposal at factor element (r, c) reads only D/S/AP row r and partner
column c, and writes only M[r, c] and AP row r. Proposals on *disjoint
rows* therefore commute exactly — the likelihood factorizes across rows
while the partner factor is frozen. The reference builds a serial queue of
such proposals and replays conflicts via RNG rollback
(ProposalQueue.cpp:169-232); we instead draw a wide batch of B candidate
proposals with counter-based RNG, keep each proposal iff no earlier lane
touches its rows or atoms (deterministic first-wins priority), and
evaluate + apply all survivors in one fused step. Like the reference's
queue — which admits whole batches under a single atom-count window
(ProposalQueue.cpp:135-158) — all proposals within a batch use the
batch-start atom count for the birth/death decision.

Execution strategy: this module is the one portable implementation. XLA
compiles the same code for the GPU and the CPU, for single chains, for
vmapped chains and for gene-sharded (collective-using) runs; the
proposal tables are read with native gathers and written with native
scatters.

Conflict resolution (_keep): exact
first-wins on rows AND atoms (earliest active lane per row/slot wins;
ops/sweep.atoms_first_wins documents why first-wins everywhere). The
rule is deterministic, keeps only mutually non-conflicting proposals,
and thins contested entities like the reference's queue does (a
contested row processes at most one proposal per sweep) — equilibrium
behavior is validated against the reference's shipped golden results
(tests/test_golden.py).

Proposal kernels replicate SingleThreadedGibbsSampler.h exactly at the
element level:
  * type draw: always birth when n < 2; else u1<0.5 splits birth/death by
    deathProb = n*L / (n*L + alpha*nBins*(L-n)); u1<0.75 move, else
    exchange (h:95-111).
  * birth (h:131-149): uniform element; Gibbs mass if the partner column
    is non-zero (else Exp(lambda)); accept when mass > epsilon.
  * death (h:154-188): uniform atom; attempted rebirth with Gibbs mass at
    the atom-removed state; accept rebirth iff log U < m*(s_mu - s*m/2),
    else the atom dies.
  * move (h:192-223): uniform atom relocated within a symmetric local
    window e1 +/- U[1, W], W = mean atom spacing — the analog of the
    reference's neighbor-bounded move interval, and a symmetric MH
    proposal w.r.t. the position-uniform atomic prior (global-uniform
    targets remain available via SamplerConsts.local_moves=False).
    Same-element moves auto-accept (a no-op here).
  * exchange (h:228-257): Gibbs mass transfer between the atom and a
    partner atom (design delta: partner is a uniform *other* atom rather
    than the domain successor — pair selection is measurable w.r.t. the
    non-resampled state, so the Gibbs step is unchanged). Same-element
    exchanges redistribute the pooled mass by a truncated shape-2 gamma
    draw, auto-accepted with the matrix untouched — the async
    reference's rule (ProposalQueue.cpp:267-277, Random.cpp:194-200).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import rng as gaps_rng
from ..ops.atoms import AtomTable

# proposal-type indices for the diagnostics counters
# (the averageQueueLength / acceptance-rate analog,
#  reference: src/GapsRunner.cpp:473-476)
T_BIRTH, T_DEATH, T_MOVE, T_EXCHANGE = 0, 1, 2, 3


class SamplerConsts(NamedTuple):
    """Static per-sampler constants (trace-time)."""

    n_rows: int  # rows of the factor being sampled (genes for A, samples for P)
    m: int  # reduction length (the other dimension)
    k: int  # n_patterns
    n_bins: int  # n_rows * k
    capacity: int  # atom table capacity
    batch: int  # proposal batch width B
    alpha: float
    domain_length: float  # binLength * nBins with binLength = 2^64 // nBins
    axis_name: object = None  # mesh axis to psum row-reductions over
    # (gene-sharded P sampler, parallel/sharded.py)
    # move proposals: True = symmetric local window around the atom
    # (target = e1 +/- U[1, W], W = mean atom spacing in bins — the
    # analog of the reference's neighbor-bounded move interval,
    # SingleThreadedGibbsSampler.h:192-223, needed for mixing in
    # sharp-posterior regimes); False = global uniform
    # (also a valid symmetric proposal; mixes slowly when the
    # posterior over positions is sharp)
    local_moves: bool = True


class MassParams(NamedTuple):
    """Runtime (possibly per-chain) mass-prior parameters: lambda =
    alpha*sqrt(k/meanNonZero(D)) and maxGibbsMass/lambda (reference:
    DenseNormalModel.h:79-81). Traced scalars so vmapped chains over
    different data subsets keep their own values."""

    lam: jnp.ndarray  # () float32
    max_gibbs_mass: jnp.ndarray  # () float32, already scaled by 1/lambda


class AddrBatch(NamedTuple):
    """Proposal addresses: lanes [0,B) are the primary element (r1, c1),
    the second element (r2, c2) rides with move/exchange lanes. Models
    access rows/columns by plain integer indexing."""

    r1: jnp.ndarray
    c1: jnp.ndarray
    r2: jnp.ndarray
    c2: jnp.ndarray


class ApplyBatch(NamedTuple):
    """Accepted matrix deltas: element (rows, cols) changes by deltas;
    lanes that were not applied carry delta exactly 0 (rows/cols are
    still in-range, so unmasked scatter-adds of zero are no-ops)."""

    rows: jnp.ndarray  # (2B,) int32
    cols: jnp.ndarray  # (2B,) int32
    deltas: jnp.ndarray  # (2B,) float32 (0 where not applied)


class LaneStats(NamedTuple):
    """Per-lane decisions of one sweep, for comparing two backends
    decision by decision (`sweep(..., lanes=True)`). A lane passes iff
    `stat > threshold` (birth, exchange: the new mass against epsilon)
    or `threshold < stat` (death, move: log U against the
    log-likelihood change), together with the lane's validity
    conditions. A death lane that passes re-births its atom; one that
    fails kills it."""

    kind: jnp.ndarray  # (B,) int32 proposal type, -1 where not kept
    passed: jnp.ndarray  # (B,) bool
    stat: jnp.ndarray  # (B,) float32
    threshold: jnp.ndarray  # (B,) float32


class SweepCounts(NamedTuple):
    """Per-sweep observability: proposals processed and accepted by type
    (reference returns only averageQueueLength, src/Cogaps.cpp:177-180;
    SURVEY §5 asks for acceptance rates by type as first-class outputs)."""

    processed: jnp.ndarray  # (4,) int32, kept proposals by type
    accepted: jnp.ndarray  # (4,) int32, accepted (state-changing) by type


def make_addr(r1, c1, r2, c2, n_rows: int = None, k: int = None) -> AddrBatch:
    """Build an AddrBatch from raw proposal addresses (n_rows/k accepted
    for backward compatibility; indices are used directly now)."""
    del n_rows, k
    return AddrBatch(r1=r1, c1=c1, r2=r2, c2=c2)


def make_consts(n_rows: int, m: int, k: int, capacity: int, batch: int,
                alpha: float, axis_name=None,
                local_moves: bool = True) -> SamplerConsts:
    n_bins = n_rows * k
    bin_length = (2**64) // n_bins
    return SamplerConsts(
        n_rows=n_rows, m=m, k=k, n_bins=n_bins, capacity=capacity,
        batch=batch, alpha=alpha,
        domain_length=float(bin_length * n_bins), axis_name=axis_name,
        local_moves=local_moves,
    )


def death_prob(n_f32: jnp.ndarray, consts: SamplerConsts) -> jnp.ndarray:
    """deathProb = n*L / (n*L + alpha*nBins*(L-n))
    (reference: SingleThreadedGibbsSampler.h:105-108)."""
    numer = n_f32 * consts.domain_length
    denom = numer + consts.alpha * consts.n_bins * (consts.domain_length - n_f32)
    return numer / denom


def atoms_first_wins(consts: SamplerConsts) -> bool:
    """Static rule: exact first-wins on atoms, always. First-wins keeps
    ~3x more survivors per sweep than the uncontested-only rule when
    atoms are heavily contended (the P sampler: B lanes picking among
    ~10^2 atoms left almost every atom multiply-claimed, which the
    uncontested rule resolved by keeping NONE of the claimants)."""
    return True


def _keep(active, r1, r2, uses2, a1, uses_a1, a2, uses_a2,
          consts: SamplerConsts) -> jnp.ndarray:
    """Conflict resolution (replaces ProposalQueue's mUsedMatrixIndices /
    mUsedAtoms hash sets, reference: ProposalQueue.h:58-61, cpp:175-232):

    * rows — exact first-wins: lane i survives iff it is the EARLIEST
      active lane touching each of its rows (min-lane per row);
    * atoms — exact first-wins per slot (ops/sweep.atoms_first_wins).

    The rule is deterministic and the kept set is mutually
    conflict-free."""
    B = r1.shape[0]
    lane = jnp.arange(B, dtype=jnp.int32)
    NRs = consts.n_rows  # sentinel row index (dropped)

    # min active lane per row, over both row streams
    lane_f = jnp.where(active, lane, B).astype(jnp.float32)
    rmin = jnp.full((consts.n_rows + 1,), float(B), jnp.float32)
    rmin = rmin.at[jnp.where(active, r1, NRs)].min(lane_f, mode="drop")
    rmin = rmin.at[jnp.where(active & uses2, r2, NRs)].min(
        lane_f, mode="drop")
    ok = rmin[r1] >= lane_f
    ok &= jnp.where(uses2, rmin[r2] >= lane_f, True)

    # exact first-wins on atoms
    amin = jnp.full((consts.capacity + 1,), float(B), jnp.float32)
    amin = amin.at[jnp.where(active & uses_a1, a1,
                             consts.capacity)].min(lane_f, mode="drop")
    amin = amin.at[jnp.where(active & uses_a2, a2,
                             consts.capacity)].min(lane_f, mode="drop")
    ok &= jnp.where(uses_a1,
                    amin[jnp.minimum(a1, consts.capacity)] >= lane_f,
                    True)
    ok &= jnp.where(uses_a2,
                    amin[jnp.minimum(a2, consts.capacity)] >= lane_f,
                    True)
    return active & ok


def sweep(key: jax.Array, atoms: AtomTable, M: jnp.ndarray,
          mstate, temp: jnp.ndarray, remaining: jnp.ndarray,
          consts: SamplerConsts, mass: MassParams, *, model,
          lanes: bool = False):
    """One batched proposal sweep. Returns
    (atoms, M, mstate, n_processed, counts), plus a LaneStats when
    `lanes` is set.

    `model` is a trace-time adapter built per update-phase
    (dense.make_model / sparse.make_model) exposing:
      * model.alpha(mstate, M, addr: AddrBatch) -> AlphaBatch
      * model.apply(mstate, upd: ApplyBatch) -> mstate  (cache update)
      * model.col_nz -> (k,) float32 in {0,1}, canUseGibbs per column
    `mstate` is the model's mutable cache pytree (dense: the weighted
    residual; sparse: empty — it has no cache, SparseNormalModel.cpp has
    no AP matrix)."""
    B = consts.batch
    C = consts.capacity
    K = consts.k
    NB = consts.n_bins
    EPS = gaps_rng.EPSILON

    idx = jnp.arange(B, dtype=jnp.int32)
    n = atoms.n

    # one (16, B) uniform block per sweep — rows 0-4 drive type/accept
    # draws, rows 5-8 drive selection
    uni = jax.random.uniform(key, (16, B), jnp.float32)
    u1, u2, u_gibbs, u_exp, u_acc = (uni[j] for j in range(5))
    ui = uni[5:9].T

    active = idx < jnp.minimum(remaining, B)

    # ---- proposal types (reference: SingleThreadedGibbsSampler.h:95-111) ----
    small = n < 2
    dp = death_prob(n.astype(jnp.float32), consts)
    is_bd = u1 < 0.5
    is_death = active & is_bd & (u2 < dp) & ~small
    is_birth = active & ((is_bd & (u2 >= dp)) | small)
    is_move = active & ~small & (u1 >= 0.5) & (u1 < 0.75)
    is_exch = active & ~small & (u1 >= 0.75)

    # ---- picks ----
    # the table is COMPACT (live atoms occupy slots [0, n) — ops/atoms.py),
    # so a uniform rank over the n live atoms IS a slot index: no search
    # structure at all (the reference keeps an unsorted vector for the
    # same O(1) uniform pick, AtomicDomain.cpp:24-29)
    n_c = jnp.maximum(n, 1)
    nf = n_c.astype(jnp.float32)
    a1r = jnp.minimum((ui[:, 0] * nf).astype(jnp.int32), n_c - 1)
    n1f = jnp.maximum(n - 1, 1).astype(jnp.float32)
    a2rr = jnp.minimum((ui[:, 1] * n1f).astype(jnp.int32),
                       jnp.maximum(n - 1, 1) - 1)
    a2r_ = a2rr + (a2rr >= a1r).astype(jnp.int32)  # uniform over ranks != a1
    a1c = a1r & (C - 1)  # in-bounds by construction (masked for the compiler)
    a2c = jnp.minimum(a2r_, n_c - 1) & (C - 1)
    e_birth = jnp.minimum((ui[:, 2] * NB).astype(jnp.int32), NB - 1)

    elem_a1 = atoms.elem[a1c]
    elem_a2 = atoms.elem[a2c]
    elem1 = jnp.where(is_birth, e_birth, jnp.maximum(elem_a1, 0))
    m1 = jnp.where(is_birth, 0.0, atoms.mass[a1c])
    if consts.local_moves:
        # symmetric window around the moved atom: sign and magnitude
        # U[1, W] both derived from ui3 (W = mean atom spacing, the
        # analog of the reference's neighbor-bounded move interval)
        W_f = jnp.maximum(1.0, jnp.floor(NB / nf))
        t2m = ui[:, 3] * 2.0
        sgn = jnp.where(t2m < 1.0, -1.0, 1.0)
        frac = t2m - jnp.floor(t2m)
        mag = jnp.minimum(jnp.floor(frac * W_f) + 1.0, W_f)
        e_move = (elem1.astype(jnp.float32) + sgn * mag) % NB
        e_move = e_move.astype(jnp.int32)
    else:
        e_move = jnp.minimum((ui[:, 3] * NB).astype(jnp.int32), NB - 1)
    elem2 = jnp.where(is_move, e_move, jnp.maximum(elem_a2, 0))
    m2 = atoms.mass[a2c]
    r1 = elem1 // K
    c1 = elem1 - r1 * K
    r2 = elem2 // K
    c2 = elem2 - r2 * K
    uses2 = is_move | is_exch
    uses_a1 = is_death | is_move | is_exch

    # ---- conflict resolution (see _keep) ----
    keep = _keep(active, r1, r2, uses2, a1c, uses_a1, a2c, is_exch, consts)

    # capacity guard (conservative pre-rank), then exact budget truncation
    pre_birth_rank = jnp.cumsum((keep & is_birth).astype(jnp.int32))
    keep &= jnp.where(is_birth,
                      n + pre_birth_rank - 1 < C, True)
    rank = jnp.cumsum(keep.astype(jnp.int32))
    keep &= rank <= remaining

    is_birth &= keep
    is_death &= keep
    is_move &= keep
    is_exch &= keep

    # ---- evaluate alpha parameters for all survivors ----
    addr = AddrBatch(r1=r1, c1=c1, r2=r2, c2=c2)
    ab = model.alpha(mstate, M, addr)
    can1 = model.col_nz[c1] > 0.5
    can2 = model.col_nz[c2] > 0.5
    log_u = gaps_rng.log_uniform(u_acc)
    # conditioning guard: a Gibbs draw whose s_mu is below the model's
    # fp32 noise floor is sampled from rounding garbage — treat it like
    # the reference's far-tail OptionalFloat failure (AlphaBatch.err*).
    rel1 = jnp.abs(ab.smu1) > ab.err1
    rel_pair = jnp.abs(ab.smu_pair) > ab.err_pair

    # birth lane (reference: SingleThreadedGibbsSampler.h:131-149)
    b_s = ab.s1 * temp
    b_smu = ab.smu1 * temp
    g_mass, g_ok = gaps_rng.gibbs_mass(u_gibbs, b_s, b_smu, 0.0,
                                       mass.max_gibbs_mass, mass.lam)
    e_mass = gaps_rng.exponential(u_exp, mass.lam)
    b_mass = jnp.where(can1, g_mass, e_mass)
    b_has = jnp.where(can1, g_ok & rel1, True)
    birth_acc = is_birth & b_has & (b_mass > EPS)

    # death lane (h:154-188); withChange(-m1): s_mu' = s_mu + m1*s
    d_s = ab.s1 * temp
    d_smu = (ab.smu1 + m1 * ab.s1) * temp
    rel_d = jnp.abs(ab.smu1 + m1 * ab.s1) > ab.err1
    d_gm, d_gok = gaps_rng.gibbs_mass(u_gibbs, d_s, d_smu, 0.0,
                                      mass.max_gibbs_mass, mass.lam)
    rebirth = jnp.where(can1 & d_gok & rel_d, d_gm, m1)
    dll_death = rebirth * (d_smu - d_s * rebirth * 0.5)
    death_rebirth = is_death & (log_u < dll_death)
    death_kill = is_death & ~(log_u < dll_death)

    # move lane (h:192-223)
    same_elem = elem1 == elem2
    p_s = ab.s_pair * temp
    p_smu = ab.smu_pair * temp
    dll_move = -m1 * (p_smu + p_s * m1 * 0.5)
    move_acc = is_move & ~same_elem & (log_u < dll_move)

    # exchange lane (h:228-257); gibbsMass without lambda, bounds (-m1, m2)
    x_mass, x_ok = gaps_rng.gibbs_mass(u_gibbs, p_s, p_smu, -m1, m2)
    # same-bin exchange: auto-accepted truncated-gamma(shape 2)
    # redistribution of the pooled mass, newMass assigned to the
    # heavier atom (reference: ProposalQueue.cpp:267-277,
    # Random.cpp:194-200); the matrix element is unchanged (both
    # streams' deltas cancel exactly)
    new_sb = gaps_rng.trunc_gamma2_y(
        u_gibbs, (m1 + m2) * mass.lam) / mass.lam
    d_sb = jnp.where(m1 > m2, new_sb - m1, m2 - new_sb)
    nm1 = jnp.where(same_elem, m1 + d_sb, m1 + x_mass)
    nm2 = jnp.where(same_elem, m2 - d_sb, m2 - x_mass)
    ex_ok = ((same_elem & is_exch)
             | (~same_elem & (can1 | can2) & x_ok & rel_pair))
    ex_acc = is_exch & ex_ok & (nm1 > EPS) & (nm2 > EPS)

    # ---- apply matrix changes (each element touched at most once; clamped
    # like safelyChangeMatrix, reference: DenseNormalModel.cpp:117-123) ----
    d1 = jnp.where(birth_acc, b_mass, 0.0)
    d1 = jnp.where(death_kill, -m1, d1)
    d1 = jnp.where(death_rebirth, rebirth - m1, d1)
    d1 = jnp.where(move_acc, -m1, d1)
    d1 = jnp.where(ex_acc & ~same_elem, nm1 - m1, d1)
    d2 = jnp.where(move_acc, m1, 0.0)
    d2 = jnp.where(ex_acc & ~same_elem, nm2 - m2, d2)

    up_r = jnp.concatenate([r1, r2])
    up_c = jnp.concatenate([c1, c2])
    up_d = jnp.concatenate([d1, d2])
    up_e = up_r * K + up_c  # flat element index: 1-D gathers/scatters
    M_flat = M.reshape(-1)
    old = M_flat[up_e]
    actual = jnp.maximum(old + up_d, 0.0) - old
    # rows are conflict-disjoint across lanes, but a same-row move/exchange
    # pair updates (r, c1) and (r, c2) from the same lane — scatter-add
    # accumulates both exactly (distinct elements)
    M = M_flat.at[up_e].add(actual).reshape(M.shape)
    upd = ApplyBatch(rows=up_r, cols=up_c, deltas=actual)
    mstate = model.apply(mstate, upd)

    # ---- apply atom changes, keeping the table COMPACT ----
    # in-place updates (move/exchange/rebirth) write their live slot;
    # births append at slots [n, n+b); each killed slot below the new live
    # boundary is refilled with a live atom from the tail — the vectorized
    # analog of the reference's swap-with-back erase
    # (reference: src/atomic/AtomicDomain.cpp:80-111)
    write_a1 = death_kill | death_rebirth | move_acc | ex_acc
    mass_v1 = jnp.where(death_kill, 0.0,
                        jnp.where(death_rebirth, rebirth,
                                  jnp.where(ex_acc, nm1, m1)))
    elem_v1 = jnp.where(death_kill, -1, jnp.where(move_acc, elem2, elem1))

    birth_rank = jnp.cumsum(birth_acc.astype(jnp.int32))
    bslot = (n + birth_rank - 1) & (C - 1)  # in-bounds: capacity guard above

    sa = jnp.where(write_a1, a1c, C)  # C => dropped
    sb = jnp.where(birth_acc, bslot, C)
    sx = jnp.where(ex_acc, a2c, C)
    mass_arr = atoms.mass.at[sa].set(mass_v1, mode="drop")
    mass_arr = mass_arr.at[sx].set(nm2, mode="drop")
    mass_arr = mass_arr.at[sb].set(b_mass, mode="drop")
    elem_arr = atoms.elem.at[sa].set(elem_v1, mode="drop")
    elem_arr = elem_arr.at[sb].set(e_birth, mode="drop")

    n_b = jnp.sum(birth_acc.astype(jnp.int32))
    n_d = jnp.sum(death_kill.astype(jnp.int32))
    top = n + n_b  # post-birth live boundary (before hole filling)
    n_new = top - n_d

    # holes below n_new must be refilled from live slots in [n_new, top);
    # the tail region has exactly n_d slots, of which the in-tail holes
    # are discarded along with it, so #fillers == #holes-below-boundary
    hole_mask_tail = jnp.zeros((C + 1,), jnp.bool_).at[
        jnp.where(death_kill, a1c, C)].set(True, mode="drop")
    lane_b = jnp.arange(B, dtype=jnp.int32)
    t_slot = (n_new + lane_b) & (C - 1)
    t_valid = lane_b < n_d
    t_filler = t_valid & ~hole_mask_tail[t_slot]
    f_rank = jnp.cumsum(t_filler.astype(jnp.int32))  # inclusive
    hole = death_kill & (a1c < n_new)
    h_rank = jnp.cumsum(hole.astype(jnp.int32))
    # pair k-th hole with k-th filler through a rank-indexed slot table
    # (ranks are 1-based inclusive cumsums; rank 0 is never queried)
    rank_to_src = jnp.zeros((B + 1,), jnp.int32).at[
        jnp.where(t_filler, f_rank, B + 1)].set(t_slot, mode="drop")
    src = rank_to_src[jnp.minimum(h_rank, B)] & (C - 1)
    fill_elem = elem_arr[src]
    fill_mass = mass_arr[src]
    sh = jnp.where(hole, a1c, C)
    elem_arr = elem_arr.at[sh].set(fill_elem, mode="drop")
    mass_arr = mass_arr.at[sh].set(fill_mass, mode="drop")
    # clear the discarded tail [n_new, top)
    st = jnp.where(t_valid, t_slot, C)
    elem_arr = elem_arr.at[st].set(-1, mode="drop")
    mass_arr = mass_arr.at[st].set(0.0, mode="drop")

    atoms = AtomTable(mass=mass_arr, elem=elem_arr, n=n_new)

    n_processed = jnp.sum(keep.astype(jnp.int32))
    cnt_i32 = lambda *ms: jnp.stack([jnp.sum(m.astype(jnp.int32))
                                     for m in ms])
    counts = SweepCounts(
        processed=cnt_i32(is_birth, is_death, is_move, is_exch),
        accepted=cnt_i32(birth_acc, death_kill | death_rebirth, move_acc,
                         ex_acc))
    if not lanes:
        return atoms, M, mstate, n_processed, counts
    kind = jnp.select([is_birth, is_death, is_move, is_exch],
                      [T_BIRTH, T_DEATH, T_MOVE, T_EXCHANGE], -1)
    stat = jnp.select([is_birth, is_death, is_move],
                      [b_mass, dll_death, dll_move],
                      jnp.minimum(nm1, nm2))
    threshold = jnp.where(is_death | is_move, log_u, EPS)
    lane_stats = LaneStats(
        kind=kind.astype(jnp.int32),
        passed=birth_acc | death_rebirth | move_acc | ex_acc,
        stat=stat, threshold=threshold)
    return atoms, M, mstate, n_processed, counts, lane_stats


def run_updates(key: jax.Array, atoms: AtomTable, M: jnp.ndarray,
                mstate, temp: jnp.ndarray, n_steps: jnp.ndarray,
                consts: SamplerConsts, mass: MassParams, *, model):
    """Process `n_steps` proposals in batched sweeps — the analog of
    GibbsSampler::update(nSteps, nThreads) (reference:
    AsynchronousGibbsSampler.h:89-121). Progress is guaranteed: the first
    active proposal of every sweep survives conflict resolution.

    Returns (atoms, M, mstate, n_done, n_sweeps, counts)."""

    def cond(carry):
        return carry[0] < n_steps

    def body(carry):
        done, i, atoms, M, mstate, counts = carry
        k = jax.random.fold_in(key, i)
        # named scopes ("sweep" here, "rebuild" on the per-call tables,
        # "stats" on the bookkeeping) let a profiler trace attribute
        # device time by layer (tools/profile_sweep.py)
        with jax.named_scope("sweep"):
            atoms, M, mstate, n_proc, c = sweep(
                k, atoms, M, mstate, temp, n_steps - done, consts, mass,
                model=model)
        counts = SweepCounts(processed=counts.processed + c.processed,
                             accepted=counts.accepted + c.accepted)
        return (done + n_proc, i + 1, atoms, M, mstate, counts)

    zc = SweepCounts(processed=jnp.zeros((4,), jnp.int32),
                     accepted=jnp.zeros((4,), jnp.int32))
    init = (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32), atoms, M,
            mstate, zc)
    done, n_sweeps, atoms, M, mstate, counts = jax.lax.while_loop(
        cond, body, init)
    return atoms, M, mstate, done, n_sweeps, counts
