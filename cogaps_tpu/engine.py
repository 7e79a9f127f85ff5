"""Algorithm driver: the two-phase annealed Gibbs run.

JAX equivalent of the reference's GapsRunner + GapsStatistics
(reference: src/GapsRunner.cpp:273-503, src/GapsStatistics.{h,cpp}):

* two phases (equilibration with annealing temp min(1, 2*iter/N), then
  sampling) of nIterations each (GapsRunner.cpp:285-291, 455-469);
* per-iteration update counts drawn Poisson(max(nAtoms, 10)) per matrix
  (GapsRunner.cpp:293-296);
* update order A -> sync -> P -> sync (GapsRunner.cpp:202-222); our sync
  is a residual transpose, the analog of the AP transpose-copy
  (DenseNormalModel.cpp:20-36);
* posterior statistics with the per-pattern max normalization
  (GapsStatistics.h:130-149): P columns scaled to max 1, A columns scaled
  inversely, accumulated as running sum and sum-of-squares; fixed-matrix
  runs accumulate the free factor unnormalized (GapsStatistics.h:152-185);
* chi-square and atom-count histories every outputFrequency iterations
  (GapsRunner.cpp:160-199), matrix snapshots (GapsRunner.cpp:316-322),
  PUMP counting (GapsStatistics.h:65-126), fixed-matrix mode
  (GapsRunner.cpp:330-350).

Each dispatch span of a phase (all its iterations, all sweeps) runs as
ONE jitted lax.fori_loop — no per-iteration dispatch. The iteration body is a pure
module-level function over an explicit `DeviceData`, so the same code path
serves the single-chip engine, vmapped multi-chain runs, and shard_map
sharded runs (parallel/).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .models import dense
from .ops import rng as gaps_rng
from .ops.atoms import AtomTable, init_atoms
from .ops.sweep import MassParams, SamplerConsts, make_consts, run_updates
from .params import EngineConfig
from .utils.pytree import pytree_dataclass

EQUILIBRATION = 0
SAMPLING = 1

_LO_BITS = 30
_LO_MASK = (1 << _LO_BITS) - 1


class DeviceData(NamedTuple):
    """Device-resident dataset (both layouts, like the reference's
    per-sampler transposed copies, GapsRunner.cpp:391-406) plus the
    data-derived mass-prior parameters (runtime scalars so vmapped chains
    over different subsets keep their own lambda)."""

    D: jnp.ndarray  # (nGenes, nSamples)
    invS2: jnp.ndarray  # (nGenes, nSamples) = 1/S^2
    D_t: jnp.ndarray  # (nSamples, nGenes)
    invS2_t: jnp.ndarray
    mass_a: MassParams
    mass_p: MassParams


class HistConfig(NamedTuple):
    """Static history/snapshot bookkeeping derived from EngineConfig."""

    n_hist: int
    snap_freq: int


@pytree_dataclass
class ChainState:
    atoms_a: AtomTable
    atoms_p: AtomTable
    M_a: jnp.ndarray  # (nGenes, k)
    M_p: jnp.ndarray  # (nSamples, k)


@pytree_dataclass
class RunStats:
    a_sum: jnp.ndarray  # (G, k)
    a_sumsq: jnp.ndarray
    p_sum: jnp.ndarray  # (S, k)
    p_sumsq: jnp.ndarray
    n_stat: jnp.ndarray  # () int32
    pump: jnp.ndarray  # (G, k)
    n_pump: jnp.ndarray  # () int32
    chisq_hist: jnp.ndarray  # (H,) float32
    atom_hist_a: jnp.ndarray  # (H,) int32
    atom_hist_p: jnp.ndarray
    snap_a: jnp.ndarray  # (2*nSnapshots or 0, G, k) [equil | sampling]
    snap_p: jnp.ndarray
    upd_lo: jnp.ndarray  # () int32 — totalUpdates, base-2^30 split
    upd_hi: jnp.ndarray  # () int32
    # sampler observability (SURVEY §5; the averageQueueLength analog,
    # reference: src/GapsRunner.cpp:473-476): proposals processed and
    # accepted by type [birth, death, move, exchange] per sampler, plus
    # total sweep (conflict-free batch) counts
    prop_counts: jnp.ndarray  # (2, 4) int32 — [A, P] x type
    acc_counts: jnp.ndarray  # (2, 4) int32
    sweep_counts: jnp.ndarray  # (2,) int32


# ----------------------------------------------------------------------
# pure iteration body (shared by single-chip / vmapped / sharded runners)
# ----------------------------------------------------------------------
def run_iteration(cfg: EngineConfig, consts_a: SamplerConsts,
                  consts_p: SamplerConsts, hist: HistConfig, phase: int,
                  data: DeviceData, it, state: ChainState, stats: RunStats,
                  base_key) -> Tuple[ChainState, RunStats]:
    """One MCMC iteration (reference: GapsRunner.cpp:273-325). Pure in
    (data, it, state, stats, key); everything else is trace-time static.

    Gene-sharded runs (consts_p.axis_name set, parallel/sharded.py):
    the A sampler works on this device's row shard with a per-device
    proposal stream; the P sampler runs identical replicated proposals on
    every device with psum'd reductions over the sharded genes axis."""
    fixed = cfg.which_matrix_fixed
    n_genes = data.D.shape[0]
    axis_name = consts_p.axis_name

    key_it = jax.random.fold_in(jax.random.fold_in(base_key, phase), it)
    kpa, kpp, kua, kup = jax.random.split(key_it, 4)
    if axis_name is not None:
        # per-device A-proposal stream over the local row shard
        kua = jax.random.fold_in(kua, jax.lax.axis_index(axis_name))

    if phase == EQUILIBRATION:
        temp = jnp.minimum(
            1.0, (2.0 * it.astype(jnp.float32)) / cfg.n_iterations)
    else:
        temp = jnp.float32(1.0)

    n_a = gaps_rng.poisson_fast(
        kpa, jnp.maximum(state.atoms_a.n, 10).astype(jnp.float32))
    n_p = gaps_rng.poisson_fast(
        kpp, jnp.maximum(state.atoms_p.n, 10).astype(jnp.float32))

    atoms_a, M_a = state.atoms_a, state.M_a
    atoms_p, M_p = state.atoms_p, state.M_p
    done_a = jnp.zeros((), jnp.int32)
    done_p = jnp.zeros((), jnp.int32)
    obs_a = obs_p = None

    # Y caches are rebuilt exactly at each sampler's update-call start
    # (the analog of sync + extraInitialization, GapsRunner.cpp:202-222);
    # the full residual is never carried across iterations.
    def run_upd(k, atoms, M, cache, n_upd, consts, mparams, invS2, other):
        phase_t = dense.make_phase(invS2, other,
                                   axis_name=consts.axis_name)
        model = dense.make_model(phase_t, invS2,
                                 axis_name=consts.axis_name)
        return run_updates(k, atoms, M, cache, temp, n_upd, consts,
                           mparams, model=model)

    if fixed != "A":
        cache_a = dense.rebuild_cache(data.D, data.invS2, M_a, M_p,
                                      axis_name=consts_a.axis_name)
        atoms_a, M_a, cache_a, done_a, ns_a, cnt_a = run_upd(
            kua, atoms_a, M_a, cache_a, n_a, consts_a, data.mass_a,
            data.invS2, M_p)
        obs_a = (ns_a, cnt_a)
    if fixed != "P":
        cache_p = dense.rebuild_cache(data.D_t, data.invS2_t, M_p, M_a,
                                      axis_name=consts_p.axis_name)
        atoms_p, M_p, cache_p, done_p, ns_p, cnt_p = run_upd(
            kup, atoms_p, M_p, cache_p, n_p, consts_p, data.mass_p,
            data.invS2_t, M_a)
        obs_p = (ns_p, cnt_p)

    state = ChainState(atoms_a=atoms_a, atoms_p=atoms_p,
                       M_a=M_a, M_p=M_p)

    def chisq_fn():
        return dense.chisq_from_state(data.D, data.invS2, M_a, M_p)

    stats = accumulate_stats(cfg, hist, phase, it, M_a, M_p,
                             state.atoms_a.n, state.atoms_p.n,
                             done_a, done_p, stats, chisq_fn, n_genes,
                             axis_name, obs_a=obs_a, obs_p=obs_p)
    return state, stats


@jax.named_scope("stats")
def accumulate_stats(cfg: EngineConfig, hist: HistConfig, phase: int, it,
                     M_a, M_p, n_atoms_a, n_atoms_p, done_a, done_p,
                     stats: RunStats, chisq_fn, n_genes: int,
                     axis_name=None, obs_a=None, obs_p=None) -> RunStats:
    """Post-sweep bookkeeping shared by the dense and sparse engines:
    totalUpdates counter, posterior statistics with max-normalization
    (GapsStatistics.h:130-185), snapshots (GapsRunner.cpp:316-322),
    chi^2/atom-count histories (GapsRunner.cpp:160-199), and the
    per-sampler proposal/acceptance observability counters."""
    fixed = cfg.which_matrix_fixed

    # totalUpdates accumulation (GapsRunner.cpp:297), 2^30-split counter
    if axis_name is not None:
        # A updates are per-shard; P updates are replicated (count once)
        done_a = jax.lax.psum(done_a, axis_name)
    inc = done_a + done_p
    lo = stats.upd_lo + inc
    stats = stats.replace(upd_lo=lo & _LO_MASK,
                          upd_hi=stats.upd_hi + (lo >> _LO_BITS))

    # sampler observability counters (SURVEY §5)
    for row, obs in ((0, obs_a), (1, obs_p)):
        if obs is None:
            continue
        ns, cnt = obs
        prop, acc = cnt.processed, cnt.accepted
        if axis_name is not None and row == 0:
            ns, prop, acc = jax.lax.psum((ns, prop, acc), axis_name)
        stats = stats.replace(
            prop_counts=stats.prop_counts.at[row].add(prop),
            acc_counts=stats.acc_counts.at[row].add(acc),
            sweep_counts=stats.sweep_counts.at[row].add(ns))

    # posterior statistics in the sampling phase
    # (GapsRunner.cpp:299-315, GapsStatistics.h:130-185)
    if phase == SAMPLING:
        if fixed == "A":
            stats = stats.replace(
                p_sum=stats.p_sum + M_p,
                p_sumsq=stats.p_sumsq + M_p * M_p,
                n_stat=stats.n_stat + 1)
        elif fixed == "P":
            stats = stats.replace(
                a_sum=stats.a_sum + M_a,
                a_sumsq=stats.a_sumsq + M_a * M_a,
                n_stat=stats.n_stat + 1)
        else:
            norm = jnp.max(M_p, axis=0)
            norm = jnp.where(norm == 0.0, 1.0, norm)
            q = M_p / norm
            prod = M_a * norm
            stats = stats.replace(
                p_sum=stats.p_sum + q, p_sumsq=stats.p_sumsq + q * q,
                a_sum=stats.a_sum + prod,
                a_sumsq=stats.a_sumsq + prod * prod,
                n_stat=stats.n_stat + 1)
            if cfg.take_pump_samples:
                amax = jnp.argmax(M_a, axis=1)
                pump_oh = (amax[:, None] == jnp.arange(
                    M_a.shape[1])[None, :]).astype(jnp.float32)
                stats = stats.replace(pump=stats.pump + pump_oh,
                                      n_pump=stats.n_pump + 1)

    # snapshots (GapsRunner.cpp:316-322); layout [equil block | sampling]
    if hist.snap_freq > 0 and (
            cfg.snapshot_phase == "all"
            or (cfg.snapshot_phase == "equilibration" and phase == EQUILIBRATION)
            or (cfg.snapshot_phase == "sampling" and phase == SAMPLING)):
        take = (it + 1) % hist.snap_freq == 0
        s_idx = (phase * cfg.n_snapshots + (it + 1) // hist.snap_freq - 1)
        s_idx = jnp.where(take, s_idx, -1)  # -1 => no slot matches
        from .ops.onehot import write_at
        stats = stats.replace(
            snap_a=write_at(stats.snap_a, s_idx, M_a[None]),
            snap_p=write_at(stats.snap_p, s_idx, M_p[None]))

    # chi^2 / atom-count history every outputFrequency
    # (GapsRunner.cpp:160-199)
    if hist.n_hist > 0:
        rec = (it + 1) % cfg.output_frequency == 0
        cs = jax.lax.cond(rec, chisq_fn, lambda: jnp.float32(0.0))
        if axis_name is not None:
            cs = jax.lax.psum(cs, axis_name)
            n_atoms_a = jax.lax.psum(n_atoms_a, axis_name)
        h_idx = (phase * (hist.n_hist // 2)
                 + (it + 1) // cfg.output_frequency - 1)
        h_idx = jnp.where(rec, h_idx, -1)  # -1 => no slot matches
        from .ops.onehot import write_at
        stats = stats.replace(
            chisq_hist=write_at(stats.chisq_hist, h_idx, cs),
            atom_hist_a=write_at(stats.atom_hist_a, h_idx, n_atoms_a),
            atom_hist_p=write_at(stats.atom_hist_p, h_idx, n_atoms_p))

    return stats


def run_phase_span(cfg: EngineConfig, consts_a: SamplerConsts,
                   consts_p: SamplerConsts, hist: HistConfig, phase: int,
                   data: DeviceData, state: ChainState, stats: RunStats,
                   seed_key, start_iter, stop_iter):
    """Iterations [start, stop) of one phase as a single fori_loop."""

    def body(it, carry):
        st, sts = carry
        return run_iteration(cfg, consts_a, consts_p, hist, phase,
                             data, it, st, sts, seed_key)

    return jax.lax.fori_loop(start_iter, stop_iter, body, (state, stats))


# module-level jits keyed on the hashable static config tuple, so every
# engine instance with the same configuration shares ONE compilation
# (distributed runs build several engines per call; per-instance jits
# recompiled identical programs)
_jit_phase_span = jax.jit(run_phase_span, static_argnums=(0, 1, 2, 3, 4))


def dispatch_spans(start: int, stop: int, span: int):
    """Host-side span schedule: one XLA program per <=span iterations.
    Progress callbacks and checkpoint chunking act between spans; spans
    dispatch asynchronously, so chunking adds no host-sync stalls unless
    a callback reads device state."""
    if span <= 0:
        yield (start, stop)
        return
    a = int(start)
    stop = int(stop)
    while a < stop:
        b = min(a + span, stop)
        yield (a, b)
        a = b


def init_chain_state(cfg: EngineConfig, data: DeviceData,
                     fixed_patterns=None) -> ChainState:
    k = cfg.n_patterns
    n_genes, n_samples = data.D.shape
    M_a = jnp.zeros((n_genes, k), jnp.float32)
    M_p = jnp.zeros((n_samples, k), jnp.float32)
    if cfg.which_matrix_fixed == "A":
        M_a = jnp.asarray(fixed_patterns, jnp.float32)
    elif cfg.which_matrix_fixed == "P":
        M_p = jnp.asarray(fixed_patterns, jnp.float32)
    return ChainState(
        atoms_a=init_atoms(cfg.capacity_a),
        atoms_p=init_atoms(cfg.capacity_p),
        M_a=M_a, M_p=M_p)


def init_run_stats(cfg: EngineConfig, n_genes: int, n_samples: int,
                   hist: HistConfig) -> RunStats:
    k = cfg.n_patterns
    n_snap = 2 * cfg.n_snapshots if cfg.n_snapshots > 0 else 0
    zi = jnp.zeros((), jnp.int32)
    return RunStats(
        a_sum=jnp.zeros((n_genes, k), jnp.float32),
        a_sumsq=jnp.zeros((n_genes, k), jnp.float32),
        p_sum=jnp.zeros((n_samples, k), jnp.float32),
        p_sumsq=jnp.zeros((n_samples, k), jnp.float32),
        n_stat=zi, pump=jnp.zeros((n_genes, k), jnp.float32), n_pump=zi,
        chisq_hist=jnp.zeros((hist.n_hist,), jnp.float32),
        atom_hist_a=jnp.zeros((hist.n_hist,), jnp.int32),
        atom_hist_p=jnp.zeros((hist.n_hist,), jnp.int32),
        snap_a=jnp.zeros((n_snap, n_genes, k), jnp.float32),
        snap_p=jnp.zeros((n_snap, n_samples, k), jnp.float32),
        upd_lo=zi, upd_hi=zi,
        prop_counts=jnp.zeros((2, 4), jnp.int32),
        acc_counts=jnp.zeros((2, 4), jnp.int32),
        sweep_counts=jnp.zeros((2,), jnp.int32))


def derive_hist(cfg: EngineConfig) -> HistConfig:
    n_hist = (2 * (cfg.n_iterations // cfg.output_frequency)
              if cfg.output_frequency > 0 else 0)
    snap_freq = (cfg.n_iterations // cfg.n_snapshots
                 if cfg.n_snapshots > 0 else 0)
    return HistConfig(n_hist=n_hist, snap_freq=snap_freq)


def prepare_device_data(D: np.ndarray, S: Optional[np.ndarray],
                        cfg: EngineConfig) -> DeviceData:
    D = np.asarray(D, np.float32)
    if S is None:
        S = dense.default_uncertainty(D)
    S = np.asarray(S, np.float32)
    if S.shape != D.shape:
        raise ValueError("uncertainty shape must match data shape")
    if np.any(S <= 0):
        raise ValueError("uncertainty must be strictly positive")
    if np.any(D < 0):
        raise ValueError("negative values in data matrix")
    Dj = jnp.asarray(D)
    invS2 = jnp.asarray(1.0 / (S * S), jnp.float32)
    k = cfg.n_patterns
    lam_a = dense.compute_lambda(D, cfg.alpha_a, k)
    lam_p = dense.compute_lambda(D, cfg.alpha_p, k)
    mass_a = MassParams(lam=jnp.float32(lam_a),
                        max_gibbs_mass=jnp.float32(cfg.max_gibbs_mass_a / lam_a))
    mass_p = MassParams(lam=jnp.float32(lam_p),
                        max_gibbs_mass=jnp.float32(cfg.max_gibbs_mass_p / lam_p))
    return DeviceData(D=Dj, invS2=invS2, D_t=Dj.T, invS2_t=invS2.T,
                      mass_a=mass_a, mass_p=mass_p)


def build_consts(cfg: EngineConfig, n_genes: int, n_samples: int
                 ) -> Tuple[SamplerConsts, SamplerConsts]:
    k = cfg.n_patterns
    consts_a = make_consts(n_genes, n_samples, k, cfg.capacity_a,
                           cfg.batch_a, cfg.alpha_a,
                           local_moves=cfg.local_moves)
    consts_p = make_consts(n_samples, n_genes, k, cfg.capacity_p,
                           cfg.batch_p, cfg.alpha_p,
                           local_moves=cfg.local_moves)
    return consts_a, consts_p


# ----------------------------------------------------------------------
# single-chip engine object (the analog of runCoGAPSAlgorithm,
# GapsRunner.cpp:380-503)
# ----------------------------------------------------------------------
class GapsEngine:
    """Compiled dense-model engine for one dataset.

    Holds device-resident data (D, invS2 and transposes) and the jitted
    phase runner. `D`/`S` are (nGenes, nSamples) float32 numpy arrays;
    S defaults to max(0.1*D, 0.1) (reference: DenseNormalModel.h:73).
    """

    def __init__(self, D: np.ndarray, S: Optional[np.ndarray],
                 config: EngineConfig):
        D = np.asarray(D, np.float32)
        self.n_genes, self.n_samples = D.shape
        self.config = config
        self.data = prepare_device_data(D, S, config)
        self.consts_a, self.consts_p = build_consts(
            config, self.n_genes, self.n_samples)
        self.lam_a = float(self.data.mass_a.lam)
        self.lam_p = float(self.data.mass_p.lam)
        self.data_sparsity = float((D == 0).mean())
        self.hist = derive_hist(config)

    # convenience accessors used by checkpointing / tests
    @property
    def D(self):
        return self.data.D

    @property
    def invS2(self):
        return self.data.invS2

    # ------------------------------------------------------------------
    def init_state(self, fixed_patterns: Optional[np.ndarray] = None
                   ) -> ChainState:
        return init_chain_state(self.config, self.data, fixed_patterns)

    def init_stats(self) -> RunStats:
        return init_run_stats(self.config, self.n_genes, self.n_samples,
                              self.hist)

    # ------------------------------------------------------------------
    def run_phase(self, state, stats, seed_key, phase: int, start_iter=0,
                  progress_cb=None):
        return self.run_span(state, stats, seed_key, phase, start_iter,
                             self.config.n_iterations,
                             progress_cb=progress_cb)

    def run_span(self, state, stats, seed_key, phase: int, start_iter,
                 stop_iter, progress_cb=None):
        """Run iterations [start, stop) of one phase, dispatched in
        bounded spans (checkpoint chunking reuses the same path).
        `progress_cb(phase, iter_end, state)` fires after each span —
        the live status hook (reference: GapsRunner.cpp:160-199)."""
        for a, b in dispatch_spans(start_iter, stop_iter,
                                   self.config.dispatch_iters):
            state, stats = _jit_phase_span(
                self.config, self.consts_a, self.consts_p, self.hist,
                phase, self.data, state, stats, seed_key,
                jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32))
            if progress_cb is not None:
                progress_cb(phase, b, state)
        return state, stats

    def chisq(self, state: ChainState) -> float:
        return float(dense.chisq_from_state(self.data.D, self.invS2,
                                            state.M_a, state.M_p))
