"""Sparse-model engine: the driver specialization for SparseNormalModel.

Same two-phase annealed MCMC as engine.py, with the sparse data model
(models/sparse.py): ELL-layout nonzeros in both orientations, Z1/Z2 lookup
tables regenerated at each sampler sync (reference:
SparseNormalModel.cpp:294-311 via sync, GapsRunner.cpp:202-222), no
residual cache, closed-form chi^2. Custom uncertainty is not supported —
the model's math assumes the implied default (reference:
R/HelperFunctions.R:223-224). Nothing here builds a dense
(genes x samples) array: every per-proposal quantity comes from the
ELL nonzeros and k x k Gram tables.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .engine import (EQUILIBRATION, HistConfig, RunStats, accumulate_stats,
                     derive_hist, init_run_stats)
from .models import sparse
from .ops import rng as gaps_rng
from .ops.atoms import AtomTable, init_atoms
from .ops.sweep import MassParams, SamplerConsts, make_consts, run_updates
from .params import EngineConfig
from .utils.pytree import pytree_dataclass


class SparseDeviceData(NamedTuple):
    ell_a: sparse.EllMatrix  # gene-major nonzeros (A-sampler layout)
    ell_p: sparse.EllMatrix  # sample-major nonzeros (P-sampler layout)
    mass_a: MassParams
    mass_p: MassParams


@pytree_dataclass
class SparseChainState:
    atoms_a: AtomTable
    atoms_p: AtomTable
    M_a: jnp.ndarray  # (nGenes, k)
    M_p: jnp.ndarray  # (nSamples, k)


def run_iteration_sparse(cfg: EngineConfig, consts_a: SamplerConsts,
                         consts_p: SamplerConsts, hist: HistConfig,
                         phase: int, data: SparseDeviceData, it,
                         state: SparseChainState, stats: RunStats,
                         base_key) -> Tuple[SparseChainState, RunStats]:
    """One sparse-model MCMC iteration (GapsRunner.cpp:273-325)."""
    fixed = cfg.which_matrix_fixed
    n_genes = state.M_a.shape[0]

    key_it = jax.random.fold_in(jax.random.fold_in(base_key, phase), it)
    kpa, kpp, kua, kup = jax.random.split(key_it, 4)

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

    def run_upd(k2, atoms, M, n_upd, consts, mparams, ell, other):
        model = sparse.make_model(ell, sparse.make_sparse_phase(other))
        atoms, M, _, done, ns, cnt = run_updates(
            k2, atoms, M, (), temp, n_upd, consts, mparams, model=model)
        return atoms, M, done, ns, cnt

    if fixed != "A":
        atoms_a, M_a, done_a, ns_a, cnt_a = run_upd(
            kua, atoms_a, M_a, n_a, consts_a, data.mass_a,
            data.ell_a, M_p)
        obs_a = (ns_a, cnt_a)
    if fixed != "P":
        atoms_p, M_p, done_p, ns_p, cnt_p = run_upd(
            kup, atoms_p, M_p, n_p, consts_p, data.mass_p,
            data.ell_p, M_a)
        obs_p = (ns_p, cnt_p)

    state = SparseChainState(atoms_a=atoms_a, atoms_p=atoms_p,
                             M_a=M_a, M_p=M_p)

    def chisq_fn():
        return sparse.sparse_chisq(data.ell_a, M_a, M_p)

    stats = accumulate_stats(cfg, hist, phase, it, M_a, M_p,
                             state.atoms_a.n, state.atoms_p.n,
                             done_a, done_p, stats, chisq_fn, n_genes,
                             obs_a=obs_a, obs_p=obs_p)
    return state, stats


def _sparse_phase_span(config, consts_a, consts_p, hist, phase, data,
                       state, stats, seed_key, start, stop):
    def body(it, carry):
        st, sts = carry
        return run_iteration_sparse(config, consts_a, consts_p, hist,
                                    phase, data, it, st, sts, seed_key)

    return jax.lax.fori_loop(start, stop, body, (state, stats))


_jit_sparse_phase_span = jax.jit(_sparse_phase_span,
                                 static_argnums=(0, 1, 2, 3, 4))


# ----------------------------------------------------------------------
# concurrent sparse multichain: all subset chains of a
# sparse distributed run execute as ONE program — the reference runs all
# workers simultaneously (R/DistributedCogaps.R:64-67); the dense path
# has had this since round 3 (parallel/multichain.py), this is the
# sparse counterpart: the XLA sweep vmapped over the chain axis.
# ----------------------------------------------------------------------
def run_iteration_sparse_batch(cfg: EngineConfig, consts_a, consts_p,
                               hist: HistConfig, phase: int,
                               data: SparseDeviceData, it,
                               state: SparseChainState, stats: RunStats,
                               base_keys):
    fixed = cfg.which_matrix_fixed
    NCH = state.M_a.shape[0]
    n_genes = state.M_a.shape[1]

    key_it = jax.vmap(lambda k: jax.random.fold_in(
        jax.random.fold_in(k, phase), it))(base_keys)
    ks = jax.vmap(lambda k: jax.random.split(k, 4))(key_it)
    kpa, kpp, kua, kup = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]

    if phase == EQUILIBRATION:
        temp = jnp.minimum(
            1.0, (2.0 * it.astype(jnp.float32)) / cfg.n_iterations)
    else:
        temp = jnp.float32(1.0)

    n_a = jax.vmap(lambda k, n: gaps_rng.poisson_fast(
        k, jnp.maximum(n, 10).astype(jnp.float32)))(kpa, state.atoms_a.n)
    n_p = jax.vmap(lambda k, n: gaps_rng.poisson_fast(
        k, jnp.maximum(n, 10).astype(jnp.float32)))(kpp, state.atoms_p.n)

    atoms_a, M_a = state.atoms_a, state.M_a
    atoms_p, M_p = state.atoms_p, state.M_p
    done_a = jnp.zeros((NCH,), jnp.int32)
    done_p = jnp.zeros((NCH,), jnp.int32)
    obs_a = obs_p = None

    def run_upd(keys2, atoms, M, n_upd, consts, mparams, ell, other):
        def one(key_i, atoms_i, M_i, n_i, lam_i, mgm_i, idx_i, val_i,
                other_i):
            model = sparse.make_model(
                sparse.EllMatrix(idx=idx_i, val=val_i),
                sparse.make_sparse_phase(other_i))
            a2, M2, _, d2, ns2, cnt2 = run_updates(
                key_i, atoms_i, M_i, (), temp, n_i, consts,
                MassParams(lam=lam_i, max_gibbs_mass=mgm_i), model=model)
            return a2, M2, d2, ns2, cnt2

        return jax.vmap(one)(keys2, atoms, M, n_upd, mparams.lam,
                             mparams.max_gibbs_mass, ell.idx, ell.val,
                             other)

    if fixed != "A":
        atoms_a, M_a, done_a, ns_a, cnt_a = run_upd(
            kua, atoms_a, M_a, n_a, consts_a, data.mass_a,
            data.ell_a, M_p)
        obs_a = (ns_a, cnt_a)
    if fixed != "P":
        atoms_p, M_p, done_p, ns_p, cnt_p = run_upd(
            kup, atoms_p, M_p, n_p, consts_p, data.mass_p,
            data.ell_p, M_a)
        obs_p = (ns_p, cnt_p)

    state = SparseChainState(atoms_a=atoms_a, atoms_p=atoms_p,
                             M_a=M_a, M_p=M_p)

    from .ops.sweep import SweepCounts
    zobs = (jnp.zeros((NCH,), jnp.int32),
            SweepCounts(processed=jnp.zeros((NCH, 4), jnp.int32),
                        accepted=jnp.zeros((NCH, 4), jnp.int32)))
    obs_a = obs_a if obs_a is not None else zobs
    obs_p = obs_p if obs_p is not None else zobs

    def one_stats(M_a1, M_p1, na1, np1, da1, dp1, stats1, idx1, val1,
                  obs_a1, obs_p1):
        def chisq_fn():
            return sparse.sparse_chisq(
                sparse.EllMatrix(idx=idx1, val=val1), M_a1, M_p1)
        return accumulate_stats(cfg, hist, phase, it, M_a1, M_p1, na1,
                                np1, da1, dp1, stats1, chisq_fn,
                                n_genes, None, obs_a=obs_a1,
                                obs_p=obs_p1)

    stats = jax.vmap(one_stats)(
        M_a, M_p, state.atoms_a.n, state.atoms_p.n, done_a, done_p,
        stats, data.ell_a.idx, data.ell_a.val, obs_a, obs_p)
    return state, stats


def _sparse_phase_span_multi(config, consts_a, consts_p, hist, phase,
                             data, state, stats, keys, start, stop):
    def body(it, carry):
        st, sts = carry
        return run_iteration_sparse_batch(config, consts_a, consts_p,
                                          hist, phase, data, it, st, sts,
                                          keys)

    return jax.lax.fori_loop(start, stop, body, (state, stats))


_jit_sparse_phase_span_multi = jax.jit(_sparse_phase_span_multi,
                                       static_argnums=(0, 1, 2, 3, 4))


def stack_sparse_device_data(Ds, cfg: EngineConfig,
                             pad_rows: int = None, pad_cols: int = None
                             ) -> Tuple[SparseDeviceData, list]:
    """Stack per-chain sparse datasets (dense arrays or CooMatrix) into
    one chain-batched SparseDeviceData. ELL widths pad to the max across
    chains; rows/cols pad to a common shape. Padded rows/columns are
    all-zero OBSERVATIONS under the sparse model's implied uncertainty
    (S = 0.1 at zeros — no invS2 = 0 no-op trick exists here, same
    caveat as parallel/sparse_sharded.py): their fitted factor rows
    shrink to ~0 and the likelihood bias is O(padding/size).

    Returns (data, shapes) with shapes the per-chain true (G, S)."""
    from .io.h5 import CooMatrix
    coos = []
    shapes = []
    for D in Ds:
        if isinstance(D, CooMatrix):
            coos.append((np.asarray(D.rows), np.asarray(D.cols),
                         np.asarray(D.vals, np.float32)))
            shapes.append(D.shape)
        else:
            D = np.asarray(D, np.float32)
            r, c = np.nonzero(D)
            coos.append((r.astype(np.int32), c.astype(np.int32),
                         D[r, c]))
            shapes.append(D.shape)
    G = pad_rows or max(s[0] for s in shapes)
    S = pad_cols or max(s[1] for s in shapes)
    k = cfg.n_patterns
    ells_a = [sparse.coo_to_ell(r, c, v, G) for r, c, v in coos]
    ells_p = [sparse.coo_to_ell(c, r, v, S) for r, c, v in coos]
    La = max(int(e.idx.shape[1]) for e in ells_a)
    Lp = max(int(e.idx.shape[1]) for e in ells_p)

    def pad_stack(ells, L):
        idx = np.full((len(ells), ells[0].idx.shape[0], L), -1, np.int32)
        val = np.zeros((len(ells), ells[0].idx.shape[0], L), np.float32)
        for i, e in enumerate(ells):
            w = e.idx.shape[1]
            idx[i, :, :w] = np.asarray(e.idx)
            val[i, :, :w] = np.asarray(e.val)
        return sparse.EllMatrix(idx=jnp.asarray(idx),
                                val=jnp.asarray(val))

    ell_a = pad_stack(ells_a, La)
    ell_p = pad_stack(ells_p, Lp)

    lam_a = np.zeros((len(Ds),), np.float32)
    lam_p = np.zeros((len(Ds),), np.float32)
    for i, (r, c, v) in enumerate(coos):
        nnz_mean = float(v.mean()) if len(v) else 1.0
        lam_a[i] = cfg.alpha_a * np.sqrt(k / nnz_mean)
        lam_p[i] = cfg.alpha_p * np.sqrt(k / nnz_mean)

    data = SparseDeviceData(
        ell_a=ell_a, ell_p=ell_p,
        mass_a=MassParams(jnp.asarray(lam_a),
                          jnp.asarray(cfg.max_gibbs_mass_a / lam_a)),
        mass_p=MassParams(jnp.asarray(lam_p),
                          jnp.asarray(cfg.max_gibbs_mass_p / lam_p)))
    return data, shapes


class SparseMultichainEngine:
    """C independent sparse chains as one program (the sparse analog of
    parallel/multichain.MultichainEngine)."""

    def __init__(self, data: SparseDeviceData, cfg: EngineConfig):
        self.config = cfg
        self.n_chains, self.n_genes = data.ell_a.idx.shape[:2]
        self.n_samples = data.ell_p.idx.shape[1]
        self.hist = derive_hist(cfg)
        self.data = data
        k = cfg.n_patterns
        self.consts_a = make_consts(self.n_genes, self.n_samples, k,
                                    cfg.capacity_a, cfg.batch_a,
                                    cfg.alpha_a,
                                    local_moves=cfg.local_moves)
        self.consts_p = make_consts(self.n_samples, self.n_genes, k,
                                    cfg.capacity_p, cfg.batch_p,
                                    cfg.alpha_p,
                                    local_moves=cfg.local_moves)
        self._run_phase = functools.partial(
            _jit_sparse_phase_span_multi, cfg, self.consts_a,
            self.consts_p, self.hist)

    def init_state(self, fixed_patterns=None) -> SparseChainState:
        cfg = self.config
        k = cfg.n_patterns
        NCH = self.n_chains
        M_a = jnp.zeros((NCH, self.n_genes, k), jnp.float32)
        M_p = jnp.zeros((NCH, self.n_samples, k), jnp.float32)
        if cfg.which_matrix_fixed in ("A", "P"):
            fp = jnp.asarray(fixed_patterns, jnp.float32)
            if fp.ndim == 2:
                fp = jnp.broadcast_to(fp, (NCH,) + fp.shape)
            if cfg.which_matrix_fixed == "A":
                M_a = fp
            else:
                M_p = fp
        stack = lambda t: jax.vmap(lambda _: t)(jnp.arange(NCH))
        return SparseChainState(
            atoms_a=stack(init_atoms(cfg.capacity_a)),
            atoms_p=stack(init_atoms(cfg.capacity_p)),
            M_a=M_a, M_p=M_p)

    def init_stats(self) -> RunStats:
        return jax.vmap(lambda _: init_run_stats(
            self.config, self.n_genes, self.n_samples, self.hist))(
                jnp.arange(self.n_chains))

    def run_phase(self, state, stats, seed_keys, phase: int,
                  start_iter=0, stop_iter=None):
        from .engine import dispatch_spans
        stop = (self.config.n_iterations if stop_iter is None
                else stop_iter)
        for a, b in dispatch_spans(start_iter, stop,
                                   self.config.dispatch_iters):
            state, stats = self._run_phase(
                phase, self.data, state, stats, seed_keys,
                jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32))
        return state, stats


class SparseGapsEngine:
    """Sparse-model engine with the same surface as GapsEngine."""

    def __init__(self, D, config: EngineConfig):
        """`D` is a dense (genes x samples) array OR an io.h5.CooMatrix —
        the COO path never densifies (atlas-scale ingestion,
        SURVEY.md §7.10)."""
        from .io.h5 import CooMatrix
        if isinstance(D, CooMatrix):
            rows, cols, vals = D.rows, D.cols, D.vals
            self.n_genes, self.n_samples = D.shape
            if np.any(vals < 0):
                raise ValueError("negative values in data matrix")
            nnz_mean = float(vals.mean()) if len(vals) else 1.0
            ell_a = sparse.coo_to_ell(rows, cols, vals, self.n_genes)
            ell_p = sparse.coo_to_ell(cols, rows, vals, self.n_samples)
            self.data_sparsity = 1.0 - len(vals) / max(
                self.n_genes * self.n_samples, 1)
        else:
            D = np.asarray(D, np.float32)
            if np.any(D < 0):
                raise ValueError("negative values in data matrix")
            self.n_genes, self.n_samples = D.shape
            nz = D[D != 0]
            nnz_mean = float(nz.mean()) if nz.size else 1.0
            ell_a = sparse.to_ell(D)
            ell_p = sparse.to_ell(D.T)
            self.data_sparsity = sparse.sparsity(D)
        k = config.n_patterns
        self.config = config
        self.hist = derive_hist(config)

        lam_a = float(config.alpha_a) * float(np.sqrt(k / nnz_mean))
        lam_p = float(config.alpha_p) * float(np.sqrt(k / nnz_mean))
        self.lam_a, self.lam_p = lam_a, lam_p
        self.data = SparseDeviceData(
            ell_a=ell_a,
            ell_p=ell_p,
            mass_a=MassParams(jnp.float32(lam_a),
                              jnp.float32(config.max_gibbs_mass_a / lam_a)),
            mass_p=MassParams(jnp.float32(lam_p),
                              jnp.float32(config.max_gibbs_mass_p / lam_p)))

        self.consts_a = make_consts(self.n_genes, self.n_samples, k,
                                    config.capacity_a, config.batch_a,
                                    config.alpha_a,
                                    local_moves=config.local_moves)
        self.consts_p = make_consts(self.n_samples, self.n_genes, k,
                                    config.capacity_p, config.batch_p,
                                    config.alpha_p,
                                    local_moves=config.local_moves)

        self._run_phase = functools.partial(
            _jit_sparse_phase_span, config, self.consts_a, self.consts_p,
            self.hist)

    # ------------------------------------------------------------------
    def init_state(self, fixed_patterns: Optional[np.ndarray] = None
                   ) -> SparseChainState:
        cfg = self.config
        k = cfg.n_patterns
        M_a = jnp.zeros((self.n_genes, k), jnp.float32)
        M_p = jnp.zeros((self.n_samples, k), jnp.float32)
        if cfg.which_matrix_fixed == "A":
            M_a = jnp.asarray(fixed_patterns, jnp.float32)
        elif cfg.which_matrix_fixed == "P":
            M_p = jnp.asarray(fixed_patterns, jnp.float32)
        return SparseChainState(
            atoms_a=init_atoms(cfg.capacity_a),
            atoms_p=init_atoms(cfg.capacity_p),
            M_a=M_a, M_p=M_p)

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
        from .engine import dispatch_spans
        for a, b in dispatch_spans(start_iter, stop_iter,
                                   self.config.dispatch_iters):
            state, stats = self._run_phase(
                phase, self.data, state, stats, seed_key,
                jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32))
            if progress_cb is not None:
                progress_cb(phase, b, state)
        return state, stats

    def chisq(self, state: SparseChainState) -> float:
        return float(sparse.sparse_chisq(self.data.ell_a, state.M_a,
                                         state.M_p))
