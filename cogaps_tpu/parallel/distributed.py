"""Distributed CoGAPS: subset -> factorize -> consensus -> fixed re-solve.

JAX equivalent of the reference's R-side fork-based orchestration
(reference: R/DistributedCogaps.R:48-119):

  phase 1: partition the long axis (genes for genome-wide, samples for
           single-cell) into nSets subsets and run a full independent chain
           on each (reference forks one C++ engine per subset;
           R/DistributedCogaps.R:64-67);
  match:   consensus patternMatch of the gathered (tiny) short-axis factor
           matrices — complete-linkage clustering of 1-cor distance, drop
           clusters < minNS, split > maxNS, cor^3-weighted means rescaled
           to max 1 (R/DistributedCogaps.R:129-217);
  phase 2: re-run every subset with the consensus matrix *fixed*
           (whichMatrixFixed = 'P' for genome-wide, 'A' for single-cell;
           R/DistributedCogaps.R:86-97) — embarrassingly parallel;
  stitch:  concatenate the free factor across subsets, re-order to the
           original index order when the subsets form a permutation, sum
           meanChiSq (R/DistributedCogaps.R:226-278).

The subset chains are data-parallel: with multiple devices each
chain's engine run is dispatched on its own device (chains are independent,
zero communication until the tiny consensus gather); on one device they
time-share. The consensus step is O(nSets^2 k^2) on host — negligible.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from ..params import CogapsParams
from ..result import CogapsResult
from ..utils.logging import log_message
from .clustering import corr_to_mean_pattern, pattern_match


# ----------------------------------------------------------------------
# subset creation (reference: R/SubsetData.R)
# ----------------------------------------------------------------------
def create_sets(n_total: int, params: CogapsParams,
                rng: np.random.Generator,
                names: Optional[Sequence[str]] = None) -> List[np.ndarray]:
    """Partition indices [0, n_total) into nSets subsets (reference:
    R/SubsetData.R:85-116). Explicit sets may be index lists (0-based here;
    the reference uses R's 1-based) or name lists."""
    if params.explicit_sets is not None:
        if len(params.explicit_sets) != params.n_sets:
            raise ValueError("nSets does not match number of explicit sets")
        sets = []
        for s in params.explicit_sets:
            s = list(s)
            if s and isinstance(s[0], str):
                if names is None:
                    raise ValueError("named explicit sets require names")
                name_ix = {n: i for i, n in enumerate(names)}
                missing = [x for x in s if x not in name_ix]
                if missing:
                    raise ValueError(
                        f"some named entries in explicit_sets not found: "
                        f"{missing[:5]}")
                sets.append(np.asarray([name_ix[x] for x in s], np.int64))
            else:
                ix = np.asarray(s, np.int64)
                if ix.min() < 0 or ix.max() >= n_total:
                    raise ValueError("explicit set index out of range")
                sets.append(ix)
        return sets

    set_size = n_total // params.n_sets
    if params.sampling_annotation is not None:
        # weighted sampling with replacement by annotation group
        # (reference: R/SubsetData.R:36-54)
        annot = np.asarray(params.sampling_annotation)
        if len(annot) != n_total:
            raise ValueError("samplingAnnotation length must match data")
        weight = dict(params.sampling_weight or {})
        groups = np.unique(annot)
        probs = np.asarray([float(weight.get(g, 0.0)) for g in groups])
        if probs.sum() <= 0:
            raise ValueError("sampling weights must have positive sum")
        probs = probs / probs.sum()
        sets = []
        for _ in range(params.n_sets):
            group_draw = rng.choice(len(groups), size=set_size, p=probs)
            chosen = []
            for gi, g in enumerate(groups):
                cnt = int((group_draw == gi).sum())
                if cnt == 0:
                    continue
                pool = np.where(annot == g)[0]
                chosen.append(rng.choice(pool, size=cnt, replace=True))
            sets.append(np.sort(np.concatenate(chosen)) if chosen
                        else np.empty(0, np.int64))
        return sets

    # uniform partition without replacement (reference: R/SubsetData.R:63-75)
    remaining = np.arange(n_total)
    sets = []
    for _ in range(params.n_sets - 1):
        sel = rng.choice(remaining, size=set_size, replace=False)
        sets.append(np.sort(sel))
        remaining = np.setdiff1d(remaining, sel)
    sets.append(np.sort(remaining))
    return sets


# ----------------------------------------------------------------------
# orchestration
# ----------------------------------------------------------------------
def _subset_run_params(params: CogapsParams, genome_wide: bool,
                       subset: np.ndarray, worker_id: int) -> CogapsParams:
    """Per-worker parameter clone (reference: R/DistributedCogaps.R:12-35)."""
    p = dataclasses.replace(params)
    p.distributed = None
    p.subset_indices = subset.tolist()
    p.subset_dim = 1 if genome_wide else 2
    p.worker_id = worker_id
    p.running_distributed = True
    p.checkpoint_interval = 0  # checkpoints disabled when subsetting
    return p


def distributed_cogaps(D: np.ndarray, params: CogapsParams, uncertainty,
                       gene_names: Sequence[str],
                       sample_names: Sequence[str]) -> CogapsResult:
    """Run CoGAPS across data subsets and stitch the results back together
    (reference: R/DistributedCogaps.R:48-119)."""
    genome_wide = params.distributed == "genome-wide"
    n_total = D.shape[0] if genome_wide else D.shape[1]
    rng = np.random.default_rng(params.resolved_seed())
    names = gene_names if genome_wide else sample_names
    sets = create_sets(n_total, params, rng, names)
    if min(len(s) for s in sets) < params.n_patterns:
        raise ValueError("data subset dimension less than nPatterns")
    if params.print_messages:
        sizes = [len(s) for s in sets]
        log_message(f"Creating subsets...\nset sizes (min, mean, max): "
                    f"({min(sizes)}, {np.mean(sizes):.1f}, {max(sizes)})")

    unc = np.asarray(uncertainty, np.float32) if uncertainty is not None else None

    # subset chains run CONCURRENTLY as one vmapped/fused multichain
    # program (the analog of the reference's forked workers,
    # R/DistributedCogaps.R:64-67) — dense AND sparse (the sparse
    # multichain engine, sparse_engine.SparseMultichainEngine)
    def run_phase_sets(fixed):
        if params.sparse_optimization:
            return _run_subsets_multichain_sparse(
                D, params, sets, genome_wide, gene_names, sample_names,
                fixed)
        return _run_subsets_multichain(D, unc, params, sets, genome_wide,
                                       gene_names, sample_names, fixed)

    diagnostics = {}
    if params.fixed_patterns is None:
        if params.print_messages:
            log_message("Running Across Subsets...")
        initial = run_phase_sets(None)
        # gather the short-axis factor from every subset chain: Pmean for
        # genome-wide, Amean for single-cell (R/DistributedCogaps.R:71-74)
        unmatched = [(r.Pmean if genome_wide else r.Amean) for r in initial]
        all_patterns = np.concatenate(unmatched, axis=1)
        if params.print_messages:
            log_message("Matching Patterns Across Subsets...")
        clusters, consensus = pattern_match(
            all_patterns, params.resolved_cut(), params.resolved_min_ns(),
            params.resolved_max_ns())
        diagnostics["unmatchedPatterns"] = unmatched
        diagnostics["clusteredPatterns"] = clusters
        diagnostics["CorrToMeanPattern"] = [
            corr_to_mean_pattern(c) for c in clusters]
    else:
        consensus = np.asarray(params.fixed_patterns, np.float32)

    if params.print_messages:
        log_message("Running Final Stage...")
    final = run_phase_sets(consensus)

    result = stitch_together(final, sets, genome_wide, gene_names,
                             sample_names)
    result.diagnostics.update(diagnostics)
    result.diagnostics["consensusPatterns"] = consensus
    if genome_wide:
        result.diagnostics["subsets"] = [
            [gene_names[j] for j in s] for s in sets]
    else:
        result.diagnostics["subsets"] = [
            [sample_names[j] for j in s] for s in sets]
    return result


def stitch_together(results: List[CogapsResult], sets: List[np.ndarray],
                    genome_wide: bool, gene_names, sample_names
                    ) -> CogapsResult:
    """Concatenate per-subset results (reference:
    R/DistributedCogaps.R:226-278)."""
    set_indices = np.concatenate(sets)

    def reorder(mat: np.ndarray, sd: np.ndarray, names: List[str]):
        if mat.shape[0] == len(set_indices):
            indices = np.arange(mat.shape[0])
            if np.array_equal(np.sort(indices), np.sort(set_indices)):
                ro = np.argsort(set_indices, kind="stable")
                # match(indices, setIndices): position of each index in
                # setIndices — argsort of a permutation gives exactly that
                return mat[ro], sd[ro], [names[j] for j in ro]
        return mat, sd, names

    if genome_wide:
        amean = np.concatenate([r.Amean for r in results], axis=0)
        asd = np.concatenate([r.Asd for r in results], axis=0)
        cat_genes = [g for r in results for g in r.gene_names]
        amean, asd, cat_genes = reorder(amean, asd, cat_genes)
        pmean = results[0].Pmean
        psd = np.zeros_like(pmean)
        genes, samples = cat_genes, list(sample_names)
    else:
        pmean = np.concatenate([r.Pmean for r in results], axis=0)
        psd = np.concatenate([r.Psd for r in results], axis=0)
        cat_samples = [s for r in results for s in r.sample_names]
        pmean, psd, cat_samples = reorder(pmean, psd, cat_samples)
        amean = results[0].Amean
        asd = np.zeros_like(amean)
        genes, samples = list(gene_names), cat_samples

    mean_chi_sq = float(sum(r.mean_chi_sq for r in results))
    k = amean.shape[1]
    return CogapsResult(
        Amean=amean, Asd=asd, Pmean=pmean, Psd=psd,
        mean_chi_sq=mean_chi_sq, gene_names=genes, sample_names=samples,
        pattern_names=[f"Pattern_{i+1}" for i in range(k)],
        diagnostics={"meanChiSq": mean_chi_sq,
                     "totalUpdates": sum(
                         r.diagnostics.get("totalUpdates", 0)
                         for r in results),
                     "seed": results[0].diagnostics.get("seed")})

class SubsetChains(NamedTuple):
    """One dense multichain stage's inputs: the subset chains padded to
    a common shape and stacked along a leading chain axis."""

    params: CogapsParams  # per-stage clone (fixed matrix set in phase 2)
    config: object  # EngineConfig at the padded shape
    data: object  # chain-stacked DeviceData
    keys: object  # (n_chains, 2) PRNG keys
    fixed_padded: Optional[np.ndarray]
    subDs: list
    subUs: Optional[list]


def subset_chains(D, unc, params: CogapsParams, sets, genome_wide: bool,
                  fixed) -> SubsetChains:
    """Pad and stack the subset chains of one stage (invS2 = 0 padding —
    exact likelihood no-ops). Every chain gets the reference's identical
    seed (R/DistributedCogaps.R forks carry the same params@seed)."""
    import jax
    import jax.numpy as jnp

    from .multichain import stack_device_data

    p = dataclasses.replace(params)
    p.seed = p.resolved_seed()  # one wall-clock draw when unset
    p.distributed = None
    p.running_distributed = True
    if fixed is not None:
        p.n_patterns = int(np.asarray(fixed).shape[1])
        p.fixed_patterns = np.asarray(fixed, np.float32)
        p.which_matrix_fixed = "P" if genome_wide else "A"

    if genome_wide:
        subDs = [D[s, :] for s in sets]
        subUs = ([unc[s, :] for s in sets] if unc is not None else None)
    else:
        subDs = [D[:, s] for s in sets]
        subUs = ([unc[:, s] for s in sets] if unc is not None else None)

    Gmax = max(d.shape[0] for d in subDs)
    Smax = max(d.shape[1] for d in subDs)
    cfg = p.engine_config(Gmax, Smax)
    data = stack_device_data(subDs, subUs, cfg, pad_rows=Gmax,
                             pad_cols=Smax)
    keys = jnp.stack([jax.random.PRNGKey(p.seed)] * len(sets))

    fixed_padded = None
    if fixed is not None:
        fp = np.asarray(fixed, np.float32)
        # fixed P (samples x k) pads the samples axis, fixed A the genes
        pad = np.zeros((Smax if genome_wide else Gmax, fp.shape[1]),
                       np.float32)
        pad[: fp.shape[0]] = fp
        fixed_padded = pad
    return SubsetChains(p, cfg, data, keys, fixed_padded, subDs, subUs)


def chain_mesh(n_chains: int):
    """A ("chains",) mesh over the devices when there are several: one
    subset chain per device group, zero communication (the reference's
    worker model, MulticoreParam(workers=nSets)); None on one device."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    nd = min(n_chains, len(devs))
    if nd > 1 and n_chains % nd == 0:
        return Mesh(np.array(devs[:nd]), ("chains",))
    return None


def _run_subsets_multichain(D, unc, params: CogapsParams, sets,
                            genome_wide: bool, gene_names, sample_names,
                            fixed) -> List[CogapsResult]:
    """Run all nSets subset chains as ONE multichain program, the
    concurrent analog of the reference's bplapply forks
    (R/DistributedCogaps.R:64-67, 93-97)."""
    import time as _time

    import jax

    from ..engine import EQUILIBRATION, SAMPLING
    from ..models import dense
    from ..result import finalize_statistics, mean_chi_sq
    from .multichain import MultichainEngine

    sc = subset_chains(D, unc, params, sets, genome_wide, fixed)
    p, subDs, subUs = sc.params, sc.subDs, sc.subUs
    eng = MultichainEngine(sc.data, sc.config, mesh=chain_mesh(len(sets)))
    seed = p.resolved_seed()

    t0 = _time.time()
    state = eng.init_state(sc.fixed_padded)
    stats = eng.init_stats()
    state, stats = eng.run_phase(state, stats, sc.keys, EQUILIBRATION)
    state, stats = eng.run_phase(state, stats, sc.keys, SAMPLING)
    stats = jax.device_get(stats)
    elapsed = _time.time() - t0

    results = []
    for i, s in enumerate(sets):
        g_i, s_i = subDs[i].shape
        amean, asd, pmean, psd = finalize_statistics(
            np.asarray(stats.a_sum[i][:g_i]),
            np.asarray(stats.a_sumsq[i][:g_i]),
            np.asarray(stats.p_sum[i][:s_i]),
            np.asarray(stats.p_sumsq[i][:s_i]),
            int(stats.n_stat[i]))
        if p.which_matrix_fixed != "N":
            mcs = 0.0
        else:
            Di = np.asarray(subDs[i], np.float32)
            Si = (np.asarray(subUs[i], np.float32) if subUs is not None
                  else dense.default_uncertainty(Di))
            mcs = mean_chi_sq(amean, pmean, Di, Si)
        if genome_wide:
            genes = [gene_names[j] for j in s]
            samples = list(sample_names)
        else:
            genes = list(gene_names)
            samples = [sample_names[j] for j in s]
        k = amean.shape[1]
        results.append(CogapsResult(
            Amean=amean, Asd=asd, Pmean=pmean, Psd=psd, mean_chi_sq=mcs,
            gene_names=genes, sample_names=samples,
            pattern_names=[f"Pattern_{j+1}" for j in range(k)],
            diagnostics={
                "meanChiSq": mcs, "seed": seed,
                "totalUpdates": int(stats.upd_hi[i]) * (1 << 30)
                + int(stats.upd_lo[i]),
                "totalRunningTime": elapsed,
            }))
    return results


def _run_subsets_multichain_sparse(D, params: CogapsParams, sets,
                                   genome_wide: bool, gene_names,
                                   sample_names, fixed
                                   ) -> List[CogapsResult]:
    """Sparse counterpart of _run_subsets_multichain: all nSets sparse
    subset chains as ONE chain-batched program (the
    reference runs all workers concurrently, R/DistributedCogaps.R:
    64-67). Custom uncertainty never reaches here — the sparse model
    rejects it at the API layer (R/HelperFunctions.R:223-224)."""
    import dataclasses as _dc
    import time as _time

    import jax
    import jax.numpy as jnp

    from ..engine import EQUILIBRATION, SAMPLING
    from ..models import sparse as sparse_mod
    from ..result import finalize_statistics
    from ..sparse_engine import (SparseMultichainEngine,
                                 stack_sparse_device_data)

    p = _dc.replace(params)
    p.distributed = None
    p.running_distributed = True
    if fixed is not None:
        p.n_patterns = int(np.asarray(fixed).shape[1])
        p.fixed_patterns = np.asarray(fixed, np.float32)
        p.which_matrix_fixed = "P" if genome_wide else "A"

    D = np.asarray(D, np.float32)
    subDs = ([D[s, :] for s in sets] if genome_wide
             else [D[:, s] for s in sets])
    Gmax = max(d.shape[0] for d in subDs)
    Smax = max(d.shape[1] for d in subDs)
    cfg = p.engine_config(Gmax, Smax)
    data, shapes = stack_sparse_device_data(subDs, cfg, pad_rows=Gmax,
                                            pad_cols=Smax)
    n = len(sets)
    eng = SparseMultichainEngine(data, cfg)
    seed = p.resolved_seed()
    keys = jnp.stack([jax.random.PRNGKey(seed)] * n)

    fixed_padded = None
    if fixed is not None:
        fp = np.asarray(fixed, np.float32)
        tgt = Smax if genome_wide else Gmax
        pad = np.zeros((tgt, fp.shape[1]), np.float32)
        pad[: fp.shape[0]] = fp
        fixed_padded = pad

    t0 = _time.time()
    state = eng.init_state(fixed_padded)
    stats = eng.init_stats()
    state, stats = eng.run_phase(state, stats, keys, EQUILIBRATION)
    state, stats = eng.run_phase(state, stats, keys, SAMPLING)
    stats = jax.device_get(stats)
    elapsed = _time.time() - t0

    results = []
    for i, s in enumerate(sets):
        g_i, s_i = shapes[i]
        amean, asd, pmean, psd = finalize_statistics(
            np.asarray(stats.a_sum[i][:g_i]),
            np.asarray(stats.a_sumsq[i][:g_i]),
            np.asarray(stats.p_sum[i][:s_i]),
            np.asarray(stats.p_sumsq[i][:s_i]),
            int(stats.n_stat[i]))
        if p.which_matrix_fixed != "N":
            mcs = 0.0
        else:
            ell_i = sparse_mod.EllMatrix(idx=data.ell_a.idx[i],
                                         val=data.ell_a.val[i])
            # sparse meanChiSq closed form over the true subset rows
            mcs = float(sparse_mod.sparse_chisq(
                ell_i, jnp.asarray(np.pad(
                    amean, ((0, Gmax - g_i), (0, 0)))),
                jnp.asarray(np.pad(pmean, ((0, Smax - s_i), (0, 0))))))
        if genome_wide:
            genes = [gene_names[j] for j in s]
            samples = list(sample_names)
        else:
            genes = list(gene_names)
            samples = [sample_names[j] for j in s]
        k = amean.shape[1]
        results.append(CogapsResult(
            Amean=amean, Asd=asd, Pmean=pmean, Psd=psd, mean_chi_sq=mcs,
            gene_names=genes, sample_names=samples,
            pattern_names=[f"Pattern_{j+1}" for j in range(k)],
            diagnostics={
                "meanChiSq": mcs, "seed": seed,
                "totalUpdates": int(stats.upd_hi[i]) * (1 << 30)
                + int(stats.upd_lo[i]),
                "totalRunningTime": elapsed,
            }))
    return results
