"""Top-level user API — the analog of the R CoGAPS()/scCoGAPS()/GWCoGAPS()
entry points (reference: R/CoGAPS.R:90-236).

``CoGAPS(data, params=None, n_patterns=..., ...)`` accepts a numpy array,
a (data, uncertainty) pair, or a file path (csv/tsv/mtx/gct — reference:
src/file_parser/FileParser.cpp:9-19), validates inputs
(reference: R/HelperFunctions.R:194-249), dispatches standard vs
distributed runs (reference: R/CoGAPS.R:145-151), and returns a
CogapsResult.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np

from .engine import EQUILIBRATION, SAMPLING, GapsEngine


def jnp_asarray(x):
    import jax.numpy as jnp
    return jnp.asarray(x, jnp.float32)
from .models import dense
from .params import CogapsParams
from .result import CogapsResult, finalize_statistics, mean_chi_sq
from .utils import checkpoint as ckpt
from .utils.compile_cache import configure_compile_cache
from .utils.logging import log_worker, log_message


def _load_data(data, transpose: bool):
    """Input coercion (reference: R/HelperFunctions.R:342-356 + file
    dispatch in R/CoGAPS.R:145-151)."""
    from .io.h5 import CooMatrix
    gene_names = sample_names = None
    if isinstance(data, str):
        if data.endswith((".h5", ".hdf5", ".h5ad")):
            from .io.h5 import read_any_h5
            mat, gene_names, sample_names = read_any_h5(data)
        else:
            from .io import parsers
            mat, row_names, col_names = parsers.read_matrix(data)
            gene_names, sample_names = row_names, col_names
    elif isinstance(data, CooMatrix):
        mat = data
    else:
        mat = np.asarray(data, dtype=np.float32)
        if hasattr(data, "index") and hasattr(data, "columns"):  # DataFrame
            gene_names = [str(x) for x in data.index]
            sample_names = [str(x) for x in data.columns]
    if isinstance(mat, CooMatrix):
        if transpose:
            mat = CooMatrix(rows=mat.cols, cols=mat.rows, vals=mat.vals,
                            shape=(mat.shape[1], mat.shape[0]))
            gene_names, sample_names = sample_names, gene_names
        return mat, gene_names, sample_names
    if mat.ndim != 2:
        raise ValueError("data must be a 2-D matrix")
    if transpose:
        mat = mat.T
        gene_names, sample_names = sample_names, gene_names
    return np.ascontiguousarray(mat, np.float32), gene_names, sample_names


def _check_inputs(D, uncertainty, params: CogapsParams) -> None:
    """Validation rules (reference: R/HelperFunctions.R:194-249)."""
    from .io.h5 import CooMatrix
    if isinstance(D, CooMatrix):
        if np.isnan(D.vals).any():
            raise ValueError("NA values in data")
        if (D.vals < 0).any():
            raise ValueError("negative values in data matrix")
        if uncertainty is not None:
            raise ValueError(
                "sparse (COO) input uses the implied uncertainty; custom "
                "uncertainty requires a dense matrix")
        if params.n_patterns >= min(D.shape) > 1:
            raise ValueError(
                "nPatterns must be less than the smaller data dimension")
        return
    if np.isnan(D).any():
        raise ValueError("NA values in data")
    if (D < 0).any():
        raise ValueError("negative values in data matrix")
    if params.sparse_optimization and uncertainty is not None:
        raise ValueError(
            "must use default uncertainty when enabling sparseOptimization")
    if uncertainty is not None:
        unc = np.asarray(uncertainty, np.float32)
        if unc.shape != D.shape:
            raise ValueError("uncertainty is not the same dimension as the data")
        if (unc < 0).any():
            raise ValueError("negative values in uncertainty matrix")
        if (unc < 1e-5).any():
            raise ValueError("small values in uncertainty matrix detected")
    if params.n_patterns >= min(D.shape):
        if min(D.shape) > 1:
            raise ValueError(
                "nPatterns must be less than the smaller data dimension")


def CoGAPS(
    data: Union[np.ndarray, str],
    params: Optional[CogapsParams] = None,
    n_patterns: Optional[int] = None,
    n_iterations: Optional[int] = None,
    uncertainty: Optional[np.ndarray] = None,
    seed: Optional[int] = None,
    transpose_data: bool = False,
    messages: bool = True,
    gene_names: Optional[Sequence[str]] = None,
    sample_names: Optional[Sequence[str]] = None,
    checkpoint_in_file: Optional[str] = None,
    **kwargs,
) -> CogapsResult:
    """Run CoGAPS (reference: R/CoGAPS.R:90-171)."""
    configure_compile_cache()
    params = dataclasses.replace(params) if params is not None else CogapsParams()
    if n_patterns is not None:
        params.n_patterns = int(n_patterns)
    if n_iterations is not None:
        params.n_iterations = int(n_iterations)
    if seed is not None:
        params.seed = int(seed)
    if transpose_data:
        params.transpose_data = True
    if checkpoint_in_file is not None:
        params.checkpoint_in_file = checkpoint_in_file
    params.print_messages = messages
    for key, val in kwargs.items():
        name = (key if hasattr(params, key)
                else params._PARAM_ALIASES.get(key))
        if name is None or not hasattr(params, name):
            # unknown kwargs must raise, not silently create attributes
            # (reference setParam rejects unrecognized parameters,
            # R/methods-CogapsParams.R:104-181)
            raise ValueError(f"unrecognized CoGAPS parameter: {key!r}")
        setattr(params, name, val)
    params.validate()

    D, file_genes, file_samples = _load_data(data, params.transpose_data)
    gene_names = list(gene_names) if gene_names is not None else file_genes
    sample_names = (list(sample_names) if sample_names is not None
                    else file_samples)
    if gene_names is None:
        gene_names = [f"Gene_{i+1}" for i in range(D.shape[0])]
    if sample_names is None:
        sample_names = [f"Sample_{i+1}" for i in range(D.shape[1])]
    _check_inputs(D, uncertainty, params)

    if params.distributed is not None:
        from .parallel.distributed import distributed_cogaps
        return distributed_cogaps(D, params, uncertainty,
                                  gene_names, sample_names)

    return _run_single(D, params, uncertainty, gene_names, sample_names)


def _run_single(D: np.ndarray, params: CogapsParams, uncertainty,
                gene_names, sample_names) -> CogapsResult:
    """One full engine run — the analog of cogaps_cpp + gaps::run
    (reference: src/Cogaps.cpp:141-215, src/GapsRunner.cpp:380-503)."""
    # a resumed run restores the original seed regardless of the seed
    # argument (reference: GapsRunner.cpp:100-106;
    # tests/testthat/test_checkpoints.R:9-15)
    if params.checkpoint_in_file:
        seed = ckpt.checkpoint_seed(params.checkpoint_in_file)
    else:
        seed = params.resolved_seed()
    from .io.h5 import CooMatrix
    is_coo = isinstance(D, CooMatrix)
    config = params.engine_config(D.shape[0], D.shape[1])
    if params.sparse_optimization or is_coo:
        from .sparse_engine import SparseGapsEngine
        engine = SparseGapsEngine(D, config)
    else:
        engine = GapsEngine(D, uncertainty, config)

    if params.print_messages and not params.running_distributed:
        log_message(
            f"Data Model: {'Sparse' if params.sparse_optimization else 'Dense'},"
            f" Normal\nSampler Type: Batched\n"
            f"nPatterns: {config.n_patterns}, nIterations: {config.n_iterations},"
            f" seed: {seed}")
        if not params.sparse_optimization and engine.data_sparsity > 0.80:
            log_message("Warning: data is more than 80% sparse and "
                        "sparseOptimization is not enabled")

    import jax
    seed_key = jax.random.PRNGKey(seed)

    start = time.time()
    if params.checkpoint_in_file:
        state, stats, phase0, start_iter = ckpt.load_checkpoint(
            params.checkpoint_in_file, engine)
    else:
        state = engine.init_state(params.fixed_patterns)
        stats = engine.init_stats()
        phase0, start_iter = EQUILIBRATION, 0

    if params.running_distributed:
        log_worker(params.worker_id, "is starting!")

    progress_cb = _make_progress(engine, params, config, start)

    # phase fallthrough supports resume in either phase
    # (reference: GapsRunner.cpp:453-468)
    for phase in (EQUILIBRATION, SAMPLING):
        if phase < phase0:
            continue
        it0 = start_iter if phase == phase0 else 0
        if params.checkpoint_interval > 0 and not params.subset_indices:
            it = it0
            while it < config.n_iterations:
                stop = min(it + params.checkpoint_interval, config.n_iterations)
                state, stats = _run_span(engine, state, stats, seed_key,
                                         phase, it, stop,
                                         progress_cb=progress_cb)
                it = stop
                if it < config.n_iterations or phase == EQUILIBRATION:
                    ckpt.save_checkpoint(params.checkpoint_out_file, engine,
                                         state, stats, phase, it, seed)
        else:
            state, stats = engine.run_phase(state, stats, seed_key, phase,
                                            it0, progress_cb=progress_cb)
        if params.debug_checks:
            from .utils.debug import check_state
            check_state(jax.device_get(state), config.n_patterns)

    stats = jax.device_get(stats)
    state = jax.device_get(state)
    elapsed = time.time() - start

    # the fixed matrix accumulates no statistics, so its mean/sd stay zero —
    # matching the reference exactly (tests/testthat/test_fixed_matrix.R:29,
    # 66: "expect all 0s in the fixed P matrix"); the fixed values are kept
    # in diagnostics for convenience.
    amean, asd, pmean, psd = finalize_statistics(
        stats.a_sum, stats.a_sumsq, stats.p_sum, stats.p_sumsq, stats.n_stat)

    # meanChiSq is zeroed for fixed-matrix runs (GapsRunner.cpp:478-485)
    if params.which_matrix_fixed != "N":
        mcs = 0.0
    else:
        if is_coo:
            # closed-form meanChiSq over the nonzeros — never densify
            # (reference formula: GapsStatistics.cpp:88-111)
            from .models import sparse as sparse_model
            mcs = float(sparse_model.sparse_chisq(
                engine.data.ell_a, jnp_asarray(amean), jnp_asarray(pmean)))
        else:
            S = (np.asarray(uncertainty, np.float32)
                 if uncertainty is not None
                 else dense.default_uncertainty(D))
            if params.sparse_optimization:
                # implied uncertainty (GapsStatistics.cpp:106)
                S = np.maximum(0.1 * D, 0.1)
            mcs = mean_chi_sq(amean, pmean, D, S)

    total_updates = int(stats.upd_hi) * (1 << 30) + int(stats.upd_lo)
    # sampler observability (SURVEY §5): proposal/acceptance counts by
    # type and survivors-per-sweep — the averageQueueLength analog
    # (reference: src/Cogaps.cpp:177-180)
    prop = np.asarray(stats.prop_counts, np.int64)
    acc = np.asarray(stats.acc_counts, np.int64)
    sw = np.asarray(stats.sweep_counts, np.int64)
    types = ("birth", "death", "move", "exchange")
    n_hist = stats.chisq_hist.shape[0]
    diagnostics = {
        "chisqHistory": np.asarray(stats.chisq_hist),
        "atomHistoryA": np.asarray(stats.atom_hist_a),
        "atomHistoryP": np.asarray(stats.atom_hist_p),
        "totalUpdates": total_updates,
        "totalRunningTime": elapsed,
        "seed": seed,
        "meanChiSq": mcs,
        "nStatUpdates": int(stats.n_stat),
        "equilibrationSnapshotsA": np.asarray(
            stats.snap_a[:stats.snap_a.shape[0] // 2]),
        "equilibrationSnapshotsP": np.asarray(
            stats.snap_p[:stats.snap_p.shape[0] // 2]),
        "samplingSnapshotsA": np.asarray(
            stats.snap_a[stats.snap_a.shape[0] // 2:]),
        "samplingSnapshotsP": np.asarray(
            stats.snap_p[stats.snap_p.shape[0] // 2:]),
        "proposalCounts": {
            m: dict(zip(types, prop[i].tolist()))
            for i, m in enumerate(("A", "P"))},
        "acceptanceRates": {
            m: dict(zip(types,
                        (acc[i] / np.maximum(prop[i], 1)).round(4).tolist()))
            for i, m in enumerate(("A", "P"))},
        "sweepCounts": {"A": int(sw[0]), "P": int(sw[1])},
        "averageQueueLengthA": float(prop[0].sum() / max(int(sw[0]), 1)),
        "averageQueueLengthP": float(prop[1].sum() / max(int(sw[1]), 1)),
    }
    if params.take_pump_samples:
        diagnostics["pumpMatrix"] = (
            np.asarray(stats.pump) / max(int(stats.n_pump), 1))
        # meanPatternAssignment: one-hot argmax of Amean
        # (reference: GapsStatistics.cpp:119-131)
        mpa = np.zeros_like(amean)
        mpa[np.arange(amean.shape[0]), np.argmax(amean, axis=1)] = 1.0
        diagnostics["meanPatternAssignment"] = mpa
    if params.which_matrix_fixed != "N":
        diagnostics["fixedPatterns"] = np.asarray(params.fixed_patterns,
                                                  np.float32)
        diagnostics["whichMatrixFixed"] = params.which_matrix_fixed
    del n_hist

    if params.running_distributed:
        log_worker(params.worker_id, f"is finished! Time: {elapsed:.1f}s")
    elif params.print_messages:
        log_message(f"meanChiSq: {mcs:.1f}, totalUpdates: {total_updates}, "
                    f"time: {elapsed:.1f}s")

    diagnostics["params"] = params
    pattern_names = [f"Pattern_{i+1}" for i in range(config.n_patterns)]
    return CogapsResult(
        Amean=np.asarray(amean, np.float32), Asd=np.asarray(asd, np.float32),
        Pmean=np.asarray(pmean, np.float32), Psd=np.asarray(psd, np.float32),
        mean_chi_sq=mcs, gene_names=gene_names, sample_names=sample_names,
        pattern_names=pattern_names, diagnostics=diagnostics)


def _run_span(engine, state, stats, seed_key, phase, start, stop,
              progress_cb=None):
    """Run iterations [start, stop) of one phase (checkpoint chunking)."""
    return engine.run_span(state, stats, seed_key, phase, start, stop,
                           progress_cb=progress_cb)


def _fmt_hms(seconds: float) -> str:
    s = max(int(seconds), 0)
    return f"{s // 3600:02d}:{(s % 3600) // 60:02d}:{s % 60:02d}"


def _make_progress(engine, params: CogapsParams, config, t0: float):
    """Live status line once per dispatch span — the analog of the
    reference's per-outputFrequency display with elapsed/ETA
    (reference: src/GapsRunner.cpp:130-199). Host-side only; disabled
    (returning None) when messages are off or outputFrequency is 0, so
    benchmarked runs pay nothing."""
    if (not params.print_messages or params.output_frequency <= 0
            or params.running_distributed):
        return None
    total = 2 * config.n_iterations

    def cb(phase, iter_end, state):
        done = phase * config.n_iterations + iter_end
        frac = done / total
        elapsed = time.time() - t0
        est = elapsed / frac if frac > 0 else 0.0
        cs = engine.chisq(state)
        n_a = int(state.atoms_a.n)
        n_p = int(state.atoms_p.n)
        name = "equilibration" if phase == EQUILIBRATION else "sampling"
        log_message(
            f"{iter_end} of {config.n_iterations}, Atoms: {n_a}({n_p}),"
            f" ChiSq: {cs:.0f}, time: {_fmt_hms(elapsed)} /"
            f" {_fmt_hms(est)} [{name}]")

    return cb


def scCoGAPS(data, params=None, **kwargs) -> CogapsResult:
    """Single-cell CoGAPS: distributed across cell subsets
    (reference: R/CoGAPS.R:173-211)."""
    params = dataclasses.replace(params) if params is not None else CogapsParams()
    params.distributed = "single-cell"
    kwargs.setdefault("sparse_optimization", True)
    return CoGAPS(data, params, **kwargs)


def GWCoGAPS(data, params=None, **kwargs) -> CogapsResult:
    """Genome-wide CoGAPS: distributed across gene subsets
    (reference: R/CoGAPS.R:213-236)."""
    params = dataclasses.replace(params) if params is not None else CogapsParams()
    params.distributed = "genome-wide"
    return CoGAPS(data, params, **kwargs)
