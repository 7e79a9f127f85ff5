"""Throughput measurement harness used by bench.py.

Runs C independent vmapped chains of the dense engine (the per-chip
deployment configuration: independent MCMC chains amortize small-matrix
dispatch, exactly how production capacity is used — GWCoGAPS runs 4+
parallel chains, reference: R/DistributedCogaps.R:56-67) and reports
aggregate Gibbs atom-updates/sec/chip plus the converged meanChiSq of
chain 0.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .params import CogapsParams


def run_throughput(D: np.ndarray, params: CogapsParams, n_chains: int = 16,
                   uncertainty: Optional[np.ndarray] = None) -> dict:
    import jax
    import jax.numpy as jnp

    from .engine import EQUILIBRATION, SAMPLING
    from .parallel.multichain import MultichainEngine, stack_device_data
    from .result import finalize_statistics, mean_chi_sq
    from .models import dense

    D = np.asarray(D, np.float32)
    cfg = params.engine_config(*D.shape)
    data = stack_device_data([D] * n_chains,
                             [uncertainty] * n_chains
                             if uncertainty is not None else None, cfg)
    eng = MultichainEngine(data, cfg)
    keys = jax.vmap(jax.random.PRNGKey)(
        jnp.arange(n_chains) + params.resolved_seed())

    def full_run():
        state, stats = eng.init_state(), eng.init_stats()
        state, stats = eng.run_phase(state, stats, keys, EQUILIBRATION)
        state, stats = eng.run_phase(state, stats, keys, SAMPLING)
        return jax.block_until_ready((state, stats))

    # warmup: absorb compilation of both phase programs (one program per
    # phase, shared by every dispatch span)
    wu_stop = min(cfg.dispatch_iters, params.n_iterations)
    st, ss = eng.init_state(), eng.init_stats()
    st, ss = eng.run_phase(st, ss, keys, EQUILIBRATION, 0, wu_stop)
    st, ss = eng.run_phase(st, ss, keys, SAMPLING, 0, wu_stop)
    jax.block_until_ready((st, ss))

    t0 = time.perf_counter()
    state, stats = full_run()
    elapsed = time.perf_counter() - t0
    stats_h = jax.device_get(stats)
    total_updates = (int(np.sum(stats_h.upd_hi.astype(np.int64))) * (1 << 30)
                     + int(np.sum(stats_h.upd_lo.astype(np.int64))))

    amean, _, pmean, _ = finalize_statistics(
        np.asarray(stats_h.a_sum[0]), np.asarray(stats_h.a_sumsq[0]),
        np.asarray(stats_h.p_sum[0]), np.asarray(stats_h.p_sumsq[0]),
        int(stats_h.n_stat[0]))
    S = (np.asarray(uncertainty, np.float32) if uncertainty is not None
         else dense.default_uncertainty(D))
    mcs = mean_chi_sq(amean, pmean, D, S)

    return {
        "updates_per_second": total_updates / elapsed,
        "total_updates": total_updates,
        "elapsed_s": elapsed,
        "n_chains": n_chains,
        "mean_chi_sq": mcs,
    }
