"""Update-budget draw equivalence.

The engine fast paths draw the per-iteration update budget with a
normal approximation (`ops/rng.poisson_fast`) instead of an exact
Poisson (reference draw: src/GapsRunner.cpp:293-296). The argued
justification — the budget sets how much work an iteration does, not
the chain's stationary distribution, so ANY positive budget sequence
leaves the sampler exact — is pinned here: equilibrium chi^2 under
exact and approximate budgets must agree within MCMC seed variance.
"""

import jax
import numpy as np

import cogaps_tpu.engine as engine_mod
from cogaps_tpu.engine import EQUILIBRATION, SAMPLING, GapsEngine
from cogaps_tpu.ops import rng as gaps_rng
from cogaps_tpu.params import CogapsParams


def _equilibrium_chisq(D, seeds, n_iterations=800):
    out = []
    for seed in seeds:
        params = CogapsParams(n_patterns=3, n_iterations=n_iterations,
                              seed=seed, output_frequency=0)
        cfg = params.engine_config(*D.shape)
        eng = GapsEngine(D, None, cfg)
        state, stats = eng.init_state(), eng.init_stats()
        key = jax.random.PRNGKey(seed)
        state, stats = eng.run_phase(state, stats, key, EQUILIBRATION)
        state, stats = eng.run_phase(state, stats, key, SAMPLING)
        out.append(eng.chisq(state))
    return np.asarray(out)


def test_poisson_fast_budget_matches_exact(modsim, monkeypatch):
    D, _, _ = modsim
    seeds = [0, 1, 2, 3]

    fast = _equilibrium_chisq(D, seeds)

    # swap in the exact Poisson draw; module-level jits cache by static
    # config, so clear them to force a re-trace under the patch
    monkeypatch.setattr(gaps_rng, "poisson_fast", gaps_rng.poisson)
    engine_mod._jit_phase_span.clear_cache()
    try:
        exact = _equilibrium_chisq(D, seeds)
    finally:
        engine_mod._jit_phase_span.clear_cache()

    # budgets only schedule work: equilibria must agree within seed
    # variance (fractional band chosen ~3x the observed seed spread)
    assert np.isfinite(fast).all() and np.isfinite(exact).all()
    rel = abs(fast.mean() - exact.mean()) / exact.mean()
    # measured seed CV at 800 iterations is ~11% => SEM of the mean
    # difference ~8%; 0.25 is a >3-sigma band
    assert rel < 0.25, (fast, exact)
