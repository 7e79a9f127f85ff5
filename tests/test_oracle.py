"""Batched-engine equilibrium vs the sequential reference-exact oracle.

The oracle (cogaps_tpu/oracle.py) mirrors the reference's sequential
sampler proposal-by-proposal — neighbor-bounded moves, successor
exchanges, per-proposal alpha evaluation. The batched engine
re-designs all three (local move windows, uniform exchange partners,
sweep-start alphas with first-wins conflicts). These tests pin that the
re-design leaves the EQUILIBRIUM unchanged: chi^2 and atom counts agree
between the two samplers within seed variance — a far sharper oracle
than the wide golden-result bands (tests/test_golden.py).
"""

import jax
import numpy as np
import pytest

from cogaps_tpu.engine import EQUILIBRATION, SAMPLING, GapsEngine
from cogaps_tpu.oracle import SequentialOracle
from cogaps_tpu.params import CogapsParams


def _engine_equilibrium(D, seed, n_iterations):
    params = CogapsParams(n_patterns=3, n_iterations=n_iterations,
                          seed=seed, output_frequency=0)
    cfg = params.engine_config(*D.shape)
    eng = GapsEngine(D, None, cfg)
    state, stats = eng.init_state(), eng.init_stats()
    key = jax.random.PRNGKey(seed)
    state, stats = eng.run_phase(state, stats, key, EQUILIBRATION)
    state, stats = eng.run_phase(state, stats, key, SAMPLING)
    return (eng.chisq(state), int(state.atoms_a.n), int(state.atoms_p.n))


def test_oracle_self_consistency(modsim):
    """The oracle itself must factorize modsim (sanity before it can
    judge anything)."""
    D, _, _ = modsim
    orc = SequentialOracle(D, k=3, seed=0).run(300, record_every=100)
    hist = np.asarray(orc.chisq_hist)
    zero_model = float(np.sum((D / np.maximum(0.1 * D, 0.1)) ** 2))
    assert hist[-1] < 0.05 * zero_model
    # cache consistency: AP == M_a @ M_p^T
    ap = orc.M_a @ orc.M_p.T
    np.testing.assert_allclose(orc.model_a.AP, ap, rtol=1e-3, atol=1e-3)


@pytest.mark.slow
def test_engine_matches_sequential_oracle(modsim):
    """Equilibrium chi^2 and atom counts: batched engine vs sequential
    oracle over several seeds on modsim (25x20, k=3)."""
    D, _, _ = modsim
    n_it = 600
    seeds = [0, 1, 2, 3]

    orc_cs, orc_na, orc_np_ = [], [], []
    for s in seeds:
        orc = SequentialOracle(D, k=3, seed=s).run(n_it)
        orc_cs.append(orc.chisq())
        orc_na.append(orc.dom_a.size())
        orc_np_.append(orc.dom_p.size())

    eng = [_engine_equilibrium(D, s, n_it) for s in seeds]
    eng_cs = [e[0] for e in eng]
    eng_na = [e[1] for e in eng]
    eng_np_ = [e[2] for e in eng]

    # chi^2: mean equilibria within 25% (measured seed CV ~11%)
    assert abs(np.mean(eng_cs) - np.mean(orc_cs)) < 0.25 * np.mean(orc_cs), (
        eng_cs, orc_cs)
    # atom counts: means within 30%
    assert abs(np.mean(eng_na) - np.mean(orc_na)) < 0.3 * np.mean(orc_na), (
        eng_na, orc_na)
    assert abs(np.mean(eng_np_) - np.mean(orc_np_)) < 0.3 * np.mean(orc_np_), (
        eng_np_, orc_np_)
