"""Golden validation against the reference's own shipped results.

The reference distributes precomputed results exactly so output can be
compared (reference: data/modsimresult.rda — a converged 50k-iteration
CogapsResult on modsimdata; data/GIST.RData — GIST.result on the GIST
matrix). data/modsim.npz and data/gist.npz vendor those via the
pure-Python RData reader (cogaps_tpu/io/rdata.py). These tests are the
external check on the sweep's proposal-kernel design deltas
(ops/sweep.py module docstring): if the sampler's equilibrium drifts
from the reference's, they fail.
"""

import os

import numpy as np
import pytest

from cogaps_tpu import CoGAPS

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def best_perm_corr(ours: np.ndarray, golden: np.ndarray) -> np.ndarray:
    """Greedy best-match correlation per golden pattern (patterns are
    exchangeable across runs)."""
    k = golden.shape[1]
    cors = np.zeros((k, k))
    for i in range(k):
        for j in range(k):
            cors[i, j] = np.corrcoef(golden[:, i], ours[:, j])[0, 1]
    out = []
    used = set()
    for i in range(k):
        order = np.argsort(-cors[i])
        j = next(jj for jj in order if jj not in used)
        used.add(j)
        out.append(cors[i, j])
    return np.asarray(out)


@pytest.fixture(scope="module")
def modsim_golden():
    z = np.load(os.path.join(DATA, "modsim.npz"))
    return {k: np.asarray(z[k]) for k in z}


def test_modsim_golden_equilibrium(modsim_golden):
    """meanChiSq and the equilibrium chi^2 level must match the
    reference's converged modsim run within MCMC variance (reference
    golden: meanChiSq 38.7, chisq history plateau ~130-140)."""
    g = modsim_golden
    res = CoGAPS(g["D"], n_patterns=3, n_iterations=1500, seed=7,
                 messages=False, output_frequency=150)
    golden_mcs = float(g["golden_meanChiSq"].reshape(-1)[0])
    golden_eq = float(np.mean(g["golden_chisqHistory"][2:]))
    hist = res.diagnostics["chisqHistory"]
    ours_eq = float(np.mean(hist[len(hist) // 2:]))
    # measured band (round 4): ours_eq/golden_eq over 4 seeds at 1500
    # iterations spans [0.80, 1.08] (the golden plateau's own within-run
    # sd is ~4%); [0.6, 1.35] is ~4 sigma of that spread and would catch
    # any likelihood mis-weighting of >35%
    assert 0.6 * golden_eq < ours_eq < 1.35 * golden_eq, (ours_eq,
                                                          golden_eq)
    # meanChiSq (chi^2 of the posterior mean) is mode-dependent on this
    # multimodal toy: measured seed spread [0.13, 1.26] x golden
    assert res.mean_chi_sq < 1.8 * golden_mcs, (res.mean_chi_sq,
                                                golden_mcs)
    # atom counts in the same regime as the reference (~70 A / ~40 P)
    n_a = res.diagnostics["atomHistoryA"][-1]
    n_p = res.diagnostics["atomHistoryP"][-1]
    assert 10 <= n_a <= 10 * np.mean(g["golden_atomsA"])
    assert 5 <= n_p <= 10 * np.mean(g["golden_atomsP"])


def test_modsim_golden_pattern_recovery(modsim_golden):
    """The recovered P patterns must correlate with the reference's
    converged sampleFactors (pattern identity is exchangeable; compare
    under best matching). The 25x20 toy posterior is multimodal —
    individual seeds occasionally converge to a different (sometimes
    lower-chi^2) mode — so recovery must hold for at least one of two
    seeds, and every run must reach the reference's chi^2 band."""
    g = modsim_golden
    golden_mcs = float(g["golden_meanChiSq"].reshape(-1)[0])
    best = None
    for seed in (12, 11):
        res = CoGAPS(g["D"], n_patterns=3, n_iterations=3000, seed=seed,
                     messages=False)
        # meanChiSq lands in the reference's converged band (38.7) for
        # EVERY seed — fit quality is not mode-dependent
        assert res.mean_chi_sq < 2.0 * golden_mcs
        cors = best_perm_corr(res.Pmean, g["golden_Pmean"])
        cors_a = best_perm_corr(res.Amean, g["golden_Amean"])
        best = max(best or 0.0, float(min(cors.min(), cors_a.min())))
        if (cors > 0.75).all() and (cors_a > 0.7).all():
            return
    raise AssertionError(
        f"no seed recovered all reference patterns (best min-corr "
        f"{best:.3f})")


@pytest.mark.slow
def test_gist_golden_pattern_recovery():
    """GIST: factorization quality and pattern recovery against the
    reference's shipped GIST.result (data/GIST.RData — a k=3
    default-uncertainty run: its factors reproduce meanChiSq 4474 under
    the default weighting exactly; chisq plateau ~6550)."""
    z = np.load(os.path.join(DATA, "gist.npz"))
    k = int(np.asarray(z["golden_Pmean"]).shape[1])
    res = CoGAPS(np.asarray(z["D"]), n_patterns=k, n_iterations=1500,
                 seed=3, messages=False, output_frequency=250)
    golden_eq = float(np.mean(np.asarray(z["golden_chisqHistory"])[2:]))
    hist = res.diagnostics["chisqHistory"]
    ours_eq = float(np.mean(hist[3 * len(hist) // 4:]))
    # measured band (round 4): ours_eq/golden_eq = 1.016-1.017 across
    # seeds — the GIST plateau is tight; 1.15x is ~10x the observed
    # spread and would catch a ~15% likelihood mis-weighting
    assert ours_eq < 1.15 * golden_eq, (ours_eq, golden_eq)
    golden_mcs = float(np.asarray(z["golden_meanChiSq"]).reshape(-1)[0])
    # measured: 1.07-1.11 x golden across seeds
    assert res.mean_chi_sq < 1.4 * golden_mcs
    cors = best_perm_corr(res.Pmean, np.asarray(z["golden_Pmean"]))
    assert np.median(cors) > 0.8, cors
    assert (cors > 0.5).all(), cors


@pytest.mark.slow
def test_gist_custom_uncertainty_converges():
    """GIST with the reference's shipped GIST.uncertainty (min ~3e-5 —
    the sharp-posterior regime: invS2 up to ~1e9). No reference
    trajectory exists for this config (the shipped GIST.result is a
    default-uncertainty run), so the oracle is convergence itself:
    chi^2 must descend to the chi^2/N ~ 1 regime, which requires the
    local move window (global-uniform moves mix too slowly here —
    reference move semantics:
    SingleThreadedGibbsSampler.h:192-223)."""
    z = np.load(os.path.join(DATA, "gist.npz"))
    D, U = np.asarray(z["D"]), np.asarray(z["uncertainty"])
    res = CoGAPS(D, n_patterns=7, n_iterations=3000, seed=42,
                 uncertainty=U, messages=False, output_frequency=500)
    h = np.asarray(res.diagnostics["chisqHistory"], np.float64)
    n_pts = D.size
    # descent: the sampling-phase plateau must sit far below the early
    # equilibration level, and in the converged chi^2/N band
    assert h[-1] < 0.6 * h[0], h
    assert h[-1] / n_pts < 2.0, (h[-1], n_pts)
    assert res.mean_chi_sq / n_pts < 2.0
