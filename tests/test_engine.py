"""Engine invariants — the analog of the reference's debug-build race
detectors and consistency asserts (maximumDrift, isSorted —
AsynchronousGibbsSampler.h:119-121,237-270) plus the seed-determinism
contract (tests/testthat/test_seed_consistency.R)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cogaps_tpu.engine import EQUILIBRATION, SAMPLING, GapsEngine
from cogaps_tpu.models import dense
from cogaps_tpu.ops.atoms import total_mass_per_element
from cogaps_tpu.params import CogapsParams


def _run(D, n_iterations=200, seed=7, rebuild_interval=0, **kw):
    params = CogapsParams(n_patterns=3, n_iterations=n_iterations, seed=seed,
                          rebuild_interval=rebuild_interval, **kw)
    cfg = params.engine_config(*D.shape)
    eng = GapsEngine(D, None, cfg)
    state, stats = eng.init_state(), eng.init_stats()
    key = jax.random.PRNGKey(seed)
    state, stats = eng.run_phase(state, stats, key, EQUILIBRATION)
    state, stats = eng.run_phase(state, stats, key, SAMPLING)
    return eng, state, stats


def test_atom_mass_drift(modsim):
    """Sum of atom masses per element must track the factor matrices within
    the reference's drift tolerance 0.01 (AsynchronousGibbsSampler.h:120)."""
    D, _, _ = modsim
    eng, state, _ = _run(D)
    ma = total_mass_per_element(state.atoms_a, D.shape[0] * 3).reshape(-1, 3)
    mp = total_mass_per_element(state.atoms_p, D.shape[1] * 3).reshape(-1, 3)
    assert float(jnp.max(jnp.abs(ma - state.M_a))) < 0.01
    assert float(jnp.max(jnp.abs(mp - state.M_p))) < 0.01


def test_compact_table_invariant(modsim):
    """The sweep must keep the atom tables compact (live atoms in slots
    [0, n) — ops/atoms.py); selection correctness depends on it."""
    D, _, _ = modsim
    _, state, _ = _run(D)
    for atoms in (state.atoms_a, state.atoms_p):
        elem = np.asarray(atoms.elem)
        n = int(atoms.n)
        assert (elem[:n] >= 0).all()
        assert (elem[n:] == -1).all()


def test_atom_table_invariants(modsim):
    """Hole-based atom table (ops/atoms.py): the live count must equal the
    number of live slots, live atoms carry positive mass, dead slots none."""
    D, _, _ = modsim
    _, state, _ = _run(D)
    for at in (state.atoms_a, state.atoms_p):
        n = int(at.n)
        live = np.asarray(at.elem) >= 0
        assert n == int(live.sum())
        mass = np.asarray(at.mass)
        assert float(mass[live].min()) > 0.0
        assert not live.any() or float(np.abs(mass[~live]).max()) == 0.0


def test_nonnegativity(modsim):
    D, _, _ = modsim
    _, state, stats = _run(D)
    assert float(state.M_a.min()) >= 0
    assert float(state.M_p.min()) >= 0
    assert float(stats.a_sum.min()) >= 0
    assert float(stats.p_sum.min()) >= 0


def test_seed_determinism(modsim):
    """Same seed => bit-identical results (the analog of the
    reference's nThreads-invariance contract,
    tests/testthat/test_seed_consistency.R:36-68)."""
    D, _, _ = modsim
    _, s1, st1 = _run(D, seed=11)
    _, s2, st2 = _run(D, seed=11)
    assert bool(jnp.array_equal(s1.M_a, s2.M_a))
    assert bool(jnp.array_equal(s1.M_p, s2.M_p))
    assert bool(jnp.array_equal(st1.a_sum, st2.a_sum))
    assert bool(jnp.array_equal(st1.chisq_hist, st2.chisq_hist))
    assert bool(jnp.array_equal(st1.atom_hist_a, st2.atom_hist_a))


def test_different_seeds_differ(modsim):
    D, _, _ = modsim
    _, s1, _ = _run(D, seed=11)
    _, s2, _ = _run(D, seed=12)
    assert not bool(jnp.array_equal(s1.M_a, s2.M_a))


def test_chisq_decreases(modsim):
    """The annealed chain must fit the data: chi^2 trajectory decreases
    substantially from its early value."""
    D, _, _ = modsim
    _, _, stats = _run(D, n_iterations=400, output_frequency=100)
    hist = np.asarray(stats.chisq_hist)
    assert hist[0] > 0
    assert hist[-1] < 0.5 * hist[0]


def test_y_cache_consistency(modsim):
    """The incrementally maintained conditional-mean table Y must track
    its exact rebuild across a full update call — the analog of the
    AP-cache consistency the reference asserts in debug builds
    (AsynchronousGibbsSampler.h:119-121)."""
    import jax
    from cogaps_tpu.ops.sweep import run_updates
    D, _, _ = modsim
    eng, state, _ = _run(D, n_iterations=50, seed=5)
    phase = dense.make_phase(eng.data.invS2, state.M_p)
    model = dense.make_model(phase, eng.data.invS2)
    cache = dense.rebuild_cache(eng.data.D, eng.data.invS2,
                                state.M_a, state.M_p)
    atoms, M_a, cache, done, _, _ = run_updates(
        jax.random.PRNGKey(9), state.atoms_a, state.M_a, cache,
        jnp.float32(1.0), jnp.asarray(500, jnp.int32), eng.consts_a,
        eng.data.mass_a, model=model)
    assert int(done) == 500
    exact = dense.rebuild_cache(eng.data.D, eng.data.invS2, M_a, state.M_p)
    assert float(jnp.max(jnp.abs(exact.Y - cache.Y))) < 0.05


def test_annealing_temp_zero_start(modsim):
    """At equilibration iteration 0 the temperature is 0 (prior-only moves,
    reference: GapsRunner.cpp:285-291) — the run must still be finite and
    non-negative."""
    D, _, _ = modsim
    params = CogapsParams(n_patterns=3, n_iterations=4, seed=1)
    cfg = params.engine_config(*D.shape)
    eng = GapsEngine(D, None, cfg)
    state, stats = eng.init_state(), eng.init_stats()
    state, stats = eng.run_phase(state, stats, jax.random.PRNGKey(1),
                                 EQUILIBRATION)
    assert np.isfinite(np.asarray(state.M_a)).all()
    assert float(state.M_a.min()) >= 0


@pytest.mark.parametrize("batch", [16, 64, 256])
def test_batch_sizes_all_converge(modsim, batch):
    """Sweep width is a performance knob, not a semantics knob: every batch
    size must converge to a comparable fit."""
    D, _, _ = modsim
    _, state, stats = _run(D, n_iterations=300, seed=3,
                           batch_size_a=batch, batch_size_p=batch,
                           output_frequency=100)
    hist = np.asarray(stats.chisq_hist)
    assert hist[-1] < 0.5 * hist[0]


def test_trunc_gamma2_inversion():
    """trunc_gamma2_y inverts the shape-2 gamma CDF on [0, b]:
    h(y(u)) == u * upper within fp tolerance (the same-bin exchange
    redistribution draw, reference: Random.cpp:194-200)."""
    import jax.numpy as jnp
    from cogaps_tpu.ops import rng as gaps_rng

    u = jnp.linspace(0.001, 0.999, 101, dtype=jnp.float32)
    for b in (0.05, 0.7, 3.0, 25.0):
        y = gaps_rng.trunc_gamma2_y(u, jnp.float32(b))
        h = 1.0 - jnp.exp(-y) * (1.0 + y)
        upper = 1.0 - np.exp(-b) * (1.0 + b)
        np.testing.assert_allclose(np.asarray(h), np.asarray(u) * upper,
                                   rtol=2e-4, atol=2e-6)
        assert float(y.max()) <= b + 1e-5
