"""Sparse-model tests — the analog of the reference's
testSparseGibbsSampler.cpp (sparse-vs-dense alphaParameters equivalence)
and test_output_across_modes.R."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cogaps_tpu import CoGAPS
from cogaps_tpu.models import dense, sparse


@pytest.fixture(scope="module")
def sparse_data():
    """Sparse data whose zeros are CONSISTENT with a rank-3 nonnegative
    factorization (sparse factors => structural zeros in the product).
    Zeroing a dense product post-hoc instead makes the zeros unfittable
    under the sparse model's implied uncertainty S=0.1 on zeros — both
    dense and sparse engines then plateau far above the noise floor, so
    convergence assertions would test the data, not the sampler."""
    rng = np.random.default_rng(5)
    A = (rng.gamma(2.0, 1.0, (30, 3)) * (rng.random((30, 3)) < 0.45)
         ).astype(np.float32)
    P = (rng.gamma(2.0, 1.0, (20, 3)) * (rng.random((20, 3)) < 0.45)
         ).astype(np.float32)
    D = (A @ P.T).astype(np.float32)
    assert 0.3 < (D == 0).mean() < 0.8
    return D


def test_ell_roundtrip(sparse_data):
    ell = sparse.to_ell(sparse_data)
    rebuilt = np.zeros_like(sparse_data)
    idx = np.asarray(ell.idx)
    val = np.asarray(ell.val)
    for r in range(sparse_data.shape[0]):
        m = idx[r] >= 0
        rebuilt[r, idx[r][m]] = val[r][m]
    np.testing.assert_array_equal(rebuilt, sparse_data)


def test_coo_to_ell_matches_dense(sparse_data):
    rows, cols = np.nonzero(sparse_data)
    vals = sparse_data[rows, cols]
    e1 = sparse.coo_to_ell(rows.astype(np.int32), cols.astype(np.int32),
                           vals, sparse_data.shape[0])
    e2 = sparse.to_ell(sparse_data)
    np.testing.assert_array_equal(np.asarray(e1.idx), np.asarray(e2.idx))
    np.testing.assert_array_equal(np.asarray(e1.val), np.asarray(e2.val))


def test_sparse_alpha_matches_dense(sparse_data):
    """The sparse closed-form alphaParameters must equal the dense ones
    computed with the implied uncertainty S = 0.1*D (no floor on nonzeros)
    — the reference's testSparseGibbsSampler.cpp oracle."""
    D = sparse_data
    rng = np.random.default_rng(7)
    k = 3
    M = jnp.asarray(rng.gamma(1.0, 1.0, (D.shape[0], k)), jnp.float32)
    other = jnp.asarray(rng.gamma(1.0, 1.0, (D.shape[1], k)), jnp.float32)

    # dense with implied uncertainty: S = 0.1*D nonzero, 0.1 at zeros
    S = np.where(D > 0, 0.1 * D, 0.1).astype(np.float32)
    invS2 = jnp.asarray(1.0 / (S * S))
    dphase = dense.make_phase(invS2, other)
    dcache = dense.rebuild_cache(jnp.asarray(D), invS2, M, other)

    B = 64
    r1 = jnp.asarray(rng.integers(0, D.shape[0], B), jnp.int32)
    c1 = jnp.asarray(rng.integers(0, k, B), jnp.int32)
    r2 = jnp.asarray(rng.integers(0, D.shape[0], B), jnp.int32)
    c2 = jnp.asarray(rng.integers(0, k, B), jnp.int32)
    # include guaranteed same-row pairs
    r2 = r2.at[:16].set(r1[:16])

    from cogaps_tpu.ops.sweep import make_addr
    addr = make_addr(r1, c1, r2, c2, D.shape[0], k)
    d_ab = dense.alpha_batch(dcache, dphase, invS2, addr)
    smodel = sparse.make_model(sparse.to_ell(D), sparse.make_sparse_phase(other))
    s_ab = smodel.alpha((), M, addr)

    # atol absorbs fp cancellation noise on exact-zero (same-element) pairs;
    # values are O(1e3), so atol=0.1 is still a strict check
    np.testing.assert_allclose(np.asarray(s_ab.s1), np.asarray(d_ab.s1),
                               rtol=2e-3, atol=0.1)
    np.testing.assert_allclose(np.asarray(s_ab.smu1), np.asarray(d_ab.smu1),
                               rtol=2e-3, atol=0.1)
    np.testing.assert_allclose(np.asarray(s_ab.s_pair),
                               np.asarray(d_ab.s_pair), rtol=2e-3, atol=0.1)
    np.testing.assert_allclose(np.asarray(s_ab.smu_pair),
                               np.asarray(d_ab.smu_pair), rtol=2e-3, atol=0.1)


def test_sparse_chisq_matches_dense_formula(sparse_data):
    D = sparse_data
    rng = np.random.default_rng(11)
    M_a = jnp.asarray(rng.gamma(1.0, 1.0, (D.shape[0], 3)), jnp.float32)
    M_p = jnp.asarray(rng.gamma(1.0, 1.0, (D.shape[1], 3)), jnp.float32)
    got = float(sparse.sparse_chisq(sparse.to_ell(D), M_a, M_p))
    S = np.where(D > 0, 0.1 * D, 0.1).astype(np.float32)
    ap = np.asarray(M_a) @ np.asarray(M_p).T
    want = float(np.sum(((D - ap) / S) ** 2))
    assert got == pytest.approx(want, rel=1e-3)


def test_sparse_run_converges(sparse_data):
    res = CoGAPS(sparse_data, n_patterns=3, n_iterations=300, seed=1,
                 messages=False, sparse_optimization=True,
                 output_frequency=100)
    h = res.diagnostics["chisqHistory"]
    assert h[-1] < 0.2 * h[0]
    assert res.Amean.shape == (30, 3)
    assert (res.Amean >= 0).all()


def test_sparse_same_shape_as_dense(sparse_data):
    """test_output_across_modes.R: dense and sparse produce same-shape
    results on the same data."""
    r1 = CoGAPS(sparse_data, n_patterns=2, n_iterations=60, seed=1,
                messages=False)
    r2 = CoGAPS(sparse_data, n_patterns=2, n_iterations=60, seed=1,
                messages=False, sparse_optimization=True)
    assert r1.Amean.shape == r2.Amean.shape
    assert r1.Pmean.shape == r2.Pmean.shape


def test_sparse_rejects_custom_uncertainty(sparse_data):
    with pytest.raises(ValueError):
        CoGAPS(sparse_data, n_patterns=3, n_iterations=10, messages=False,
               sparse_optimization=True,
               uncertainty=np.full_like(sparse_data, 0.5))


def _avals(jaxpr):
    """Every intermediate's abstract value, through nested jaxprs."""
    for eqn in jaxpr.eqns:
        yield from (v.aval for v in eqn.outvars)
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    yield from _avals(sub)


def test_sparse_ell_mode_end_to_end():
    """A sparse run never builds a dense (genes x samples) array: not in
    the engine's device data, not in any intermediate of the traced
    phase program — and it still factorizes soundly end to end."""
    from cogaps_tpu.engine import EQUILIBRATION, SAMPLING
    from cogaps_tpu.params import CogapsParams
    from cogaps_tpu.sparse_engine import SparseGapsEngine, _sparse_phase_span

    rng = np.random.default_rng(4)
    G_, S_, k = 37, 23, 3
    A = rng.gamma(2.0, 1.0, (G_, k)) * (rng.random((G_, k)) < 0.5)
    P = rng.gamma(2.0, 1.0, (S_, k)) * (rng.random((S_, k)) < 0.5)
    D = (A @ P.T).astype(np.float32)
    # no fully dense row or column, so no ELL width equals G or S
    assert (D > 0).sum(1).max() < S_ and (D > 0).sum(0).max() < G_
    params = CogapsParams(n_patterns=k, n_iterations=200, seed=3,
                          output_frequency=50)
    eng = SparseGapsEngine(D, params.engine_config(G_, S_))

    def is_dense(shape):
        return G_ in shape and S_ in shape

    assert not any(is_dense(x.shape) for x in jax.tree.leaves(eng.data))
    st, ss = eng.init_state(), eng.init_stats()
    key = jax.random.PRNGKey(3)
    closed = jax.make_jaxpr(_sparse_phase_span, static_argnums=(0, 1, 2, 3, 4))(
        eng.config, eng.consts_a, eng.consts_p, eng.hist, SAMPLING,
        eng.data, st, ss, key, 0, 2)
    shapes = [a.shape for a in _avals(closed.jaxpr) if hasattr(a, "shape")]
    assert shapes and not any(is_dense(s) for s in shapes)

    st, ss = eng.run_phase(st, ss, key, EQUILIBRATION)
    st, ss = eng.run_phase(st, ss, key, SAMPLING)
    h = np.asarray(jax.device_get(ss).chisq_hist)
    assert h[-1] < 0.5 * h[0]
