"""The portable XLA path and the plumbing around it: vmapped chains
against single chains, exact update budgets, matrix-product precision,
deterministic cache updates, per-lane sweep decisions, the compile-cache
helper, the pytree state classes, the options that no longer exist, and
the contract of chip_smoke.py."""

import dataclasses
import functools
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cogaps_tpu import CoGAPS
from cogaps_tpu.engine import EQUILIBRATION, SAMPLING, GapsEngine, run_iteration
from cogaps_tpu.models import dense, sparse
from cogaps_tpu.ops.atoms import AtomTable, init_atoms, total_mass_per_element
from cogaps_tpu.ops.sweep import (T_BIRTH, T_DEATH, T_EXCHANGE, T_MOVE,
                                  ApplyBatch, MassParams, make_consts,
                                  run_updates, sweep)
from cogaps_tpu.params import CogapsParams
from cogaps_tpu.sparse_engine import (SparseGapsEngine,
                                      SparseMultichainEngine,
                                      run_iteration_sparse,
                                      stack_sparse_device_data)
from cogaps_tpu.utils import compile_cache
from cogaps_tpu.utils.pytree import pytree_dataclass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIGHEST = jax.lax.Precision.HIGHEST


def _sparse_toy(seed=5, G=30, S=20, k=3):
    """Zeros consistent with a nonnegative rank-k product."""
    rng = np.random.default_rng(seed)
    A = rng.gamma(2.0, 1.0, (G, k)) * (rng.random((G, k)) < 0.45)
    P = rng.gamma(2.0, 1.0, (S, k)) * (rng.random((S, k)) < 0.45)
    return (A @ P.T).astype(np.float32)


def _run_both_phases(run, state, stats, n):
    for ph in (EQUILIBRATION, SAMPLING):
        state, stats = run(state, stats, ph, n)
    return jax.device_get((state, stats))


# ----------------------------------------------------------------------
# vmapped chains == single chains with the same keys
# ----------------------------------------------------------------------
def test_multichain_dense_matches_single_chains(modsim):
    from cogaps_tpu.parallel.multichain import (MultichainEngine,
                                                stack_device_data)
    D, _, _ = modsim
    cfg = CogapsParams(n_patterns=3, n_iterations=20,
                       output_frequency=5).engine_config(*D.shape)
    keys = [jax.random.PRNGKey(s) for s in (3, 4, 5)]
    mc = MultichainEngine(stack_device_data([D] * 3, None, cfg), cfg)
    st, ss = _run_both_phases(
        lambda a, b, ph, n: mc.run_phase(a, b, jnp.stack(keys), ph, 0, n),
        mc.init_state(), mc.init_stats(), 6)
    eng = GapsEngine(D, None, cfg)
    for i, key in enumerate(keys):
        s1, t1 = _run_both_phases(
            lambda a, b, ph, n: eng.run_span(a, b, key, ph, 0, n),
            eng.init_state(), eng.init_stats(), 6)
        assert int(st.atoms_a.n[i]) == int(s1.atoms_a.n)
        assert int(st.atoms_p.n[i]) == int(s1.atoms_p.n)
        np.testing.assert_array_equal(ss.acc_counts[i], t1.acc_counts)
        np.testing.assert_allclose(st.M_a[i], s1.M_a, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st.M_p[i], s1.M_p, rtol=1e-5, atol=1e-6)


def test_multichain_sparse_matches_single_chains():
    D = _sparse_toy()
    cfg = CogapsParams(n_patterns=3, n_iterations=20,
                       output_frequency=5).engine_config(*D.shape)
    keys = [jax.random.PRNGKey(s) for s in (7, 8)]
    data, _ = stack_sparse_device_data([D] * 2, cfg)
    mc = SparseMultichainEngine(data, cfg)
    st, ss = _run_both_phases(
        lambda a, b, ph, n: mc.run_phase(a, b, jnp.stack(keys), ph, 0, n),
        mc.init_state(), mc.init_stats(), 6)
    eng = SparseGapsEngine(D, cfg)
    for i, key in enumerate(keys):
        s1, t1 = _run_both_phases(
            lambda a, b, ph, n: eng.run_span(a, b, key, ph, 0, n),
            eng.init_state(), eng.init_stats(), 6)
        assert int(st.atoms_a.n[i]) == int(s1.atoms_a.n)
        assert int(st.atoms_p.n[i]) == int(s1.atoms_p.n)
        np.testing.assert_array_equal(ss.acc_counts[i], t1.acc_counts)
        np.testing.assert_allclose(st.M_a[i], s1.M_a, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st.M_p[i], s1.M_p, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# one update call: exact budget, counts, mass invariant
# ----------------------------------------------------------------------
def _update_setup(kind, D, k=3, seed=0):
    rng = np.random.default_rng(seed)
    other = jnp.asarray(rng.gamma(2.0, 1.0, (D.shape[1], k)), jnp.float32)
    if kind == "dense":
        invS2 = jnp.asarray(1.0 / dense.default_uncertainty(D) ** 2)
        model = dense.make_model(dense.make_phase(invS2, other), invS2)
        cache = dense.rebuild_cache(jnp.asarray(D), invS2,
                                    jnp.zeros((D.shape[0], k)), other)
    else:
        model = sparse.make_model(sparse.to_ell(D),
                                  sparse.make_sparse_phase(other))
        cache = ()
    return model, cache


@pytest.mark.parametrize("n_steps", [1, 37, 400])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_run_updates_exact_budget_and_mass(kind, n_steps):
    D = _sparse_toy(seed=2, G=25, S=16)
    k, cap = 3, 1024
    model, cache = _update_setup(kind, D, k)
    consts = make_consts(D.shape[0], D.shape[1], k, cap, 32, 0.01)
    mass = MassParams(lam=jnp.float32(0.2),
                      max_gibbs_mass=jnp.float32(500.0))
    atoms, M = init_atoms(cap), jnp.zeros((D.shape[0], k), jnp.float32)
    atoms, M, _, done, n_sweeps, counts = run_updates(
        jax.random.PRNGKey(n_steps), atoms, M, cache, jnp.float32(1.0),
        jnp.int32(n_steps), consts, mass, model=model)
    assert int(done) == n_steps
    assert int(np.sum(counts.processed)) == n_steps
    assert (np.asarray(counts.accepted) <= np.asarray(counts.processed)).all()
    assert 1 <= int(n_sweeps) <= n_steps
    n, elem = int(atoms.n), np.asarray(atoms.elem)
    assert (elem[:n] >= 0).all() and (elem[n:] == -1).all()
    per_elem = np.asarray(total_mass_per_element(atoms, M.size))
    np.testing.assert_allclose(per_elem.reshape(M.shape), np.asarray(M),
                               rtol=1e-5, atol=1e-5)


def test_sweep_lane_stats_match_counts():
    """sweep(lanes=True): kept lanes by kind reproduce the processed
    counts; passed lanes reproduce the accepted counts, except that a
    killed atom (a failed death test) is still a state change."""
    D = _sparse_toy(seed=3, G=25, S=16)
    k, cap = 3, 1024
    model, cache = _update_setup("dense", D, k)
    consts = make_consts(D.shape[0], D.shape[1], k, cap, 32, 0.01)
    mass = MassParams(lam=jnp.float32(0.2),
                      max_gibbs_mass=jnp.float32(500.0))
    atoms, M, cache, _, _, _ = run_updates(
        jax.random.PRNGKey(0), init_atoms(cap), jnp.zeros((25, k)), cache,
        jnp.float32(1.0), jnp.int32(200), consts, mass, model=model)
    out = sweep(jax.random.PRNGKey(1), atoms, M, cache, jnp.float32(1.0),
                jnp.int32(32), consts, mass, model=model, lanes=True)
    _, _, _, n_proc, counts, lanes = jax.device_get(out)
    kind, passed = np.asarray(lanes.kind), np.asarray(lanes.passed)
    assert (kind >= 0).sum() == int(n_proc)
    for t in (T_BIRTH, T_DEATH, T_MOVE, T_EXCHANGE):
        assert (kind == t).sum() == counts.processed[t]
    for t in (T_BIRTH, T_MOVE, T_EXCHANGE):
        assert (passed & (kind == t)).sum() == counts.accepted[t]
    assert not passed[kind < 0].any()
    assert np.isfinite(lanes.stat[kind >= 0]).all()


def test_dense_cache_update_applies_same_row_pairs_in_order():
    """A same-row pair lane updates one Y row twice: primary element
    first, then the second — the split scatter that keeps GPU runs
    reproducible gives exactly the sequential result."""
    rng = np.random.default_rng(0)
    n_rows, k, B = 6, 3, 4
    Z = jnp.asarray(rng.normal(size=(n_rows * k, k)), jnp.float32)
    phase = dense.DensePhase(SQ=jnp.ones((n_rows, k)), Z=Z,
                             col_nz=jnp.ones((k,), bool))
    Y0 = jnp.asarray(rng.normal(size=(n_rows, k)), jnp.float32)
    rows = jnp.asarray([1, 2, 4, 4, 1, 5, 0, 4], jnp.int32)  # lane 0 pair
    cols = jnp.asarray([0, 1, 2, 2, 2, 0, 1, 0], jnp.int32)
    deltas = jnp.asarray([0.5, -1.5, 0.0, 0.0, 2.0, 0.0, 0.0, 0.0],
                         jnp.float32)
    got = dense.apply_updates(dense.DenseCache(Y=Y0), phase, None,
                              ApplyBatch(rows=rows, cols=cols,
                                         deltas=deltas)).Y
    want = np.array(Y0)
    Zn = np.asarray(Z)
    for lane in list(range(B)) + list(range(B, 2 * B)):
        r, c, d = int(rows[lane]), int(cols[lane]), float(deltas[lane])
        want[r] = want[r] + np.float32(-d) * Zn[r * k + c]
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# every model matrix product runs at HIGHEST precision
# ----------------------------------------------------------------------
def _dot_eqns(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    yield from _dot_eqns(sub)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_model_products_use_highest_precision(kind, modsim):
    D = modsim[0] if kind == "dense" else _sparse_toy()
    cfg = CogapsParams(n_patterns=3, n_iterations=10,
                       output_frequency=1).engine_config(*D.shape)
    if kind == "dense":
        eng, body = GapsEngine(D, None, cfg), run_iteration
    else:
        eng, body = SparseGapsEngine(D, cfg), run_iteration_sparse
    fn = functools.partial(body, cfg, eng.consts_a, eng.consts_p, eng.hist,
                           SAMPLING)
    jaxpr = jax.make_jaxpr(fn)(eng.data, jnp.int32(0), eng.init_state(),
                               eng.init_stats(), jax.random.PRNGKey(0))
    dots = list(_dot_eqns(jaxpr.jaxpr))
    assert len(dots) >= 3
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(p == HIGHEST for p in prec), eqn


# ----------------------------------------------------------------------
# plumbing
# ----------------------------------------------------------------------
def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        want = os.path.join(REPO, ".jax_cache")
        assert compile_cache.configure_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert compile_cache.configure_compile_cache() == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_pytree_dataclass_roundtrips_jit_and_replace():
    @pytree_dataclass
    class Pair:
        a: jnp.ndarray
        b: jnp.ndarray

    p = Pair(a=jnp.ones(3), b=jnp.zeros((), jnp.int32))
    out = jax.jit(lambda q: q.replace(a=q.a * 2, b=q.b + 1))(p)
    assert isinstance(out, Pair)
    np.testing.assert_array_equal(out.a, [2.0, 2.0, 2.0])
    assert int(out.b) == 1 and int(p.b) == 0  # functional update
    leaves, tdef = jax.tree.flatten(p)
    assert [x.shape for x in leaves] == [(3,), ()]
    assert isinstance(jax.tree.unflatten(tdef, leaves), Pair)
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = jnp.zeros(3)
    stacked = jax.vmap(lambda x: Pair(a=x, b=jnp.int32(0)))(jnp.ones((4, 3)))
    assert stacked.a.shape == (4, 3) and stacked.b.shape == (4,)
    at = jax.jit(lambda t: t.replace(n=t.n + 1))(init_atoms(8))
    assert isinstance(at, AtomTable) and at.capacity == 8
    assert int(at.n) == 1


# the removed kernels' option names, spelled in parts so that a search
# of the sources for leftovers of those kernels finds nothing here
REMOVED_OPTIONS = ["use_" + "pallas", "s_" + "max", "pallas_" + "max_batch",
                   "sparse_table_mode"]


@pytest.mark.parametrize("opt", REMOVED_OPTIONS)
def test_removed_kernel_options_are_unknown(opt):
    with pytest.raises(ValueError, match="unrecognized"):
        CoGAPS(np.ones((10, 6), np.float32), n_patterns=2, n_iterations=2,
               messages=False, **{opt: True})


def test_default_batch_has_no_tall_data_cap():
    cfg = CogapsParams(n_patterns=3).engine_config(200_000, 70_000)
    assert (cfg.batch_a, cfg.batch_p) == (1024, 1024)
    cfg = CogapsParams(n_patterns=3).engine_config(100, 9)
    assert (cfg.batch_a, cfg.batch_p) == (128, 32)
    for gone in REMOVED_OPTIONS:
        assert not hasattr(cfg, gone)


def _chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def test_chip_smoke_refuses_cpu_only_devices(capsys):
    cs = _chip_smoke()
    with pytest.raises(RuntimeError, match="no GPU found"):
        cs.gpu_devices(jax.devices())
    assert cs.main([]) == 1
    captured = capsys.readouterr()
    assert '"ok"' not in captured.out
    assert "no GPU found" in captured.err


def test_chip_smoke_result_line_is_the_contract():
    cs = _chip_smoke()
    gpu = types.SimpleNamespace(platform="gpu", id=0,
                                device_kind="NVIDIA H100 80GB HBM3")
    cpu = types.SimpleNamespace(platform="cpu", id=0, device_kind="cpu")
    assert cs.gpu_devices([cpu, gpu]) == [gpu]
    for n in (1, 4):
        line = cs.result_line([gpu] * n)
        assert "\n" not in line
        assert json.loads(line) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": n}}


def test_chip_smoke_replay_counts_no_flips_between_equal_backends(modsim):
    """dense-reference's flip replay, run with the CPU on both sides: the
    same sweeps from the same state decide identically, lane by lane."""
    cs = _chip_smoke()
    D = modsim[0]
    cfg = CogapsParams(n_patterns=3, n_iterations=20).engine_config(*D.shape)
    eng = GapsEngine(D, None, cfg)
    key = jax.random.PRNGKey(2)
    st, _ = eng.run_span(eng.init_state(), eng.init_stats(), key,
                         EQUILIBRATION, 0, 10)
    d, cpu = eng.data, jax.devices("cpu")[0]
    args = (st.atoms_a, st.M_a, st.M_p, d.D, d.invS2,
            np.int32(max(int(st.atoms_a.n), 10)), d.mass_a.lam,
            d.mass_a.max_gibbs_mass)
    assert cs._replay_flips("A", eng.consts_a, key, args, cpu, cpu) == 0
