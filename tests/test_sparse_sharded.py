"""Sparse x sharded engine — the atlas-scale execution path
(SURVEY.md §7.10; reference model: src/gibbs_sampler/SparseNormalModel.cpp
+ the subset scheme it lacks at native level)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from cogaps_tpu.engine import EQUILIBRATION, SAMPLING
from cogaps_tpu.io.h5 import CooMatrix
from cogaps_tpu.params import CogapsParams
from cogaps_tpu.parallel.sparse_sharded import (SparseShardedEngine,
                                                atlas_memory_plan)


def _coo(n_genes=96, n_samples=30, k=3, seed=2, keep=0.4):
    rng = np.random.default_rng(seed)
    A = (rng.gamma(2, 1, (n_genes, k)) * (rng.random((n_genes, k)) < keep)
         ).astype(np.float32)
    P = (rng.gamma(2, 1, (n_samples, k)) * (rng.random((n_samples, k)) < keep)
         ).astype(np.float32)
    D = (A @ P.T).astype(np.float32)
    rows, cols = np.nonzero(D)
    return CooMatrix(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                     vals=D[rows, cols], shape=D.shape), D


@pytest.fixture(scope="module")
def mesh4():
    return Mesh(np.array(jax.devices()[:4]), ("genes",))


def test_sparse_sharded_converges(mesh4):
    coo, D = _coo()
    params = CogapsParams(n_patterns=3, n_iterations=200, seed=5,
                          output_frequency=50)
    cfg = params.engine_config(*coo.shape)
    eng = SparseShardedEngine(coo, cfg, mesh4)
    state, stats = eng.init_state(), eng.init_stats()
    key = jax.random.PRNGKey(5)
    state, stats = eng.run_phase(state, stats, key, EQUILIBRATION)
    state, stats = eng.run_phase(state, stats, key, SAMPLING)
    hist = np.asarray(jax.device_get(stats).chisq_hist)
    assert hist[0] > 0
    assert hist[-1] < 0.5 * hist[0]
    M_a = eng.trim(np.asarray(state.M_a))
    assert M_a.shape == (96, 3)
    assert (M_a >= 0).all()
    # mass drift oracle on the replicated P table
    from cogaps_tpu.ops.atoms import total_mass_per_element
    mp = total_mass_per_element(jax.device_get(state.atoms_p),
                                coo.shape[1] * 3).reshape(-1, 3)
    assert float(jnp.max(jnp.abs(mp - np.asarray(state.M_p)))) < 0.01


def test_sparse_sharded_matches_single_device_shapes(mesh4):
    """Uneven gene counts pad to a device multiple; results trim back."""
    coo, D = _coo(n_genes=90)
    params = CogapsParams(n_patterns=3, n_iterations=30, seed=1)
    cfg = params.engine_config(*coo.shape)
    eng = SparseShardedEngine(coo, cfg, mesh4)
    assert eng.n_genes % 4 == 0
    state, stats = eng.init_state(), eng.init_stats()
    state, stats = eng.run_phase(state, stats, jax.random.PRNGKey(0),
                                 EQUILIBRATION)
    assert eng.trim(np.asarray(state.M_a)).shape == (90, 3)


def test_atlas_memory_budget():
    """1M cells x 30k genes, k=50, 5% density over 8 devices must fit
    comfortably in a 16 GB device memory — the SURVEY §7.10 plan."""
    plan = atlas_memory_plan(n_cells=1_000_000, n_genes=30_000, k=50,
                             density=0.05, n_devices=8)
    assert plan["A_shard"] == 125_000 * 50 * 4  # 25 MB
    assert plan["total_per_device"] < 4 * 2**30, plan


def test_sparse_sharded_checkpoint_resume_exact(mesh4, tmp_path):
    """Checkpoint parity for the atlas engine:
    save mid-run, resume on the same mesh => bitwise-identical final
    state vs the uninterrupted run (the test_checkpoints.R contract,
    reference: src/GapsRunner.cpp:225-270)."""
    coo, D = _coo()
    params = CogapsParams(n_patterns=3, n_iterations=80, seed=11,
                          output_frequency=20)
    cfg = params.engine_config(*coo.shape)
    eng = SparseShardedEngine(coo, cfg, mesh4)
    key = jax.random.PRNGKey(11)

    # uninterrupted
    st, ss = eng.init_state(), eng.init_stats()
    st, ss = eng.run_phase(st, ss, key, EQUILIBRATION)
    st, ss = eng.run_phase(st, ss, key, SAMPLING)
    ref_state = jax.device_get(st)

    # interrupted at mid-equilibration
    st2, ss2 = eng.init_state(), eng.init_stats()
    st2, ss2 = eng.run_phase(st2, ss2, key, EQUILIBRATION, 0, 40)
    pfx = str(tmp_path / "atlas_ckpt")
    eng.save_checkpoint(pfx, st2, ss2, EQUILIBRATION, 40, 11)

    eng2 = SparseShardedEngine(coo, cfg, mesh4)
    st3, ss3, phase, it, seed = eng2.load_checkpoint(pfx)
    assert (phase, it, seed) == (EQUILIBRATION, 40, 11)
    st3, ss3 = eng2.run_phase(st3, ss3, key, EQUILIBRATION, it)
    st3, ss3 = eng2.run_phase(st3, ss3, key, SAMPLING)
    got = jax.device_get(st3)
    np.testing.assert_array_equal(np.asarray(got.M_a),
                                  np.asarray(ref_state.M_a))
    np.testing.assert_array_equal(np.asarray(got.M_p),
                                  np.asarray(ref_state.M_p))
    np.testing.assert_array_equal(np.asarray(got.atoms_p.mass),
                                  np.asarray(ref_state.atoms_p.mass))


def test_sparse_sharded_checkpoint_resume_other_device_count(mesh4,
                                                             tmp_path):
    """Resume the atlas engine on a DIFFERENT device count: A atoms are
    re-binned through global element ids; the resumed run must conserve
    atom mass (drift oracle) and keep factorizing."""
    coo, D = _coo()
    params = CogapsParams(n_patterns=3, n_iterations=80, seed=13,
                          output_frequency=20)
    cfg = params.engine_config(*coo.shape)
    eng = SparseShardedEngine(coo, cfg, mesh4)
    key = jax.random.PRNGKey(13)
    st, ss = eng.init_state(), eng.init_stats()
    st, ss = eng.run_phase(st, ss, key, EQUILIBRATION, 0, 40)
    pfx = str(tmp_path / "atlas_ckpt2")
    eng.save_checkpoint(pfx, st, ss, EQUILIBRATION, 40, 13)
    total_before = float(np.asarray(st.atoms_a.mass).sum())

    mesh2 = Mesh(np.array(jax.devices()[:2]), ("genes",))
    eng2 = SparseShardedEngine(coo, cfg, mesh2)
    st2, ss2, phase, it, seed = eng2.load_checkpoint(pfx)
    # atoms conserved through the re-binning
    assert np.isclose(float(np.asarray(st2.atoms_a.mass).sum()),
                      total_before, rtol=1e-6)
    ka = np.asarray(st2.M_a)
    # M_a shards agree with the saved global M_a
    np.testing.assert_allclose(ka, np.asarray(st.M_a), rtol=1e-6)
    st2, ss2 = eng2.run_phase(st2, ss2, key, EQUILIBRATION, it)
    from cogaps_tpu.ops.atoms import total_mass_per_element
    mp = total_mass_per_element(jax.device_get(st2.atoms_p),
                                coo.shape[1] * 3).reshape(-1, 3)
    assert float(jnp.max(jnp.abs(mp - np.asarray(st2.M_p)))) < 0.01
