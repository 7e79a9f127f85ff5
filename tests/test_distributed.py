"""Distributed mode tests — the analog of the reference's distributed
sections of test_top_level.R:85-117, test_subset_data.R, and the
patternMatch determinism requirement (SURVEY.md §7 hard part 5)."""

import numpy as np
import pytest

from cogaps_tpu import CoGAPS, CogapsParams
from cogaps_tpu.parallel import clustering
from cogaps_tpu.parallel.distributed import create_sets


# ----------------------------------------------------------------------
# subset creation (reference: R/SubsetData.R)
# ----------------------------------------------------------------------
def test_uniform_sets_partition():
    params = CogapsParams(n_patterns=3, n_sets=4)
    rng = np.random.default_rng(1)
    sets = create_sets(103, params, rng)
    assert len(sets) == 4
    allix = np.concatenate(sets)
    assert len(allix) == 103
    assert np.array_equal(np.sort(allix), np.arange(103))
    for s in sets[:-1]:
        assert len(s) == 103 // 4


def test_explicit_index_sets():
    params = CogapsParams(n_patterns=3, n_sets=2,
                          explicit_sets=[[0, 1, 2], [3, 4, 5, 6]])
    sets = create_sets(7, params, np.random.default_rng(0))
    assert [list(s) for s in sets] == [[0, 1, 2], [3, 4, 5, 6]]


def test_explicit_named_sets():
    names = [f"g{i}" for i in range(6)]
    params = CogapsParams(n_patterns=3, n_sets=2,
                          explicit_sets=[["g0", "g2"], ["g1", "g3", "g5"]])
    sets = create_sets(6, params, np.random.default_rng(0), names)
    assert [list(s) for s in sets] == [[0, 2], [1, 3, 5]]
    bad = CogapsParams(n_patterns=3, n_sets=1, explicit_sets=[["nope"]])
    with pytest.raises(ValueError):
        create_sets(6, bad, np.random.default_rng(0), names)


def test_annotation_weighted_sets():
    annot = ["x"] * 50 + ["y"] * 50
    params = CogapsParams(n_patterns=3, n_sets=3,
                          sampling_annotation=annot,
                          sampling_weight={"x": 9.0, "y": 1.0})
    sets = create_sets(100, params, np.random.default_rng(2))
    assert len(sets) == 3
    frac_x = np.mean([np.mean(s < 50) for s in sets])
    assert frac_x > 0.7  # heavily weighted toward group x


# ----------------------------------------------------------------------
# consensus clustering (reference: R/DistributedCogaps.R:129-217)
# ----------------------------------------------------------------------
def _noisy_patterns(n_sets=4, k=3, n=20, noise=0.02, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.gamma(2.0, 1.0, (n, k)).astype(np.float64)
    cols = []
    for _ in range(n_sets):
        perm = rng.permutation(k)
        cols.append(base[:, perm] + rng.normal(0, noise, (n, k)))
    return np.concatenate(cols, axis=1), base


def test_pattern_match_recovers_patterns():
    allp, base = _noisy_patterns()
    clusters, consensus = clustering.pattern_match(allp, cut=3, min_ns=2,
                                                   max_ns=6)
    assert consensus.shape == (20, 3)
    assert np.allclose(consensus.max(axis=0), 1.0, rtol=1e-5)
    # each consensus pattern matches one base pattern (up to order)
    base_n = base / base.max(axis=0)
    corr = np.corrcoef(consensus.T, base_n.T)[:3, 3:]
    assert (corr.max(axis=1) > 0.99).all()


def test_corcut_drops_small_clusters():
    allp, _ = _noisy_patterns(n_sets=4)
    rng = np.random.default_rng(9)
    outlier = rng.random((20, 1))
    allp = np.concatenate([allp, outlier], axis=1)
    clusters = clustering.corcut(allp, cut=4, min_ns=2)
    sizes = [c.shape[1] for c in clusters]
    assert all(sz >= 2 for sz in sizes)


def test_pattern_match_splits_large_clusters():
    allp, _ = _noisy_patterns(n_sets=8)
    clusters, consensus = clustering.pattern_match(allp, cut=3, min_ns=2,
                                                   max_ns=5)
    assert all(c.shape[1] <= 5 for c in clusters)


def test_cutree_against_scipy_reference():
    """complete_linkage + cutree must agree with scipy's complete linkage
    on label partitioning (scipy is an independent oracle for hclust)."""
    scipy_hier = pytest.importorskip("scipy.cluster.hierarchy")
    scipy_dist = pytest.importorskip("scipy.spatial.distance")
    rng = np.random.default_rng(3)
    X = rng.random((12, 5))
    d = 1 - np.corrcoef(X)
    np.fill_diagonal(d, 0.0)
    merges = clustering.complete_linkage(d)
    for k in (2, 3, 4):
        ours = clustering.cutree_k(merges, 12, k)
        Z = scipy_hier.linkage(scipy_dist.squareform(d, checks=False),
                               method="complete")
        theirs = scipy_hier.fcluster(Z, t=k, criterion="maxclust")
        # same partition up to label renaming
        for a in range(12):
            for b in range(12):
                assert (ours[a] == ours[b]) == (theirs[a] == theirs[b])


# ----------------------------------------------------------------------
# end-to-end distributed runs (reference: test_top_level.R:85-117)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["genome-wide", "single-cell"])
def test_distributed_end_to_end(modsim, mode):
    D, _, _ = modsim
    # seed note: consensus clusters with > maxNS members are SPLIT
    # (reference: R/DistributedCogaps.R:159-167), which can legitimately
    # return MORE than nPatterns patterns for unlucky trajectories —
    # bookkeeping must hold for any outcome; at least one of the tried
    # seeds must land on exactly nPatterns
    exact = False
    for seed in (7, 12, 42):
        params = CogapsParams(n_patterns=3, n_iterations=150, seed=seed,
                              n_sets=2)
        res = CoGAPS(D, params, distributed=mode, messages=False)
        k_out = res.Amean.shape[1]
        assert k_out >= 3
        assert res.Amean.shape == (25, k_out)
        assert res.Pmean.shape == (20, k_out)
        assert len(res.diagnostics["subsets"]) == 2
        assert "consensusPatterns" in res.diagnostics
        # the free factor must be learned (nonzero); the fixed one is
        # zeros (parity: test_fixed_matrix.R:66-102)
        if mode == "genome-wide":
            assert np.abs(res.Amean).sum() > 0
            assert np.abs(res.Pmean).sum() == 0
        else:
            assert np.abs(res.Pmean).sum() > 0
            assert np.abs(res.Amean).sum() == 0
        if k_out == 3:
            exact = True
            break
    assert exact, "no seed produced exactly nPatterns consensus patterns"


def test_distributed_seed_reproducible(modsim):
    D, _, _ = modsim
    params = CogapsParams(n_patterns=3, n_iterations=100, seed=7, n_sets=2)
    r1 = CoGAPS(D, params, distributed="genome-wide", messages=False)
    r2 = CoGAPS(D, params, distributed="genome-wide", messages=False)
    np.testing.assert_array_equal(r1.Amean, r2.Amean)


def test_distributed_gene_order_restored(modsim):
    """stitchTogether must re-order the concatenated factor back to the
    original data order (reference: R/DistributedCogaps.R:240-249)."""
    D, _, _ = modsim
    genes = [f"g{i:03d}" for i in range(25)]
    params = CogapsParams(n_patterns=3, n_iterations=80, seed=3, n_sets=2)
    res = CoGAPS(D, params, distributed="genome-wide", messages=False,
                 gene_names=genes)
    assert res.gene_names == genes


def test_subset_too_small_rejected(modsim):
    D, _, _ = modsim
    params = CogapsParams(n_patterns=8, n_iterations=10, seed=1, n_sets=4)
    with pytest.raises(ValueError):
        CoGAPS(D, params, distributed="single-cell", messages=False)


def test_multichain_matches_serial_subset_runs(modsim):
    """The concurrent multichain phase-1 must equal running each subset
    chain through the single-chain engine (equal-size explicit subsets
    => no padding => identical streams). Reference semantics:
    R/DistributedCogaps.R:64-67 forks with identical params."""
    import dataclasses
    import numpy as np
    from cogaps_tpu.api import _run_single
    from cogaps_tpu.params import CogapsParams
    from cogaps_tpu.parallel.distributed import _run_subsets_multichain

    D, _, _ = modsim
    sets = [np.arange(0, 12), np.arange(12, 24)]
    params = CogapsParams(n_patterns=3, n_iterations=80, seed=21,
                          distributed="genome-wide", n_sets=2,
                          explicit_sets=[list(s) for s in sets],
                          print_messages=False)
    genes = [f"G{i}" for i in range(D.shape[0])]
    samples = [f"S{i}" for i in range(D.shape[1])]
    multi = _run_subsets_multichain(D, None, params, sets, True,
                                    genes, samples, None)

    serial = []
    for i, s in enumerate(sets):
        p = dataclasses.replace(params)
        p.distributed = None
        p.explicit_sets = None
        p.running_distributed = True
        p.print_messages = False
        serial.append(_run_single(D[s, :], p, None,
                                  [genes[j] for j in s], samples))

    for rm, rs in zip(multi, serial):
        np.testing.assert_allclose(rm.Amean, rs.Amean, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(rm.Pmean, rs.Pmean, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("mode", ["single-cell", "genome-wide"])
def test_distributed_sparse_concurrent(modsim, mode):
    """scCoGAPS/GWCoGAPS with sparseOptimization runs all subset chains
    as ONE chain-batched program (reference runs workers
    concurrently, R/DistributedCogaps.R:64-67) and produces a sound
    factorization."""
    D, A, P = modsim
    D = D * (np.random.default_rng(0).random(D.shape) < 0.6)  # sparsify
    exact = False
    for seed in (7, 12, 42):
        params = CogapsParams(n_patterns=3, n_iterations=150, seed=seed,
                              n_sets=2)
        res = CoGAPS(D, params, distributed=mode, messages=False,
                     sparse_optimization=True)
        k_out = res.Amean.shape[1]
        assert k_out >= 3
        assert res.Amean.shape == (25, k_out)
        assert res.Pmean.shape == (20, k_out)
        free = res.Pmean if mode == "single-cell" else res.Amean
        fixed_m = res.Amean if mode == "single-cell" else res.Pmean
        assert np.abs(free).sum() > 0
        assert np.abs(fixed_m).sum() == 0
        assert res.diagnostics["totalUpdates"] > 0
        if k_out == 3:
            exact = True
            break
    assert exact
