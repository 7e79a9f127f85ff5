"""Analysis API tests — the analog of the reference's
test_patternMarkers.R (output completeness, all-genes-assigned invariant)
and test_getPatternGeneSet.R (enrichment significance of a planted set)."""

import numpy as np
import pytest

from cogaps_tpu import CoGAPS, analysis, plots


@pytest.fixture(scope="module")
def result(modsim):
    D, A, P = modsim
    return CoGAPS(D, n_patterns=3, n_iterations=300, seed=1, messages=False)


def test_pattern_markers_all_outputs(result):
    pm = analysis.pattern_markers(result, threshold="all")
    assert set(pm) >= {"PatternMarkers", "PatternRanks", "PatternScores"}
    # every gene assigned exactly once (test_patternMarkers.R:20-33)
    all_markers = [g for v in pm["PatternMarkers"].values() for g in v]
    assert len(all_markers) == result.Amean.shape[0]
    assert len(set(all_markers)) == len(all_markers)
    assert all(len(v) > 0 for v in pm["PatternMarkers"].values())


def test_pattern_markers_cut(result):
    pm = analysis.pattern_markers(result, threshold="cut")
    # cut threshold yields per-pattern prefixes; ranks cover all genes
    assert pm["PatternRanks"].shape == (25, 3)
    for name, markers in pm["PatternMarkers"].items():
        assert len(markers) <= 25


def test_pattern_markers_axis2(result):
    pm = analysis.pattern_markers(result, axis=2, threshold="all")
    all_m = [s for v in pm["PatternMarkers"].values() for s in v]
    assert set(all_m) <= set(result.sample_names)
    assert len(all_m) == 20


def test_pattern_markers_ranks_are_permutations(result):
    pm = analysis.pattern_markers(result)
    ranks = pm["PatternRanks"]
    for j in range(ranks.shape[1]):
        assert sorted(ranks[:, j]) == list(range(1, 26))


def test_calc_z(result):
    z = analysis.calc_z(result, "featureLoadings")
    assert z.shape == result.Amean.shape
    assert np.isfinite(z).all()
    with pytest.raises(ValueError):
        analysis.calc_z(result, "bogus")


def test_reconstruct_and_residuals(result, modsim):
    D, _, _ = modsim
    rec = analysis.reconstruct_gene(result)
    assert rec.shape == D.shape
    # reconstruction must correlate strongly with the data
    corr = np.corrcoef(rec.ravel(), D.ravel())[0, 1]
    assert corr > 0.95
    resid = analysis.residuals(result, D)
    assert resid.shape == D.shape
    sub = analysis.reconstruct_gene(result, genes=[result.gene_names[0]])
    assert sub.shape == (1, D.shape[1])


def test_binary_a(result):
    b = analysis.binary_a(result, threshold=2.0)
    assert set(np.unique(b)) <= {0, 1}


def test_calc_cogaps_stat_planted_set(result):
    """A set planted from the top z-scores of pattern 1 must test
    significant for pattern 1. The statistic permutes the z = mean/sd
    matrix (reference: R/methods-CogapsResult.R:510-521), so the planted
    set is built from top z — top-Amean genes need not have top z when
    their posterior sd is large."""
    z = analysis.calc_z(result)
    top = np.argsort(-z[:, 0])[:5]
    planted = [result.gene_names[i] for i in top]
    rng = np.random.default_rng(0)
    randset = [result.gene_names[i] for i in rng.choice(25, 5, replace=False)]
    stat = analysis.calc_cogaps_stat(result, {"planted": planted,
                                              "rand": randset},
                                     num_perm=500, seed=1)
    up = stat["GSUpreg"]
    assert up.shape == (2, 3)
    assert up[0, 0] < 0.1  # planted set upregulated in pattern 1
    assert (stat["twoSidedPValue"] >= 1 / 500).all()


def test_gene_gs_prob(result):
    top = np.argsort(-result.Amean[:, 0])[:5]
    planted = [result.gene_names[i] for i in top]
    probs = analysis.compute_gene_gs_prob(result, planted, num_perm=200)
    assert set(probs) == set(planted)
    assert all(0.0 <= v <= 1.0 for v in probs.values())


def test_get_pattern_gene_set_enrichment(result):
    top = np.argsort(-result.Amean[:, 0])[:6]
    gs = {"sig_p1": [result.gene_names[i] for i in top],
          "rand": [result.gene_names[i] for i in [3, 9, 14, 17, 21]]}
    res = analysis.get_pattern_gene_set(result, gs, method="enrichment",
                                        seed=2)
    assert len(res) == 3
    rec = {r["gene.set"]: r for r in res[0]["results"]}
    assert rec["sig_p1"]["padj"] < 0.2
    assert all("neg.log.padj" in r for r in res[0]["results"])


def test_get_pattern_gene_set_overrepresentation(result):
    pm = analysis.pattern_markers(result)
    first = result.pattern_names[0]
    gs = {"markers_p1": pm["PatternMarkers"][first][:6],
          "rand": [result.gene_names[i] for i in [3, 9, 14, 17, 21]]}
    res = analysis.get_pattern_gene_set(result, gs,
                                        method="overrepresentation")
    rec = {r["gene.set"]: r for r in res[0]["results"]}
    assert rec["markers_p1"]["overlap"] >= 1
    assert rec["markers_p1"]["pval"] <= rec["rand"]["pval"]


def test_manova(result):
    rng = np.random.default_rng(4)
    # responses correlated with pattern 1 weights
    x = result.Pmean[:, 0]
    Y = np.stack([x * 2 + rng.normal(0, 0.01, len(x)),
                  x - rng.normal(0, 0.01, len(x))], axis=1)
    fits = analysis.manova(Y, result)
    assert set(fits) == set(result.pattern_names)
    first = result.pattern_names[0]
    assert fits[first]["p_value"] < 0.01
    assert 0 <= fits[first]["pillai"] <= 2.0


def test_plots_render(result, modsim, tmp_path):
    D, _, _ = modsim
    figs = [
        plots.plot_result(result),
        plots.plot_result(result, groups=["a"] * 10 + ["b"] * 10),
        plots.binary_a(result, 2.0),
        plots.plot_residuals(result, D),
        plots.plot_pattern_markers(result, D),
    ]
    for i, f in enumerate(figs):
        f.savefig(tmp_path / f"fig{i}.png")
    assert all((tmp_path / f"fig{i}.png").exists() for i in range(len(figs)))


def test_calc_gene_gs_stat_degenerate_weights_returns_dict(result):
    """Degenerate gene-set weights must return an (empty) dict — the
    same type as the normal branch — so compute_gene_gs_prob's
    .values() iteration cannot crash."""
    from unittest import mock
    planted = [result.gene_names[i] for i in range(4)]
    # force the permutation statistic to 1.0 => gs_stat == -log(1) == 0
    with mock.patch.object(
            analysis, "calc_cogaps_stat",
            return_value={"GSUpreg": np.ones((1, len(planted)))}):
        out = analysis.calc_gene_gs_stat(result, planted, num_perm=10)
    assert out == {}
