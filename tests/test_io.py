"""File parser tests against the shipped GIST files — the analog of
src/cpp_tests/testFileParsers.cpp (all four formats must agree)."""

import os

import numpy as np
import pytest

from cogaps_tpu.io import parsers
from cogaps_tpu.result import CogapsResult

REF = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


@pytest.mark.skipif(not os.path.exists(f"{REF}/GIST.csv"),
                    reason="reference GIST files unavailable")
def test_gist_formats_agree():
    csv, rn, cn = parsers.read_matrix(f"{REF}/GIST.csv")
    tsv, _, _ = parsers.read_matrix(f"{REF}/GIST.tsv")
    gct, grn, gcn = parsers.read_matrix(f"{REF}/GIST.gct")
    mtx, _, _ = parsers.read_matrix(f"{REF}/GIST.mtx")
    assert csv.shape == (1363, 9)
    np.testing.assert_allclose(csv, tsv, rtol=1e-6)
    np.testing.assert_allclose(csv, gct, rtol=1e-6)
    np.testing.assert_allclose(csv, mtx, rtol=1e-4)
    assert rn is not None and len(rn) == 1363
    assert cn is not None and len(cn) == 9


@pytest.mark.skipif(not os.path.exists(f"{REF}/GIST.csv"),
                    reason="reference GIST files unavailable")
def test_file_info():
    info = parsers.file_info(f"{REF}/GIST.csv")
    assert info["nRows"] == 1363 and info["nCols"] == 9


def test_csv_write_read_roundtrip(tmp_path, modsim):
    D, _, _ = modsim
    path = str(tmp_path / "m.csv")
    genes = [f"g{i}" for i in range(D.shape[0])]
    samples = [f"s{i}" for i in range(D.shape[1])]
    parsers.write_csv(path, D, genes, samples)
    mat, rn, cn = parsers.read_matrix(path)
    np.testing.assert_allclose(mat, D, rtol=1e-5)
    assert rn == genes and cn == samples


def test_mtx_coo_reader(tmp_path):
    path = str(tmp_path / "m.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write("3 4 2\n1 1 5.0\n3 4 2.5\n")
    rows, cols, vals, nr, nc = parsers.read_mtx_coo(path)
    assert (nr, nc) == (3, 4)
    assert rows.tolist() == [0, 2] and cols.tolist() == [0, 3]
    np.testing.assert_allclose(vals, [5.0, 2.5])


def test_result_csv_roundtrip(tmp_path, modsim):
    """toCSV/fromCSV parity (reference: R/methods-CogapsResult.R:624-682)."""
    from cogaps_tpu import CoGAPS
    D, _, _ = modsim
    res = CoGAPS(D, n_patterns=3, n_iterations=50, seed=1, messages=False)
    prefix = str(tmp_path / "res")
    res.to_csv(prefix)
    back = CogapsResult.from_csv(prefix)
    np.testing.assert_allclose(back.Amean, res.Amean, rtol=1e-5)
    np.testing.assert_allclose(back.Psd, res.Psd, rtol=1e-5, atol=1e-7)
    assert back.gene_names == res.gene_names
    assert back.mean_chi_sq == pytest.approx(res.mean_chi_sq, rel=1e-6)


def test_result_npz_roundtrip(tmp_path, modsim):
    from cogaps_tpu import CoGAPS
    D, _, _ = modsim
    res = CoGAPS(D, n_patterns=3, n_iterations=50, seed=1, messages=False)
    path = str(tmp_path / "res.npz")
    res.save(path)
    back = CogapsResult.load(path)
    np.testing.assert_array_equal(back.Amean, res.Amean)
    assert back.diagnostics["totalUpdates"] == res.diagnostics["totalUpdates"]
