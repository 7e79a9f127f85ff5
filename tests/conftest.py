"""Test environment: 8 virtual CPU devices so multi-device sharding paths
compile + execute without accelerator hardware (the counterpart of the
reference's fork-based multi-process tests,
tests/testthat/test_top_level.R:85-117)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # tests always run on the host CPU
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# jax may already be imported (by a plugin or an earlier conftest), in
# which case the env var above is read too late for the platform choice
# — set it through the config API as well (XLA_FLAGS is still read at
# first backend initialization, which happens later).
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# no persistent compile cache in tests: parallel workers would share CPU
# executables through the checkout's cache directory
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIST_CSV = os.path.join(REPO, "data", "GIST.csv")


def make_modsim(n_genes=25, n_samples=20, k=3, noise=0.1, seed=0):
    """Synthetic ground-truth dataset in the spirit of the reference's
    modsimdata (25x20, k=3 toy — reference: R/data.R:12)."""
    rng = np.random.default_rng(seed)
    A = rng.gamma(2.0, 1.0, (n_genes, k)).astype(np.float32)
    P = rng.gamma(2.0, 1.0, (n_samples, k)).astype(np.float32)
    D = (A @ P.T + rng.normal(0, noise, (n_genes, n_samples)))
    return D.clip(0).astype(np.float32), A, P


@pytest.fixture(scope="session")
def modsim():
    return make_modsim()


@pytest.fixture(scope="session")
def gist():
    if not os.path.exists(GIST_CSV):
        pytest.skip("GIST.csv reference dataset not available")
    from cogaps_tpu.io import parsers
    mat, rows, cols = parsers.read_matrix(GIST_CSV)
    return mat, rows, cols
