"""Multi-host runtime pieces (reference analog: the BiocParallel
fork-join layer, R/DistributedCogaps.R:56-67 — here jax.distributed +
per-shard checkpoints)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cogaps_tpu.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sharded_checkpoint_roundtrip(tmp_path):
    """Per-shard save/restore of a mesh-sharded pytree (single process:
    all shards addressable)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:4]), ("chains",))
    x = jax.device_put(jnp.arange(32.0).reshape(8, 4),
                       NamedSharding(mesh, P("chains")))
    y = jnp.float32(7.0)
    tree = {"x": x, "y": y}
    prefix = str(tmp_path / "ck")
    multihost.save_sharded_checkpoint(prefix, tree)
    restored = multihost.load_sharded_checkpoint(
        prefix, {"x": 0, "y": 0})
    np.testing.assert_array_equal(restored["x"],
                                  np.arange(32.0).reshape(8, 4))
    assert float(restored["y"]) == 7.0


def test_initialize_single_process():
    assert multihost.initialize_distributed() == jax.process_index()
    assert multihost.is_coordinator() == (jax.process_index() == 0)
    mesh = multihost.global_mesh("chains")
    assert mesh.shape["chains"] == jax.device_count()


@pytest.mark.slow
def test_two_process_cpu_run():
    """Genuine 2-process jax.distributed run: each process drives one
    chain of a multichain engine over the global mesh and writes its
    shard checkpoint; process 0 reassembles the global state."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "multihost_demo.py"),
         "launch", "2"],
        capture_output=True, text=True, timeout=570)
    assert r.returncode == 0, r.stdout + r.stderr
    assert '"restore": "ok"' in r.stdout
