"""Multi-host runtime: process initialization, global meshes, and
per-shard checkpointing.

The reference's only distribution mechanism is single-machine
BiocParallel forks (reference: R/DistributedCogaps.R:56-67); the JAX
equivalent spans hosts: `jax.distributed.initialize` brings up the
cross-process runtime, a global mesh
spans every process's devices, and pjit/shard_map programs written
against that mesh run unchanged — the collectives the engines already
use (psum of conditional tables and chi^2, parallel/sharded.py and
parallel/sparse_sharded.py) ride the interconnect.

Checkpoints are written per process: each host serializes only its
addressable shards plus the global sharding layout, so no host ever
materializes the global state (SURVEY §5 checkpoint plan).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """Bring up the multi-process JAX runtime from explicit arguments,
    or from COGAPS_COORDINATOR / COGAPS_NUM_PROCESSES /
    COGAPS_PROCESS_ID; with neither it does nothing (single process).
    Returns this process's index. Safe to call once."""
    import jax

    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    elif os.environ.get("COGAPS_COORDINATOR"):
        jax.distributed.initialize(
            coordinator_address=os.environ["COGAPS_COORDINATOR"],
            num_processes=int(os.environ["COGAPS_NUM_PROCESSES"]),
            process_id=int(os.environ["COGAPS_PROCESS_ID"]))
    return jax.process_index()


def global_mesh(axis_name: str = "chains"):
    """One-axis mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis_name,))


def is_coordinator() -> bool:
    import jax

    return jax.process_index() == 0


# ----------------------------------------------------------------------
# per-shard checkpointing: each process writes only what it holds
# ----------------------------------------------------------------------
def save_sharded_checkpoint(path_prefix: str, tree, extra: dict = None
                            ) -> str:
    """Write this process's addressable shards of a (possibly sharded)
    pytree to `<prefix>.shard<pid>.npz`. Works single-process too (all
    shards are addressable). Returns the written path."""
    import jax

    pid = jax.process_index()
    leaves, treedef = jax.tree.flatten(tree)
    payload = {"n_leaves": np.int32(len(leaves)),
               "process_id": np.int32(pid),
               "num_processes": np.int32(jax.process_count())}
    for i, leaf in enumerate(leaves):
        arr = leaf
        if hasattr(arr, "addressable_shards"):
            for s in arr.addressable_shards:
                payload[f"leaf{i}_shard{s.index}"] = np.asarray(s.data)
                payload[f"leaf{i}_shape"] = np.asarray(arr.shape,
                                                       np.int64)
        else:
            payload[f"leaf{i}_shard_full"] = np.asarray(arr)
    for k, v in (extra or {}).items():
        payload[f"extra_{k}"] = v
    path = f"{path_prefix}.shard{pid}.npz"
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)
    return path


def load_sharded_checkpoint(path_prefix: str, tree_like):
    """Reassemble a pytree saved by save_sharded_checkpoint, reading
    every process's shard file (single-host restore path; each leaf is
    rebuilt dense and can be re-placed with device_put)."""
    import glob

    import jax

    files = sorted(glob.glob(f"{path_prefix}.shard*.npz"))
    if not files:
        raise FileNotFoundError(f"no shard files for {path_prefix}")
    zs = [np.load(f) for f in files]
    leaves, treedef = jax.tree.flatten(tree_like)
    out = []
    for i, like in enumerate(leaves):
        key_full = f"leaf{i}_shard_full"
        if key_full in zs[0]:
            out.append(np.asarray(zs[0][key_full]))
            continue
        shape = tuple(np.asarray(zs[0][f"leaf{i}_shape"], np.int64))
        acc = np.zeros(shape, np.asarray(
            next(v for k, v in zs[0].items()
                 if k.startswith(f"leaf{i}_shard"))).dtype)
        for z in zs:
            for k in z.files:
                if k.startswith(f"leaf{i}_shard") and k != f"leaf{i}_shape":
                    idx_str = k[len(f"leaf{i}_shard"):]
                    sl = _parse_index(idx_str, shape)
                    acc[sl] = z[k]
        out.append(acc)
    return jax.tree.unflatten(treedef, out)


def _parse_index(idx_str: str, shape) -> tuple:
    """Parse the repr of a shard.index (a tuple of slices) back into
    slices — e.g. '(slice(0, 8, None), slice(None, None, None))'."""
    if idx_str in ("()", "_full"):
        return tuple(slice(None) for _ in shape)
    out = []
    inner = idx_str.strip("()")
    for part in inner.split("slice")[1:]:
        nums = part.strip("(), ").split(",")
        a = None if nums[0].strip() == "None" else int(nums[0])
        b = None if nums[1].strip() == "None" else int(nums[1])
        out.append(slice(a, b))
    while len(out) < len(shape):
        out.append(slice(None))
    return tuple(out)
