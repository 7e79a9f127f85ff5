"""Checkpoint / resume.

The reference serializes the complete sampler state (params, RNG seeder,
both samplers' factor matrices and atomic domains, statistics accumulators,
phase, iteration) to a versioned binary Archive with a .backup rename
during the write (reference: src/GapsRunner.cpp:225-270,
src/utils/Archive.h:16-17). Resume reproduces the run exactly even if a
different seed argument is passed (tests/testthat/test_checkpoints.R:9-15).

Here the chain state is a flat pytree of arrays (factor matrices,
atom tables, residual, statistics sums) plus three scalars (phase,
iteration, seed) — the counter-based RNG needs no stored stream state, only
the original seed, so resume-with-different-seed-argument exactness holds
by construction. Written as npz with a magic/version field and the same
.backup rename dance.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

MAGIC = 0xB123AA4D  # keep the reference's archive magic (Archive.h:16)
VERSION = 1


def save_checkpoint(path: str, engine, state, stats, phase: int,
                    iteration: int, seed: int) -> None:
    import jax
    state = jax.device_get(state)
    stats = jax.device_get(stats)
    payload = {
        "magic": np.uint32(MAGIC),
        "version": np.uint32(VERSION),
        "phase": np.int32(phase),
        "iteration": np.int32(iteration),
        "seed": np.int64(seed),
        "n_genes": np.int32(engine.n_genes),
        "n_samples": np.int32(engine.n_samples),
        "n_patterns": np.int32(engine.config.n_patterns),
        # full engine-config fingerprint: resuming under different
        # alpha/maxGibbsMass/batch/... must fail loudly rather than
        # silently diverge from the resume-exactness contract
        "config_hash": np.int64(hash(engine.config) & 0x7FFFFFFFFFFFFFFF),
        # chain state ("R" absent for the cache-free sparse model)
        "M_a": state.M_a, "M_p": state.M_p,
        "atoms_a_mass": state.atoms_a.mass, "atoms_a_elem": state.atoms_a.elem,
        "atoms_a_n": state.atoms_a.n,
        "atoms_p_mass": state.atoms_p.mass, "atoms_p_elem": state.atoms_p.elem,
        "atoms_p_n": state.atoms_p.n,
        "sparse": np.bool_(type(state).__name__ == "SparseChainState"),
        # statistics
        "a_sum": stats.a_sum, "a_sumsq": stats.a_sumsq,
        "p_sum": stats.p_sum, "p_sumsq": stats.p_sumsq,
        "n_stat": stats.n_stat, "pump": stats.pump, "n_pump": stats.n_pump,
        "chisq_hist": stats.chisq_hist,
        "atom_hist_a": stats.atom_hist_a, "atom_hist_p": stats.atom_hist_p,
        "snap_a": stats.snap_a, "snap_p": stats.snap_p,
        "upd_lo": stats.upd_lo, "upd_hi": stats.upd_hi,
        "prop_counts": stats.prop_counts, "acc_counts": stats.acc_counts,
        "sweep_counts": stats.sweep_counts,
    }
    # .backup rename during the write (reference: GapsRunner.cpp:232-243)
    backup = path + ".backup"
    if os.path.exists(path):
        os.replace(path, backup)
    with open(path, "wb") as f:
        np.savez(f, **payload)
    if os.path.exists(backup):
        os.remove(backup)


def load_checkpoint(path: str, engine) -> Tuple[object, object, int, int]:
    from ..engine import ChainState, RunStats
    from ..sparse_engine import SparseChainState
    from ..ops.atoms import AtomTable
    import jax.numpy as jnp

    z = np.load(path)
    if int(z["magic"]) != MAGIC:
        raise ValueError(f"corrupt checkpoint file: {path}")
    if (int(z["n_genes"]) != engine.n_genes
            or int(z["n_samples"]) != engine.n_samples
            or int(z["n_patterns"]) != engine.config.n_patterns):
        raise ValueError("checkpoint does not match data dimensions")
    if "config_hash" in z and int(z["config_hash"]) != (
            hash(engine.config) & 0x7FFFFFFFFFFFFFFF):
        raise ValueError(
            "checkpoint was written with different engine parameters; "
            "resume requires the identical configuration")

    from .atoms_compat import load_table
    atoms_a = load_table(z["atoms_a_mass"], z["atoms_a_elem"],
                         z["atoms_a_n"])
    atoms_p = load_table(z["atoms_p_mass"], z["atoms_p_elem"],
                         z["atoms_p_n"])
    cls = SparseChainState if bool(z["sparse"]) else ChainState
    state = cls(atoms_a=atoms_a, atoms_p=atoms_p,
                M_a=jnp.asarray(z["M_a"]), M_p=jnp.asarray(z["M_p"]))
    stats = RunStats(
        a_sum=jnp.asarray(z["a_sum"]), a_sumsq=jnp.asarray(z["a_sumsq"]),
        p_sum=jnp.asarray(z["p_sum"]), p_sumsq=jnp.asarray(z["p_sumsq"]),
        n_stat=jnp.asarray(z["n_stat"]), pump=jnp.asarray(z["pump"]),
        n_pump=jnp.asarray(z["n_pump"]),
        chisq_hist=jnp.asarray(z["chisq_hist"]),
        atom_hist_a=jnp.asarray(z["atom_hist_a"]),
        atom_hist_p=jnp.asarray(z["atom_hist_p"]),
        snap_a=jnp.asarray(z["snap_a"]), snap_p=jnp.asarray(z["snap_p"]),
        upd_lo=jnp.asarray(z["upd_lo"]), upd_hi=jnp.asarray(z["upd_hi"]),
        prop_counts=jnp.asarray(z["prop_counts"]) if "prop_counts" in z
        else jnp.zeros((2, 4), jnp.int32),
        acc_counts=jnp.asarray(z["acc_counts"]) if "acc_counts" in z
        else jnp.zeros((2, 4), jnp.int32),
        sweep_counts=jnp.asarray(z["sweep_counts"]) if "sweep_counts" in z
        else jnp.zeros((2,), jnp.int32))
    return state, stats, int(z["phase"]), int(z["iteration"])


def checkpoint_seed(path: str) -> int:
    """The original run's seed, restored on resume regardless of the seed
    argument (reference: GapsRunner.cpp:100-106 reloads params+randState
    before anything else)."""
    return int(np.load(path)["seed"])
