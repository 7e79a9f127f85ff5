"""Data-parallel chains: vmapped independent Gibbs chains sharded over a
device mesh.

This is the JAX equivalent of the reference's process-level parallelism
(one forked C++ engine per data subset, reference:
R/DistributedCogaps.R:56-67 with BiocParallel::MulticoreParam): chains are
completely independent until the tiny consensus gather, so we stack their
state along a leading axis, vmap the shared iteration body
(engine.run_iteration), and shard the chain axis over the mesh. One chain
per device gives the reference's worker model; several chains per device
amortize small-matrix dispatch.

All chains must share shapes (genes x samples x k x capacity); the
distributed driver pads subsets to a common size with zero-uncertainty
rows (invS2 = 0 rows contribute nothing to likelihood, reductions, or
chi^2 — they are exact no-ops in the model).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..engine import (ChainState, DeviceData, RunStats,  # noqa
                      derive_hist, init_chain_state, init_run_stats,
                      build_consts, run_iteration)
from ..models import dense
from ..ops.sweep import MassParams
from ..params import EngineConfig

CHAIN_AXIS = "chains"


def init_chain_state_batch(config, data):
    """Batched init (used for spec inference; a dummy fixed matrix is
    supplied when one factor is fixed — shapes are all that matter)."""
    if config.which_matrix_fixed == "A":
        fp = jnp.zeros((data.D.shape[1], config.n_patterns), jnp.float32)
        return jax.vmap(lambda d: init_chain_state(config, d, fp))(data)
    if config.which_matrix_fixed == "P":
        fp = jnp.zeros((data.D.shape[2], config.n_patterns), jnp.float32)
        return jax.vmap(lambda d: init_chain_state(config, d, fp))(data)
    return jax.vmap(lambda d: init_chain_state(config, d))(data)


def _init_stats_batch(config, n_chains, n_genes, n_samples, hist):
    return jax.vmap(lambda _: init_run_stats(
        config, n_genes, n_samples, hist))(jnp.arange(n_chains))


def _phase_span_multi(config, consts_a, consts_p, hist, phase, data,
                      state, stats, keys, start, stop):
    def body(it, carry):
        st, sts = carry
        st, sts = jax.vmap(
            functools.partial(run_iteration, config, consts_a, consts_p,
                              hist, phase),
            in_axes=(0, None, 0, 0, 0))(data, it, st, sts, keys)
        return st, sts

    return jax.lax.fori_loop(start, stop, body, (state, stats))


_jit_phase_span_multi = jax.jit(_phase_span_multi,
                                static_argnums=(0, 1, 2, 3, 4))


def stack_device_data(Ds, Ss, cfg: EngineConfig,
                      pad_rows: Optional[int] = None,
                      pad_cols: Optional[int] = None) -> DeviceData:
    """Stack per-chain datasets into one batched DeviceData, padding the
    gene axis (and optionally the sample axis — single-cell subsets) to
    a common size with invS2 = 0 entries (exact no-ops in every
    likelihood term)."""
    n = len(Ds)
    G = pad_rows or max(d.shape[0] for d in Ds)
    S = pad_cols or max(d.shape[1] for d in Ds)
    D_stack = np.zeros((n, G, S), np.float32)
    inv_stack = np.zeros((n, G, S), np.float32)
    lam_a = np.zeros((n,), np.float32)
    lam_p = np.zeros((n,), np.float32)
    for i, D in enumerate(Ds):
        D = np.asarray(D, np.float32)
        Si = (np.asarray(Ss[i], np.float32) if Ss is not None and Ss[i] is not None
              else dense.default_uncertainty(D))
        g, s = D.shape
        D_stack[i, :g, :s] = D
        inv_stack[i, :g, :s] = 1.0 / (Si * Si)
        lam_a[i] = dense.compute_lambda(D, cfg.alpha_a, cfg.n_patterns)
        lam_p[i] = dense.compute_lambda(D, cfg.alpha_p, cfg.n_patterns)
    Dj = jnp.asarray(D_stack)
    invj = jnp.asarray(inv_stack)
    return DeviceData(
        D=Dj, invS2=invj,
        D_t=jnp.swapaxes(Dj, 1, 2), invS2_t=jnp.swapaxes(invj, 1, 2),
        mass_a=MassParams(lam=jnp.asarray(lam_a),
                          max_gibbs_mass=jnp.asarray(
                              cfg.max_gibbs_mass_a / lam_a)),
        mass_p=MassParams(lam=jnp.asarray(lam_p),
                          max_gibbs_mass=jnp.asarray(
                              cfg.max_gibbs_mass_p / lam_p)))


class MultichainEngine:
    """Run C independent chains as one vmapped, device-sharded program.

    `data` carries a leading chain axis; states/stats/keys follow. With a
    mesh, the chain axis is sharded over `mesh` axis "chains" — XLA
    partitions the batched program with zero communication (the chains
    never interact), exactly like the reference's forked workers.
    """

    def __init__(self, data: DeviceData, config: EngineConfig,
                 mesh: Optional[jax.sharding.Mesh] = None):
        self.config = config
        self.n_chains, self.n_genes, self.n_samples = data.D.shape
        self.hist = derive_hist(config)
        self.consts_a, self.consts_p = build_consts(
            config, self.n_genes, self.n_samples)
        self.mesh = mesh
        if mesh is not None:
            spec = jax.sharding.PartitionSpec(CHAIN_AXIS)
            sharding = jax.sharding.NamedSharding(mesh, spec)
            data = jax.tree.map(
                lambda x: jax.device_put(x, sharding) if x.ndim > 0 else x,
                data)
        self.data = data

        if mesh is None:
            self._run_phase = functools.partial(
                _jit_phase_span_multi, config, self.consts_a,
                self.consts_p, self.hist)
        else:
            # explicit shard_map over the chain axis: each device runs
            # its local chains' iterations with zero communication (the
            # auto-SPMD partitioner inserts pathological collectives
            # around the sweep's gathers/scatters otherwise)
            def chain_spec(x):
                return jax.sharding.PartitionSpec(
                    *((CHAIN_AXIS,) + (None,) * (x.ndim - 1)))

            data_spec = jax.tree.map(chain_spec, self.data)
            state_ex = jax.eval_shape(
                lambda: init_chain_state_batch(config, self.data))
            stats_ex = jax.eval_shape(
                lambda: _init_stats_batch(config, self.n_chains,
                                          self.n_genes, self.n_samples,
                                          self.hist))
            state_spec = jax.tree.map(chain_spec, state_ex)
            stats_spec = jax.tree.map(chain_spec, stats_ex)
            P0 = jax.sharding.PartitionSpec
            self._shard_specs = (state_spec, stats_spec)

            jitted = {}
            for ph in (0, 1):
                fn = jax.shard_map(
                    functools.partial(_phase_span_multi, config,
                                      self.consts_a, self.consts_p,
                                      self.hist, ph),
                    mesh=mesh,
                    in_specs=(data_spec, state_spec, stats_spec,
                              P0(CHAIN_AXIS), P0(), P0()),
                    out_specs=(state_spec, stats_spec),
                    check_vma=False)
                jitted[ph] = jax.jit(fn)

            def run(phase, data, state, stats, keys, start, stop):
                return jitted[phase](data, state, stats, keys, start,
                                     stop)

            self._run_phase = run

    # ------------------------------------------------------------------
    def init_state(self, fixed_patterns=None) -> ChainState:
        def one(data_i, fixed_i):
            return init_chain_state(self.config, data_i, fixed_i)

        if fixed_patterns is None:
            state = jax.vmap(lambda d: init_chain_state(self.config, d))(
                self.data)
        else:
            fp = jnp.asarray(fixed_patterns, jnp.float32)
            if fp.ndim == 2:
                fp = jnp.broadcast_to(fp, (self.n_chains,) + fp.shape)
            state = jax.vmap(one)(self.data, fp)
        return self._shard(state)

    def init_stats(self) -> RunStats:
        stats = jax.vmap(lambda _: init_run_stats(
            self.config, self.n_genes, self.n_samples, self.hist))(
                jnp.arange(self.n_chains))
        return self._shard(stats)

    def _shard(self, tree):
        if self.mesh is None:
            return tree
        spec = jax.sharding.PartitionSpec(CHAIN_AXIS)
        sharding = jax.sharding.NamedSharding(self.mesh, spec)
        return jax.tree.map(
            lambda x: jax.device_put(x, sharding) if x.ndim > 0 else x, tree)

    # ------------------------------------------------------------------
    def run_phase(self, state, stats, seed_keys, phase: int,
                  start_iter=0, stop_iter=None
                  ) -> Tuple[ChainState, RunStats]:
        from ..engine import dispatch_spans
        stop = self.config.n_iterations if stop_iter is None else stop_iter
        for a, b in dispatch_spans(start_iter, stop,
                                   self.config.dispatch_iters):
            state, stats = self._run_phase(
                phase, self.data, state, stats, seed_keys,
                jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32))
        return state, stats

    # ------------------------------------------------------------------
    # per-shard checkpointing for multichain runs: the
    # chain axis is the sharded one; each process writes the chains it
    # holds. The reference's distributed mode has no checkpointing at
    # all (R/HelperFunctions.R:237-238) — this is parity-plus.
    def save_checkpoint(self, path_prefix: str, state, stats,
                        phase: int, it: int, seeds) -> str:
        from .multihost import save_sharded_checkpoint
        return save_sharded_checkpoint(
            path_prefix, (state, stats),
            extra={"phase": np.int32(phase), "iter": np.int32(it),
                   "seeds": np.asarray(seeds),
                   "n_chains": np.int32(self.n_chains)})

    def load_checkpoint(self, path_prefix: str):
        """Returns (state, stats, phase, iter, seeds)."""
        import glob
        from .multihost import load_sharded_checkpoint
        like = (jax.device_get(self.init_state()),
                jax.device_get(self.init_stats()))
        state, stats = load_sharded_checkpoint(path_prefix, like)
        z = np.load(sorted(glob.glob(f"{path_prefix}.shard*.npz"))[0])
        if int(z["extra_n_chains"]) != self.n_chains:
            raise ValueError("checkpoint chain count mismatch")
        if self.mesh is not None:
            spec = jax.sharding.PartitionSpec(CHAIN_AXIS)
            put = lambda x: jax.device_put(
                jnp.asarray(x),
                jax.sharding.NamedSharding(self.mesh, spec)) \
                if np.ndim(x) > 0 else jnp.asarray(x)
            state = jax.tree.map(put, state)
            stats = jax.tree.map(put, stats)
        else:
            state = jax.tree.map(jnp.asarray, state)
            stats = jax.tree.map(jnp.asarray, stats)
        return (state, stats, int(z["extra_phase"]),
                int(z["extra_iter"]), np.asarray(z["extra_seeds"]))
