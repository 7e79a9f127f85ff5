"""Gene-sharded single chain: one Gibbs chain over data too large for one
device, sharded along the genes axis with shard_map.

This is the "scale the long axis" parallelism the reference lacks at the
native level (SURVEY.md §5 long-context: its only mechanism is the
subset+consensus scheme). ONE chain runs with D, A (and uncertainties)
row-sharded over the mesh axis "genes"; P is replicated.

DETERMINISM CONTRACT (the analog of the reference's thread-count
invariance, tests/testthat/test_seed_consistency.R:36-68, achieved there
by RNG rollback + per-proposal streams, ProposalQueue.h:19): the unit of
A-side parallelism is a fixed ROW BLOCK, not a device. The gene axis is
partitioned into `n_blocks` static blocks; every stream is keyed by
(seed, phase, iteration, BLOCK ID), every A-side atom table and proposal
batch is block-local, and every cross-block float reduction (the P
sampler's SQ/Y/Z tables, chi^2) is an all_gather of per-block partials
summed in block order — never a device-count-shaped psum tree. Devices
merely own contiguous groups of blocks, so the SAME SEED GIVES BITWISE
THE SAME TRAJECTORY ON 1, 2, 4, ... n_blocks DEVICES
(tests/test_parallel.py::test_sharded_device_count_invariance).

* A sampler — per block: each block Gibbs-samples its own row slice
  against the replicated P (the likelihood factorizes over rows while P
  is frozen — the same argument as ops/sweep.py), with a block-local
  compact atom table and a block-keyed proposal stream. Moves/exchanges
  stay within the block (a valid blocked kernel mixture; the reference's
  distributed mode restricts them to the subset the same way).
* P sampler — replicated: every device draws IDENTICAL proposals and
  evaluates them against the ordered-sum conditional tables; the P
  factor and its atom table evolve identically on all devices.
* integer counters (totalUpdates, atom counts) cross shards via psum —
  integer sums are order-exact.

The atlas memory plan (SURVEY.md §7.10): A is G x k fp32 (1M x 50 =
200 MB) sharded with D; P (30k x 50) replicated.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine import (ChainState, DeviceData, EQUILIBRATION, RunStats,
                      _LO_BITS, _LO_MASK, derive_hist, init_run_stats)
from ..models import dense
from ..ops import rng as gaps_rng
from ..ops.atoms import AtomTable
from ..ops.sweep import (MassParams, SweepCounts, make_consts,
                         run_updates)
from ..params import EngineConfig

GENE_AXIS = "genes"


def pad_to_multiple(D: np.ndarray, S: Optional[np.ndarray], n: int):
    """Pad the gene axis to a multiple of n. Padded rows get invS2 = 0
    downstream => they are exact no-ops in every likelihood term."""
    G = D.shape[0]
    pad = (-G) % n
    if pad == 0:
        return D, S, G
    D2 = np.concatenate([D, np.zeros((pad, D.shape[1]), D.dtype)], axis=0)
    if S is None:
        S = dense.default_uncertainty(D)
    S2 = np.concatenate([S, np.full((pad, D.shape[1]), 1.0, np.float32)],
                        axis=0)
    return D2, S2, G


def _atom_spec(axis) -> AtomTable:
    return AtomTable(mass=P(axis), elem=P(axis), n=P(axis))


class ShardedGapsEngine:
    """One chain, genes axis block-partitioned and sharded over `mesh`
    axis "genes". Results are invariant to the device count (blocks per
    device) for a fixed n_blocks."""

    def __init__(self, D: np.ndarray, S: Optional[np.ndarray],
                 config: EngineConfig, mesh: Mesh,
                 n_blocks: Optional[int] = None):
        if GENE_AXIS not in mesh.axis_names:
            raise ValueError(f"mesh must have a '{GENE_AXIS}' axis")
        self.mesh = mesh
        n_dev = mesh.shape[GENE_AXIS]
        self.n_dev = n_dev
        self.n_blocks = int(n_blocks or max(8, n_dev))
        if self.n_blocks % n_dev != 0:
            raise ValueError("n_blocks must be a multiple of the device "
                             "count")
        self.bpd = self.n_blocks // n_dev  # blocks per device

        D = np.asarray(D, np.float32)
        D, S, self.n_genes_orig = pad_to_multiple(D, S, self.n_blocks)
        if S is None:
            S = dense.default_uncertainty(D)
        S = np.asarray(S, np.float32)
        inv = (1.0 / (S * S)).astype(np.float32)
        inv[self.n_genes_orig:] = 0.0  # padded rows contribute nothing

        self.n_genes, self.n_samples = D.shape
        self.g_blk = self.n_genes // self.n_blocks
        self.config = config
        self.hist = derive_hist(config)
        k = config.n_patterns

        lam_a = dense.compute_lambda(D[: self.n_genes_orig], config.alpha_a, k)
        lam_p = dense.compute_lambda(D[: self.n_genes_orig], config.alpha_p, k)
        self.lam_a, self.lam_p = lam_a, lam_p
        mass_a = MassParams(jnp.float32(lam_a),
                            jnp.float32(config.max_gibbs_mass_a / lam_a))
        mass_p = MassParams(jnp.float32(lam_p),
                            jnp.float32(config.max_gibbs_mass_p / lam_p))
        self.mass_a, self.mass_p = mass_a, mass_p

        # per-BLOCK A consts (block-local bins/capacity/batch) and the
        # replicated P consts (no axis_name: reductions are explicit
        # ordered sums, not psums)
        self.cap_blk = max(256, config.capacity_a // self.n_blocks)
        self.batch_blk = max(32, config.batch_a // self.n_blocks)
        self.consts_a = make_consts(
            self.g_blk, self.n_samples, k, self.cap_blk, self.batch_blk,
            config.alpha_a, local_moves=config.local_moves)
        self.consts_p = make_consts(
            self.n_samples, self.n_genes, k, config.capacity_p,
            config.batch_p, config.alpha_p,
            local_moves=config.local_moves)

        Dj = jnp.asarray(D)
        invj = jnp.asarray(inv)
        self.data = DeviceData(D=Dj, invS2=invj, D_t=Dj.T, invS2_t=invj.T,
                               mass_a=mass_a, mass_p=mass_p)

        self.data_spec = DeviceData(
            D=P(GENE_AXIS, None), invS2=P(GENE_AXIS, None),
            D_t=P(None, GENE_AXIS), invS2_t=P(None, GENE_AXIS),
            mass_a=MassParams(P(), P()), mass_p=MassParams(P(), P()))
        # A atoms: (n_blocks, cap_blk) block tables sharded over devices
        self.state_spec = ChainState(
            atoms_a=_atom_spec(GENE_AXIS),
            atoms_p=AtomTable(mass=P(None), elem=P(None), n=P()),
            M_a=P(GENE_AXIS, None), M_p=P(None, None))
        self.stats_spec = RunStats(
            a_sum=P(GENE_AXIS, None), a_sumsq=P(GENE_AXIS, None),
            p_sum=P(None, None), p_sumsq=P(None, None),
            n_stat=P(), pump=P(GENE_AXIS, None), n_pump=P(),
            chisq_hist=P(None), atom_hist_a=P(None), atom_hist_p=P(None),
            snap_a=P(None, GENE_AXIS, None), snap_p=P(None, None, None),
            upd_lo=P(), upd_hi=P(),
            prop_counts=P(None, None), acc_counts=P(None, None),
            sweep_counts=P(None))

        in_specs = (self.data_spec, self.state_spec, self.stats_spec,
                    P(None), P(), P())
        out_specs = (self.state_spec, self.stats_spec)
        self._run_phase = {}
        for ph in (0, 1):
            fn = jax.shard_map(
                functools.partial(self._phase_local, phase_static=ph),
                mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                check_vma=False)
            self._run_phase[ph] = jax.jit(fn)

    # ------------------------------------------------------------------
    def _ordered_sum(self, partials):
        """Sum per-block partials in GLOBAL BLOCK ORDER: all_gather the
        local (bpd, ...) stacks (device order == block order for
        contiguous assignment) and reduce over the static n_blocks axis
        — a device-count-independent summation order, unlike psum."""
        full = jax.lax.all_gather(partials, GENE_AXIS, axis=0,
                                  tiled=True)  # (n_blocks, ...)
        return jnp.sum(full, axis=0)

    def _iteration(self, data, it, state, stats, seed_key, phase):
        cfg = self.config
        k = cfg.n_patterns
        bpd, g_blk = self.bpd, self.g_blk
        fixed = cfg.which_matrix_fixed

        key_it = jax.random.fold_in(jax.random.fold_in(seed_key, phase),
                                    it)
        kpa, kpp, kua, kup = jax.random.split(key_it, 4)
        blk_ids = (jax.lax.axis_index(GENE_AXIS) * bpd
                   + jnp.arange(bpd, dtype=jnp.int32))

        if phase == EQUILIBRATION:
            temp = jnp.minimum(
                1.0, (2.0 * it.astype(jnp.float32)) / cfg.n_iterations)
        else:
            temp = jnp.float32(1.0)

        atoms_a, M_a = state.atoms_a, state.M_a
        atoms_p, M_p = state.atoms_p, state.M_p
        # local block views
        Db = data.D.reshape(bpd, g_blk, self.n_samples)
        invb = data.invS2.reshape(bpd, g_blk, self.n_samples)
        Mb = M_a.reshape(bpd, g_blk, k)
        done_a = jnp.zeros((), jnp.int32)
        done_p = jnp.zeros((), jnp.int32)
        cnt_a = SweepCounts(processed=jnp.zeros((4,), jnp.int32),
                            accepted=jnp.zeros((4,), jnp.int32))
        cnt_p = cnt_a
        ns_a = jnp.zeros((), jnp.int32)
        ns_p = jnp.zeros((), jnp.int32)

        if fixed != "A":
            def upd_block(blk_id, at, Mx, Dx, ix):
                kb = jax.random.fold_in(kua, blk_id)
                kp = jax.random.fold_in(kpa, blk_id)
                n_b = gaps_rng.poisson(
                    kp, jnp.maximum(at.n, 10).astype(jnp.float32))
                cache = dense.rebuild_cache(Dx, ix, Mx, M_p)
                model = dense.make_model(dense.make_phase(ix, M_p), ix)
                at, Mx, _, done, ns, cnt = run_updates(
                    kb, at, Mx, cache, temp, n_b, self.consts_a,
                    self.mass_a, model=model)
                return at, Mx, done, ns, cnt

            # lax.map, not vmap: per-block computations must lower to
            # the SAME batch-1 programs for every device count, or
            # batched-matmul reassociation breaks bitwise invariance
            atoms_a, Mb, dns, nss, cnts = jax.lax.map(
                lambda t: upd_block(*t), (blk_ids, atoms_a, Mb, Db, invb))
            M_a = Mb.reshape(bpd * g_blk, k)
            done_a = jnp.sum(dns)
            ns_a = jnp.sum(nss)
            cnt_a = SweepCounts(processed=jnp.sum(cnts.processed, 0),
                                accepted=jnp.sum(cnts.accepted, 0))

        if fixed != "P":
            # conditional tables for the replicated P sampler from
            # per-block partials summed in block order (exact for any
            # device count)
            def block_tables(Mx, Dx, ix):
                # partial SQ/Z over this block's gene rows (the
                # reductions of dense.make_phase), plus the partial Y
                oo = (Mx[:, :, None] * Mx[:, None, :]).reshape(
                    g_blk, k * k)
                ixt = ix.T  # (S, g_blk)
                sq = jnp.dot(ixt, Mx * Mx,
                             preferred_element_type=jnp.float32,
                             precision=dense.HIGHEST)
                z = jnp.dot(ixt, oo, preferred_element_type=jnp.float32,
                            precision=dense.HIGHEST)
                R = (Dx.T - jnp.dot(M_p, Mx.T,
                                    preferred_element_type=jnp.float32,
                                    precision=dense.HIGHEST)
                     ) * ixt
                Y = jnp.dot(R, Mx, preferred_element_type=jnp.float32,
                            precision=dense.HIGHEST)
                cmax = jnp.max(Mx, axis=0)
                return sq, z, Y, cmax

            sqs, zs, Ys, cmaxs = jax.lax.map(
                lambda t: block_tables(*t), (Mb, Db, invb))
            SQ_p = self._ordered_sum(sqs)
            Z_p = self._ordered_sum(zs)
            Y_p = self._ordered_sum(Ys)
            col_max = jnp.max(jax.lax.all_gather(
                cmaxs, GENE_AXIS, axis=0, tiled=True), axis=0)
            phase_p = dense.DensePhase(
                SQ=SQ_p, Z=Z_p.reshape(self.n_samples * k, k),
                col_nz=col_max > 0.0)
            model_p = dense.make_model(phase_p, data.invS2_t)
            n_p = gaps_rng.poisson(
                kpp, jnp.maximum(atoms_p.n, 10).astype(jnp.float32))
            atoms_p, M_p, _, done_p, ns_p, cnt_p = run_updates(
                kup, atoms_p, M_p, dense.DenseCache(Y=Y_p), temp, n_p,
                self.consts_p, self.mass_p, model=model_p)

        state = ChainState(atoms_a=atoms_a, atoms_p=atoms_p,
                           M_a=M_a, M_p=M_p)

        # ---- statistics (ordered-sum chi^2; integer psums are exact)
        stats = self._accumulate(phase, it, state, stats, Db, invb,
                                 done_a, done_p, ns_a, ns_p, cnt_a,
                                 cnt_p)
        return state, stats

    def _accumulate(self, phase, it, state, stats, Db, invb, done_a,
                    done_p, ns_a, ns_p, cnt_a, cnt_p):
        cfg = self.config
        k = cfg.n_patterns
        from ..engine import SAMPLING
        M_a, M_p = state.M_a, state.M_p

        done_a = jax.lax.psum(done_a, GENE_AXIS)
        inc = done_a + done_p
        lo = stats.upd_lo + inc
        stats = stats.replace(upd_lo=lo & _LO_MASK,
                              upd_hi=stats.upd_hi + (lo >> _LO_BITS))
        ns_a, pa, aa = jax.lax.psum(
            (ns_a, cnt_a.processed, cnt_a.accepted), GENE_AXIS)
        stats = stats.replace(
            prop_counts=stats.prop_counts.at[0].add(pa).at[1].add(
                cnt_p.processed),
            acc_counts=stats.acc_counts.at[0].add(aa).at[1].add(
                cnt_p.accepted),
            sweep_counts=stats.sweep_counts.at[0].add(ns_a).at[1].add(
                ns_p))

        if phase == SAMPLING and cfg.which_matrix_fixed == "N":
            norm = jnp.max(M_p, axis=0)
            norm = jnp.where(norm == 0.0, 1.0, norm)
            q = M_p / norm
            prod = M_a * norm
            stats = stats.replace(
                p_sum=stats.p_sum + q, p_sumsq=stats.p_sumsq + q * q,
                a_sum=stats.a_sum + prod,
                a_sumsq=stats.a_sumsq + prod * prod,
                n_stat=stats.n_stat + 1)
        elif phase == SAMPLING and cfg.which_matrix_fixed == "P":
            stats = stats.replace(
                a_sum=stats.a_sum + M_a,
                a_sumsq=stats.a_sumsq + M_a * M_a,
                n_stat=stats.n_stat + 1)
        elif phase == SAMPLING and cfg.which_matrix_fixed == "A":
            stats = stats.replace(
                p_sum=stats.p_sum + M_p,
                p_sumsq=stats.p_sumsq + M_p * M_p,
                n_stat=stats.n_stat + 1)

        if self.hist.n_hist > 0:
            rec = (it + 1) % cfg.output_frequency == 0

            def chisq_fn():
                Mb = M_a.reshape(self.bpd, self.g_blk, k)

                def blk_cs(Mx, Dx, ix):
                    R = (Dx - jnp.dot(
                        Mx, M_p.T, preferred_element_type=jnp.float32,
                        precision=dense.HIGHEST)) * ix
                    return jnp.sum(jnp.where(ix > 0, R * R / ix, 0.0))

                parts = jax.lax.map(lambda t: blk_cs(*t),
                                    (Mb, Db, invb))
                return self._ordered_sum(parts)

            cs = jax.lax.cond(rec, chisq_fn, lambda: jnp.float32(0.0))
            n_atoms_a = jax.lax.psum(jnp.sum(state.atoms_a.n), GENE_AXIS)
            h_idx = (phase * (self.hist.n_hist // 2)
                     + (it + 1) // cfg.output_frequency - 1)
            h_idx = jnp.where(rec, h_idx, -1)
            from ..ops.onehot import write_at
            stats = stats.replace(
                chisq_hist=write_at(stats.chisq_hist, h_idx, cs),
                atom_hist_a=write_at(stats.atom_hist_a, h_idx,
                                     n_atoms_a),
                atom_hist_p=write_at(stats.atom_hist_p, h_idx,
                                     state.atoms_p.n))
        return stats

    # ------------------------------------------------------------------
    def _phase_local(self, data, state, stats, seed_key, start, stop,
                     *, phase_static: int):
        """Per-device body: fori_loop over the block-keyed iteration."""

        def body(it, carry):
            st, sts = carry
            return self._iteration(data, it, st, sts, seed_key,
                                   phase_static)

        return jax.lax.fori_loop(start, stop, body, (state, stats))

    # ------------------------------------------------------------------
    def _put(self, tree, specs):
        return jax.tree.map(
            lambda x, s: jax.device_put(jnp.asarray(x),
                                        NamedSharding(self.mesh, s)),
            tree, specs)

    def init_state(self, fixed_patterns=None) -> ChainState:
        k = self.config.n_patterns
        M_a = jnp.zeros((self.n_genes, k), jnp.float32)
        M_p = jnp.zeros((self.n_samples, k), jnp.float32)
        if self.config.which_matrix_fixed == "A":
            fp = np.zeros((self.n_genes, k), np.float32)
            fp[: self.n_genes_orig] = np.asarray(fixed_patterns, np.float32)
            M_a = jnp.asarray(fp)
        elif self.config.which_matrix_fixed == "P":
            M_p = jnp.asarray(fixed_patterns, jnp.float32)
        state = ChainState(
            atoms_a=AtomTable(
                mass=jnp.zeros((self.n_blocks, self.cap_blk), jnp.float32),
                elem=jnp.full((self.n_blocks, self.cap_blk), -1, jnp.int32),
                n=jnp.zeros((self.n_blocks,), jnp.int32)),
            atoms_p=AtomTable(
                mass=jnp.zeros((self.config.capacity_p,), jnp.float32),
                elem=jnp.full((self.config.capacity_p,), -1, jnp.int32),
                n=jnp.zeros((), jnp.int32)),
            M_a=M_a, M_p=M_p)
        return self._put(state, self.state_spec)

    def init_stats(self) -> RunStats:
        stats = init_run_stats(self.config, self.n_genes, self.n_samples,
                               self.hist)
        return self._put(stats, self.stats_spec)

    def sharded_data(self) -> DeviceData:
        return self._put(self.data, self.data_spec)

    # ------------------------------------------------------------------
    def run_phase(self, state, stats, seed_key, phase: int, start_iter=0,
                  stop_iter=None) -> Tuple[ChainState, RunStats]:
        from ..engine import dispatch_spans
        stop = self.config.n_iterations if stop_iter is None else stop_iter
        data = self.sharded_data()
        for a, b in dispatch_spans(start_iter, stop,
                                   self.config.dispatch_iters):
            state, stats = self._run_phase[phase](
                data, state, stats, seed_key,
                jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32))
        return state, stats

    # ------------------------------------------------------------------
    def trim(self, arr: np.ndarray) -> np.ndarray:
        """Strip gene-axis padding from a gathered result array."""
        return np.asarray(arr)[: self.n_genes_orig]

    # ------------------------------------------------------------------
    # per-shard checkpointing: each process writes only
    # its addressable shards; resume re-places them on the current mesh.
    # The single-chip engine's npz checkpoints (utils/checkpoint.py)
    # cover api runs; these cover the sharded mode the reference lacks.
    def save_checkpoint(self, path_prefix: str, state, stats, phase: int,
                        it: int, seed: int) -> str:
        from .multihost import save_sharded_checkpoint
        return save_sharded_checkpoint(
            path_prefix, (state, stats),
            extra={"phase": np.int32(phase), "iter": np.int32(it),
                   "seed": np.int64(seed),
                   "n_blocks": np.int32(self.n_blocks),
                   "n_genes": np.int64(self.n_genes_orig),
                   "n_samples": np.int64(self.n_samples),
                   "k": np.int32(self.config.n_patterns)})

    def load_checkpoint(self, path_prefix: str):
        """Returns (state, stats, phase, iter, seed) re-placed on this
        engine's mesh. The device count may DIFFER from the saving
        run's — block state is device-count-independent."""
        import glob
        from .multihost import load_sharded_checkpoint
        like = (jax.device_get(self.init_state()),
                jax.device_get(self.init_stats()))
        state, stats = load_sharded_checkpoint(path_prefix, like)
        z = np.load(sorted(glob.glob(f"{path_prefix}.shard*.npz"))[0])
        if int(z["extra_n_blocks"]) != self.n_blocks:
            raise ValueError(
                f"checkpoint has n_blocks={int(z['extra_n_blocks'])}, "
                f"engine has {self.n_blocks}")
        return (self._put(state, self.state_spec),
                self._put(stats, self.stats_spec),
                int(z["extra_phase"]), int(z["extra_iter"]),
                int(z["extra_seed"]))

