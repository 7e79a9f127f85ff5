"""Smoke run of CoGAPS on one NVIDIA GPU, through the user entry points.

One process drives one card through these phases:

  device            the card's name and power limit (nvidia-smi), the jax
                    version and the compile-cache directory; with no GPU
                    among jax.devices() the script exits 1 at once
  dense-api         CoGAPS("data/GIST.csv", k=7, 2000 iterations, seed):
                    meanChiSq below 2x the reference's golden value,
                    totalUpdates > 0
  dense-reference   from dense-api's equilibrated state, one
                    ops/sweep.run_updates call per sampler on the GPU and
                    the same call with the same key on the CPU (the plain
                    reference): identical per-type counts, M to rtol 1e-5;
                    a flipped decision is replayed sweep by sweep and
                    reported lane by lane, and more than one flipped lane
                    in a call fails. chi^2 on the GPU vs float64 NumPy to
                    rtol 1e-5
  multichain        bench_harness.run_throughput at bench.py's
                    configuration (GIST, 16 chains, 2000 iterations):
                    the same convergence gate, updates/s
  sparse            a seeded 2,000 x 10,000 matrix, ~10% nonzero gamma
                    values: CoGAPS(sparse_optimization=True, k=10, 500
                    iterations); sparse chi^2 vs float64 NumPy to rtol
                    1e-4; atom mass per element equals M
  distributed       CoGAPS(GIST, distributed="genome-wide", nSets=4, k=7,
                    1000 iterations), the four subset chains vmapped on
                    one card: a consensus result of the right shapes

--four-cards runs one phase only, on four cards: distributed CoGAPS
genome-wide with nSets=4 and 500 iterations (one subset chain per
card), its per-subset
Amean/Pmean against the same chains run one at a time on one card through
MultichainEngine(mesh=None) to rtol 1e-5, and
__graft_entry__.dryrun_multichip(4).

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}, printed only when
every phase passed; otherwise the exit code is 1.

Usage: python chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GIST_CSV = os.path.join(REPO, "data", "GIST.csv")
GIST_NPZ = os.path.join(REPO, "data", "gist.npz")


# ----------------------------------------------------------------------
# device check and the result line
# ----------------------------------------------------------------------
def gpu_devices(devices) -> list:
    """The GPU devices among `devices`; raises when there is none (no
    CPU fallback: this script measures the card)."""
    gpus = [d for d in devices if d.platform == "gpu"]
    if not gpus:
        raise RuntimeError(
            "no GPU found: jax.devices() = "
            f"{[f'{d.platform}:{d.id}' for d in devices]}")
    return gpus


def result_line(devices) -> str:
    """The contract's last line, from the devices as JAX reports them."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def card_lines() -> list:
    """`nvidia-smi --query-gpu=name,power.limit` lines, one per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def golden_mean_chi_sq() -> float:
    z = np.load(GIST_NPZ)
    return float(np.asarray(z["golden_meanChiSq"]).reshape(-1)[0])


def log(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_dense_api(seed: int, n_iterations: int, ckpt_path: str):
    """CoGAPS on GIST through the API; the checkpoint written after the
    equilibration phase seeds dense-reference."""
    from cogaps_tpu import CoGAPS

    res = CoGAPS(GIST_CSV, n_patterns=7, n_iterations=n_iterations,
                 seed=seed, messages=False,
                 checkpoint_interval=n_iterations,
                 checkpoint_out_file=ckpt_path)
    golden = golden_mean_chi_sq()
    mcs = float(res.mean_chi_sq)
    upd = int(res.diagnostics["totalUpdates"])
    log(f"dense-api: meanChiSq {mcs!r} (gate < 2 x golden {golden!r}), "
        f"totalUpdates {upd}, "
        f"{res.diagnostics['totalRunningTime']!r} s")
    assert mcs < 2.0 * golden, "dense run did not converge"
    assert upd > 0, "no updates"
    return res


def _update_call_fn(consts, lanes: bool):
    """A jitted update call of one sampler from an explicit state: the
    body of engine.run_iteration's run_upd at temperature 1. With
    `lanes`, one sweep with per-lane decisions instead."""
    import jax
    import jax.numpy as jnp

    from cogaps_tpu.models import dense
    from cogaps_tpu.ops.sweep import MassParams, run_updates, sweep

    def model_of(invS2, other):
        return dense.make_model(dense.make_phase(invS2, other), invS2)

    if not lanes:
        def call(key, atoms, M, other, D, invS2, n_steps, lam, mgm):
            cache = dense.rebuild_cache(D, invS2, M, other)
            return run_updates(key, atoms, M, cache, jnp.float32(1.0),
                               n_steps, consts, MassParams(lam, mgm),
                               model=model_of(invS2, other))
        return jax.jit(call)

    def one(key, atoms, M, cache, other, invS2, remaining, lam, mgm):
        return sweep(key, atoms, M, cache, jnp.float32(1.0), remaining,
                     consts, MassParams(lam, mgm),
                     model=model_of(invS2, other), lanes=True)
    return jax.jit(one)


def _replay_flips(name, consts, key, args, gpu, cpu) -> int:
    """Replay one update call sweep by sweep on both devices, each sweep
    from the CPU's state, and report every lane whose decision differs.
    Returns the number of flipped lanes."""
    import jax
    import jax.numpy as jnp

    from cogaps_tpu.models import dense

    atoms, M, other, D, invS2, n_steps, lam, mgm = args
    one = _update_call_fn(consts, lanes=True)
    cache = dense.rebuild_cache(*jax.device_put((D, invS2, M, other), cpu))
    state = jax.device_put((atoms, M), cpu) + (cache,)
    done, i, flips = 0, 0, 0
    while done < int(n_steps):
        k = jax.random.fold_in(key, i)
        rest = (other, invS2, jnp.int32(int(n_steps) - done), lam, mgm)
        outs = {}
        for dev in (gpu, cpu):
            a, m, c = jax.device_put(state, dev)
            outs[dev] = jax.device_get(
                one(jax.device_put(k, dev), a, m, c,
                    *jax.device_put(rest, dev)))
        lg, lc = outs[gpu][5], outs[cpu][5]
        for lane in np.nonzero((lg.passed != lc.passed)
                               | (lg.kind != lc.kind))[0]:
            flips += 1
            log(f"  {name} sweep {i} lane {lane}: kind {lg.kind[lane]}/"
                f"{lc.kind[lane]} passed {lg.passed[lane]}/"
                f"{lc.passed[lane]} stat gpu {lg.stat[lane]!r} "
                f"cpu {lc.stat[lane]!r}, threshold gpu "
                f"{lg.threshold[lane]!r} cpu {lc.threshold[lane]!r}")
        state = jax.device_put(outs[cpu][:3], cpu)
        done += int(outs[cpu][3])
        i += 1
    return flips


def phase_dense_reference(seed: int, n_iterations: int, ckpt_path: str):
    """GPU vs CPU: one update call per sampler with the same key, from
    the equilibrated checkpoint of dense-api; then chi^2 vs float64."""
    import jax

    from cogaps_tpu.engine import GapsEngine
    from cogaps_tpu.io import parsers
    from cogaps_tpu.models import dense
    from cogaps_tpu.params import CogapsParams
    from cogaps_tpu.utils import checkpoint as ckpt

    D, _, _ = parsers.read_matrix(GIST_CSV)
    params = CogapsParams(n_patterns=7, n_iterations=n_iterations,
                          seed=seed)
    engine = GapsEngine(D, None, params.engine_config(*D.shape))
    state, _, phase, it = ckpt.load_checkpoint(ckpt_path, engine)
    log(f"dense-reference: state after phase {phase} iteration {it}, "
        f"atoms A {int(state.atoms_a.n)} P {int(state.atoms_p.n)}")
    gpu = gpu_devices(jax.devices())[0]
    cpu = jax.devices("cpu")[0]
    data = engine.data
    failures = []
    for name, consts, atoms, M, other, Dm, invS2, mass in (
            ("A", engine.consts_a, state.atoms_a, state.M_a, state.M_p,
             data.D, data.invS2, data.mass_a),
            ("P", engine.consts_p, state.atoms_p, state.M_p, state.M_a,
             data.D_t, data.invS2_t, data.mass_p)):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), ord(name))
        n_steps = np.int32(max(int(atoms.n), 10))
        args = (atoms, M, other, Dm, invS2, n_steps, mass.lam,
                mass.max_gibbs_mass)
        call = _update_call_fn(consts, lanes=False)
        out = {dev: jax.device_get(call(*jax.device_put((key,) + args,
                                                        dev)))
               for dev in (gpu, cpu)}
        (_, Mg, _, dg, sg, cg), (_, Mc, _, dc, sc, cc) = out[gpu], out[cpu]
        scale = float(np.abs(Mc).max())
        rel = float(np.abs(Mg - Mc).max()) / max(scale, 1e-30)
        same = (int(dg) == int(dc) and int(sg) == int(sc)
                and np.array_equal(cg.processed, cc.processed)
                and np.array_equal(cg.accepted, cc.accepted)
                and np.allclose(Mg, Mc, rtol=1e-5, atol=1e-5 * scale))
        log(f"dense-reference {name}: {int(dc)} proposals in {int(sc)} "
            f"sweeps; accepted by type gpu {cg.accepted.tolist()} cpu "
            f"{cc.accepted.tolist()}; max |dM| / max|M| {rel!r} "
            f"(tol rtol 1e-5)")
        if not same:
            flips = _replay_flips(name, consts, key, args, gpu, cpu)
            log(f"dense-reference {name}: {flips} flipped lane(s) "
                f"(at most 1 allowed)")
            if flips > 1 or flips == 0:
                failures.append(f"{name}: {flips} flipped lanes")

    cs_gpu = float(dense.chisq_from_state(data.D, data.invS2, state.M_a,
                                          state.M_p))
    D64 = np.asarray(D, np.float64)
    S64 = dense.default_uncertainty(D).astype(np.float64)
    ap = (np.asarray(state.M_a, np.float64)
          @ np.asarray(state.M_p, np.float64).T)
    cs_ref = float(np.sum(((D64 - ap) / S64) ** 2))
    cs_rel = abs(cs_gpu - cs_ref) / cs_ref
    log(f"dense-reference chi^2: gpu {cs_gpu!r} float64 {cs_ref!r} "
        f"rel {cs_rel!r} (tol 1e-5)")
    if cs_rel > 1e-5:
        failures.append(f"chi^2 rel error {cs_rel!r}")
    assert not failures, "; ".join(failures)


def phase_multichain(seed: int, n_iterations: int, n_chains: int,
                     cards: list):
    from cogaps_tpu.bench_harness import run_throughput
    from cogaps_tpu.io import parsers
    from cogaps_tpu.params import CogapsParams

    D, _, _ = parsers.read_matrix(GIST_CSV)
    params = CogapsParams(n_patterns=7, n_iterations=n_iterations,
                          seed=seed, output_frequency=0)
    r = run_throughput(D, params, n_chains=n_chains)
    golden = golden_mean_chi_sq()
    log(f"multichain: {r['updates_per_second']!r} updates/s, "
        f"{r['elapsed_s']!r} s wall for {n_chains} chains x 2 x "
        f"{n_iterations} iterations ({r['total_updates']} updates) on "
        f"{' | '.join(cards)}; chain 0 meanChiSq {r['mean_chi_sq']!r} "
        f"(gate < 2 x golden {golden!r})")
    assert r["mean_chi_sq"] < 2.0 * golden, "multichain did not converge"


def sparse_matrix(seed: int, n_genes: int, n_cells: int,
                  density: float) -> np.ndarray:
    """Single-cell-like data: ~density nonzeros with gamma values."""
    rng = np.random.default_rng(seed)
    D = rng.gamma(2.0, 1.0, (n_genes, n_cells)).astype(np.float32)
    D[rng.random((n_genes, n_cells)) >= density] = 0.0
    return D


def phase_sparse(seed: int, n_genes: int, n_cells: int, k: int,
                 n_iterations: int, ckpt_path: str):
    import jax.numpy as jnp

    from cogaps_tpu import CoGAPS
    from cogaps_tpu.models import sparse
    from cogaps_tpu.ops.atoms import total_mass_per_element
    from cogaps_tpu.params import CogapsParams
    from cogaps_tpu.sparse_engine import SparseGapsEngine
    from cogaps_tpu.utils import checkpoint as ckpt
    from cogaps_tpu.utils.debug import check_state

    D = sparse_matrix(seed, n_genes, n_cells, 0.1)
    res = CoGAPS(D, sparse_optimization=True, n_patterns=k,
                 n_iterations=n_iterations, seed=seed, messages=False,
                 checkpoint_interval=n_iterations,
                 checkpoint_out_file=ckpt_path)
    log(f"sparse: {n_genes} x {n_cells}, {int((D > 0).sum())} nonzeros, "
        f"k={k}, {n_iterations} iterations: meanChiSq "
        f"{float(res.mean_chi_sq)!r}, totalUpdates "
        f"{int(res.diagnostics['totalUpdates'])}, "
        f"{res.diagnostics['totalRunningTime']!r} s")
    assert np.isfinite(res.Amean).all() and np.isfinite(res.Pmean).all()

    ell = sparse.to_ell(D)
    cs_gpu = float(sparse.sparse_chisq(ell, jnp.asarray(res.Amean),
                                       jnp.asarray(res.Pmean)))
    D64 = D.astype(np.float64)
    S64 = np.where(D > 0, 0.1 * D64, 0.1)
    ap = res.Amean.astype(np.float64) @ res.Pmean.astype(np.float64).T
    cs_ref = float(np.sum(((D64 - ap) / S64) ** 2))
    cs_rel = abs(cs_gpu - cs_ref) / cs_ref
    log(f"sparse chi^2: gpu {cs_gpu!r} float64 {cs_ref!r} rel {cs_rel!r} "
        f"(tol 1e-4)")
    assert cs_rel < 1e-4, "sparse chi^2 disagrees with float64"

    params = CogapsParams(n_patterns=k, n_iterations=n_iterations,
                          seed=seed, sparse_optimization=True)
    engine = SparseGapsEngine(D, params.engine_config(n_genes, n_cells))
    state, _, _, _ = ckpt.load_checkpoint(ckpt_path, engine)
    check_state(state, k)
    for name, atoms, M in (("A", state.atoms_a, state.M_a),
                           ("P", state.atoms_p, state.M_p)):
        M = np.asarray(M)
        mass = np.asarray(total_mass_per_element(
            atoms, M.size)).reshape(M.shape)
        err = float(np.abs(mass - M).max())
        log(f"sparse mass invariant {name}: {int(atoms.n)} atoms, max "
            f"|mass per element - M| {err!r} (tol 1e-4 + 1e-4 |M|)")
        np.testing.assert_allclose(mass, M, rtol=1e-4, atol=1e-4)


def phase_distributed(seed: int, n_iterations: int):
    from cogaps_tpu import CoGAPS
    from cogaps_tpu.io import parsers

    D, _, _ = parsers.read_matrix(GIST_CSV)
    res = CoGAPS(GIST_CSV, distributed="genome-wide", n_sets=4,
                 n_patterns=7, n_iterations=n_iterations, seed=seed,
                 messages=False)
    check_consensus(res, D.shape)
    log(f"distributed: genome-wide nSets=4, {n_iterations} iterations: "
        f"{res.Amean.shape[1]} consensus patterns, Amean "
        f"{res.Amean.shape}, Pmean {res.Pmean.shape}, meanChiSq "
        f"{float(res.mean_chi_sq)!r}")


def check_consensus(res, shape) -> None:
    n_genes, n_samples = shape
    kc = res.Amean.shape[1]  # patternMatch may split past nPatterns
    assert kc >= 1, kc
    assert res.Amean.shape == (n_genes, kc)
    assert res.Pmean.shape == (n_samples, kc)
    assert np.asarray(res.diagnostics["consensusPatterns"]).shape == (
        n_samples, kc)
    assert sorted(g for s in res.diagnostics["subsets"] for g in s) == (
        sorted(res.gene_names))
    assert np.isfinite(res.Amean).all() and (res.Amean >= 0).all()
    assert np.isfinite(res.Pmean).all() and (res.Pmean >= 0).all()


def phase_four_cards(seed: int, n_iterations: int):
    """Distributed genome-wide on four cards, checked chain by chain
    against one-card runs of the same padded subsets and keys. Each
    card's shard of the mesh program is the batch-1 chain program that
    MultichainEngine(mesh=None) runs for one chain, so the two agree."""
    import jax
    from jax.sharding import Mesh

    import __graft_entry__
    from cogaps_tpu import CoGAPS
    from cogaps_tpu.engine import EQUILIBRATION, SAMPLING
    from cogaps_tpu.io import parsers
    from cogaps_tpu.params import CogapsParams
    from cogaps_tpu.parallel.distributed import create_sets, subset_chains
    from cogaps_tpu.parallel.multichain import MultichainEngine
    from cogaps_tpu.result import finalize_statistics

    devs = gpu_devices(jax.devices())
    assert len(devs) >= 4, f"--four-cards needs 4 GPUs, found {len(devs)}"
    D, genes, _ = parsers.read_matrix(GIST_CSV)

    t0 = time.perf_counter()
    res = CoGAPS(GIST_CSV, distributed="genome-wide", n_sets=4,
                 n_patterns=7, n_iterations=n_iterations, seed=seed,
                 messages=False)
    check_consensus(res, D.shape)
    log(f"four-cards distributed: {res.Amean.shape[1]} consensus "
        f"patterns, meanChiSq {float(res.mean_chi_sq)!r}, "
        f"{time.perf_counter() - t0!r} s")

    params = CogapsParams(n_patterns=7, n_iterations=n_iterations,
                          seed=seed, distributed="genome-wide", n_sets=4)
    sets = create_sets(D.shape[0], params,
                       np.random.default_rng(params.resolved_seed()),
                       genes)
    sc = subset_chains(D, None, params, sets, True, None)

    def run(eng, keys):
        st, ss = eng.init_state(), eng.init_stats()
        st, ss = eng.run_phase(st, ss, keys, EQUILIBRATION)
        st, ss = eng.run_phase(st, ss, keys, SAMPLING)
        return jax.device_get(ss)

    def means(ss, i, g):
        a, _, p, _ = finalize_statistics(
            np.asarray(ss.a_sum[i][:g]), np.asarray(ss.a_sumsq[i][:g]),
            np.asarray(ss.p_sum[i]), np.asarray(ss.p_sumsq[i]),
            int(ss.n_stat[i]))
        return a, p

    mesh = Mesh(np.array(devs[:4]), ("chains",))
    s4 = run(MultichainEngine(sc.data, sc.config, mesh=mesh), sc.keys)
    for i in range(4):
        data_i = jax.tree.map(lambda x: x[i:i + 1], sc.data)
        s1 = run(MultichainEngine(data_i, sc.config, mesh=None),
                 sc.keys[i:i + 1])
        g = sc.subDs[i].shape[0]
        (a4, p4), (a1, p1) = means(s4, i, g), means(s1, 0, g)
        ra = float(np.abs(a4 - a1).max() / max(np.abs(a1).max(), 1e-30))
        rp = float(np.abs(p4 - p1).max() / max(np.abs(p1).max(), 1e-30))
        log(f"four-cards subset {i}: {g} genes, max rel |dAmean| {ra!r} "
            f"|dPmean| {rp!r} (tol rtol 1e-5)")
        np.testing.assert_allclose(a4, a1, rtol=1e-5,
                                   atol=1e-5 * np.abs(a1).max())
        np.testing.assert_allclose(p4, p1, rtol=1e-5,
                                   atol=1e-5 * np.abs(p1).max())
    __graft_entry__.dryrun_multichip(4)


# ----------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card distributed phase")
    args = ap.parse_args(argv)

    # the CPU backend is the plain reference of dense-reference: keep it
    # reachable when the platform list was narrowed to the GPU
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    devices = jax.devices()
    try:
        gpu_devices(devices)
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1

    from cogaps_tpu.utils.compile_cache import configure_compile_cache

    cache = configure_compile_cache()
    failed = []

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        try:
            fn(*a)
            log(f"PASS {name} ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc()
            log(f"FAIL {name} ({time.perf_counter() - t0:.1f} s)")
            failed.append(name)

    cards = []

    def device_phase():
        cards.extend(card_lines())
        for c in cards:
            log(f"card: {c}")
        log(f"jax {jax.__version__}, devices {devices}, compile cache "
            f"{cache}")

    phase("device", device_phase)
    with tempfile.TemporaryDirectory() as tmp:
        if args.four_cards:
            phase("four-cards", phase_four_cards, args.seed, 500)
        else:
            dense_ckpt = os.path.join(tmp, "dense.npz")
            phase("dense-api", phase_dense_api, args.seed, 2000,
                  dense_ckpt)
            phase("dense-reference", phase_dense_reference, args.seed,
                  2000, dense_ckpt)
            phase("multichain", phase_multichain, args.seed, 2000, 16,
                  cards)
            phase("sparse", phase_sparse, args.seed, 2000, 10000, 10, 500,
                  os.path.join(tmp, "sparse.npz"))
            phase("distributed", phase_distributed, args.seed, 1000)
    if failed:
        log(f"chip_smoke: failed phases: {', '.join(failed)}")
        return 1
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
