"""Micro-benchmark for the Gibbs sweep kernel on the current backend.

Times K chained sweeps (lax.scan) for the A- and P-sampler configs of a
GIST-shaped problem, at a configurable chain count (vmap), so per-sweep
latency and its batch scaling can be measured in isolation from the
driver. Usage: python tools/perf_sweep.py [n_chains] [K]
"""
import os, sys, time
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import jax, jax.numpy as jnp, numpy as np
from cogaps_tpu.io import parsers
from cogaps_tpu.params import CogapsParams
from cogaps_tpu.engine import prepare_device_data, build_consts
from cogaps_tpu.models import dense
from cogaps_tpu.ops.sweep import sweep
from cogaps_tpu.ops.atoms import init_atoms, AtomTable


def bench_sampler(name, D, invS2, consts, mass, n_atoms0, n_chains, K, seed=0):
    NR, m, k = consts.n_rows, consts.m, consts.k

    def mk_chain(key):
        ka, km = jax.random.split(key)
        elem = jax.random.randint(ka, (consts.capacity,), 0, consts.n_bins)
        alive = jnp.arange(consts.capacity) < n_atoms0
        elem = jnp.where(alive, elem, -1)
        mass_arr = jnp.where(alive, jax.random.uniform(km, (consts.capacity,)) + 0.1, 0.0)
        atoms = AtomTable(mass=mass_arr, elem=elem, n=jnp.asarray(n_atoms0, jnp.int32))
        M = jax.random.uniform(km, (NR, k)) * 2.0
        other = jax.random.uniform(ka, (m, k)) * 2.0
        R = (jnp.zeros((NR, m)) + 1.0)
        return atoms, M, other, R

    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(n_chains) + seed)
    atoms, M, other, R = jax.vmap(mk_chain)(keys)

    def run_k(key, atoms, M, other, R):
        phase = dense.make_phase(invS2, other)
        model = dense.make_model(phase, invS2)
        Y0 = jnp.dot(R, other)

        def body(carry, i):
            atoms, M, cache = carry
            k2 = jax.random.fold_in(key, i)
            atoms, M, cache, n_proc, _cnt = sweep(
                k2, atoms, M, cache, jnp.float32(1.0),
                jnp.asarray(10**9, jnp.int32), consts, mass, model=model)
            return (atoms, M, cache), n_proc

        (atoms, M, cache), n_procs = jax.lax.scan(
            body, (atoms, M, dense.DenseCache(Y0)), jnp.arange(K))
        import os
        if os.environ.get("PS_RETURN_SMALL"):
            return atoms.n, M, jnp.sum(n_procs)
        return atoms, M, jnp.sum(n_procs)

    fn = jax.jit(jax.vmap(run_k, in_axes=(0, 0, 0, 0, 0)))
    out = fn(keys, atoms, M, other, R)
    jax.block_until_ready(out[1])
    t0 = time.perf_counter()
    out = fn(keys, atoms, M, other, R)
    jax.block_until_ready(out[1])
    dt = time.perf_counter() - t0
    n_done = int(np.sum(np.asarray(out[2])))
    print(f"{name}: chains={n_chains} K={K} total {dt*1e3:.1f}ms "
          f"-> {dt/K*1e6:.0f}us/sweep  processed={n_done} "
          f"({n_done/dt/1e6:.2f}M upd/s)", flush=True)


def main():
    n_chains = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    D, _, _ = parsers.read_matrix(os.path.join(REPO, "data", "GIST.csv"))
    params = CogapsParams(n_patterns=7, n_iterations=1000, seed=1)
    cfg = params.engine_config(*D.shape)
    data = prepare_device_data(D, None, cfg)
    consts_a, consts_p = build_consts(cfg, *D.shape)
    print("A consts:", {k: getattr(consts_a, k) for k in
          ("n_rows", "m", "k", "capacity", "batch")}, flush=True)
    print("P consts:", {k: getattr(consts_p, k) for k in
          ("n_rows", "m", "k", "capacity", "batch")}, flush=True)
    bench_sampler("A-sampler", D, data.invS2, consts_a, data.mass_a,
                  3000, n_chains, K)
    bench_sampler("P-sampler", D.T, data.invS2_t, consts_p, data.mass_p,
                  100, n_chains, K)


if __name__ == "__main__":
    main()
