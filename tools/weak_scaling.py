"""Weak-scaling harness: multichain throughput vs device count.

Measures the distributed-chains configuration (one chain per device,
fixed per-chain problem size — the reference's worker model,
R/DistributedCogaps.R:56-67) at 1, 2, 4, ... devices and reports
efficiency = T(1 device, 1 chain) / T(n devices, n chains). Target:
>= 80% (BASELINE.md). Runs on the devices JAX finds; with --cpu, on a
virtual CPU mesh of max_devices devices instead.

Usage: python tools/weak_scaling.py [max_devices] [n_iterations] [--cpu]
Prints one JSON line with per-n timings and efficiencies.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    argv = [a for a in sys.argv[1:] if a != "--cpu"]
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices",
                          int(argv[0]) if argv else 8)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from cogaps_tpu.engine import EQUILIBRATION
    from cogaps_tpu.params import CogapsParams
    from cogaps_tpu.parallel.multichain import (MultichainEngine,
                                                stack_device_data)

    max_dev = int(argv[0]) if argv else len(jax.devices())
    n_iter = int(argv[1]) if len(argv) > 1 else 120

    rng = np.random.default_rng(0)
    A = rng.gamma(2.0, 1.0, (200, 5)).astype(np.float32)
    P = rng.gamma(2.0, 1.0, (40, 5)).astype(np.float32)
    D = (A @ P.T + rng.normal(0, 0.1, (200, 40))).clip(0).astype(np.float32)

    params = CogapsParams(n_patterns=5, n_iterations=n_iter, seed=3,
                          output_frequency=0)
    cfg = params.engine_config(*D.shape)

    def run(n_dev: int) -> float:
        n_chains = n_dev
        data = stack_device_data([D] * n_chains, None, cfg)
        mesh = (Mesh(np.array(jax.devices()[:n_dev]), ("chains",))
                if n_dev > 1 else None)
        eng = MultichainEngine(data, cfg, mesh=mesh)
        keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(n_chains) + 7)
        state, stats = eng.init_state(), eng.init_stats()
        # warm compile
        state, stats = eng.run_phase(state, stats, keys, EQUILIBRATION,
                                     0, 5)
        jax.block_until_ready(state.M_a)
        t0 = time.perf_counter()
        state, stats = eng.run_phase(state, stats, keys, EQUILIBRATION,
                                     5, n_iter)
        jax.block_until_ready(state.M_a)
        return time.perf_counter() - t0

    results = {}
    n = 1
    ns = []
    while n <= max_dev:
        ns.append(n)
        n *= 2
    for n_dev in ns:
        results[n_dev] = run(n_dev)

    # emulation ceiling: the same weak-scaling measurement for a trivial
    # matmul loop — virtual CPU "devices" share one host's threads, so
    # even embarrassingly parallel work cannot reach 1.0 there; report
    # efficiency relative to this ceiling so virtual-mesh numbers are
    # interpretable (real >= 80% validation needs >= 2 physical chips)
    from jax.sharding import PartitionSpec as PS

    def ceiling(n_dev: int) -> float:
        def body(x):
            def step(i, x):
                return x @ x * 1e-3 + 1.0
            return jax.lax.fori_loop(0, 200, step, x)

        if n_dev == 1:
            f = jax.jit(jax.vmap(body))
        else:
            m = Mesh(np.array(jax.devices()[:n_dev]), ("d",))
            f = jax.jit(jax.shard_map(jax.vmap(body), mesh=m,
                                      in_specs=PS("d"), out_specs=PS("d")))
        x = jnp.ones((n_dev, 128, 128))
        o = f(x); jax.block_until_ready(o)
        t0 = time.perf_counter()
        o = f(x); jax.block_until_ready(o)
        return time.perf_counter() - t0

    ceil = {n: ceiling(n) for n in ns}
    t1 = results[ns[0]]
    c1 = ceil[ns[0]]
    out = {
        "config": f"weak scaling, {n_iter} iterations, 200x40 k=5, "
                  f"1 chain/device",
        "backend": jax.default_backend(),
        "virtual_devices": jax.device_count() > len(set(
            d.platform for d in jax.devices())),
        "timings_s": {str(k): round(v, 3) for k, v in results.items()},
        "efficiency": {str(k): round(t1 / v, 3) for k, v in
                       results.items()},
        "emulation_ceiling": {str(k): round(c1 / v, 3)
                              for k, v in ceil.items()},
        "note": "virtual CPU devices share one host's threads; real "
                "weak-scaling validation requires >= 2 physical chips",
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
