"""Two-process (or N-process) distributed demo/validation.

Worker mode (invoked per process):
    python tools/multihost_demo.py worker <pid> <nproc> [port]

Launcher mode (spawns the workers on this host over the CPU backend —
the multi-host smoke test the driver/tests use):
    python tools/multihost_demo.py launch [nproc]

Each process joins via cogaps_tpu.parallel.multihost.initialize_distributed,
builds the global mesh, runs a short multichain span (one chain per
process), writes its per-shard checkpoint, and process 0 reassembles and
validates the global state.

This is an explicit CPU demo: every worker pins itself to the CPU
backend. A multi-process launch on GPUs would need one card per process
(a JAX process reserves most of a card's memory), which this script does
not arrange.
"""

import json
import os
import subprocess
import sys
import tempfile
import time


def worker(pid: int, nproc: int, port: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from cogaps_tpu.parallel import multihost

    multihost.initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc, process_id=pid)

    import jax.numpy as jnp
    import numpy as np

    from cogaps_tpu.engine import EQUILIBRATION
    from cogaps_tpu.params import CogapsParams
    from cogaps_tpu.parallel.multichain import (MultichainEngine,
                                                stack_device_data)

    rng = np.random.default_rng(0)
    A = rng.gamma(2.0, 1.0, (48, 3)).astype(np.float32)
    P = rng.gamma(2.0, 1.0, (16, 3)).astype(np.float32)
    D = (A @ P.T).astype(np.float32)

    params = CogapsParams(n_patterns=3, n_iterations=20, seed=4,
                          output_frequency=0)
    cfg = params.engine_config(*D.shape)
    n_chains = jax.device_count()
    data = stack_device_data([D] * n_chains, None, cfg)
    mesh = multihost.global_mesh("chains")
    eng = MultichainEngine(data, cfg, mesh=mesh)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(n_chains) + 3)
    state, stats = eng.init_state(), eng.init_stats()
    state, stats = eng.run_phase(state, stats, keys, EQUILIBRATION)
    jax.block_until_ready(state.M_a)

    path = multihost.save_sharded_checkpoint(
        os.path.join(tempfile.gettempdir(), f"mh_demo_{port}"), state, extra={"pid": np.int32(pid)})
    # only this process's shards are addressable in multi-process mode
    n_local = [int(np.asarray(s.data).reshape(-1)[0])
               for s in state.atoms_a.n.addressable_shards]
    print(json.dumps({"pid": pid, "devices": jax.device_count(),
                      "local": jax.local_device_count(),
                      "ckpt": path, "n_atoms_local": n_local}),
          flush=True)

    if pid == 0:
        # reassemble the global state from every process's shard file
        time.sleep(3.0)
        structure = jax.tree.map(lambda x: 0, state)
        restored = multihost.load_sharded_checkpoint(
            os.path.join(tempfile.gettempdir(), f"mh_demo_{port}"),
            structure)
        assert restored.M_a.shape[0] == n_chains
        assert np.abs(restored.M_a).sum() > 0
        print(json.dumps({"restore": "ok",
                          "chains": int(restored.M_a.shape[0])}),
              flush=True)


def launch(nproc: int = 2, port: int = 12396) -> int:
    procs = [subprocess.Popen(
        [sys.executable, __file__, "worker", str(i), str(nproc),
         str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        for i in range(nproc)]
    ok = True
    for p in procs:
        out, _ = p.communicate(timeout=600)
        print(out.strip())
        ok &= p.returncode == 0
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]),
               int(sys.argv[4]) if len(sys.argv) > 4 else 12396)
    else:
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 2
        sys.exit(launch(n))
