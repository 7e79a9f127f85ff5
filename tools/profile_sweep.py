"""Time the XLA sweep at bench.py's configuration and trace its share of
device time.

Configuration: GIST (1363 x 9), k=7, 16 vmapped chains (bench.py).

  1. steady window: after a warm-up, N iterations of the equilibration
     program timed with block_until_ready -> iterations/s, and from the
     engine's sweep counters chain-sweeps/s and us per chain-sweep;
  2. one jax.profiler trace of a short window of the same program,
     reduced to: device busy time and idle share, device time by layer
     (the named scopes "sweep", "rebuild" and "stats", the sweep loops'
     predicates, the rest), kernels and device-to-host copies per
     iteration, and the top ops.

Ops are attributed through the compiled program's HLO metadata
(op_name), joined to the trace's hlo_op stat. XLA replays most of the
program as CUDA graphs ("command_buffer" events), which hides the
kernels inside them; --kernels turns command buffers off
(XLA_FLAGS=--xla_gpu_enable_command_buffer=) so every kernel shows, at
the price of more launches — use it for attribution, not for timing.

Usage: python tools/profile_sweep.py [--chains 16] [--window 400]
           [--trace-iters 20] [--kernels] [--out chiprun_out]
Prints one JSON line; writes the trace reduction to
<out>/sweep_profile[_kernels].json.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def hlo_scopes(hlo_text: str) -> dict:
    """Instruction name -> metadata op_name, from optimized HLO text."""
    out = {}
    for m in re.finditer(r"^\s*(?:ROOT )?%?([\w.\-]+) = .*?metadata=\{[^}]*"
                         r"op_name=\"([^\"]*)\"", hlo_text, re.M):
        out[m.group(1)] = m.group(2)
    return out


LAYERS = ("sweep", "rebuild", "stats")


def layer_of(op: str, scope: str) -> str:
    """A named scope shows as `/name/`, or as `vmap(name)` under vmap.
    Ops of the sweep's while loop outside the scope (the loop op itself,
    carry copies, the predicate) are `sweep_loop`: their op_name has two
    nested whiles (the iteration fori_loop around run_updates')."""
    for name in LAYERS:
        if re.search(rf"[/(]{name}[/)]", scope):
            return name
    if op == "command_buffer":
        return "command_buffer"
    if scope.count("/while") >= 2:
        return "sweep_loop"
    return "other"


def reduce_trace(path: str, scopes: dict, n_iters: int) -> dict:
    """Device time by layer from one .xplane.pb."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    intervals, kernels, d2h, by_layer = [], {}, 0, {}
    total_ns = 0.0
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                name = ev.name
                if re.search(r"dtoh|d2h", name + str(stats.get(
                        "memcpy_details", "")), re.I):
                    d2h += 1
                op = stats.get("hlo_op", name)
                dur = float(ev.duration_ns)
                intervals.append((float(ev.start_ns),
                                  float(ev.start_ns) + dur))
                total_ns += dur
                layer = layer_of(op, scopes.get(op, ""))
                by_layer[layer] = by_layer.get(layer, 0.0) + dur
                k = kernels.setdefault(op, [0, 0.0, scopes.get(op, "")])
                k[0] += 1
                k[1] += dur
    intervals.sort()
    busy, end = 0.0, None
    if not intervals:
        return {"device_events": 0}
    start0 = intervals[0][0]
    stop = max((b for _, b in intervals), default=0.0)
    for a, b in intervals:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = stop - start0
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:25]
    return {
        "device_window_ns": window,
        "device_busy_ns": busy,
        "device_idle_share": 1.0 - busy / window if window else None,
        "kernel_time_ns": total_ns,
        "share_of_kernel_time": {k: v / total_ns
                                 for k, v in sorted(by_layer.items())},
        "device_events": len(intervals),
        "device_events_per_iteration": len(intervals) / n_iters,
        "dtoh_copies_per_iteration": d2h / n_iters,
        "top_ops": [{"op": k, "count": v[0], "ns": v[1], "scope": v[2]}
                    for k, v in top],
        "ops": {k: [v[0], v[1], v[2]] for k, v in kernels.items()},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--window", type=int, default=400)
    ap.add_argument("--trace-iters", type=int, default=20)
    ap.add_argument("--kernels", action="store_true",
                    help="turn XLA's command buffers off for attribution")
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if args.kernels:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_gpu_enable_command_buffer=")

    import jax
    import jax.numpy as jnp
    import numpy as np

    from cogaps_tpu.engine import EQUILIBRATION
    from cogaps_tpu.io import parsers
    from cogaps_tpu.parallel.multichain import (MultichainEngine,
                                                stack_device_data)
    from cogaps_tpu.params import CogapsParams
    from cogaps_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    D, _, _ = parsers.read_matrix(os.path.join(repo, "data", "GIST.csv"))
    n_it = 2000
    params = CogapsParams(n_patterns=7, n_iterations=n_it, seed=42,
                          output_frequency=0)
    cfg = params.engine_config(*D.shape)
    eng = MultichainEngine(stack_device_data([D] * args.chains, None, cfg),
                           cfg)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(args.chains) + 42)
    st, ss = eng.init_state(), eng.init_stats()

    def span(st, ss, a, b):
        st, ss = eng.run_phase(st, ss, keys, EQUILIBRATION, a, b)
        return jax.block_until_ready((st, ss))

    t0 = time.perf_counter()
    st, ss = span(st, ss, 0, 1000)  # compile + reach the atom plateau
    warm_s = time.perf_counter() - t0
    sw0 = np.asarray(ss.sweep_counts).sum(0)
    up0 = int(np.asarray(ss.upd_lo, np.int64).sum())
    t0 = time.perf_counter()
    st, ss = span(st, ss, 1000, 1000 + args.window)
    dt = time.perf_counter() - t0
    sw = np.asarray(ss.sweep_counts).sum(0) - sw0
    ups = (int(np.asarray(ss.upd_lo, np.int64).sum()) - up0) / dt

    lowered = eng._run_phase.func.lower(
        *eng._run_phase.args, EQUILIBRATION, eng.data, st, ss, keys,
        jnp.int32(0), jnp.int32(1))
    scopes = hlo_scopes(lowered.compile().as_text())

    a = 1000 + args.window
    tag = "_kernels" if args.kernels else ""
    tdir = os.path.join(args.out, "sweep_trace" + tag)
    with jax.profiler.trace(tdir):
        st, ss = span(st, ss, a, a + args.trace_iters)
    xp = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                          recursive=True))[-1]
    red = reduce_trace(xp, scopes, args.trace_iters)
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except OSError:
        card = "nvidia-smi unavailable"
    d = jax.devices()[0]
    out = {
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "config": f"GIST 1363x9 k=7, {args.chains} chains, equilibration "
                  f"iterations 1000..{1000 + args.window}",
        "warmup_s_incl_compile": warm_s,
        "window_s": dt,
        "iterations_per_s": args.window / dt,
        "updates_per_s": ups,
        "chain_sweeps_A_P": sw.tolist(),
        "chain_sweeps_per_s": float(sw.sum()) / dt,
        "us_per_chain_sweep": dt / float(sw.sum()) * 1e6,
        "sweeps_per_chain_iteration": float(sw.sum()) / args.window
        / args.chains,
        "trace": {k: v for k, v in red.items()
                  if k not in ("top_ops", "ops")},
        "scopes_found": len(scopes),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"sweep_profile{tag}.json"),
              "w") as f:
        json.dump(dict(out, trace=red), f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
