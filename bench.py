"""Benchmark: Gibbs atom-update throughput per chip on the GIST config
(1363 genes x 9 samples, k=7 — the reference's benchmark dataset,
reference: tests/testthat/test_top_level.R:33-36).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Baseline (the "1x"): single-threaded C++ atom-updates/sec measured on this
machine by native/baseline_ref.cpp — a cost model of the reference's hot
loop (alphaParameters row reduction + rank-1 AP update, reference:
src/gibbs_sampler/DenseNormalModel.cpp:162-258). The measured value is
cached in native/baseline_measured.json; rebuild with
`make -C native bench-baseline` (falls back to the recorded constant when
the toolchain is unavailable).

Throughput is measured at equal statistical work: full two-phase runs with
the default engine settings, wall-clocked after a warmup run that absorbs
compilation; the run must reach a converged meanChiSq (sanity-gated) so the
number cannot be gamed by not fitting.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

GIST_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "GIST.csv")
BASELINE_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "native", "baseline_measured.json")
FALLBACK_BASELINE_UPS = 23.0e6  # measured 2026-08-18 on this image's CPU


def measure_baseline() -> float:
    """Single-thread C++ updates/sec (cached)."""
    try:
        with open(BASELINE_JSON) as f:
            return float(json.load(f)["updates_per_second"])
    except Exception:
        pass
    try:
        here = os.path.dirname(os.path.abspath(__file__))
        exe = os.path.join(here, "native", "baseline_ref")
        if not os.path.exists(exe):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-funroll-loops",
                 "-o", exe, os.path.join(here, "native", "baseline_ref.cpp")],
                check=True, capture_output=True)
        out = subprocess.run([exe, "1363", "9", "7", "3000000"],
                             check=True, capture_output=True, text=True)
        ups = float(out.stdout.split()[-1])
        with open(BASELINE_JSON, "w") as f:
            json.dump({"updates_per_second": ups,
                       "config": "GIST 1363x9 k=7 single-thread"}, f)
        return ups
    except Exception:
        return FALLBACK_BASELINE_UPS


def main() -> None:
    n_iterations = int(os.environ.get("BENCH_ITERATIONS", "2000"))
    # 16 vmapped chains is the per-chip deployment packing (independent
    # chains amortize the sweep's fixed per-step cost; GWCoGAPS-style
    # production runs 4+ chains per worker, reference:
    # R/DistributedCogaps.R:56-67)
    n_chains = int(os.environ.get("BENCH_CHAINS", "16"))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from cogaps_tpu.io import parsers
    from cogaps_tpu.params import CogapsParams
    from cogaps_tpu.bench_harness import run_throughput
    from cogaps_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    D, _, _ = parsers.read_matrix(GIST_CSV)
    params = CogapsParams(n_patterns=7, n_iterations=n_iterations, seed=42,
                          output_frequency=0)

    # warmup (compile) + timed runs
    result = run_throughput(D, params, n_chains=n_chains)
    ups = result["updates_per_second"]
    baseline = measure_baseline()

    # convergence gate: within 2x of the reference's own converged GIST
    # meanChiSq (data/gist.npz golden result; reference data/GIST.RData) —
    # a half-converged run cannot pass
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "data", "gist.npz"))
    golden_mcs = float(np.asarray(golden["golden_meanChiSq"]).reshape(-1)[0])
    assert result["mean_chi_sq"] < 2.0 * golden_mcs, (
        f"benchmark run did not converge: meanChiSq "
        f"{result['mean_chi_sq']:.1f} vs reference golden {golden_mcs:.1f}")

    print(json.dumps({
        "metric": "gibbs_atom_updates_per_sec_per_chip_gist_k7",
        "value": round(ups, 1),
        "unit": "updates/s",
        "vs_baseline": round(ups / baseline, 3),
    }))


if __name__ == "__main__":
    main()
