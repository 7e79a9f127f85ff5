"""Logging discipline (reference: src/utils/GapsPrint.h:3-15 and the
worker start/finish lines GapsRunner.cpp:429-433,495-501). In multi-host
runs only process_index 0 prints, mirroring the reference's workerID
convention (SURVEY.md §2.3 P6)."""

from __future__ import annotations

import sys


def _is_primary() -> bool:
    try:
        import jax
        return jax.process_index() == 0
    except Exception:
        return True


def log_message(msg: str) -> None:
    if _is_primary():
        print(msg, file=sys.stdout, flush=True)


def log_worker(worker_id: int, msg: str) -> None:
    print(f"    worker {worker_id} {msg}", file=sys.stdout, flush=True)


def build_report() -> str:
    """Runtime/environment report — the analog of the reference's
    buildReport() (reference: src/utils/GlobalConfig.h:27-55, surfaced
    through getBuildReport_cpp)."""
    import jax
    import jaxlib

    import cogaps_tpu

    lines = [
        f"cogaps_tpu version: {cogaps_tpu.__version__}",
        f"jax: {jax.__version__}, jaxlib: {jaxlib.__version__}",
        f"backend: {jax.default_backend()}",
        f"devices: {[str(d) for d in jax.devices()]}",
        f"process: {jax.process_index()}/{jax.process_count()}",
        "sweep: XLA (ops/sweep.py) on every backend",
        "checkpoints: enabled",
    ]
    return "\n".join(lines)
