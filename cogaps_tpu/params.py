"""Run parameters for the CoGAPS engine.

Mirrors the capability surface of the reference's two parameter layers:
the R S4 class ``CogapsParams`` (reference: R/class-CogapsParams.R:44-123)
and the flat C++ ``GapsParameters`` struct (reference: src/GapsParameters.h:36-70).
Defaults follow the R layer (nIterations=50000, alpha=0.01, maxGibbsMass=100,
nSets=4, cut=nPatterns, minNS=ceil(nSets/2), maxNS=minNS+nSets,
reference: R/class-CogapsParams.R:99-123).

Engine additions (no counterpart in the reference, which tunes OpenMP
threads instead): ``batch_size_*`` (width of the vectorized
conflict-free proposal sweep), ``atom_capacity_*`` (static capacity of the
on-device atom tables), and ``n_chains`` (vmapped independent chains
per device).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Optional, Sequence


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


@dataclasses.dataclass
class CogapsParams:
    """User-facing parameters (reference: R/class-CogapsParams.R:44-71)."""

    # core algorithm parameters
    n_patterns: int = 7
    n_iterations: int = 50000
    alpha_a: float = 0.01
    alpha_p: float = 0.01
    max_gibbs_mass_a: float = 100.0
    max_gibbs_mass_p: float = 100.0
    seed: Optional[int] = None  # None -> derived from wall clock (R: ms of day)

    # run configuration
    sparse_optimization: bool = False
    transpose_data: bool = False
    output_frequency: int = 500
    n_snapshots: int = 0
    snapshot_phase: str = "sampling"  # 'sampling' | 'equilibration' | 'all'
    take_pump_samples: bool = False

    # fixed-matrix conditional solve (reference: src/GapsRunner.cpp:330-350)
    which_matrix_fixed: str = "N"  # 'A' | 'P' | 'N'
    fixed_patterns: Optional[Any] = None  # array, (nGenes,k) for A / (nSamples,k) for P

    # distributed ("genome-wide" | "single-cell" | None)
    # (reference: R/DistributedCogaps.R:48-119)
    distributed: Optional[str] = None
    n_sets: int = 4
    cut: Optional[int] = None  # default nPatterns
    min_ns: Optional[int] = None  # default ceil(nSets/2)
    max_ns: Optional[int] = None  # default minNS + nSets
    explicit_sets: Optional[Sequence[Sequence[int]]] = None
    sampling_annotation: Optional[Sequence[str]] = None
    sampling_weight: Optional[dict] = None

    # subset bookkeeping (set internally by distributed mode,
    # reference: R/DistributedCogaps.R:25-27)
    subset_indices: Optional[Sequence[int]] = None
    subset_dim: int = 0  # 0 = none, 1 = rows(genes), 2 = cols(samples)

    # checkpointing (reference: src/GapsRunner.cpp:225-270)
    checkpoint_interval: int = 0
    checkpoint_out_file: str = "gaps_checkpoint.npz"
    checkpoint_in_file: Optional[str] = None

    # runtime debug assertions (the GAPS_DEBUG analog, utils/debug.py)
    debug_checks: bool = False

    # logging
    worker_id: int = 1
    running_distributed: bool = False
    print_messages: bool = True

    # ---- engine knobs (new; no reference counterpart) ----
    batch_size_a: Optional[int] = None  # proposal sweep width for the A sampler
    batch_size_p: Optional[int] = None
    atom_capacity_a: Optional[int] = None
    atom_capacity_p: Optional[int] = None
    # retained for config compatibility: the engine now rebuilds its
    # conditional-mean cache exactly at every sampler phase (models/dense.py)
    rebuild_interval: int = 100
    n_chains: int = 1  # independent vmapped chains
    # max iterations per device dispatch: phases run as a host-side loop
    # of bounded spans, and the live progress line and checkpoint
    # chunking act at span boundaries (engine.dispatch_spans)
    dispatch_iters: int = 250
    # move proposals: symmetric local window (the reference's
    # neighbor-bounded move analog; required for mixing under sharp
    # custom-uncertainty posteriors) vs global-uniform targets
    local_moves: bool = True

    # ------------------------------------------------------------------
    def resolved_seed(self) -> int:
        if self.seed is None:
            # reference default: milliseconds of the day
            # (R/class-CogapsParams.R:104-107)
            now = time.time()
            return int((now % 86400) * 1000) & 0x7FFFFFFF
        return int(self.seed)

    def resolved_cut(self) -> int:
        return self.n_patterns if self.cut is None else int(self.cut)

    def resolved_min_ns(self) -> int:
        return (
            int(math.ceil(self.n_sets / 2.0)) if self.min_ns is None else int(self.min_ns)
        )

    def resolved_max_ns(self) -> int:
        return self.resolved_min_ns() + self.n_sets if self.max_ns is None else int(self.max_ns)

    def set_distributed_params(
        self,
        n_sets: int,
        cut: Optional[int] = None,
        min_ns: Optional[int] = None,
        max_ns: Optional[int] = None,
    ) -> "CogapsParams":
        """Guarded setter (reference: R/methods-CogapsParams.R:186-199)."""
        self.n_sets = int(n_sets)
        self.cut = cut
        self.min_ns = min_ns
        self.max_ns = max_ns
        self.validate()
        return self

    def set_fixed_patterns(self, fixed_patterns, which_matrix_fixed: str) -> "CogapsParams":
        """Guarded setter (reference: R/methods-CogapsParams.R:215-223)."""
        self.fixed_patterns = fixed_patterns
        self.which_matrix_fixed = which_matrix_fixed
        self.validate()
        return self

    def set_annotation_weights(self, annotation, weights) -> "CogapsParams":
        """Guarded setter (reference: R/methods-CogapsParams.R:203-211)."""
        self.sampling_annotation = list(annotation)
        self.sampling_weight = dict(weights)
        self.validate()
        return self

    # generic get/set mirroring setParam/getParam
    # (reference: R/methods-CogapsParams.R:104-181, 227-231)
    _PARAM_ALIASES = {
        "nPatterns": "n_patterns",
        "nIterations": "n_iterations",
        "alphaA": "alpha_a",
        "alphaP": "alpha_p",
        "maxGibbsMassA": "max_gibbs_mass_a",
        "maxGibbsMassP": "max_gibbs_mass_p",
        "seed": "seed",
        "sparseOptimization": "sparse_optimization",
        "nSets": "n_sets",
        "cut": "cut",
        "minNS": "min_ns",
        "maxNS": "max_ns",
        "distributed": "distributed",
    }

    def set_param(self, name: str, value) -> "CogapsParams":
        attr = self._PARAM_ALIASES.get(name, name)
        if not hasattr(self, attr):
            raise ValueError(f"unknown parameter: {name}")
        if attr in ("cut", "min_ns", "max_ns", "n_sets"):
            raise ValueError(
                f"please use set_distributed_params to set {name!r}"
            )  # reference: R/methods-CogapsParams.R:118-124
        setattr(self, attr, value)
        self.validate()
        return self

    def get_param(self, name: str):
        attr = self._PARAM_ALIASES.get(name, name)
        return getattr(self, attr)

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Validity rules (reference: R/class-CogapsParams.R:131-193)."""
        if self.n_patterns <= 0:
            raise ValueError("number of patterns must be greater than zero")
        if self.n_iterations <= 0:
            raise ValueError("number of iterations must be greater than zero")
        if min(self.alpha_a, self.alpha_p) <= 0:
            raise ValueError("alpha parameter must be greater than zero")
        if min(self.max_gibbs_mass_a, self.max_gibbs_mass_p) <= 0:
            raise ValueError("maxGibbsMass must be greater than zero")
        if self.distributed not in (None, "genome-wide", "single-cell"):
            raise ValueError("distributed must be 'genome-wide' or 'single-cell'")
        if self.which_matrix_fixed not in ("A", "P", "N"):
            raise ValueError("whichMatrixFixed must be 'A', 'P' or 'N'")
        if (self.fixed_patterns is None) != (self.which_matrix_fixed == "N"):
            raise ValueError(
                "fixedPatterns and whichMatrixFixed must be set together"
            )
        if self.distributed is not None:
            min_ns, max_ns, cut = (
                self.resolved_min_ns(),
                self.resolved_max_ns(),
                self.resolved_cut(),
            )
            # NOTE the reference's S4 validity expressions for minNS/nSets
            # (class-CogapsParams.R:167-170) are dead code (the strings are
            # never returned), and its own tests run nSets=2 => minNS=1
            # (test_output_across_modes.R:20-24) — so only the genuinely
            # enforced constraints are errors here.
            if min_ns < 1:
                raise ValueError("minNS must be at least one")
            if self.n_sets < 2:
                raise ValueError("nSets must be at least two")
            if max_ns <= min_ns:
                raise ValueError("maxNS must be greater than minNS")
            if cut > self.n_patterns:
                raise ValueError("cut must not be greater than nPatterns")
            # can't fix P in single-cell, A in genome-wide
            # (reference: R/class-CogapsParams.R:163-166)
            if self.distributed == "single-cell" and self.which_matrix_fixed == "P":
                raise ValueError("can't fix P matrix in single-cell distributed mode")
            if self.distributed == "genome-wide" and self.which_matrix_fixed == "A":
                raise ValueError("can't fix A matrix in genome-wide distributed mode")
            if self.which_matrix_fixed != "N" and self.explicit_sets is None:
                raise ValueError(
                    "doing manual pattern matching requires explicit subsets"
                )  # reference: R/class-CogapsParams.R:161-162
        if self.snapshot_phase not in ("sampling", "equilibration", "all"):
            raise ValueError("snapshotPhase must be sampling/equilibration/all")

    # ------------------------------------------------------------------
    def engine_config(self, n_genes: int, n_samples: int) -> "EngineConfig":
        """Resolve data-dependent engine settings."""
        k = self.n_patterns
        n_bins_a = n_genes * k
        n_bins_p = n_samples * k

        def default_batch(n_rows: int) -> int:
            # the expected count of row-conflict survivors per sweep,
            # B*exp(-B/n_rows), peaks at B ~ n_rows — oversampling past
            # that only wastes draws
            return max(32, min(1024, _next_pow2(n_rows)))

        def default_capacity(n_bins: int) -> int:
            # stationary atom counts on real data sit well under 0.5
            # atom/bin (GIST k=7 equilibrates at ~3.5k atoms over 9.5k
            # bins), so nBins/2 rounded up still leaves >2x headroom;
            # the table is kept as small as safely possible
            # (atom_capacity_a/p override when a dataset runs hotter —
            # the capacity guard blocks births at the brim)
            return max(1 << 10, min(1 << 22, _next_pow2(n_bins) // 2))

        return EngineConfig(
            n_patterns=k,
            n_iterations=self.n_iterations,
            alpha_a=float(self.alpha_a),
            alpha_p=float(self.alpha_p),
            max_gibbs_mass_a=float(self.max_gibbs_mass_a),
            max_gibbs_mass_p=float(self.max_gibbs_mass_p),
            batch_a=int(self.batch_size_a or default_batch(n_genes)),
            batch_p=int(self.batch_size_p or default_batch(n_samples)),
            capacity_a=int(self.atom_capacity_a or default_capacity(n_bins_a)),
            capacity_p=int(self.atom_capacity_p or default_capacity(n_bins_p)),
            output_frequency=int(self.output_frequency),
            rebuild_interval=int(self.rebuild_interval),
            which_matrix_fixed=self.which_matrix_fixed,
            n_snapshots=int(self.n_snapshots),
            snapshot_phase=self.snapshot_phase,
            take_pump_samples=bool(self.take_pump_samples),
            dispatch_iters=int(self.dispatch_iters),
            local_moves=bool(self.local_moves),
        )


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static (trace-time) engine configuration, the analog of the flat
    C++ GapsParameters struct (reference: src/GapsParameters.h:36-70)."""

    n_patterns: int
    n_iterations: int
    alpha_a: float
    alpha_p: float
    max_gibbs_mass_a: float
    max_gibbs_mass_p: float
    batch_a: int
    batch_p: int
    capacity_a: int
    capacity_p: int
    output_frequency: int
    rebuild_interval: int
    which_matrix_fixed: str
    n_snapshots: int
    snapshot_phase: str
    take_pump_samples: bool
    dispatch_iters: int = 250
    local_moves: bool = True
