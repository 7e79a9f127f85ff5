"""cogaps_tpu — Bayesian non-negative matrix factorization on JAX.

A from-scratch JAX/XLA re-design of the capabilities of
FertigLab/CoGAPS (Coordinated Gene Activity in Pattern Sets): atomic-prior
Gibbs-sampled NMF ``D ~ A @ P.T`` with per-element uncertainty, two-phase
annealed MCMC, distributed subset+consensus mode, and the downstream
pattern-analysis toolkit.
"""

from . import analysis, plots
from .utils.logging import build_report
from .api import CoGAPS, GWCoGAPS, scCoGAPS
from .params import CogapsParams
from .result import CogapsResult

__version__ = "0.1.0"

__all__ = [
    "CoGAPS", "GWCoGAPS", "scCoGAPS", "CogapsParams", "CogapsResult",
    "analysis", "plots", "build_report", "__version__",
]
