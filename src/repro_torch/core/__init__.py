"""Clairvoyant core (the port's copy of ``repro.core``): the paper's
contribution as a composable library.

features   — the 19 lexical features (§3.2)
gbdt       — from-scratch XGBoost-class boosted trees (§4.3)
predictor  — features + ensemble -> P(Long)
scheduler  — SJF indexed array-heap + starvation timeout (§3.4)
simulation — serial-backend DES, workload generators, P-K theory (§2.4, §5.5)
sim_fast   — SoA request batches + compiled/vectorized DES engines
sim_torch  — the same DES as (G, n) tensors on the card (device replication axis)
sweep      — one-shot policy x tau x rho x seed grids over the DES
ranking    — ranking accuracy (Algorithm 1) + Table 7 baselines
calibration— tau = 3 x mu_short (§3.4)
router     — beyond-paper: predictive multi-replica placement
"""

from repro_torch.core.features import (FEATURE_NAMES, N_FEATURES, extract,
                                       extract_batch)
from repro_torch.core.gbdt import GBDTModel, GBDTParams, train_gbdt
from repro_torch.core.predictor import Predictor
from repro_torch.core.ranking import (classification_accuracy, class_labels,
                                      ranking_accuracy)
from repro_torch.core.scheduler import ArrayHeap, MinHeap, Request, SJFQueue
from repro_torch.core.sim_fast import (BatchSimResult, RequestBatch,
                                       simulate_batch)
from repro_torch.core.sim_torch import simulate_grid_torch
from repro_torch.core.simulation import (ServiceDist, SimResult,
                                         burst_workload, poisson_workload,
                                         simulate, simulate_reference)
from repro_torch.core.sweep import (SweepResult, run_grid, sweep_batches,
                                    sweep_burst, sweep_poisson)

__all__ = [
    "FEATURE_NAMES", "N_FEATURES", "extract", "extract_batch",
    "GBDTModel", "GBDTParams", "train_gbdt", "Predictor",
    "classification_accuracy", "class_labels", "ranking_accuracy",
    "ArrayHeap", "MinHeap", "Request", "SJFQueue",
    "ServiceDist", "SimResult", "burst_workload", "poisson_workload",
    "simulate", "simulate_reference",
    "BatchSimResult", "RequestBatch", "simulate_batch",
    "simulate_grid_torch",
    "SweepResult", "run_grid", "sweep_batches", "sweep_burst",
    "sweep_poisson",
]
