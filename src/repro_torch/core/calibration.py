"""Starvation-timeout calibration (paper §3.4: tau = 3 x mu_short).

mu_short must be the mean Short-request *sojourn* time under representative
mixed-workload queueing conditions — NOT the isolated sequential service time
(the paper is emphatic about this distinction).  ``measure_mu_short``
reproduces profiler/measure_mu_short.py: dispatch a concurrent mixed burst,
average Short sojourns.  A copy of ``repro.core.calibration`` (imports
renamed), held to it by ``tests/test_torch_des.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.simulation import ServiceDist, burst_workload, simulate

TAU_MULTIPLIER = 3.0  # the paper's Pareto-elbow choice


def measure_mu_short(short: ServiceDist, long: ServiceDist,
                     n_short: int = 50, n_long: int = 50,
                     policy: str = "sjf", seed: int = 0,
                     effective_rate: float = 1.0) -> float:
    """Mean short-request sojourn under a mixed concurrent burst.

    ``effective_rate`` rescales both class distributions by the backend's
    aggregate speculative speedup (``serving.service_time
    .expected_speedup``) so tau is calibrated against the sojourns the
    speculative backend actually produces.  The default 1.0 divides by
    one — an IEEE-exact identity, so pre-speculation calibrations are
    bitwise unchanged.
    """
    rng = np.random.default_rng(seed)
    if effective_rate != 1.0:
        if effective_rate <= 0.0:
            raise ValueError(
                f"effective_rate must be positive, got {effective_rate}")
        short = ServiceDist(mean=short.mean / effective_rate,
                            std=short.std / effective_rate,
                            floor=short.floor / effective_rate)
        long = ServiceDist(mean=long.mean / effective_rate,
                           std=long.std / effective_rate,
                           floor=long.floor / effective_rate)
    reqs = burst_workload(rng, n_short, n_long, short, long)
    res = simulate(reqs, policy=policy, tau=None)
    return res.mean(klass="short", attr="sojourn")


def calibrate_tau(short: ServiceDist, long: ServiceDist,
                  multiplier: float = TAU_MULTIPLIER, **kw) -> float:
    """tau = multiplier x mu_short (default 3x, the paper's heuristic)."""
    return multiplier * measure_mu_short(short, long, **kw)
