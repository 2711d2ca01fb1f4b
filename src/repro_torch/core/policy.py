"""Scheduling policies (port of the seed trio of ``repro.core.policy``).

A policy owns the priority key of the live queue (lower = sooner):
``fcfs`` keys on arrival, ``sjf`` on the predictor's P(Long),
``sjf_oracle`` on the true service time.  The starvation guard (the
paper's promote-oldest rule with timeout tau) belongs to the queue.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Policy:
    name: str = "policy"

    @property
    def uses_predictor(self) -> bool:
        """Whether admission should score prompts (P(Long))."""
        return True

    def key(self, req) -> float:
        raise NotImplementedError


@dataclass(frozen=True)
class FCFS(Policy):
    name: str = "fcfs"

    @property
    def uses_predictor(self) -> bool:
        return False

    def key(self, req) -> float:
        return req.arrival


@dataclass(frozen=True)
class PredictedSJF(Policy):
    """The paper's policy: key = P(Long), the continuous predictor score."""
    name: str = "sjf"

    def key(self, req) -> float:
        return req.p_long


@dataclass(frozen=True)
class OracleSJF(Policy):
    """Clairvoyant upper bound: key = true service time."""
    name: str = "sjf_oracle"

    @property
    def uses_predictor(self) -> bool:
        return False

    def key(self, req) -> float:
        return req.true_service


_REGISTRY: Dict[str, Policy] = {p.name: p
                                for p in (FCFS(), PredictedSJF(), OracleSJF())}


def get_policy(spec) -> Policy:
    """A ``Policy`` passes through; a name looks up the registry."""
    if isinstance(spec, Policy):
        return spec
    if isinstance(spec, str):
        try:
            return _REGISTRY[spec]
        except KeyError:
            raise ValueError(f"unknown policy {spec!r}; ported: "
                             f"{', '.join(sorted(_REGISTRY))}") from None
    raise TypeError(f"policy spec must be str or Policy, got {type(spec)!r}")
