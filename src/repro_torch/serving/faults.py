"""Deterministic fault injection + fault handling for the serving stack.

The paper positions Clairvoyant as a drop-in sidecar for flaky local
serial backends (Ollama, llama.cpp) — environments where the backend
crashes mid-generation, a replica stalls, or the predictor sees
out-of-distribution inputs.  This module provides both halves of the
robustness story:

**Injection** — a seeded :class:`FaultPlan` schedules faults ahead of
time, so every chaos run is reproducible bit-for-bit:

* ``crash`` — the engine dies mid-generation.  On sim drains the crash
  fires when its virtual-time trigger falls inside a service interval;
  on real engines it fires at a fused-decode segment boundary (the
  ``after_polls``-th cancel poll), raising :class:`EngineCrash` out of
  ``generate``/``run_lanes``.  ``repair_s`` keeps the replica down.
* ``lane_crash`` — batched engines only: one decode lane dies at a
  segment boundary; the lane is evicted and back-filled, and the server
  requeues the victim (work-conserving resume via re-prefill).
* ``stall`` — a straggler window: services dispatched inside
  ``[at, at + duration)`` are stretched by ``factor`` (sim/DES drains).
* ``predictor_down`` — admission-time predictor outage window: the
  server degrades to FCFS admission instead of erroring (see
  ``ClairvoyantServer.degraded``), recovering when the window closes.
* ``transient`` — a retryable backend error at dispatch time
  (:class:`TransientBackendError`); each spec fails exactly one attempt.
* ``overflow`` — admission-queue overflow window: submissions during
  ``[at, at + duration)`` are shed with ``status="shed"``.

**Handling** — the machinery the server/router thread through:

* :class:`RetryPolicy` — jittered exponential backoff with a bounded
  retry count (seeded jitter: deterministic across runs).
* :class:`CircuitBreaker` — per-replica closed -> open -> half-open
  breaker; ``open`` after ``failure_threshold`` consecutive failures,
  a single probe is admitted after ``recovery_s``, and a probe success
  closes the breaker (feeds ``ReplicaState.healthy`` in core/router.py).
* Deadline budgets / load shedding live in the server (``deadline_s``):
  a request whose queue wait already exceeds its budget at dispatch
  time is shed with a terminal response instead of served.

The invariant all of this protects: **no request is ever silently
lost** — every submitted request terminates with exactly one terminal
:class:`~repro_torch.serving.openai_api.CompletionResponse`
(``ok | shed | failed | timeout | cancelled``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------
# Exceptions
# --------------------------------------------------------------------------

class FaultError(RuntimeError):
    """Base class for injected/handled backend faults."""


class TransientBackendError(FaultError):
    """Retryable backend error at dispatch time (e.g. a dropped
    connection to the sidecar's backend)."""


class EngineCrash(FaultError):
    """The engine died mid-generation; in-flight work is lost and the
    replica is down for ``repair_s``."""

    def __init__(self, msg: str = "engine crash", at: float = 0.0,
                 repair_s: float = 0.0):
        super().__init__(msg)
        self.at = at
        self.repair_s = repair_s


class PredictorFailure(FaultError):
    """Predictor raised or returned non-finite scores; admission must
    degrade, never propagate this to callers."""


# --------------------------------------------------------------------------
# Fault plans
# --------------------------------------------------------------------------

KINDS = ("crash", "lane_crash", "stall", "predictor_down", "transient",
         "overflow")


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``at``/``duration`` are virtual-time triggers (sim drains, windows);
    ``after_polls`` triggers on the N-th segment-boundary cancel poll of
    a real engine (wall-clock drains need a deterministic trigger that
    does not depend on timing).  ``replica < 0`` matches any replica.
    """
    kind: str
    at: float = 0.0
    duration: float = 0.0
    replica: int = -1
    factor: float = 2.0          # stall slowdown multiplier
    repair_s: float = 0.0        # crash: replica downtime
    after_polls: int = -1        # real engines: segment-poll trigger
    lane: int = -1               # lane_crash: victim lane (-1 = first busy)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """An immutable, seeded schedule of :class:`FaultSpec`.

    Build explicitly (``FaultPlan([spec, ...])``) for targeted tests, or
    with :meth:`random` for rate-based chaos: Poisson crash/transient
    arrivals with MTBF/MTTR parameters, all drawn from one
    ``np.random.default_rng(seed)`` so the plan — and therefore the whole
    chaos run — is deterministic.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), seed: int = 0):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    @classmethod
    def random(cls, seed: int, horizon: float, *,
               crash_mtbf: Optional[float] = None, crash_mttr: float = 5.0,
               transient_rate: Optional[float] = None,
               stall_mtbf: Optional[float] = None, stall_s: float = 10.0,
               stall_factor: float = 2.0,
               predictor_mtbf: Optional[float] = None,
               predictor_mttr: float = 10.0,
               n_replicas: int = 1) -> "FaultPlan":
        """Rate-based plan over ``[0, horizon)``.

        ``*_mtbf`` are mean seconds between faults (None disables that
        kind); crash repair times are exponential with mean
        ``crash_mttr``.  Each fault targets a uniformly random replica.
        """
        rng = np.random.default_rng(seed)
        specs: List[FaultSpec] = []

        def poisson_times(mtbf: float) -> List[float]:
            out, t = [], 0.0
            while True:
                t += float(rng.exponential(mtbf))
                if t >= horizon:
                    return out
                out.append(t)

        if crash_mtbf:
            for t in poisson_times(crash_mtbf):
                specs.append(FaultSpec(
                    kind="crash", at=t,
                    repair_s=float(rng.exponential(crash_mttr)),
                    replica=int(rng.integers(n_replicas))))
        if transient_rate:
            for t in poisson_times(1.0 / transient_rate):
                specs.append(FaultSpec(
                    kind="transient", at=t,
                    replica=int(rng.integers(n_replicas))))
        if stall_mtbf:
            for t in poisson_times(stall_mtbf):
                specs.append(FaultSpec(
                    kind="stall", at=t, duration=stall_s,
                    factor=stall_factor,
                    replica=int(rng.integers(n_replicas))))
        if predictor_mtbf:
            for t in poisson_times(predictor_mtbf):
                specs.append(FaultSpec(kind="predictor_down", at=t,
                                       duration=predictor_mttr))
        specs.sort(key=lambda s: s.at)
        return cls(specs, seed=seed)


class FaultInjector:
    """Runtime state over a :class:`FaultPlan`: which one-shot specs have
    fired, and per-replica segment-poll counters for the wall-clock
    trigger mode.  One injector is shared by a server and its engines.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan if isinstance(plan, FaultPlan) else FaultPlan(plan)
        self.reset()

    def reset(self) -> None:
        self._fired: set = set()
        self._polls: Dict[int, int] = {}

    # ------------------------------------------------------- spec queries
    def _live(self, kind: str, replica: Optional[int] = None):
        for i, s in enumerate(self.plan.specs):
            if s.kind != kind or i in self._fired:
                continue
            if replica is not None and s.replica >= 0 \
                    and s.replica != replica:
                continue
            yield i, s

    # ---------------------------------------------- virtual-time triggers
    def transient_due(self, replica: int, now: float) -> Optional[FaultSpec]:
        """Consume one due transient-error spec (each fails one attempt)."""
        for i, s in self._live("transient", replica):
            if s.at <= now:
                self._fired.add(i)
                return s
        return None

    def crash_between(self, replica: int, t0: float,
                      t1: float) -> Optional[FaultSpec]:
        """Consume the earliest crash whose trigger falls in ``[t0, t1)``
        (a virtual-time service interval).  Poll-triggered crash specs
        (``after_polls >= 0``) are ignored here."""
        best = None
        for i, s in self._live("crash", replica):
            if s.after_polls >= 0:
                continue
            if t0 <= s.at < t1 and (best is None or s.at < best[1].at):
                best = (i, s)
        if best is None:
            return None
        self._fired.add(best[0])
        return best[1]

    def stall_factor(self, replica: int, now: float) -> float:
        """Combined straggler slowdown at ``now`` (windows never fire-out)."""
        f = 1.0
        for _, s in self._live("stall", replica):
            if s.at <= now < s.at + s.duration:
                f *= s.factor
        return f

    def predictor_down(self, now: float) -> bool:
        return any(s.at <= now < s.at + s.duration
                   for _, s in self._live("predictor_down"))

    def overflow_active(self, now: float) -> bool:
        return any(s.at <= now < s.at + s.duration
                   for _, s in self._live("overflow"))

    # --------------------------------------------- segment-poll triggers
    def poll_segment(self, replica: int) -> None:
        """Called by real engines between fused-decode segments.  Raises
        :class:`EngineCrash` when a poll-triggered crash spec fires —
        this IS the mid-generation crash, surfacing at the segment
        boundary exactly like a cancellation would."""
        c = self._polls.get(replica, 0) + 1
        self._polls[replica] = c
        for i, s in self._live("crash", replica):
            if 0 <= s.after_polls <= c:
                self._fired.add(i)
                raise EngineCrash("injected engine crash "
                                  f"(replica {replica}, poll {c})",
                                  repair_s=s.repair_s)

    def lane_crash_due(self, replica: int) -> Optional[FaultSpec]:
        """Consume a due lane crash (batched engines; poll-count
        triggered, checked once per segment)."""
        c = self._polls.get(replica, 0)
        for i, s in self._live("lane_crash", replica):
            if 0 <= s.after_polls <= c:
                self._fired.add(i)
                return s
        return None


def as_injector(plan_or_injector) -> Optional[FaultInjector]:
    """Normalize a FaultPlan / FaultInjector / spec list / None."""
    if plan_or_injector is None or isinstance(plan_or_injector,
                                              FaultInjector):
        return plan_or_injector
    return FaultInjector(plan_or_injector)


# --------------------------------------------------------------------------
# Handling: retry/backoff + circuit breaker
# --------------------------------------------------------------------------

@dataclass
class RetryPolicy:
    """Bounded retries with jittered exponential backoff.

    ``backoff(attempt)`` for attempt 0, 1, ... returns
    ``base_s * multiplier**attempt * (1 + jitter * U[0,1))`` from a
    seeded rng — deterministic for a given call sequence, but decorrelated
    across retries (no synchronized retry storms).
    """
    max_retries: int = 2
    base_s: float = 0.05
    multiplier: float = 2.0
    jitter: float = 0.2
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def backoff(self, attempt: int) -> float:
        return (self.base_s * self.multiplier ** max(0, attempt)
                * (1.0 + self.jitter * float(self._rng.random())))


class CircuitBreaker:
    """closed -> open -> half-open breaker over one replica.

    * ``closed``: requests flow; ``failure_threshold`` consecutive
      failures trip it open.
    * ``open``: requests are rejected until ``recovery_s`` has elapsed.
    * ``half_open``: exactly one probe is admitted; success closes the
      breaker, failure re-opens it (cooldown restarts).
    """

    def __init__(self, failure_threshold: int = 3, recovery_s: float = 30.0):
        self.failure_threshold = int(failure_threshold)
        self.recovery_s = float(recovery_s)
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self._probe_inflight = False

    def clone(self) -> "CircuitBreaker":
        return CircuitBreaker(self.failure_threshold, self.recovery_s)

    def would_allow(self, now: float) -> bool:
        """Side-effect-free eligibility check (placement comparisons must
        not consume the half-open probe slot)."""
        if self.state == "closed":
            return True
        if self.state == "open":
            return now - self.opened_at >= self.recovery_s
        return not self._probe_inflight

    def allow(self, now: float) -> bool:
        """May a request be sent to this replica at ``now``?  Transitions
        open -> half-open after the cooldown and COMMITS the single probe
        slot — call only when the request is actually dispatched here."""
        if self.state == "closed":
            return True
        if self.state == "open":
            if now - self.opened_at >= self.recovery_s:
                self.state = "half_open"
                self._probe_inflight = True
                return True
            return False
        # half_open: one probe at a time
        if not self._probe_inflight:
            self._probe_inflight = True
            return True
        return False

    def record_success(self, now: float = 0.0) -> None:
        self.state = "closed"
        self.failures = 0
        self._probe_inflight = False

    def record_failure(self, now: float) -> None:
        self._probe_inflight = False
        if self.state == "half_open":
            self.state = "open"
            self.opened_at = now
            return
        self.failures += 1
        if self.state == "closed" and self.failures >= self.failure_threshold:
            self.state = "open"
            self.opened_at = now
