"""First-class scheduling policies (paper §3 + beyond-paper extensions).

The paper's contribution is an admission *policy* — predictive SJF with a
starvation guard — but policies used to live as a 3-string tuple whose
priority-key computation was duplicated across four layers (SJFQueue,
``sim_fast.dispatch_key``, ``core.sweep``, ``serving.server``).  This
module makes the policy a value:

* a :class:`Policy` owns the priority key in BOTH forms — ``key_array``
  for the struct-of-arrays simulation engines and ``key`` for the live
  one-request-at-a-time queue — so every consumer computes the same
  ordering from the same code;
* an :class:`AgingRule` generalises the hardwired ``wait > tau``
  starvation guard (``promote_oldest`` is the paper's rule; ``none``
  disables aging regardless of the tau passed at the call site);
* preemptive policies additionally own the preemption rule: when may a
  queued candidate evict the running request (``should_preempt``), what
  key does the evicted request re-enter the queue with (``requeue_key``),
  and — for multi-level feedback — how long a job may run before being
  demoted (``quantum_array``).  The DES engines execute these as
  re-enqueue events (``sim_fast.simulate_grid_preempt``); the live server
  executes them as segment-boundary cancellation + resume from the
  generated prefix (``serving.server``).

Registry
--------
Policies register under string names; ``"fcfs"`` / ``"sjf"`` /
``"sjf_oracle"`` are the seed aliases and stay bitwise trace-equivalent
to the reference simulator.  New in this layer:

``srpt``          preemptive shortest-remaining-predicted-time: the key is
                  the posterior-mean predicted service and decreases as the
                  job receives service; an arrival with a strictly smaller
                  predicted total evicts the running job at the next
                  decision point (Learning-to-Rank scheduling, Fu et al.).
``sjf_quantile``  uncertainty-aware SJF: the key is a high quantile
                  (mean + z*sigma of the two-class posterior mixture) of
                  predicted service, not the posterior mean — hedges
                  against confidently-wrong "short" predictions.
``mlfq``          multi-level feedback: jobs start in the predicted-class
                  queue with a service budget of ``slack x`` their
                  predicted service; jobs that outlive their prediction
                  are demoted to a background level that only runs when
                  the top level is empty.
``sjf_effective`` acceptance-aware SJF for speculative-decoding backends:
                  the key is predicted service divided by the expected
                  speculative speedup of the request's draft acceptance
                  rate — a token-long request that drafts well is
                  *effectively* short and ranks accordingly.
``fair_share``    per-tenant weighted fair share: the key is the tenant's
                  cumulative *predicted* work (weighted), so a tenant
                  flooding the queue only delays itself (start-time fair
                  queueing over the predictor's service estimates, using
                  ``Request.tenant``).

The class-conditional service estimates default to the paper's §5.5
RTX 4090 calibration (N(3.5, 0.8) short / N(8.9, 2.0) long); pass
``short``/``long`` moments to re-calibrate for another backend.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# Engine execution modes (mirrored by the C loop in core/_native.py).
MODE_NONE = 0        # non-preemptive: key fixed at admission
MODE_SRPT = 1        # preempt on arrival; key decays with service received
MODE_QUANTUM = 2     # preempt on arrival + demote on quantum expiry

#: Key offset added per MLFQ demotion level.  Any level-l key sorts after
#: every level-(l-1) key because base keys are bounded far below this.
LEVEL_STRIDE = 1e9

# Paper §5.5 service calibration (RTX 4090): N(3.5, 0.8) / N(8.9, 2.0).
DEFAULT_SHORT = (3.5, 0.8)
DEFAULT_LONG = (8.9, 2.0)


@dataclass(frozen=True)
class AgingRule:
    """Starvation guard.  ``promote_oldest`` is the paper's §3.4 rule:
    at each dispatch decision, if the FIFO-oldest waiter has waited
    strictly more than tau, it is dispatched regardless of its key.
    ``none`` disables aging even when a tau is passed per-call."""

    mode: str = "promote_oldest"          # "promote_oldest" | "none"
    tau: Optional[float] = None           # default tau (per-call overrides)

    def __post_init__(self):
        if self.mode not in ("promote_oldest", "none"):
            raise ValueError(f"unknown aging mode {self.mode!r}")

    def effective_tau(self, override: Optional[float]) -> Optional[float]:
        """The tau the engines should enforce (None = guard off)."""
        if self.mode == "none":
            return None
        return self.tau if override is None else override


@dataclass(frozen=True)
class Policy:
    """A scheduling policy: priority key + aging + optional preemption.

    Subclasses override the ``key``/``key_array`` pair (they MUST agree)
    and, for preemptive policies, the requeue/quantum hooks.  Instances
    are immutable and shareable; stateful policies (fair share) return a
    per-queue clone from :meth:`fresh`.
    """

    name: str = "policy"
    aging: AgingRule = field(default_factory=AgingRule)
    #: class-conditional service moments (mean, std) for predictor-based
    #: service estimates; paper §5.5 calibration by default
    short: Tuple[float, float] = DEFAULT_SHORT
    long: Tuple[float, float] = DEFAULT_LONG

    # engine contract -------------------------------------------------------
    mode: int = MODE_NONE

    @property
    def preemptive(self) -> bool:
        return self.mode != MODE_NONE

    @property
    def uses_predictor(self) -> bool:
        """Whether the admission path should score prompts (P(Long))."""
        return True

    def fresh(self) -> "Policy":
        """Per-queue instance (identity for stateless policies)."""
        return self

    # priority keys ---------------------------------------------------------
    def key(self, req) -> float:
        """Scalar priority key for the live queue (lower = sooner)."""
        raise NotImplementedError

    def key_array(self, arrival: np.ndarray, p_long: np.ndarray,
                  true_service: np.ndarray, tenant=None,
                  tenants: Sequence[str] = ("default",)) -> np.ndarray:
        """Array form of :meth:`key` over an arrival-sorted batch."""
        raise NotImplementedError

    # predictor-derived service estimate ------------------------------------
    def predicted_service(self, p_long: float) -> float:
        """Posterior-mean service: E[S | P(Long)] under the two-class mix."""
        return (1.0 - p_long) * self.short[0] + p_long * self.long[0]

    def predicted_service_array(self, p_long: np.ndarray) -> np.ndarray:
        p = np.asarray(p_long, np.float64)
        return (1.0 - p) * self.short[0] + p * self.long[0]

    # dispatch feedback (live queue) ----------------------------------------
    def note_dispatch(self, key: float) -> None:
        """Called by the live queue when a request with ``key`` dispatches.
        Stateless policies ignore it; fair share advances its virtual
        clock (SCFQ) so late-joining tenants cannot replay history."""

    # preemption hooks (engines consult these only when ``preemptive``) -----
    # NOTE on engine contract: the compiled DES engines
    # (sim_fast.simulate_grid_preempt / _native.des_preempt_run_many)
    # implement these hook semantics natively for the two built-in modes
    # (strict key comparison, SRPT decay, LEVEL_STRIDE demotion) — they
    # cannot call back into Python per event.  A custom subclass that
    # overrides the hooks with bespoke logic is honored on the live
    # serving path (serving/server.py calls them); array sweeps require
    # one of the built-in modes.
    def should_preempt(self, running_key: float, candidate_key: float) -> bool:
        """May the best queued candidate evict the running request?
        ``running_key`` is the running request's *current* key (for SRPT:
        predicted remaining); strict comparison — ties never preempt."""
        return candidate_key < running_key

    def running_key(self, key0: float, received: float) -> float:
        """Current key of the running request after ``received`` seconds
        of service (SRPT decays; others are static).  Floored at 0: a
        job past its predicted total is "almost done" — it keeps the
        minimal remaining-key rather than going negative (negative keys
        would make a mispredicted long both unpreemptable while running
        and queue-jumping once requeued)."""
        if self.mode == MODE_SRPT:
            return max(key0 - received, 0.0)
        return key0

    def requeue_key(self, key0: float, received: float) -> float:
        """Key a preempted request re-enters the queue with.  For MLFQ
        this is the *demotion* hook (quantum expiry); plain preemption
        re-enters at :meth:`running_key`."""
        return self.running_key(key0, received)

    def quantum_array(self, arrival: np.ndarray, p_long: np.ndarray,
                      true_service: np.ndarray) -> Optional[np.ndarray]:
        """Per-request level-0 service budget (MODE_QUANTUM only)."""
        return None

    def quantum(self, p_long: float) -> Optional[float]:
        return None


# --------------------------------------------------------------------- seed
@dataclass(frozen=True)
class FCFS(Policy):
    """First-come-first-served: key = arrival time."""

    name: str = "fcfs"

    @property
    def uses_predictor(self) -> bool:
        return False

    def key(self, req) -> float:
        return req.arrival

    def key_array(self, arrival, p_long, true_service, tenant=None,
                  tenants=("default",)) -> np.ndarray:
        return arrival


@dataclass(frozen=True)
class PredictedSJF(Policy):
    """The paper's policy: key = P(Long), the continuous predictor score."""

    name: str = "sjf"

    def key(self, req) -> float:
        return req.p_long

    def key_array(self, arrival, p_long, true_service, tenant=None,
                  tenants=("default",)) -> np.ndarray:
        return p_long


@dataclass(frozen=True)
class OracleSJF(Policy):
    """Clairvoyant upper bound: key = true service time."""

    name: str = "sjf_oracle"

    @property
    def uses_predictor(self) -> bool:
        return False

    def key(self, req) -> float:
        return req.true_service

    def key_array(self, arrival, p_long, true_service, tenant=None,
                  tenants=("default",)) -> np.ndarray:
        return true_service


# ---------------------------------------------------------------- extensions
@dataclass(frozen=True)
class PredictedSRPT(Policy):
    """Preemptive shortest-remaining-predicted-time.

    Key = posterior-mean predicted service; while a request runs, its key
    decays by the service received, and an arrival whose predicted total
    is strictly below the running request's predicted remaining evicts it
    at the next decision point (segment boundary on the live engine,
    arrival event in the DES).
    """

    name: str = "srpt"
    mode: int = MODE_SRPT

    def key(self, req) -> float:
        return self.predicted_service(req.p_long)

    def key_array(self, arrival, p_long, true_service, tenant=None,
                  tenants=("default",)) -> np.ndarray:
        return self.predicted_service_array(p_long)


@dataclass(frozen=True)
class QuantileSJF(Policy):
    """Uncertainty-aware SJF: key = high-quantile predicted service.

    Plain SJF keys on the posterior mean, which is a monotone transform
    of P(Long) — it cannot distinguish a 95%-confident "short" from a
    60%-confident one.  This key evaluates predicted service at the
    *pessimistic* posterior ``p_hi = clip(p + z * sqrt(p (1-p)))``
    (z = Phi^-1(q), default q = 0.90): confident predictions keep their
    rank while uncertain mid-posterior scores are hedged toward the long
    class, so a 60%-confident "short" sorts after a 95%-confident one
    (uncertainty-aware length prediction, 2604.00499).
    """

    name: str = "sjf_quantile"
    z: float = 1.2815515655446004          # Phi^-1(0.90)

    def _hedged(self, p):
        p_hi = np.clip(p + self.z * np.sqrt(np.maximum(p * (1.0 - p), 0.0)),
                       0.0, 1.0)
        return (1.0 - p_hi) * self.short[0] + p_hi * self.long[0]

    def key(self, req) -> float:
        return float(self._hedged(float(req.p_long)))

    def key_array(self, arrival, p_long, true_service, tenant=None,
                  tenants=("default",)) -> np.ndarray:
        return self._hedged(np.asarray(p_long, np.float64))


@dataclass(frozen=True)
class MLFQ(Policy):
    """Multi-level feedback over the predicted class.

    Level 0 orders by P(Long) (the paper's key) and grants each job a
    service budget of ``slack x`` its predicted service; a job that
    outlives its prediction is demoted to the background level
    (key + ``LEVEL_STRIDE``), which only runs when level 0 is empty.
    Arrivals preempt strictly-worse running jobs, so a mispredicted
    long can no longer hold the head of the line.
    """

    name: str = "mlfq"
    mode: int = MODE_QUANTUM
    slack: float = 1.5

    def key(self, req) -> float:
        return req.p_long

    def key_array(self, arrival, p_long, true_service, tenant=None,
                  tenants=("default",)) -> np.ndarray:
        return np.asarray(p_long, np.float64)

    def requeue_key(self, key0: float, received: float) -> float:
        return key0 + LEVEL_STRIDE          # demotion

    def quantum_array(self, arrival, p_long, true_service):
        return self.slack * self.predicted_service_array(p_long)

    def quantum(self, p_long: float) -> Optional[float]:
        return self.slack * self.predicted_service(p_long)


@dataclass(frozen=True)
class WeightedFairShare(Policy):
    """Per-tenant weighted fair share over predicted work.

    Key = the tenant's virtual finish tag: ``max(tenant's last finish
    tag, virtual time) + predicted service / weight`` — self-clocked fair
    queueing (SCFQ) over the predictor's estimates.  A tenant flooding
    the queue inflates only its own tags, so light tenants keep
    dispatching; the virtual-time floor (advanced by the live queue via
    :meth:`note_dispatch`) stops a late-joining tenant from replaying
    the incumbents' whole service history.  ``weights`` maps tenant
    name -> share weight (default 1.0; higher = larger share).

    The array form tags a one-shot admission batch from a zero virtual
    clock (the DES engines precompute static keys, so there is no
    dispatch feedback); it matches the scalar form exactly for a fresh
    queue tagged before any dispatch.
    """

    name: str = "fair_share"
    weights: Tuple[Tuple[str, float], ...] = ()

    def fresh(self) -> "WeightedFairShare":
        clone = replace(self)
        object.__setattr__(clone, "_credit", {})
        object.__setattr__(clone, "_vtime", 0.0)
        return clone

    def _weight(self, tenant: str) -> float:
        return dict(self.weights).get(tenant, 1.0)

    def key(self, req) -> float:
        credit = getattr(self, "_credit", None)
        if credit is None:                  # registry instance: lazily init
            credit = {}
            object.__setattr__(self, "_credit", credit)
            object.__setattr__(self, "_vtime", 0.0)
        cost = self.predicted_service(req.p_long) / self._weight(req.tenant)
        start = max(credit.get(req.tenant, 0.0), self._vtime)
        credit[req.tenant] = start + cost
        return credit[req.tenant]

    def note_dispatch(self, key: float) -> None:
        if key > getattr(self, "_vtime", 0.0):
            object.__setattr__(self, "_vtime", key)

    def key_array(self, arrival, p_long, true_service, tenant=None,
                  tenants=("default",)) -> np.ndarray:
        n = len(arrival)
        pred = self.predicted_service_array(p_long)
        if tenant is None:
            tenant = np.zeros(n, np.int32)
        w = np.array([self._weight(t) for t in tenants], np.float64)
        w = w[np.minimum(tenant, len(w) - 1)] if len(w) else np.ones(n)
        share = pred / w
        key = np.empty(n, np.float64)
        for code in np.unique(tenant):
            m = tenant == code
            key[m] = np.cumsum(share[m])
        return key


@dataclass(frozen=True)
class EffectiveSJF(Policy):
    """Acceptance-aware SJF: key = predicted service / expected speedup.

    Under speculative decoding a request's wall-clock cost is not its
    token count — it is the token count divided by the speculative
    speedup, which varies per request with draft acceptance (predictable
    prompts draft well, adversarial ones do not).  This key divides the
    posterior-mean predicted service by
    ``serving.service_time.expected_speedup(accept_rate, draft_k)`` so a
    token-long request that speculates well can rank ahead of a
    token-short one that does not.  Requests without an ``accept_rate``
    (None) fall back to ``prior_accept``; with a uniform acceptance rate
    the key is a positive scalar multiple of plain SJF's, i.e. the
    ordering degenerates to token-count SJF exactly.
    """

    name: str = "sjf_effective"
    draft_k: int = 4
    draft_cost: float = 0.15
    prior_accept: float = 0.5

    def _speedup(self, accept_rate):
        # lazy import: serving.service_time imports core.simulation,
        # which reaches back into this module via core.scheduler
        from repro_torch.serving.service_time import expected_speedup
        return expected_speedup(accept_rate, self.draft_k, self.draft_cost)

    def key(self, req) -> float:
        a = getattr(req, "accept_rate", None)
        if a is None:
            a = self.prior_accept
        return self.predicted_service(req.p_long) / float(self._speedup(a))

    def key_array(self, arrival, p_long, true_service, tenant=None,
                  tenants=("default",), accept_rate=None) -> np.ndarray:
        pred = self.predicted_service_array(p_long)
        if accept_rate is None:
            return pred / float(self._speedup(self.prior_accept))
        a = np.where(np.isnan(np.asarray(accept_rate, np.float64)),
                     self.prior_accept, np.asarray(accept_rate, np.float64))
        return pred / self._speedup(a)


# ------------------------------------------------------------------ registry
_REGISTRY: Dict[str, Policy] = {}


def register(policy: Policy) -> Policy:
    """Register ``policy`` under its name (later wins)."""
    _REGISTRY[policy.name] = policy
    return policy


def registered_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def get_policy(spec) -> Policy:
    """Resolve a policy spec: a :class:`Policy` passes through, a string
    looks up the registry.  Unknown names raise ``ValueError`` listing the
    registered policies (an exception, not an assert, so ``python -O``
    builds fail loudly too)."""
    if isinstance(spec, Policy):
        return spec
    if isinstance(spec, str):
        try:
            return _REGISTRY[spec]
        except KeyError:
            raise ValueError(
                f"unknown policy {spec!r}; registered: "
                f"{', '.join(sorted(_REGISTRY))}") from None
    raise TypeError(f"policy spec must be str or Policy, got {type(spec)!r}")


register(FCFS())
register(PredictedSJF())
register(OracleSJF())
register(PredictedSRPT())
register(QuantileSJF())
register(MLFQ())
register(WeightedFairShare())
register(EffectiveSJF())

#: The seed policy names (kept for backward compatibility; the full set is
#: :func:`registered_names`).
SEED_POLICIES = ("fcfs", "sjf", "sjf_oracle")
