"""Discrete-event simulation of the serial backend (paper §5.4/§5.5).

Single non-preemptive server fed by the SJFQueue: exactly the M/G/1 setting
of the paper's steady-state analysis and the closed-queue setting of its
burst benchmark.  Service times come either from parametric distributions
(the paper's calibrated Gaussians) or from the framework's roofline-derived
engine cost model (serving/service_time.py).

``simulate`` runs on the vectorized SoA engine (``core.sim_fast`` — C
inner loop with a run-batched numpy fallback); the seed per-event Python
loop is kept as ``simulate_reference``, the trace-equivalence oracle and
the "old" side of ``benchmarks/sim_bench.py``.  For whole grids
(policy x tau x rho x seed) use ``core.sweep`` — one call per sweep,
not one per cell.  A copy of ``repro.core.simulation``
(imports renamed), held to it by ``tests/test_torch_des.py``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch.core.scheduler import Request, SJFQueue


@dataclass
class SimResult:
    requests: List[Request]
    promotions: int
    makespan: float

    def _vals(self, klass: Optional[str], attr: str) -> np.ndarray:
        # wait/sojourn are NaN (not None) before dispatch/completion
        vals = [getattr(r, attr) for r in self.requests
                if klass is None or r.klass == klass]
        return np.array([v for v in vals
                         if v is not None and not math.isnan(v)])

    def percentile(self, q: float, klass: Optional[str] = None,
                   attr: str = "sojourn") -> float:
        v = self._vals(klass, attr)
        return float(np.percentile(v, q)) if len(v) else float("nan")

    def mean(self, klass: Optional[str] = None, attr: str = "sojourn") -> float:
        v = self._vals(klass, attr)
        return float(v.mean()) if len(v) else float("nan")


def simulate_reference(requests: Sequence[Request], policy="sjf",
                       tau: Optional[float] = None) -> SimResult:
    """Seed per-event loop (the trace-equivalence oracle; slow).

    Accepts any *non-preemptive* registered policy (the oracle serves each
    dispatched request to completion); preemptive policies are rejected.
    """
    from repro_torch.core.policy import get_policy
    if get_policy(policy).preemptive:
        raise ValueError("simulate_reference is non-preemptive; use "
                         "simulate() for preemptive policies")
    reqs = sorted(requests, key=lambda r: (r.arrival, r.req_id))
    q = SJFQueue(policy=policy, tau=tau)
    t = 0.0
    i, n = 0, len(reqs)
    done: List[Request] = []
    while i < n or len(q):
        if not len(q):
            t = max(t, reqs[i].arrival)
        while i < n and reqs[i].arrival <= t:
            q.push(reqs[i])
            i += 1
        req = q.pop(now=t)
        if req is None:
            continue
        req.start = t
        t += req.true_service
        req.finish = t
        done.append(req)
    return SimResult(requests=done, promotions=q.stats["promotions"],
                     makespan=t)


def simulate(requests: Sequence[Request], policy="sjf",
             tau: Optional[float] = None, engine: str = "auto",
             recorder=None) -> SimResult:
    """Run the serial-server DES.  ``requests`` carry arrival/p_long/service.

    ``policy`` is a registry name or Policy instance.  For key-based
    policies this keeps the seed loop's contract (start/finish/promoted
    written onto the passed Requests, dispatch-ordered result list) and is
    trace-equivalent bitwise; preemptive policies (srpt/mlfq) run on the
    preemptive engine, where ``start`` is the FIRST dispatch time.

    ``recorder`` (a ``serving.observability.FlightRecorder``) replays the
    result as the live drains' span schema in virtual time — pure
    post-processing over the DES result arrays, zero inner-loop cost.
    """
    from repro_torch.core.sim_fast import RequestBatch, simulate_batch
    reqs = sorted(requests, key=lambda r: (r.arrival, r.req_id))
    n = len(reqs)
    if n == 0:
        return SimResult(requests=[], promotions=0, makespan=0.0)
    res = simulate_batch(RequestBatch.from_requests(reqs), policy=policy,
                         tau=tau, engine=engine)
    for i, r in enumerate(reqs):
        r.start = float(res.start[i])
        r.finish = float(res.finish[i])
        r.promoted = bool(res.promoted[i])
    if recorder is not None:
        from repro_torch.core.sim_fast import record_batch_trace
        record_batch_trace(
            recorder,
            arrival=[r.arrival for r in reqs],
            start=res.start, finish=res.finish,
            req_ids=[r.req_id for r in reqs],
            out_tokens=[r.meta.get("output_tokens")
                        if r.meta.get("output_tokens") is not None
                        else None for r in reqs]
            if any(r.meta.get("output_tokens") is not None
                   for r in reqs) else None)
    done = [reqs[i] for i in np.argsort(res.start, kind="stable")]
    return SimResult(requests=done, promotions=res.promotions,
                     makespan=res.makespan)


def simulate_speculative(requests: Sequence[Request], policy="sjf",
                         tau: Optional[float] = None, *, draft_k: int = 0,
                         draft_cost: float = 0.15,
                         engine: str = "auto") -> SimResult:
    """Serial-server DES with a speculative-decoding backend.

    Mirrors draft-verify decode (serving/generate.py) as a per-request
    service-rate modifier: each request's wall-clock service is
    ``true_service / expected_speedup(accept_rate, draft_k)`` where
    ``accept_rate`` is ``Request.accept_rate`` (None counts as 0.0 — the
    draft overhead is paid regardless).  Acceptance-aware policies
    (``sjf_effective``) receive the per-request acceptance rates through
    ``key_array``; plain policies key exactly as before.  ``draft_k=0``
    is the identity — bitwise trace-equal to :func:`simulate`.
    """
    from dataclasses import replace as _replace

    from repro_torch.core.policy import EffectiveSJF, get_policy
    from repro_torch.core.sim_fast import (RequestBatch, simulate_arrays,
                                     speculative_service)
    reqs = sorted(requests, key=lambda r: (r.arrival, r.req_id))
    n = len(reqs)
    if n == 0:
        return SimResult(requests=[], promotions=0, makespan=0.0)
    pol = get_policy(policy)
    if isinstance(pol, EffectiveSJF):
        # key against this run's actual draft depth/cost
        pol = _replace(pol, draft_k=draft_k, draft_cost=draft_cost)
    if pol.preemptive:
        raise ValueError(
            f"simulate_speculative supports key-based policies only, "
            f"got preemptive {pol.name!r}")
    batch = RequestBatch.from_requests(reqs)      # already arrival-sorted
    accept = np.array([float("nan") if r.accept_rate is None
                       else float(r.accept_rate) for r in reqs], np.float64)
    service = speculative_service(batch.true_service, accept, draft_k,
                                  draft_cost)
    try:
        key = pol.key_array(batch.arrival, batch.p_long, service,
                            tenant=batch.tenant, tenants=batch.tenants,
                            accept_rate=accept)
    except TypeError:                             # acceptance-unaware policy
        key = pol.key_array(batch.arrival, batch.p_long, service,
                            tenant=batch.tenant, tenants=batch.tenants)
    start, finish, promoted, promotions = simulate_arrays(
        batch.arrival, service, key, pol.aging.effective_tau(tau),
        engine=engine)
    for i, r in enumerate(reqs):
        r.start = float(start[i])
        r.finish = float(finish[i])
        r.promoted = bool(promoted[i])
    done = [reqs[i] for i in np.argsort(start, kind="stable")]
    return SimResult(requests=done, promotions=promotions,
                     makespan=float(finish.max()))


def simulate_servers(requests: Sequence[Request], policy="sjf",
                     tau: Optional[float] = None, n_servers: int = 1,
                     slowdown=None, mem_tokens=None,
                     mem_budget=None) -> SimResult:
    """Run the *c-server* DES: ``n_servers`` concurrent decode lanes with
    a per-lane slowdown ``slowdown[k-1]`` at k busy lanes and an optional
    memory-token budget — the bounded-concurrency micro-batching regime
    (serving/batching.py) in virtual time.

    ``mem_tokens`` is aligned with the arrival-sorted request order (the
    same ``(arrival, req_id)`` sort every engine applies).  Key-based
    policies and srpt are supported; the reference simulator stays c=1 —
    at ``n_servers=1`` with unit slowdown this is bitwise trace-equal to
    :func:`simulate` (and the reference) for key policies.
    """
    from repro_torch.core.sim_fast import RequestBatch, simulate_batch_servers
    reqs = sorted(requests, key=lambda r: (r.arrival, r.req_id))
    n = len(reqs)
    if n == 0:
        return SimResult(requests=[], promotions=0, makespan=0.0)
    res = simulate_batch_servers(
        RequestBatch.from_requests(reqs), policy=policy, tau=tau,
        n_servers=n_servers, slowdown=slowdown, mem_tokens=mem_tokens,
        mem_budget=mem_budget)
    for i, r in enumerate(reqs):
        r.start = float(res.start[i])
        r.finish = float(res.finish[i])
        r.promoted = bool(res.promoted[i])
    done = [reqs[i] for i in np.argsort(res.start, kind="stable")]
    return SimResult(requests=done, promotions=res.promotions,
                     makespan=res.makespan)


@dataclass
class PagedSimResult(SimResult):
    """A :class:`SimResult` plus the paged-pool outcome counters."""

    preemptions: int = 0
    prefix_hits: int = 0
    peak_pages: float = 0.0


def simulate_paged(requests: Sequence[Request], policy="sjf",
                   tau: Optional[float] = None, n_servers: int = 1,
                   slowdown=None, *, prompt_tokens, total_tokens,
                   page_size: int, n_pages: int, share_group=None,
                   shared_tokens=None,
                   prefill_saved=None) -> PagedSimResult:
    """Run the *block-paged* c-server DES: the worst-case memory
    reservation of :func:`simulate_servers` replaced by page-granular
    accounting with linear decode growth, youngest-lane preemption on
    pool exhaustion and a shared-prefix cache
    (:func:`repro_torch.core.sim_fast.simulate_grid_paged`).

    Token arrays are aligned with the arrival-sorted request order and
    converted to pages here (``ceil(tokens / page_size)``; shared
    prefixes count whole pages only, as the allocator caches only full
    pages).  ``share_group`` labels requests sharing a prompt prefix of
    ``shared_tokens`` tokens; ``prefill_saved`` is the prefill seconds a
    warm admission skips.
    """
    from repro_torch.core.sim_fast import RequestBatch, simulate_batch_paged
    ps = int(page_size)
    if ps < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    reqs = sorted(requests, key=lambda r: (r.arrival, r.req_id))
    n = len(reqs)
    if n == 0:
        return PagedSimResult(requests=[], promotions=0, makespan=0.0)
    pp = -(-np.asarray(prompt_tokens, np.float64) // ps)
    tp = -(-np.asarray(total_tokens, np.float64) // ps)
    sp = None if shared_tokens is None \
        else np.asarray(shared_tokens, np.float64) // ps   # full pages only
    res = simulate_batch_paged(
        RequestBatch.from_requests(reqs), policy=policy, tau=tau,
        n_servers=n_servers, slowdown=slowdown, prompt_pages=pp,
        total_pages=tp, n_pages=n_pages, share_group=share_group,
        shared_pages=sp, prefill_saved=prefill_saved)
    for i, r in enumerate(reqs):
        r.start = float(res.start[i])
        r.finish = float(res.finish[i])
        r.promoted = bool(res.promoted[i])
    done = [reqs[i] for i in np.argsort(res.start, kind="stable")]
    return PagedSimResult(requests=done, promotions=res.promotions,
                          makespan=res.makespan,
                          preemptions=res.preemptions,
                          prefix_hits=res.prefix_hits,
                          peak_pages=res.peak_pages)


@dataclass
class FaultSimResult(SimResult):
    """A :class:`SimResult` plus the fault-run outcome counters.  Shed
    requests stay in ``requests`` with ``start = finish = NaN``, so the
    percentile/mean aggregations (which drop NaN) report *goodput*
    latency over served requests only."""

    shed: int = 0
    requeues: int = 0
    timeouts: int = 0

    @property
    def served(self) -> int:
        return len(self.requests) - self.shed - self.timeouts


def simulate_faulty(requests: Sequence[Request], policy="sjf",
                    tau: Optional[float] = None,
                    faults=None, deadline: Optional[float] = None,
                    in_service_timeout: bool = False
                    ) -> FaultSimResult:
    """Run the serial DES under a :class:`~repro_torch.core.sim_fast.ServerFaults`
    timeline (server down/repair windows + stall windows) with optional
    deadline shedding (a request whose queueing delay exceeds ``deadline``
    at dispatch is dropped — only before any service has run; a crashed
    request's remainder is always work-conserving requeued).
    ``in_service_timeout=True`` extends the deadline to the whole sojourn:
    mid-service expiry abandons the request at the deadline instant
    (``meta["timeout"]``, counted in ``timeouts``) — the DES mirror of the
    sidecar's ``deadline_mode="sojourn"``.

    With ``faults=None``/empty and ``deadline=None`` this is bitwise
    trace-equivalent to :func:`simulate` (and the reference oracle) for
    key-based policies; preemptive policies are rejected.
    """
    from repro_torch.core.policy import get_policy
    from repro_torch.core.sim_fast import (RequestBatch, ServerFaults,
                                     simulate_grid_faults)
    pol = get_policy(policy)
    if pol.preemptive:
        raise ValueError("simulate_faulty is non-preemptive; fault "
                         "injection composes with key-based policies only")
    if faults is None:
        faults = ServerFaults()
    reqs = sorted(requests, key=lambda r: (r.arrival, r.req_id))
    n = len(reqs)
    if n == 0:
        return FaultSimResult(requests=[], promotions=0, makespan=0.0)
    b = RequestBatch.from_requests(reqs)
    key = pol.key_array(b.arrival, b.p_long, b.true_service,
                        tenant=b.tenant, tenants=b.tenants)
    start, finish, promoted, promos, shed, timeout, requeues = \
        simulate_grid_faults(
            b.arrival[None], b.true_service[None], key[None],
            (pol.aging.effective_tau(tau),), faults, deadline=deadline,
            in_service_timeout=in_service_timeout)
    for i, r in enumerate(reqs):
        r.start = float(start[0, i])
        r.finish = float(finish[0, i])
        r.promoted = bool(promoted[0, i])
        if shed[0, i]:
            r.meta["shed"] = True
        if timeout[0, i]:
            r.meta["timeout"] = True
    ok = ~shed[0] & ~timeout[0]
    makespan = float(finish[0, ok].max()) if ok.any() else 0.0
    done = [reqs[i] for i in np.argsort(np.where(ok, start[0], np.inf),
                                        kind="stable")]
    return FaultSimResult(requests=done, promotions=int(promos[0]),
                          makespan=makespan, shed=int(shed[0].sum()),
                          requeues=int(requeues[0]),
                          timeouts=int(timeout[0].sum()))


# ---------------------------------------------------------------------------
# Workload generators
# ---------------------------------------------------------------------------

@dataclass
class ServiceDist:
    """Truncated normal service-time distribution (paper §5.5 uses
    N(3.5, 0.8) short / N(8.9, 2.0) long for the RTX 4090 calibration)."""
    mean: float
    std: float
    floor: float = 0.05

    def sample(self, rng, size=None):
        return np.maximum(rng.normal(self.mean, self.std, size), self.floor)


def poisson_workload(rng, n: int, lam: float,
                     short: ServiceDist, long: ServiceDist,
                     mix_long: float = 0.5,
                     p_long_fn: Optional[Callable[[Request], float]] = None
                     ) -> List[Request]:
    """Open-loop Poisson arrivals with a short/long service mix."""
    arrivals = np.cumsum(rng.exponential(1.0 / lam, n))
    out = []
    for k in range(n):
        is_long = rng.random() < mix_long
        dist = long if is_long else short
        r = Request(req_id=k, arrival=float(arrivals[k]),
                    true_service=float(dist.sample(rng)),
                    klass="long" if is_long else "short")
        r.p_long = 1.0 if is_long else 0.0
        out.append(r)
    if p_long_fn is not None:
        for r in out:
            r.p_long = p_long_fn(r)
    return out


def burst_workload(rng, n_short: int, n_long: int,
                   short: ServiceDist, long: ServiceDist,
                   window: float = 0.05) -> List[Request]:
    """The paper's adversarial stress test: all requests arrive within
    ``window`` seconds (asyncio.gather analogue)."""
    out = []
    total = n_short + n_long
    order = rng.permutation(total)
    for pos, k in enumerate(order):
        is_long = k >= n_short
        dist = long if is_long else short
        r = Request(req_id=pos, arrival=float(rng.uniform(0, window)),
                    true_service=float(dist.sample(rng)),
                    klass="long" if is_long else "short")
        r.p_long = 1.0 if is_long else 0.0
        out.append(r)
    return out


def imperfect_predictor(rng, ranking_accuracy: float
                        ) -> Callable[[Request], float]:
    """Synthesise P(Long) scores achieving a target (Short, Long) pairwise
    ranking accuracy — used to propagate measured predictor fidelity into the
    queueing simulation without re-running the real predictor."""
    spread = _spread_for_accuracy(ranking_accuracy)

    def fn(req: Request) -> float:
        base = 0.75 if req.klass == "long" else 0.25
        return float(np.clip(rng.normal(base, spread), 0.0, 1.0))

    return fn


def _spread_for_accuracy(acc: float) -> float:
    """Noise sigma s.t. P(N(.75,s) > N(.25,s)) == acc (two-class gaussians)."""
    acc = min(max(acc, 0.5 + 1e-6), 1.0 - 1e-9)
    # P(X_l > X_s) = Phi(0.5 / (s*sqrt(2)))
    z = _probit(acc)
    return 0.5 / (z * math.sqrt(2.0)) if z > 0 else 1e6


def _probit(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        return -_probit(1 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
           (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


# ---------------------------------------------------------------------------
# Queueing theory reference values (paper §2.4)
# ---------------------------------------------------------------------------

def pk_wait_fcfs(lam: float, es: float, es2: float) -> float:
    """Pollaczek-Khinchine mean FCFS waiting time.  es2 = E[S^2]."""
    rho = lam * es
    if rho >= 1.0:
        return float("inf")
    return lam * es2 / (2.0 * (1.0 - rho))


def cs2(service_times: np.ndarray) -> float:
    """Squared coefficient of variation (Table 1)."""
    s = np.asarray(service_times, float)
    return float(s.var() / s.mean() ** 2)
