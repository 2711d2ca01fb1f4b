"""Cluster-level predictive routing (beyond-paper extension).

At fleet scale each model-parallel replica is a serial backend with its own
Clairvoyant admission queue.  The same P(Long) signal the paper uses for
*ordering* is used here for *placement*: join-shortest-predicted-work (JSPW)
— route each request to the replica with the least predicted outstanding
work, where predicted work is the expected service time under the predictor's
class posterior.  Falls back to join-shortest-queue when no predictor is
available.  Hedged dispatch re-enqueues requests from replicas that miss a
deadline (straggler mitigation on the serving path).

Robustness: an optional per-replica circuit breaker
(serving/faults.py) feeds placement eligibility — engine failures
recorded via :meth:`PredictiveRouter.record_failure` trip the breaker
open after N consecutive failures, the replica stops receiving traffic
for its cooldown, then a single half-open probe re-admits it on success.
``ReplicaState.healthy`` stays the *manual* kill switch
(:meth:`fail_replica`); a replica takes traffic only when it is healthy
AND its breaker allows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.scheduler import Request, SJFQueue
from repro_torch.serving.faults import CircuitBreaker


@dataclass
class ReplicaState:
    replica_id: int
    queue: SJFQueue
    busy_until: float = 0.0          # time the in-flight request finishes
    predicted_backlog: float = 0.0   # sum of predicted service of queued reqs
    healthy: bool = True
    breaker: Optional[CircuitBreaker] = None


class PredictiveRouter:
    """JSPW router over N replica admission queues.

    ``policy`` is a registry name or :class:`repro_torch.core.policy.Policy`
    instance; each replica queue resolves it through the policy layer, so
    the fleet can run any registered policy (including preemptive ones on
    backends that support eviction).
    """

    def __init__(self, n_replicas: int, policy="sjf",
                 tau: Optional[float] = None,
                 service_estimate=(2.0, 10.0, 30.0),
                 breaker: Optional[CircuitBreaker] = None):
        """service_estimate: expected service seconds per (short, med, long).
        ``breaker`` is a template circuit breaker cloned per replica
        (None disables automatic failure-driven eligibility)."""
        self.replicas = [
            ReplicaState(i, SJFQueue(policy=policy, tau=tau),
                         breaker=breaker.clone() if breaker else None)
            for i in range(n_replicas)]
        self.service_estimate = np.asarray(service_estimate, float)
        self.stats = {"routed": 0, "hedged": 0, "failed_over": 0,
                      "breaker_opens": 0, "breaker_probes": 0}
        # optional serving.observability.FlightRecorder: route decisions
        # become instant events on the chosen replica's trace track
        self.recorder = None

    def eligible(self, replica_id: int, now: float = 0.0) -> bool:
        """May this replica receive traffic?  ``healthy`` is the manual
        kill switch; the breaker adds automatic failure-driven gating.
        Pure check — the half-open probe slot is only committed when
        :meth:`route` actually places a request on the replica."""
        r = self.replicas[replica_id]
        return r.healthy and (r.breaker is None
                              or r.breaker.would_allow(now))

    def record_failure(self, replica_id: int, now: float) -> None:
        """An engine fault on this replica: feed the breaker (if any)."""
        r = self.replicas[replica_id]
        if r.breaker is not None:
            was_open = r.breaker.state == "open"
            r.breaker.record_failure(now)
            if r.breaker.state == "open" and not was_open:
                self.stats["breaker_opens"] += 1

    def record_success(self, replica_id: int, now: float = 0.0) -> None:
        r = self.replicas[replica_id]
        if r.breaker is not None:
            if r.breaker.state == "half_open":
                self.stats["breaker_probes"] += 1
            r.breaker.record_success(now)

    def predicted_service(self, proba: np.ndarray) -> float:
        """E[service | predictor posterior]."""
        return float(np.dot(np.asarray(proba, float), self.service_estimate))

    def route(self, req: Request, proba: Optional[np.ndarray] = None,
              now: float = 0.0, exclude: Optional[int] = None,
              est: Optional[float] = None) -> int:
        """``est`` overrides the service estimate when the caller already
        knows it (hedging/failover re-routes of scored requests)."""
        if est is None:
            est = (self.predicted_service(proba) if proba is not None
                   else float(self.service_estimate.mean()))
        best, best_cost = None, float("inf")
        for r in self.replicas:
            if r.replica_id == exclude \
                    or not self.eligible(r.replica_id, now):
                continue
            cost = max(r.busy_until - now, 0.0) + r.predicted_backlog + est
            if cost < best_cost:
                best, best_cost = r, cost
        if best is None:
            raise RuntimeError("no healthy replicas")
        if best.breaker is not None:
            best.breaker.allow(now)       # commit the half-open probe slot
        req.meta["predicted_service"] = est
        req.meta["replica"] = best.replica_id
        best.queue.push(req)
        best.predicted_backlog += est
        self.stats["routed"] += 1
        rec = self.recorder
        if rec is not None:
            rec.instant("route", req.req_id, now,
                        track=f"replica{best.replica_id}",
                        args={"replica": best.replica_id,
                              "est": round(est, 4),
                              "backlog": round(best.predicted_backlog, 4)})
        return best.replica_id

    def hedge_overdue(self, now: float, deadline: float) -> List[Request]:
        """Hedged dispatch: re-route requests that missed their queue-wait
        deadline on a straggling replica.

        Any queued request whose wait exceeds ``deadline`` is cancelled
        from its queue and re-routed to the least-loaded *other* replica
        (straggler mitigation on the serving path).  Each request is
        hedged at most once (``meta["hedged"]``), so repeated sweeps
        cannot bounce a request between replicas forever.
        """
        if len([r for r in self.replicas if r.healthy]) < 2:
            return []
        moved: List[Request] = []
        for r in self.replicas:
            if not r.healthy:
                continue
            overdue = [req for req in r.queue.waiting()
                       if (now - req.arrival) > deadline
                       and not req.meta.get("hedged")]
            for req in overdue:
                r.queue.remove(req.req_id)
                est = req.meta.get("predicted_service") or None
                if est:
                    r.predicted_backlog = max(0.0,
                                              r.predicted_backlog - est)
                req.meta["hedged"] = True
                # carry the known estimate: re-routing must not replace a
                # scored request's prediction with the class-agnostic mean
                self.route(req, now=now, exclude=r.replica_id, est=est)
                self.stats["hedged"] += 1
                moved.append(req)
        return moved

    def on_dispatch(self, replica_id: int, req: Request, now: float,
                    service_estimate: Optional[float] = None) -> None:
        r = self.replicas[replica_id]
        est = service_estimate or req.meta.get("predicted_service", 0.0)
        r.predicted_backlog = max(0.0, r.predicted_backlog - est)
        r.busy_until = now + est

    def release(self, replica_id: int, req: Request) -> None:
        """Release a request's predicted backlog without dispatching it
        (shed / terminal failure): the work will never run here."""
        r = self.replicas[replica_id]
        est = req.meta.get("predicted_service", 0.0)
        r.predicted_backlog = max(0.0, r.predicted_backlog - est)

    def on_engine_failure(self, replica_id: int, req: Request,
                          now: float) -> int:
        """Retry-aware failover: record the fault against the replica's
        breaker, then re-route the in-flight request through the existing
        ``exclude``/``est`` path (carrying its known service estimate).
        Falls back to the same replica's queue when no other replica is
        eligible — the request must terminate somewhere, and the repaired
        replica will drain it."""
        self.record_failure(replica_id, now)
        self.release(replica_id, req)
        req.meta["failed_over"] = True
        est = req.meta.get("predicted_service")
        try:
            chosen = self.route(req, now=now, exclude=replica_id, est=est)
            self.stats["failed_over"] += 1
            return chosen
        except RuntimeError:
            r = self.replicas[replica_id]
            r.queue.push_requeue(
                req, req.meta.get("queue_key",
                                  req.meta.get("policy_key0", 0.0)),
                reason="fault")
            r.predicted_backlog += est or 0.0
            return replica_id

    def fail_replica(self, replica_id: int, now: float = 0.0) -> List[Request]:
        """Replica loss: drain its queue and re-route every queued request.

        Non-preemptive SJF makes replay trivial — nothing mid-flight is lost
        except the active request, which the engine re-enqueues at its head.
        """
        r = self.replicas[replica_id]
        r.healthy = False
        drained = []
        while True:
            req = r.queue.pop(now=now)
            if req is None:
                break
            drained.append(req)
        for req in drained:
            req.meta["failed_over"] = True
            # carry the known estimate: re-routing must not replace a
            # scored request's prediction with the class-agnostic mean
            self.route(req, now=now,
                       est=req.meta.get("predicted_service") or None)
            self.stats["failed_over"] += 1
        return drained

    def queue_lengths(self) -> Dict[int, int]:
        return {r.replica_id: len(r.queue) for r in self.replicas}
