"""The Clairvoyant front end (port of ``repro.serving.server.
ClairvoyantServer``): features -> predictor -> SJF queue -> engine.

``ClairvoyantServer`` fronts N replica engines; each replica has its own
``SJFQueue`` (+ starvation guard) and the multi-replica case routes by
predicted work (``core.router.PredictiveRouter``).  The policy is a
``core.policy.Policy`` (registry name or instance); a preemptive one
(``srpt``, ``mlfq``) evicts the running request at the next fused-decode
segment boundary.

Admission: ``submit`` scores one request (the predictor's single-row path,
K5 on the card) -- the sidecar calls it per HTTP request; ``submit_many``
scores an arrival burst with one batched call (K5 too).  A predictor
exception, a non-finite score or an injected outage admits with
``p_long = 0`` (FCFS order) and sets ``degraded`` until a later call
succeeds.  Without ``true_output_tokens`` a request's output length is
drawn from the service model's class lengths (``sample_output_tokens``
on the server's seeded RNG), as in the JAX server.

The drains (the sidecar has its own dispatch loop,
``serving/http_sidecar.py``):

* a ``SimEngine`` replica (the default when no engines are given):
  ``_drain_sim``, a virtual clock advanced by the ``ServiceTimeModel``,
  with injected transients, stalls and crash + repair, deadline shedding
  and sojourn timeouts; under a preemptive policy the replica's backlog
  runs through the preemptive DES (``_drain_sim_preemptive``);
* a ``RealEngine`` replica: ``_drain_real``, one fused decode at a time
  on the wall clock.  Under a preemptive policy only requests that have
  arrived compete (``_pop_arrival_aware``), a better-keyed arrival (or an
  exhausted MLFQ quantum) stops the decode at the next segment boundary,
  and the evicted request re-enters its queue and later resumes by
  re-prefilling prompt + generated prefix;
* a lane engine (``BatchedRealEngine``, ``PagedBatchedEngine``) under a
  non-preemptive policy: ``_drain_batched`` (under a preemptive one it
  takes ``_drain_real``).

Every drain carries the fault layer (``fault_plan``: crashes at segment
boundaries or in virtual time, lane crashes, and transients at dispatch
in the serial drains; retried under ``RetryPolicy`` with the original
arrival, ``failed`` once retries run out), deadline shedding, sojourn timeouts
(``deadline_mode="sojourn"``) and flight-recorder spans.  Every admitted
request ends in exactly one terminal ``CompletionResponse`` (``ok | shed
| failed | timeout | cancelled``): ``_finish`` raises on a second one.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import features as F
from repro_torch.core.policy import MODE_SRPT, get_policy
from repro_torch.core.predictor import Predictor
from repro_torch.core.router import PredictiveRouter
from repro_torch.core.scheduler import Request
from repro_torch.core.sim_fast import RequestBatch, simulate_batch
from repro_torch.data.tokenizer import HashTokenizer, approx_token_len
from repro_torch.serving.engine import (BatchedRealEngine, RealEngine,
                                        SimEngine)
from repro_torch.serving.faults import (CircuitBreaker, EngineCrash,
                                        FaultError, RetryPolicy,
                                        TransientBackendError, as_injector)
from repro_torch.serving.observability import (Observability,
                                               record_service_spans)
from repro_torch.serving.openai_api import (CompletionRequest,
                                            CompletionResponse)
from repro_torch.serving.service_time import (ServiceTimeModel,
                                              sample_output_tokens)


class ClairvoyantServer:
    """Replica engines (or sidecar backends) behind per-replica
    ``SJFQueue``s.  ``policy``: a registry name or ``Policy``; ``tau``:
    the starvation-guard timeout in seconds (None = off).  Without
    ``engines`` the server fronts ``n_replicas`` virtual-time
    ``SimEngine``s on ``service_model``."""

    def __init__(self, *, policy="sjf", tau: Optional[float] = None,
                 n_replicas: int = 1, predictor=None,
                 service_model: Optional[ServiceTimeModel] = None,
                 engines: Optional[Sequence] = None,
                 seed: int = 0, fault_plan=None,
                 retry: Optional[RetryPolicy] = None,
                 deadline_s: Optional[float] = None,
                 deadline_mode: str = "queue",
                 max_queue_depth: Optional[int] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 observability: Optional[Observability] = None):
        self.policy_obj = get_policy(policy)
        self.policy = self.policy_obj.name
        self.predictor = predictor
        self.rng = np.random.default_rng(seed)
        self.service_model = service_model or ServiceTimeModel(
            prefill_tok_per_s=8000.0, decode_tok_per_s=60.0)
        if engines is not None:
            self.engines = list(engines)
        else:
            self.engines = [SimEngine(self.service_model, i)
                            for i in range(n_replicas)]
        self.router = PredictiveRouter(len(self.engines), policy=policy,
                                       tau=tau, breaker=breaker)
        self._inflight: Dict[int, CompletionRequest] = {}
        self._decoding: Dict[int, int] = {}     # replica_id -> request_id
        self._disconnected: set = set()         # mid-flight client cancels
        self._tokenizer: Optional[HashTokenizer] = None
        self.responses: List[CompletionResponse] = []
        # --- robustness layer (serving/faults.py) ---
        self.faults = as_injector(fault_plan)
        self.retry = retry if retry is not None else RetryPolicy(seed=seed)
        self.deadline_s = deadline_s
        # "queue": the deadline bounds queue wait (undispatched work is
        # shed); "sojourn": it bounds arrival-to-finish, and expiry in
        # service ends the request with status "timeout" (the wire's)
        if deadline_mode not in ("queue", "sojourn"):
            raise ValueError(f"unknown deadline_mode {deadline_mode!r}")
        self.deadline_mode = deadline_mode
        self.max_queue_depth = max_queue_depth
        self.degraded = False                   # predictor-outage FCFS mode
        #: the last exception the predictor raised (degraded admissions)
        self.predictor_error: Optional[str] = None
        self._terminal: Dict[int, str] = {}     # req_id -> terminal status
        self._next_id = 1                       # per-server request-id space
        self.fault_stats = {"predictor_failures": 0,
                            "degraded_admissions": 0, "sheds": 0,
                            "retries": 0, "failures": 0, "crashes": 0,
                            "transients": 0, "requeues": 0, "timeouts": 0}
        if self.faults is not None:
            for eng in self.engines:
                if isinstance(eng, RealEngine):
                    eng.fault_injector = self.faults
        self.obs: Optional[Observability] = None
        self._obs_arrival: Dict[int, float] = {}   # req_id -> arrival time
        if observability is not None:
            self.attach_observability(observability)

    @property
    def queue(self):
        """The first replica's queue (the whole queue of a one-replica
        server)."""
        return self.router.replicas[0].queue

    def attach_observability(self, obs: Observability) -> None:
        """Wire the flight recorder and metrics registry into the stack:
        the router's route instants, the engines' recorder, and the
        scrape-time collectors over stats the server and engines keep."""
        self.obs = obs
        self.router.recorder = obs.recorder
        for eng in self.engines:
            if hasattr(eng, "recorder"):
                eng.recorder = obs.recorder
        obs.register_server(self)
        obs.register_engines(self.engines)

    # ------------------------------------------------------------ admission
    def _predict_probas(self, prompts: List[str], now: float,
                        rid_hint: Optional[int] = None):
        """Predictor call with graceful degradation: an exception, a
        non-finite score or an injected outage returns None (admission
        then uses ``p_long = 0`` for all: FCFS order) and sets
        ``degraded``; a later successful call heals it.

        With observability attached, feature extraction and scoring are
        timed apart (``feature_extract`` / ``predict`` spans at the
        batch's arrival, measured wall durations) and the per-request
        predictor latency feeds its histogram."""
        if self.predictor is None or not self.policy_obj.uses_predictor \
                or not prompts:
            return None
        obs = self.obs
        rec = obs.recorder if obs is not None else None
        probas = None
        if self.faults is None or not self.faults.predictor_down(now):
            try:
                if obs is not None and isinstance(self.predictor, Predictor):
                    rid = rid_hint if rid_hint is not None else self._next_id
                    w0 = time.perf_counter()
                    X = F.extract_batch(prompts)
                    w1 = time.perf_counter()
                    probas = np.asarray(self.predictor.proba_features(X),
                                        float)
                    w2 = time.perf_counter()
                    if rec is not None:
                        trk = f"req{rid}"
                        rec.span("feature_extract", rid, now,
                                 now + (w1 - w0), track=trk,
                                 args={"batch": len(prompts)})
                        rec.span("predict", rid, now + (w1 - w0),
                                 now + (w2 - w0), track=trk,
                                 args={"batch": len(prompts)})
                    obs.observe_predict(len(prompts), w2 - w0)
                else:
                    probas = np.asarray(self.predictor.proba_batch(prompts),
                                        float)
                if not np.all(np.isfinite(probas)):
                    probas = None                # NaN/inf scores: degrade
            except Exception as e:               # predictor raised: degrade
                self.predictor_error = f"{type(e).__name__}: {e}"
                probas = None
        if probas is None:
            self.fault_stats["predictor_failures"] += 1
            self.degraded = True
            return None
        self.degraded = False                    # predictor healed
        return probas

    def allocate_id(self) -> int:
        """Reserve the next request id (the sidecar pre-assigns ids so it
        can register a waiter before admission can emit a shed)."""
        rid = self._next_id
        self._next_id += 1
        return rid

    def submit(self, req: CompletionRequest, *, arrival: float = 0.0,
               true_output_tokens: Optional[int] = None,
               klass: str = "", deadline_s: Optional[float] = None) -> int:
        """Admit one request: one predictor call for its one row.
        ``deadline_s`` overrides the server-wide budget for it.  Returns
        the chosen replica, or -1 if it was shed at admission."""
        probas = self._predict_probas([req.prompt], arrival,
                                      rid_hint=req.request_id)
        return self._admit(req, None if probas is None else probas[0],
                           arrival, true_output_tokens, klass,
                           deadline_s=deadline_s)

    def submit_many(self, reqs: Sequence[CompletionRequest], *,
                    arrivals: Optional[Sequence[float]] = None,
                    true_output_tokens: Optional[Sequence[int]] = None,
                    klasses: Optional[Sequence[str]] = None) -> List[int]:
        """Admit an arrival burst with ONE batched predictor call.
        Returns the chosen replica per request (-1: shed at admission)."""
        n = len(reqs)
        probas = self._predict_probas(
            [r.prompt for r in reqs],
            0.0 if arrivals is None or not n else float(arrivals[0]),
            rid_hint=reqs[0].request_id if n else None)
        return [
            self._admit(
                req, None if probas is None else probas[i],
                0.0 if arrivals is None else float(arrivals[i]),
                None if true_output_tokens is None
                else int(true_output_tokens[i]),
                "" if klasses is None else klasses[i])
            for i, req in enumerate(reqs)]

    def _admit(self, req: CompletionRequest, proba, arrival: float,
               true_output_tokens: Optional[int], klass: str,
               deadline_s: Optional[float] = None) -> int:
        """``true_output_tokens`` is the ground truth a simulator knows
        (only ``sjf_oracle`` reads it); without it a length is drawn for
        the request's class (``short`` when unknown)."""
        if req.request_id is None:
            req.request_id = self.allocate_id()
        else:
            self._next_id = max(self._next_id, int(req.request_id) + 1)
        if req.request_id in self._terminal \
                or req.request_id in self._inflight:
            raise ValueError(f"request id {req.request_id} already "
                             "submitted to this server")
        obs = self.obs
        if obs is not None:
            self._obs_arrival[req.request_id] = arrival
            obs.observe_admission(1, self.policy)
        if true_output_tokens is None:
            true_output_tokens = sample_output_tokens(
                self.rng, klass or "short")
        prompt_toks = approx_token_len(req.prompt)
        p_long = float(proba[2]) if proba is not None else 0.0
        degraded = proba is None and self.degraded \
            and self.policy_obj.uses_predictor
        r = Request(req_id=req.request_id, prompt=req.prompt, arrival=arrival,
                    p_long=p_long, klass=klass,
                    true_service=self.service_model.service(
                        prompt_toks, true_output_tokens),
                    tenant=req.tenant,
                    meta={"prompt_tokens": prompt_toks,
                          "output_tokens": true_output_tokens})
        if deadline_s is not None:
            r.meta["deadline_s"] = float(deadline_s)
        if degraded:
            r.meta["degraded"] = True
            self.fault_stats["degraded_admissions"] += 1
        depth = sum(len(rep.queue) for rep in self.router.replicas)
        if (self.max_queue_depth is not None
                and depth >= self.max_queue_depth) \
                or (self.faults is not None
                    and self.faults.overflow_active(arrival)):
            self.fault_stats["sheds"] += 1
            self._finish(CompletionResponse(
                request_id=req.request_id, text="", tokens_generated=0,
                queue_wait_s=0.0, service_s=0.0, replica=-1,
                p_long=p_long, klass=klass, status="shed",
                error="admission queue overflow", degraded=degraded))
            return -1
        self._inflight[req.request_id] = req
        return self.router.route(r, proba=proba, now=arrival)

    # -------------------------------------------------------- terminal path
    def _finish(self, resp: CompletionResponse) -> None:
        """The single exit gate: every admitted request passes here
        exactly once (a duplicate terminal response raises)."""
        prev = self._terminal.get(resp.request_id)
        if prev is not None:
            raise RuntimeError(
                f"request {resp.request_id} already terminated "
                f"({prev!r}); duplicate terminal status {resp.status!r}")
        self._terminal[resp.request_id] = resp.status
        self._inflight.pop(resp.request_id, None)
        self.responses.append(resp)
        obs = self.obs
        if obs is not None:
            obs.observe_terminal(
                resp, self._obs_arrival.pop(resp.request_id, None))

    def _deadline_of(self, req) -> Optional[float]:
        """The request's deadline budget: its own (``submit(...,
        deadline_s=)``) or the server-wide one."""
        return req.meta.get("deadline_s", self.deadline_s)

    def _maybe_shed(self, rep, req, now: float) -> bool:
        """Deadline shedding at dispatch: a request not yet started and
        already past its budget terminates ``shed``."""
        dl = self._deadline_of(req)
        if dl is None or req.start is not None \
                or (now - req.arrival) <= dl:
            return False
        self.router.release(rep.replica_id, req)
        self.fault_stats["sheds"] += 1
        req.finish = now
        obs = self.obs
        if obs is not None and obs.recorder is not None:
            obs.recorder.span("queue_wait", req.req_id, req.arrival, now,
                              track=f"req{req.req_id}")
        self._finish(CompletionResponse(
            request_id=req.req_id, text="", tokens_generated=0,
            queue_wait_s=max(0.0, now - req.arrival), service_s=0.0,
            replica=rep.replica_id, p_long=req.p_long, klass=req.klass,
            status="shed", error="deadline budget exceeded before dispatch",
            retries=req.meta.get("fault_retries", 0),
            degraded=bool(req.meta.get("degraded"))))
        return True

    def _retry_or_fail(self, rep, req, now: float, exc: Exception,
                       charge_backoff: bool = True) -> float:
        """Fault epilogue: the popped request re-enters its queue (bounded
        retries, original arrival kept) or terminates ``failed``.  Returns
        the (possibly backoff-advanced) clock."""
        n = req.meta.get("fault_retries", 0) + 1
        req.meta["fault_retries"] = n
        self.router.record_failure(rep.replica_id, now)
        if isinstance(exc, EngineCrash):
            self.fault_stats["crashes"] += 1
        elif isinstance(exc, TransientBackendError):
            self.fault_stats["transients"] += 1
        if n > self.retry.max_retries:
            self.fault_stats["failures"] += 1
            self.router.release(rep.replica_id, req)
            start = req.start if req.start is not None else now
            req.finish = now
            self._finish(CompletionResponse(
                request_id=req.req_id, text="", tokens_generated=0,
                queue_wait_s=max(0.0, start - req.arrival),
                service_s=max(0.0, now - start),
                replica=rep.replica_id, p_long=req.p_long, klass=req.klass,
                status="failed", error=f"{type(exc).__name__}: {exc}",
                retries=n, degraded=bool(req.meta.get("degraded"))))
            return now
        self.fault_stats["retries"] += 1
        self.fault_stats["requeues"] += 1
        if charge_backoff:
            now += self.retry.backoff(n - 1)
        rep.queue.push_requeue(
            req, req.meta.get("queue_key",
                              req.meta.get("policy_key0", 0.0)),
            reason="fault")
        return now

    def cancel(self, request_id: int) -> bool:
        """Client disconnect.  A queued request terminates ``cancelled``
        at once; one in a lane of a lane engine is evicted at the next
        segment boundary; one decoding on a serial engine or backend is
        flagged so the fused loop stops at the next segment boundary.
        False when the request is neither queued nor in flight."""
        for rep in self.router.replicas:
            req = rep.queue._live.get(request_id)
            if rep.queue.cancel(request_id):
                self.router.release(rep.replica_id, req)
                self._finish(CompletionResponse(
                    request_id=request_id, text="", tokens_generated=0,
                    queue_wait_s=0.0, service_s=0.0,
                    replica=rep.replica_id, p_long=req.p_long,
                    klass=req.klass, status="cancelled",
                    error="client disconnect (queued)",
                    degraded=bool(req.meta.get("degraded"))))
                return True
        for eng in self.engines:
            if isinstance(eng, BatchedRealEngine) \
                    and eng.lane_manager is not None \
                    and eng.lane_manager.lane_of(request_id) is not None:
                self._disconnected.add(request_id)
                return True
        for replica_id, rid in self._decoding.items():
            if rid == request_id:
                eng = self.engines[replica_id]
                if hasattr(eng, "request_cancel"):
                    # a disconnect, told apart from other stops by the
                    # drain loop through _disconnected
                    self._disconnected.add(request_id)
                    eng.request_cancel()
                    return True
        return False

    # ---------------------------------------------------------------- drain
    def drain(self, max_new_tokens: int = 64) -> List[CompletionResponse]:
        """Serve every replica's queue to empty: a lane engine under a
        non-preemptive policy through its lanes, any other real engine one
        request at a time, a ``SimEngine`` in virtual time."""
        for rep, eng in zip(self.router.replicas, self.engines):
            if isinstance(eng, BatchedRealEngine) \
                    and not self.policy_obj.preemptive:
                self._drain_batched(rep, eng, max_new_tokens)
            elif isinstance(eng, RealEngine):
                self._drain_real(rep, eng, max_new_tokens)
            elif isinstance(eng, SimEngine):
                self._drain_sim(rep, eng)
            else:
                raise TypeError(f"cannot drain {type(eng).__name__} in "
                                "process (a sidecar backend is served by "
                                "Sidecar)")
        return self.responses

    def _drain_sim(self, rep, eng: SimEngine) -> None:
        """Virtual-clock serial drain, exception-safe: every popped
        request terminates through ``_finish`` (ok / shed / failed /
        timeout) or re-enters the queue -- injected faults (transient
        errors, stalls, crash + repair) and organic engine exceptions both
        route through ``_retry_or_fail``.  The loop always re-pops, so a
        requeued request is served later in this same drain."""
        if self.policy_obj.preemptive:
            self._drain_sim_preemptive(rep, eng)
            return
        inj = self.faults
        rid = rep.replica_id
        obs = self.obs
        rec = obs.recorder if obs is not None else None
        trk = f"replica{rid}"
        t = eng.busy_until
        while True:
            req = rep.queue.pop(now=t)
            if req is None:
                break
            t = max(t, req.arrival)
            if self._maybe_shed(rep, req, t):
                continue
            # injected transient backend error: fails this attempt before
            # any service is rendered
            if inj is not None:
                spec = inj.transient_due(rid, t)
                if spec is not None:
                    t = self._retry_or_fail(rep, req, t,
                                            TransientBackendError(
                                                "injected transient "
                                                "backend error"))
                    continue
            if req.start is None:
                req.start = t                  # first dispatch
            try:
                ttft, service = self._sim_execute(eng, rid, t, req)
            except FaultError as e:
                # engine crash mid-service: the clock is already advanced
                # to the end of the repair window by _sim_execute
                t = self._retry_or_fail(rep, req, eng.busy_until, e,
                                        charge_backoff=False)
                continue
            except Exception as e:             # organic engine bug
                t = self._retry_or_fail(rep, req, t, e)
                continue
            if self.deadline_mode == "sojourn":
                dl = self._deadline_of(req)
                if dl is not None and t + service > req.arrival + dl:
                    # in-service expiry: the attempt is abandoned AT the
                    # deadline instant with a terminal ``timeout`` (the
                    # pre-dispatch case stays ``shed`` via _maybe_shed)
                    expiry = max(t, req.arrival + dl)
                    eng.busy_until = expiry
                    self.router.release(rid, req)
                    self.fault_stats["timeouts"] += 1
                    req.finish = expiry
                    if rec is not None:
                        record_service_spans(
                            rec, req.req_id, arrival=req.arrival,
                            start=t, finish=expiry,
                            ttft=min(ttft, expiry - t),
                            out_tokens=req.meta["output_tokens"],
                            track=trk)
                    self._finish(CompletionResponse(
                        request_id=req.req_id, text="", tokens_generated=0,
                        queue_wait_s=req.start - req.arrival,
                        service_s=max(0.0, expiry - req.start),
                        ttft_s=(req.start - req.arrival + ttft)
                        if t + ttft <= expiry else None,
                        promoted=req.promoted, replica=rid,
                        p_long=req.p_long, klass=req.klass,
                        status="timeout",
                        error="deadline expired in service",
                        retries=req.meta.get("fault_retries", 0),
                        degraded=bool(req.meta.get("degraded"))))
                    t = expiry
                    continue
            t += service
            req.finish = t
            self.router.on_dispatch(rid, req, t, service_estimate=service)
            self.router.record_success(rid, t)
            retries = req.meta.get("fault_retries", 0)
            if rec is not None:
                record_service_spans(
                    rec, req.req_id, arrival=req.arrival,
                    start=t - service, finish=t, ttft=ttft,
                    out_tokens=req.meta["output_tokens"], track=trk)
            self._finish(CompletionResponse(
                request_id=req.req_id, text="",
                tokens_generated=req.meta["output_tokens"],
                queue_wait_s=req.start - req.arrival,
                # a fault-requeued request reports time-in-service across
                # the gaps so sojourn_s == finish - arrival stays exact
                service_s=service if retries == 0 else t - req.start,
                ttft_s=req.start - req.arrival + ttft,
                promoted=req.promoted, replica=rid,
                p_long=req.p_long, klass=req.klass, retries=retries,
                degraded=bool(req.meta.get("degraded"))))

    def _sim_execute(self, eng: SimEngine, rid: int, t: float, req) -> tuple:
        """One virtual-time service attempt with fault injection.  Returns
        ``(ttft, service)`` and advances the engine clock on success; on
        an injected crash raises :class:`EngineCrash` with the engine
        parked at the end of its repair window and the request's partial
        progress recorded (work-conserving requeue: the next attempt only
        serves the remaining work)."""
        ptoks = req.meta["prompt_tokens"]
        otoks = req.meta["output_tokens"]
        full = eng.model.service(ptoks, otoks)
        used = req.meta.get("sim_used_s", 0.0)
        rem = max(full - used, 0.0)
        inj = self.faults
        if inj is not None:
            rem *= inj.stall_factor(rid, t)    # straggler window
            crash = inj.crash_between(rid, t, t + rem)
            if crash is not None:
                crash_t = max(t, crash.at)
                req.meta["sim_used_s"] = used + (crash_t - t)
                eng.busy_until = crash_t + crash.repair_s
                raise EngineCrash("injected engine crash mid-service",
                                  at=crash_t, repair_s=crash.repair_s)
        ttft = eng.model.overhead_s + ptoks / eng.model.prefill_tok_per_s
        eng.busy_until = t + rem
        eng.served += 1
        return ttft, rem

    def _drain_sim_preemptive(self, rep, eng: SimEngine) -> None:
        """Virtual-time drain under a preemptive policy: the replica's
        whole backlog runs through the preemptive DES engine (arrival
        events slice service; evicted work is re-enqueued with the
        policy's requeue key), then responses are emitted in finish
        order.  ``queue_wait_s`` is time to FIRST dispatch."""
        reqs = rep.queue.waiting()
        for r in reqs:                       # drain the queue bookkeeping
            rep.queue.remove(r.req_id)
            rep.queue.stats["dispatched"] += 1
        if not reqs:
            return
        batch = RequestBatch.from_requests(reqs)
        # the engine may still be busy from a previous drain: nothing can
        # start before busy_until, so clamp the simulated arrivals (waits
        # are still reported against the TRUE arrival, like _drain_sim)
        batch.arrival = np.maximum(batch.arrival, eng.busy_until)
        res = simulate_batch(batch, policy=self.policy_obj,
                             tau=rep.queue.tau)
        rep.queue.stats["promotions"] += res.promotions
        rep.queue.stats["preemptions"] += res.preemptions
        obs = self.obs
        rec = obs.recorder if obs is not None else None
        order = np.argsort(res.finish, kind="stable")
        for i in order:
            req = reqs[i]
            req.start = float(res.start[i])
            req.finish = float(res.finish[i])
            req.promoted = bool(res.promoted[i])
            service = req.true_service
            ttft = (eng.model.overhead_s + req.meta["prompt_tokens"]
                    / eng.model.prefill_tok_per_s)
            if rec is not None:
                # preempted services interleave, so [start, finish]
                # windows of different requests can partially overlap:
                # each request gets its own sub-track of the replica
                record_service_spans(
                    rec, req.req_id, arrival=req.arrival, start=req.start,
                    finish=req.finish, ttft=ttft,
                    out_tokens=req.meta["output_tokens"],
                    track=f"replica{rep.replica_id}/req{req.req_id}")
            eng.busy_until = max(eng.busy_until, req.finish)
            eng.served += 1
            self.router.on_dispatch(rep.replica_id, req, req.finish,
                                    service_estimate=service)
            self._finish(CompletionResponse(
                request_id=req.req_id, text="",
                tokens_generated=req.meta["output_tokens"],
                queue_wait_s=req.start - req.arrival,
                # time in service INCLUDING eviction gaps, so sojourn_s
                # (wait + service) equals finish - arrival exactly
                service_s=req.finish - req.start,
                ttft_s=req.start - req.arrival + ttft,
                promoted=req.promoted, replica=rep.replica_id,
                p_long=req.p_long, klass=req.klass,
                degraded=bool(req.meta.get("degraded"))))

    def _prepare_ids(self, req: Request, eng, max_new_tokens: int):
        """Token budget and input ids for one dispatch, shared by the
        serial and lane drains (their truncation must match: the lanes'
        token contract compares against serial runs).  Returns (ids,
        n_total, resume): the prompt is clamped so that prompt + budget
        fits ``eng.max_len``, and a preempted request's generated prefix
        is re-prefilled after the prompt."""
        if self._tokenizer is None:
            self._tokenizer = HashTokenizer(eng.cfg.vocab_size)
        n_total = max(1, min(max_new_tokens, req.meta["output_tokens"]))
        resume = req.meta.get("resume_tokens", [])
        prompt_ids = self._tokenizer.encode(req.prompt)[:max(
            1, eng.max_len - n_total)]
        ids = np.concatenate([np.asarray(prompt_ids, np.int64),
                              np.asarray(resume, np.int64)]) \
            if resume else prompt_ids
        return ids, n_total, resume

    def _drain_real(self, rep, eng: RealEngine, max_new_tokens: int) -> None:
        """Serial loop (pop -> tokenize -> fused decode) on a clock that
        starts at the engine's ``busy_until`` and advances by each
        attempt's measured wall-clock time.

        Under a preemptive policy, a queued request that has arrived and
        whose key strictly beats the running one (or, for MLFQ, a running
        request that exhausts its quantum) stops the fused loop at the
        next segment boundary; the evicted request re-enters the queue
        with its policy requeue key and the tokens generated so far, and
        later resumes by re-prefilling prompt + generated prefix (greedy
        decode makes the resumed sequence equal to an uninterrupted one).
        The running key decays by wall seconds of service against
        model-calibrated keys: an approximation unless the policy's
        moments are calibrated to this engine.

        Exception-safe: an injected or organic engine fault charges the
        wall time burned (plus a crash's repair time) and goes through
        ``_retry_or_fail``; the loop always re-pops, so a requeued request
        is served later in the same drain."""
        pol = self.policy_obj
        obs = self.obs
        rec = obs.recorder if obs is not None else None
        trk = f"replica{rep.replica_id}"
        t = eng.busy_until
        while True:
            if pol.preemptive:
                req, t = self._pop_arrival_aware(rep, t)
            else:
                req = rep.queue.pop(now=t)
            if req is None:
                break
            t = max(t, req.arrival)
            if self._maybe_shed(rep, req, t):
                continue
            ids, n_total, resume = self._prepare_ids(req, eng,
                                                     max_new_tokens)
            n_new = max(1, n_total - len(resume))
            used = req.meta.get("used_s", 0.0)
            key0 = req.meta.get("policy_key0", 0.0)
            level = req.meta.get("mlfq_level", 0)
            evict_reason: List[str] = []
            cancel_cb = None
            if pol.preemptive:
                wall0 = time.monotonic()
                # SRPT decays from the admission key by the total service
                # received; level policies carry their current queue key
                base_key = key0 if pol.mode == MODE_SRPT \
                    else req.meta.get("queue_key", key0)

                def cancel_cb(_req=req, _t=t, _w0=wall0, _used=used,
                              _level=level, _base=base_key,
                              _why=evict_reason):
                    elapsed = time.monotonic() - _w0
                    best = self._best_eligible(rep, _t + elapsed)
                    if best is None:
                        return False
                    quantum = pol.quantum(_req.p_long)
                    if (quantum is not None and _level == 0
                            and _used + elapsed > quantum):
                        _why.append("quantum")
                        return True
                    run_key = pol.running_key(_base, _used + elapsed)
                    if pol.should_preempt(run_key, best[0]):
                        _why.append("preempt")
                        return True
                    return False

            deadline_hit: List[bool] = []
            dl = self._deadline_of(req) \
                if self.deadline_mode == "sojourn" else None
            if dl is not None:
                wall_dl0, waited = time.monotonic(), max(0.0, t - req.arrival)

                def cancel_cb(_inner=cancel_cb, _w0=wall_dl0, _dl=dl,
                              _waited=waited):
                    # sojourn budget: the queue wait already spent plus
                    # this attempt's wall time; expiry stops the fused
                    # loop at the next segment boundary -> ``timeout``
                    if _waited + (time.monotonic() - _w0) > _dl:
                        deadline_hit.append(True)
                        return True
                    return _inner() if _inner is not None else False

            if req.start is None:
                req.start = t                 # first dispatch
            if self.faults is not None:
                spec = self.faults.transient_due(rep.replica_id, t)
                if spec is not None:
                    t = self._retry_or_fail(rep, req, t,
                                            TransientBackendError(
                                                "injected transient "
                                                "backend error"))
                    continue
            self._decoding[rep.replica_id] = req.req_id
            wall_gen0 = time.monotonic()
            seg_marks: List[float] = []
            on_seg = None
            if rec is not None:
                def on_seg(new_toks, _m=seg_marks):
                    _m.append(time.monotonic())
            try:
                out = eng.generate(ids, max_new_tokens=n_new,
                                   cancel_cb=cancel_cb, on_segment=on_seg)
            except Exception as e:
                # the popped request must not be lost: charge the wall
                # time burned, then requeue or fail; its decoded tokens
                # died with the engine (no resume credit)
                t += time.monotonic() - wall_gen0
                if isinstance(e, EngineCrash):
                    t += e.repair_s           # replica down for repair
                eng.busy_until = t
                t = self._retry_or_fail(rep, req, t, e)
                continue
            finally:
                self._decoding.pop(rep.replica_id, None)
            service = out["service_s"]
            tokens = list(resume) + list(out["tokens"])
            req.meta.setdefault("ttft_s", out["ttft_s"])
            t += service
            eng.busy_until = t
            cancelled = out["cancelled"]
            if cancelled and evict_reason and not deadline_hit \
                    and req.req_id not in self._disconnected \
                    and len(tokens) < n_total:
                # preemption / demotion: re-enqueue the remaining work
                self._requeue_evicted(rep, req, tokens, used + service,
                                      key0, level, evict_reason)
                continue
            req.finish = t
            if rec is not None:
                t0 = t - service
                record_service_spans(rec, req.req_id, arrival=req.arrival,
                                     start=t0, finish=t,
                                     ttft=out["ttft_s"], max_segments=0,
                                     track=trk)
                edges = [min(t0 + out["ttft_s"], t)]
                for m in seg_marks:           # measured segment boundaries
                    edges.append(min(max(t0 + (m - wall_gen0), edges[-1]),
                                     t))
                edges.append(t)
                for i in range(len(edges) - 1):
                    rec.span("decode_segment", req.req_id, edges[i],
                             edges[i + 1], track=trk)
            common = dict(
                request_id=req.req_id, text="", tokens_generated=len(tokens),
                queue_wait_s=req.start - req.arrival,
                service_s=used + service,
                ttft_s=req.start - req.arrival + req.meta["ttft_s"],
                promoted=req.promoted, replica=rep.replica_id,
                p_long=req.p_long, klass=req.klass,
                retries=req.meta.get("fault_retries", 0),
                degraded=bool(req.meta.get("degraded")), token_ids=tokens)
            if cancelled and req.req_id in self._disconnected:
                self._disconnected.discard(req.req_id)
                self._finish(CompletionResponse(
                    status="cancelled",
                    error="client disconnect (mid-generation)", **common))
                continue
            if cancelled and deadline_hit:
                self.fault_stats["timeouts"] += 1
                self.router.release(rep.replica_id, req)
                self._finish(CompletionResponse(
                    status="timeout", error="deadline expired in service",
                    **common))
                continue
            if cancelled and not evict_reason:    # engine-level cancel
                self.router.release(rep.replica_id, req)
                self._finish(CompletionResponse(
                    status="cancelled", error="cancelled mid-generation",
                    **common))
                continue
            # done (an eviction that came once every token was out is a
            # finish, not a preemption)
            self.router.on_dispatch(rep.replica_id, req, t,
                                    service_estimate=used + service)
            self.router.record_success(rep.replica_id, t)
            self._finish(CompletionResponse(**common))

    def _drain_batched(self, rep, eng: BatchedRealEngine,
                       max_new_tokens: int) -> None:
        """Micro-batched wall-clock drain: up to ``eng.n_lanes`` requests
        decode concurrently under the engine's KV budget.

        The engine's lane back-fill pulls through ``SJFQueue.pop_many``,
        so the starvation guard is re-evaluated between every pop, and a
        request past its deadline budget is shed instead of admitted.
        Admission is memory-aware: a head whose footprint does not fit
        blocks back-fill until lanes retire.  Injected transients are
        left to the serial drains, as in the JAX lane drain.  At each
        segment boundary a client disconnect or an expired sojourn
        deadline evicts its lane (``cancelled`` / ``timeout``), and a
        crashed lane's request keeps its decoded prefix and is retried
        (re-prefilled) or fails.  A
        whole-engine crash raised out of ``run_lanes`` sends every busy
        lane and every popped-but-unadmitted item through
        ``_retry_or_fail``, and the lanes run again until the queue
        drains.  The clock starts at the engine's ``busy_until`` and runs
        on the wall clock; with a recorder, each request gets a
        ``queue_wait`` span and the engine adds its lane spans."""
        obs = self.obs
        rec = obs.recorder if obs is not None else None
        eng.recorder = rec                     # lane spans (engine.py)
        t_base = eng.busy_until
        wall0 = time.monotonic()

        def now() -> float:
            return t_base + (time.monotonic() - wall0)

        def source(k: int):
            items = []
            while len(items) < k:
                got = rep.queue.pop_many(k - len(items), now=now())
                if not got:
                    break
                for req in got:
                    if self._maybe_shed(rep, req, now()):
                        continue              # shed: pull a replacement
                    if rec is not None:
                        rec.span("queue_wait", req.req_id, req.arrival,
                                 now(), track=f"req{req.req_id}")
                    ids, n_total, resume = self._prepare_ids(
                        req, eng, max_new_tokens)
                    items.append({"req_id": req.req_id, "ids": ids,
                                  "max_new": max(1, n_total - len(resume)),
                                  "tenant": req.tenant,
                                  "meta": {"req": req,
                                           "resume": list(resume)}})
            return items

        def cancel_check(state) -> bool:
            if state.req_id in self._disconnected:
                return True
            if self.deadline_mode == "sojourn":
                req = state.meta["req"]
                dl = self._deadline_of(req)
                if dl is not None and (now() - req.arrival) > dl:
                    state.meta["deadline_hit"] = True
                    return True
            return False

        def on_finish(state, out):
            req = state.meta["req"]
            tokens = state.meta["resume"] + out["tokens"]
            if req.start is None:
                req.start = max(out["admit_t"], req.arrival)
            if out["crashed"]:
                # the lane died at a segment boundary: keep the decoded
                # prefix for the resume re-prefill, then retry or fail
                req.meta["resume_tokens"] = tokens
                self._retry_or_fail(rep, req, out["finish_t"], EngineCrash(
                    "injected lane crash"), charge_backoff=False)
                return
            req.finish = max(out["finish_t"], req.start)
            common = dict(
                request_id=req.req_id, text="",
                tokens_generated=len(tokens),
                queue_wait_s=req.start - req.arrival,
                service_s=req.finish - req.start,
                promoted=req.promoted, replica=rep.replica_id,
                p_long=req.p_long, klass=req.klass,
                retries=req.meta.get("fault_retries", 0),
                degraded=bool(req.meta.get("degraded")), token_ids=tokens)
            if out["cancelled"]:
                # a disconnect wins over a deadline that fired in the same
                # segment (the client is gone either way)
                timed_out = state.meta.get("deadline_hit") \
                    and req.req_id not in self._disconnected
                if timed_out:
                    self.fault_stats["timeouts"] += 1
                    self.router.release(rep.replica_id, req)
                else:
                    self._disconnected.discard(req.req_id)
                self._finish(CompletionResponse(
                    ttft_s=req.start - req.arrival + out["ttft_s"],
                    status="timeout" if timed_out else "cancelled",
                    error="deadline expired in service" if timed_out
                    else "client disconnect (mid-generation)", **common))
                return
            req.meta.setdefault("ttft_s", out["ttft_s"])
            self.router.on_dispatch(rep.replica_id, req, req.finish,
                                    service_estimate=out["service_s"])
            self.router.record_success(rep.replica_id, req.finish)
            self._finish(CompletionResponse(
                ttft_s=req.start - req.arrival + req.meta["ttft_s"],
                **common))

        # a whole-engine crash raised from a segment boundary evicts every
        # busy lane back into the queue (bounded per-request retries), and
        # the lanes run again until the queue drains.  The pass cap is a
        # safety net: fault plans are finite, so it is hit only by an
        # engine that raises without end, and then what is left
        # terminates ``failed`` instead of looping forever.
        for _pass in range(64):
            try:
                eng.run_lanes(source, on_finish, cancel_check=cancel_check,
                              now_fn=now)
            except Exception as e:
                t_err = now()
                mgr = eng.lane_manager
                if mgr is not None:
                    for lane in list(mgr.busy_lanes()):
                        st = mgr.evict(lane)
                        victim = st.meta["req"]
                        victim.meta["resume_tokens"] = \
                            st.meta["resume"] + list(st.tokens)
                        if victim.start is None:
                            victim.start = max(st.admit_t, victim.arrival)
                        self._retry_or_fail(rep, victim, t_err, e,
                                            charge_backoff=False)
                # items popped from the queue but not yet in a lane would
                # otherwise vanish with the engine's stack
                for item in eng.take_pending():
                    self._retry_or_fail(rep, item["meta"]["req"], t_err, e,
                                        charge_backoff=False)
            if not rep.queue.live():
                break
        else:
            for req in list(rep.queue.live()):
                rep.queue.remove(req.req_id)
                req.finish = now()
                self._finish(CompletionResponse(
                    request_id=req.req_id, text="", tokens_generated=0,
                    queue_wait_s=max(0.0, now() - req.arrival),
                    service_s=0.0, replica=rep.replica_id,
                    p_long=req.p_long, klass=req.klass, status="failed",
                    error="engine unable to drain (retry passes exhausted)",
                    retries=req.meta.get("fault_retries", 0)))
        eng.busy_until = now()

    # ------------------------------------------------- preemptive dispatch
    def _pop_arrival_aware(self, rep, t: float):
        """Dispatch decision for preemptive real drains: only requests
        that have arrived by ``t`` compete (otherwise the best key would
        always dispatch first and nothing could ever preempt).  Jumps the
        clock to the next arrival when none has arrived.  Applies the
        starvation guard, then the policy key.  One unsorted O(n) scan
        per dispatch."""
        live = rep.queue.live()
        if not live:
            return None, t
        if all(r.arrival > t for r in live):
            t = min(r.arrival for r in live)
        oldest = best = None
        for r in live:
            if r.arrival > t:
                continue
            if oldest is None or (r.arrival, r.req_id) \
                    < (oldest.arrival, oldest.req_id):
                oldest = r
            if best is None or (r.meta["queue_key"], r.req_id) \
                    < (best.meta["queue_key"], best.req_id):
                best = r
        tau = rep.queue.tau
        if tau is not None and (t - oldest.arrival) > tau:
            req = oldest
            req.promoted = True
            rep.queue.stats["promotions"] += 1
        else:
            req = best
        rep.queue.remove(req.req_id)
        rep.queue.stats["dispatched"] += 1
        rep.queue.policy_obj.note_dispatch(req.meta.get("queue_key", 0.0))
        return req, t

    def _best_eligible(self, rep, now: float):
        """Best (key, Request) among queued requests arrived by ``now``.
        The heap head is the global best: if it has arrived it is the
        answer in O(1); otherwise one unsorted scan (polled every
        segment, so no sorting here)."""
        top = rep.queue.peek()
        if top is not None and top[1].arrival <= now:
            return top
        best = None
        for r in rep.queue.live():
            if r.arrival <= now:
                k = r.meta["queue_key"]
                if best is None or k < best[0]:
                    best = (k, r)
        return best

    def _requeue_evicted(self, rep, req, tokens, used_s, key0, level,
                         evict_reason) -> None:
        """Re-enqueue a preempted or demoted request with its resume
        state, through the policy's requeue hooks."""
        pol = self.policy_obj
        req.meta["resume_tokens"] = tokens
        req.meta["used_s"] = used_s
        cur_key = req.meta.get("queue_key", key0)
        if evict_reason and evict_reason[0] == "quantum":
            req.meta["mlfq_level"] = level + 1
            new_key = pol.requeue_key(cur_key, used_s)     # demotion
        else:
            base = key0 if pol.mode == MODE_SRPT else cur_key
            new_key = pol.running_key(base, used_s)        # plain eviction
        rep.queue.push_requeue(req, new_key)

    # --------------------------------------------------------------- stats
    def percentile(self, q: float, klass: Optional[str] = None,
                   attr: str = "sojourn_s",
                   statuses: Optional[Sequence[str]] = ("ok",)) -> float:
        """Latency percentile over terminal responses (``ok`` only by
        default; ``statuses=None`` pools everything)."""
        vals = [getattr(r, attr) for r in self.responses
                if (klass is None or self._klass_of(r) == klass)
                and (statuses is None or r.status in statuses)]
        return float(np.percentile(vals, q)) if vals else float("nan")

    @property
    def ok_responses(self) -> List[CompletionResponse]:
        return [r for r in self.responses if r.status == "ok"]

    @staticmethod
    def _klass_of(resp: CompletionResponse) -> str:
        if resp.klass:
            return resp.klass
        toks = resp.tokens_generated
        return "short" if toks < 200 else ("medium" if toks < 800 else "long")

    @property
    def promotions(self) -> int:
        return sum(rep.queue.stats["promotions"]
                   for rep in self.router.replicas)
