"""The Clairvoyant front end (port of ``repro.serving.server.
ClairvoyantServer`` for one replica): features -> predictor -> SJF queue ->
a serial ``RealEngine`` or a lane engine (``BatchedRealEngine``,
``PagedBatchedEngine``).

Admission is batched: ``submit_many`` scores a whole arrival burst with one
predictor call (feature extraction on the host, K4 on the card).  ``drain``
then serves the queue non-preemptively.  A serial engine takes one request
at a time: pop (starvation guard first, then the policy key), tokenize,
bucketed prefill, fused decode.  A lane engine pulls through
``SJFQueue.pop_many`` whenever lanes are vacant, so the queue stays the one
source of dispatch order.  ``cancel`` removes a queued request at once and
evicts a request in a lane at its next segment boundary.  Every admitted
request ends in exactly one ``CompletionResponse``.  The JAX server's
router, fault layer, deadlines, shedding and flight recorder are not
ported.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.policy import get_policy
from repro_torch.core.scheduler import Request, SJFQueue
from repro_torch.data.tokenizer import HashTokenizer, approx_token_len
from repro_torch.serving.engine import BatchedRealEngine
from repro_torch.serving.openai_api import (CompletionRequest,
                                            CompletionResponse)
from repro_torch.serving.service_time import ServiceTimeModel


class ClairvoyantServer:
    """One engine replica (serial or lanes) behind one ``SJFQueue``.

    ``policy``: "fcfs", "sjf" or "sjf_oracle" (or a ``Policy``); ``tau``:
    the starvation-guard timeout in seconds (None = off).
    """

    def __init__(self, *, engines: Sequence, policy="sjf",
                 tau: Optional[float] = None, predictor=None,
                 service_model: Optional[ServiceTimeModel] = None):
        if len(engines) != 1:
            raise ValueError("the port serves exactly one replica")
        self.engines = list(engines)
        self.policy_obj = get_policy(policy)
        self.policy = self.policy_obj.name
        self.queue = SJFQueue(self.policy_obj, tau)
        self.predictor = predictor
        self.service_model = service_model or ServiceTimeModel(
            prefill_tok_per_s=8000.0, decode_tok_per_s=60.0)
        self._tokenizer = HashTokenizer(self.engines[0].cfg.vocab_size)
        self._inflight: Dict[int, CompletionRequest] = {}
        self._terminal: Dict[int, str] = {}
        self._disconnected: set = set()     # in-flight lane cancels, by id
        self._next_id = 1
        self.responses: List[CompletionResponse] = []

    # ------------------------------------------------------------ admission
    def _predict_probas(self, prompts: List[str]):
        if self.predictor is None or not self.policy_obj.uses_predictor \
                or not prompts:
            return None
        return np.asarray(self.predictor.proba_batch(prompts), float)

    def submit(self, req: CompletionRequest, *, arrival: float = 0.0,
               true_output_tokens: Optional[int] = None,
               klass: str = "") -> int:
        """Admit one request; returns its replica (always 0)."""
        probas = self._predict_probas([req.prompt])
        return self._admit(req, None if probas is None else probas[0],
                           arrival, true_output_tokens, klass)

    def submit_many(self, reqs: Sequence[CompletionRequest], *,
                    arrivals: Optional[Sequence[float]] = None,
                    true_output_tokens: Optional[Sequence[int]] = None,
                    klasses: Optional[Sequence[str]] = None) -> List[int]:
        """Admit an arrival burst with ONE batched predictor call."""
        probas = self._predict_probas([r.prompt for r in reqs])
        return [
            self._admit(
                req, None if probas is None else probas[i],
                0.0 if arrivals is None else float(arrivals[i]),
                None if true_output_tokens is None
                else int(true_output_tokens[i]),
                "" if klasses is None else klasses[i])
            for i, req in enumerate(reqs)]

    def _admit(self, req: CompletionRequest, proba, arrival: float,
               true_output_tokens: Optional[int], klass: str) -> int:
        """``true_output_tokens`` is the ground truth a simulator knows
        (only ``sjf_oracle`` reads it); without it the request's own
        ``max_tokens`` budget stands in."""
        if req.request_id is None:
            req.request_id = self._next_id
            self._next_id += 1
        else:
            self._next_id = max(self._next_id, int(req.request_id) + 1)
        if req.request_id in self._terminal \
                or req.request_id in self._inflight:
            raise ValueError(f"request id {req.request_id} already "
                             "submitted to this server")
        if true_output_tokens is None:
            true_output_tokens = req.max_tokens
        prompt_toks = approx_token_len(req.prompt)
        r = Request(req_id=req.request_id, prompt=req.prompt, arrival=arrival,
                    p_long=float(proba[2]) if proba is not None else 0.0,
                    klass=klass, tenant=req.tenant,
                    true_service=self.service_model.service(
                        prompt_toks, true_output_tokens),
                    meta={"prompt_tokens": prompt_toks,
                          "output_tokens": true_output_tokens})
        self._inflight[req.request_id] = req
        self.queue.push(r)
        return 0

    # --------------------------------------------------------------- drain
    def _finish(self, resp: CompletionResponse) -> None:
        """The single exit gate: every request passes here exactly once."""
        prev = self._terminal.get(resp.request_id)
        if prev is not None:
            raise RuntimeError(f"request {resp.request_id} already "
                               f"terminated ({prev!r})")
        self._terminal[resp.request_id] = resp.status
        self._inflight.pop(resp.request_id, None)
        self.responses.append(resp)

    def _prepare_ids(self, req: Request, max_len: int, max_new_tokens: int):
        """Token budget and prompt ids: the prompt is clamped so that
        prompt + budget fits the engine's ``max_len``."""
        n_total = max(1, min(max_new_tokens, req.meta["output_tokens"]))
        ids = self._tokenizer.encode(req.prompt)[:max(1, max_len - n_total)]
        return ids, n_total

    def cancel(self, request_id: int) -> bool:
        """Client disconnect.  A queued request is removed and terminates
        at once with a ``cancelled`` response; one in a lane of a lane
        engine is evicted at the next segment boundary and terminates
        then.  False otherwise (the serial engine's in-flight cancel is
        ``RealEngine.request_cancel``)."""
        req = self.queue._live.get(request_id)
        if self.queue.cancel(request_id):
            self._finish(CompletionResponse(
                request_id=request_id, text="", tokens_generated=0,
                queue_wait_s=0.0, service_s=0.0,
                replica=self.engines[0].replica_id, p_long=req.p_long,
                klass=req.klass, status="cancelled",
                error="client disconnect (queued)"))
            return True
        mgr = getattr(self.engines[0], "lane_manager", None)
        if mgr is not None and mgr.lane_of(request_id) is not None:
            self._disconnected.add(request_id)
            return True
        return False

    def drain(self, max_new_tokens: int = 64) -> List[CompletionResponse]:
        """Serve the queue to empty: through the lanes on a lane engine
        (non-preemptive policies, as in the JAX server), else one request
        at a time."""
        eng = self.engines[0]
        if isinstance(eng, BatchedRealEngine) \
                and not getattr(self.policy_obj, "preemptive", False):
            self._drain_batched(eng, max_new_tokens)
        else:
            self._drain_serial(eng, max_new_tokens)
        return self.responses

    def _drain_serial(self, eng, max_new_tokens: int) -> None:
        """One request at a time, on a clock that starts at the engine's
        ``busy_until`` and advances by each request's measured wall-clock
        service time."""
        t = eng.busy_until
        while True:
            req = self.queue.pop(now=t)
            if req is None:
                break
            t = max(t, req.arrival)
            ids, n_total = self._prepare_ids(req, eng.max_len, max_new_tokens)
            req.start = t
            out = eng.generate(ids, max_new_tokens=n_total)
            t += out["service_s"]
            eng.busy_until = req.finish = t
            self._finish(CompletionResponse(
                request_id=req.req_id, text="",
                tokens_generated=len(out["tokens"]),
                queue_wait_s=req.start - req.arrival,
                service_s=out["service_s"],
                ttft_s=req.start - req.arrival + out["ttft_s"],
                promoted=req.promoted, replica=eng.replica_id,
                p_long=req.p_long, klass=req.klass,
                status="cancelled" if out["cancelled"] else "ok",
                error="cancelled mid-generation" if out["cancelled"]
                else None,
                token_ids=list(out["tokens"])))

    def _drain_batched(self, eng: BatchedRealEngine,
                       max_new_tokens: int) -> None:
        """Micro-batched wall-clock drain (JAX ``_drain_batched`` without
        shedding, faults or recorder): up to ``eng.n_lanes`` requests
        decode concurrently under the engine's KV budget.

        The engine's lane back-fill pulls through :meth:`SJFQueue.pop_many`,
        so the starvation guard is re-evaluated between every pop.
        Admission is memory-aware: a head whose footprint does not fit
        blocks back-fill until lanes retire.  A client disconnect evicts
        its lane at the next segment boundary.  The clock starts at the
        engine's ``busy_until`` and runs on the wall clock."""
        t_base = eng.busy_until
        wall0 = time.monotonic()

        def now() -> float:
            return t_base + (time.monotonic() - wall0)

        def source(k: int):
            items = []
            for req in self.queue.pop_many(k, now=now()):
                ids, n_total = self._prepare_ids(req, eng.max_len,
                                                 max_new_tokens)
                items.append({"req_id": req.req_id, "ids": ids,
                              "max_new": n_total, "tenant": req.tenant,
                              "meta": {"req": req}})
            return items

        def cancel_check(state) -> bool:
            return state.req_id in self._disconnected

        def on_finish(state, out):
            req = state.meta["req"]
            if req.start is None:
                req.start = max(out["admit_t"], req.arrival)
            req.finish = max(out["finish_t"], req.start)
            cancelled = out["cancelled"]
            self._disconnected.discard(req.req_id)
            self._finish(CompletionResponse(
                request_id=req.req_id, text="",
                tokens_generated=len(out["tokens"]),
                queue_wait_s=req.start - req.arrival,
                service_s=req.finish - req.start,
                ttft_s=req.start - req.arrival + out["ttft_s"],
                promoted=req.promoted, replica=eng.replica_id,
                p_long=req.p_long, klass=req.klass,
                status="cancelled" if cancelled else "ok",
                error="client disconnect (mid-generation)" if cancelled
                else None,
                token_ids=list(out["tokens"])))

        eng.run_lanes(source, on_finish, cancel_check=cancel_check,
                      now_fn=now)
        eng.busy_until = now()

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

    @staticmethod
    def _klass_of(resp: CompletionResponse) -> str:
        if resp.klass:
            return resp.klass
        toks = resp.tokens_generated
        return "short" if toks < 200 else ("medium" if toks < 800 else "long")
