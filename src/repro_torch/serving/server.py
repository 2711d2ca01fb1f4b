"""The Clairvoyant front end (port of ``repro.serving.server.
ClairvoyantServer`` for one serial replica): features -> predictor -> SJF
queue -> ``RealEngine``.

Admission is batched: ``submit_many`` scores a whole arrival burst with one
predictor call (feature extraction on the host, K4 on the card).  ``drain``
then serves the queue serially and non-preemptively: pop (starvation guard
first, then the policy key), tokenize, bucketed prefill, fused decode.
Every admitted request ends in exactly one ``CompletionResponse``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.policy import get_policy
from repro_torch.core.scheduler import Request, SJFQueue
from repro_torch.data.tokenizer import HashTokenizer, approx_token_len
from repro_torch.serving.openai_api import (CompletionRequest,
                                            CompletionResponse)
from repro_torch.serving.service_time import ServiceTimeModel


class ClairvoyantServer:
    """One ``RealEngine`` replica behind one ``SJFQueue``.

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

    def drain(self, max_new_tokens: int = 64) -> List[CompletionResponse]:
        """Serve the queue to empty, one request at a time, on a clock
        that starts at the engine's ``busy_until`` and advances by each
        request's measured wall-clock service time."""
        eng = self.engines[0]
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
        return self.responses

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
