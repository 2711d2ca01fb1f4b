"""OpenAI-compatible request/response shapes (the sidecar's wire schema;
a copy of ``repro.serving.openai_api`` whose responses also carry the
generated token ids).

The paper's proxy intercepts /v1/chat/completions-style requests.  Two
transports share these dataclasses: the in-process path (the framework
serves from the same binary — examples, benchmarks, the batch drains)
and the real asyncio HTTP/SSE sidecar (``serving/http_sidecar.py``),
which serializes them with the helpers at the bottom of this module.

Request ids are **per-server**: ``CompletionRequest.request_id``
defaults to ``None`` and is assigned by ``ClairvoyantServer`` at
admission from a server-local counter.  (It used to draw from a
process-global ``itertools.count``, which meant two servers in one
process shared an id space — ids depended on construction history, and
an id recycled across servers could cross-poison the duplicate-terminal
guard in ``_finish``.  Per-server allocation makes every server's id
stream dense and deterministic; explicit ids are still honored, with a
duplicate-submission check at admission.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class CompletionRequest:
    prompt: str
    max_tokens: int = 1024
    model: str = "default"
    tenant: str = "default"
    stream: bool = False
    #: assigned by the server at admission when None (per-server counter)
    request_id: Optional[int] = None
    created: float = field(default_factory=time.monotonic)


#: Terminal states a response can report.  Every submitted request ends
#: in exactly one of these (the server's no-lost-requests invariant):
#: ``ok`` served to completion; ``shed`` dropped by admission control
#: (queue overflow) or a deadline budget before service; ``failed`` the
#: backend faulted and the bounded retries were exhausted; ``timeout``
#: the deadline expired while in service; ``cancelled`` client
#: disconnect (queued or mid-generation).
STATUSES = ("ok", "shed", "failed", "timeout", "cancelled")

#: Wire mapping for the five terminal statuses (the sidecar's response
#: codes).  ``cancelled`` uses 499 (client-closed-request, the de-facto
#: convention) — usually unsendable because the client is gone, but it
#: keeps logs and the non-disconnect cancel path (server shutdown)
#: well-defined.
HTTP_STATUS = {
    "ok": 200,
    "shed": 429,        # admission overflow / rate limit / deadline shed
    "failed": 502,      # backend fault, retries exhausted
    "timeout": 504,     # deadline expired in service
    "cancelled": 499,   # client closed request
}


@dataclass
class CompletionResponse:
    request_id: int
    text: str
    tokens_generated: int
    queue_wait_s: float
    service_s: float
    ttft_s: Optional[float] = None      # time to first token
    promoted: bool = False              # starvation-guard promotion
    replica: int = 0
    p_long: float = 0.0
    klass: str = ""                     # ground-truth class, if known
    status: str = "ok"                  # terminal state (see STATUSES)
    error: Optional[str] = None         # human-readable failure reason
    retries: int = 0                    # fault retries before terminating
    degraded: bool = False              # admitted under predictor outage
    accept_rate: Optional[float] = None  # draft acceptance (speculative only)
    #: the generated token ids of an in-process drain (the hashed
    #: tokenizer cannot detokenize; the wire carries ``text``)
    token_ids: List[int] = field(default_factory=list)

    def __post_init__(self):
        if self.status not in STATUSES:
            raise ValueError(f"unknown status {self.status!r}")

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    @property
    def sojourn_s(self) -> float:
        return self.queue_wait_s + self.service_s


# --------------------------------------------------------------------------
# Wire serialization (OpenAI chat-completion shapes + clairvoyant extras)
# --------------------------------------------------------------------------

def chat_completion_body(resp: CompletionResponse, model: str,
                         created: Optional[float] = None,
                         extra: Optional[dict] = None) -> dict:
    """Non-streaming /v1/chat/completions response body.

    ``extra`` merges additional keys into the ``clairvoyant`` block —
    the sidecar uses it to surface the online ranking-fidelity snapshot
    alongside the per-request scheduling facts."""
    finish = "stop" if resp.status == "ok" else resp.status
    body = {
        "id": f"chatcmpl-{resp.request_id}",
        "object": "chat.completion",
        "created": int(created if created is not None else time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": resp.text},
            "finish_reason": finish,
        }],
        "usage": {"completion_tokens": resp.tokens_generated},
        "clairvoyant": {
            "status": resp.status,
            "queue_wait_s": resp.queue_wait_s,
            "service_s": resp.service_s,
            "ttft_s": resp.ttft_s,
            "p_long": resp.p_long,
            "replica": resp.replica,
            "retries": resp.retries,
            "promoted": resp.promoted,
            "degraded": resp.degraded,
            "accept_rate": resp.accept_rate,
        },
    }
    if resp.error:
        body["clairvoyant"]["error"] = resp.error
    if extra:
        body["clairvoyant"].update(extra)
    return body


def chat_chunk_body(request_id: int, model: str, delta: str,
                    finish_reason: Optional[str] = None) -> dict:
    """One streaming chat.completion.chunk (SSE ``data:`` payload)."""
    d: dict = {"content": delta} if delta else {}
    return {
        "id": f"chatcmpl-{request_id}",
        "object": "chat.completion.chunk",
        "model": model,
        "choices": [{"index": 0, "delta": d,
                     "finish_reason": finish_reason}],
    }


def error_body(status: str, message: str,
               request_id: Optional[int] = None) -> dict:
    """Terminal error payload (both the JSON body of non-200 responses
    and the final SSE frame of a stream that ended non-ok)."""
    return {"error": {"type": status, "message": message,
                      "request_id": request_id}}
