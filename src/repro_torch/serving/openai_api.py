"""Request/response shapes of the serving path (port of
``repro.serving.openai_api``'s dataclasses)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

#: terminal states a response can report in this slice (the JAX server
#: adds shed / failed / timeout with its fault layer)
STATUSES = ("ok", "cancelled")


@dataclass
class CompletionRequest:
    prompt: str
    max_tokens: int = 1024
    tenant: str = "default"
    #: assigned by the server at admission when None (per-server counter)
    request_id: Optional[int] = None


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
    error: Optional[str] = None
    #: the generated token ids (the hashed tokenizer cannot detokenize)
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
