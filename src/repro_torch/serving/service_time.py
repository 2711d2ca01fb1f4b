"""Service-time model (copy of ``repro.serving.service_time.
ServiceTimeModel``): the admission layer's estimate of a request's service
seconds, which is the key of the ``sjf_oracle`` policy."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ServiceTimeModel:
    """service(prompt_tokens, output_tokens) in seconds."""
    prefill_tok_per_s: float
    decode_tok_per_s: float
    overhead_s: float = 0.010

    def service(self, prompt_tokens: int, output_tokens: int) -> float:
        return (self.overhead_s
                + prompt_tokens / self.prefill_tok_per_s
                + output_tokens / self.decode_tok_per_s)
