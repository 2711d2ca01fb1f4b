"""Service-time model (copies of ``repro.serving.service_time.
ServiceTimeModel`` and ``expected_speedup``): the admission layer's
estimate of a request's service seconds, which is the key of the
``sjf_oracle`` policy, and the speculative speedup the ``sjf_effective``
policy divides by."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def expected_speedup(accept_rate, draft_k: int, draft_cost: float = 0.15):
    """Expected decode speedup of draft-verify speculation.

    With per-position acceptance rate ``a`` and draft depth ``k``, one
    round emits ``E = (1 - a^(k+1)) / (1 - a)`` target tokens (the
    accepted prefix plus the bonus token) and costs ``k`` draft forwards
    plus one verify forward, so the speedup over serial decode is
    ``E / (k * draft_cost + 1)`` where ``draft_cost`` is the draft/target
    per-forward cost ratio.  Can be < 1 at low acceptance — speculation
    is not free.  Accepts scalars or arrays; ``draft_k == 0`` is exactly
    1.0 (no speculation).
    """
    if draft_k == 0:
        a = np.asarray(accept_rate, np.float64)
        return np.ones_like(a) if a.ndim else 1.0
    a = np.clip(np.asarray(accept_rate, np.float64), 0.0, 1.0 - 1e-9)
    tokens_per_round = (1.0 - a ** (draft_k + 1)) / (1.0 - a)
    out = tokens_per_round / (draft_k * draft_cost + 1.0)
    return out if out.ndim else float(out)


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
