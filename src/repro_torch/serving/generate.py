"""Fused greedy generation (port of ``repro.serving.generate.FusedDecoder``)
and the prefill bucket helpers.

The JAX decoder runs each segment as one jitted ``lax.while_loop`` with the
stop predicate on the device.  Here a segment is a Python loop of
``decode_step`` calls whose inputs and outputs never leave the device: the
current token, the emitted-token buffer and the cache fill level ``t`` all
stay there, and the host reads the buffer once per segment.  The length
limits (``max_len``, ``max_new_tokens``) are known on the host, so each
segment is sized to them before it launches; only EOS depends on the data,
and tokens past an EOS inside a segment are dropped on the host.
"""

from __future__ import annotations

from typing import Optional

import torch


class FusedDecoder:
    """Segmented greedy decoder for one ``LM``: one host read per segment,
    where cancellation and streaming are observed."""

    def __init__(self, lm, max_len: int, segment_len: int = 16):
        if segment_len < 1:
            raise ValueError("segment_len must be >= 1")
        self.lm = lm
        self.max_len = max_len
        self.segment_len = segment_len

    def _budget(self, prompt_len: int, produced: int, max_new: int) -> int:
        """Steps the stop rules allow from here, capped at one segment (the
        oracle's window and request budgets, counted on the host)."""
        return max(0, min(self.segment_len,
                          self.max_len - prompt_len - produced,
                          max_new - produced))

    @torch.no_grad()
    def _segment(self, cache, tok, n: int):
        """``n`` decode steps on the device; returns (tokens (n,), last
        token (1, 1)) without synchronising the host."""
        buf = torch.empty(n, dtype=torch.long, device=tok.device)
        for i in range(n):
            logits = self.lm.decode_step(cache, tok)
            tok = logits.argmax(dim=-1).view(1, 1)
            buf[i:i + 1] = tok[0]
        return buf, tok

    def decode(self, cache, first_token: int, prompt_len: int,
               max_new_tokens: int, eos_id: Optional[int] = None,
               cancel_check=None, on_segment=None) -> dict:
        """Greedy-decode from a prefilled cache (updated in place).

        ``first_token`` is the prefill argmax (already emitted).  Returns
        {"tokens": [first_token, ...], "cancelled", "segments", "cache"}.
        ``on_segment(new_tokens)`` fires with the prefill token and then
        once per segment; ``cancel_check()`` is polled before each segment.

        A segment that emits EOS still runs its remaining steps: their K/V
        are written past the EOS position and the cache's fill level ends
        past it too.  Those slots are never read for this request, and the
        next request prefills a fresh cache.
        """
        out = [int(first_token)]
        if on_segment is not None:
            on_segment([int(first_token)])
        tok = torch.full((1, 1), int(first_token), dtype=torch.long,
                         device=self.lm.device)
        cancelled = False
        segments = 0

        def live() -> bool:
            # the oracle's break conditions, in order: EOS, window, budget
            return ((eos_id is None or out[-1] != eos_id)
                    and prompt_len + len(out) < self.max_len
                    and len(out) < max_new_tokens)

        while True:
            if cancel_check is not None and cancel_check():
                cancelled = True
                break
            n = self._budget(prompt_len, len(out), max_new_tokens) \
                if live() else 0
            new = []
            if n:
                buf, tok = self._segment(cache, tok, n)
                new = buf.tolist()                 # one host read per segment
                if eos_id is not None and eos_id in new:
                    new = new[:new.index(eos_id) + 1]
            segments += 1
            out.extend(new)
            if on_segment is not None and new:
                on_segment(new)
            if not live():
                break
        return {"tokens": out, "cancelled": cancelled, "segments": segments,
                "cache": cache}


def geometric_buckets(max_len: int, floor: int = 16) -> tuple:
    """Prefill padding buckets: powers of two from ``floor`` up to and
    including ``max_len``."""
    buckets = []
    b = floor
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def bucket_for(n: int, buckets) -> int:
    """Smallest bucket >= n; lengths beyond the last bucket prefill at
    exact length."""
    for b in buckets:
        if n <= b:
            return b
    return n
