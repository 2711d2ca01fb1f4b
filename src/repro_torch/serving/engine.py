"""The serial backend (port of ``repro.serving.engine.RealEngine``): bucketed
prefill, then fused greedy decode over a ring-buffer KV cache.

One request is in flight at a time.  Cancellation (``request_cancel`` or a
``cancel_cb``) stops the fused loop at the next segment boundary.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import LM
from repro_torch.serving.generate import (FusedDecoder, bucket_for,
                                          geometric_buckets)


class RealEngine:
    """An ``LM`` decoding on ``device`` (the card unless ``device='cpu'``).

    ``state_dict`` (e.g. from ``bridge.params_from_jax``) replaces the
    seeded initialisation.
    """

    def __init__(self, cfg, state_dict=None, replica_id: int = 0,
                 seed: int = 0, max_len: int = 256, segment_len: int = 16,
                 device=None):
        self.cfg = cfg
        self.lm = LM(cfg, device=device, seed=seed)
        if state_dict is not None:
            self.lm.load_state_dict(state_dict)
        self.device = self.lm.device
        self.replica_id = replica_id
        self.max_len = max_len
        self.segment_len = segment_len
        self.busy_until = 0.0
        self.served = 0
        self._cancel = False
        self.buckets = geometric_buckets(max_len)

    # ---------------------------------------------------------------- admin
    def request_cancel(self) -> None:
        """Mid-generation disconnect: the fused loop stops at the next
        segment boundary."""
        self._cancel = True

    def engine_stats(self) -> dict:
        return {"replica": self.replica_id, "served": self.served,
                "speculative": False}

    # -------------------------------------------------------------- prefill
    def _run_prefill(self, prompt_ids):
        """Bucket-pad + prefill.  Returns (last logits (1, V), cache,
        prompt_len)."""
        ids = np.asarray(prompt_ids, np.int64).reshape(-1)
        plen = len(ids)
        if plen < 1:
            raise ValueError("empty prompt: prefill needs >= 1 token")
        toks = np.zeros((1, bucket_for(plen, self.buckets)), np.int64)
        toks[0, :plen] = ids
        logits, cache = self.lm.prefill(
            torch.from_numpy(toks).to(self.device), pad_to=self.max_len,
            prompt_len=plen)
        return logits, cache, plen

    # ------------------------------------------------------------- generate
    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, cancel_cb=None,
                 segment_len: Optional[int] = None, on_segment=None) -> dict:
        """Fused greedy decode.  Returns {"tokens", "ttft_s", "service_s",
        "cancelled", "segments"}."""
        self._cancel = False
        t0 = time.monotonic()
        logits, cache, plen = self._run_prefill(prompt_ids)
        tok = int(logits[0].argmax())
        ttft = time.monotonic() - t0

        def cancelled():
            return self._cancel or (cancel_cb is not None and cancel_cb())

        dec = FusedDecoder(self.lm, self.max_len,
                           segment_len or self.segment_len)
        out = dec.decode(cache, tok, plen, max_new_tokens, eos_id=eos_id,
                         cancel_check=cancelled, on_segment=on_segment)
        self.served += 1
        self._cancel = False
        return {"tokens": out["tokens"], "ttft_s": ttft,
                "service_s": time.monotonic() - t0,
                "cancelled": out["cancelled"], "segments": out["segments"]}

    def generate_reference(self, prompt_ids, max_new_tokens: int = 32,
                           eos_id: Optional[int] = None) -> dict:
        """Per-token loop with one host read per token: the equivalence
        oracle for the fused loop (same prefill, same stop order)."""
        t0 = time.monotonic()
        logits, cache, plen = self._run_prefill(prompt_ids)
        tok = int(logits[0].argmax())
        ttft = time.monotonic() - t0
        out = [tok]
        for _ in range(max_new_tokens - 1):
            if eos_id is not None and tok == eos_id:
                break
            if plen + len(out) >= self.max_len:
                break
            step = torch.full((1, 1), tok, dtype=torch.long,
                              device=self.device)
            tok = int(self.lm.decode_step(cache, step)[0].argmax())
            out.append(tok)
        self.served += 1
        return {"tokens": out, "ttft_s": ttft,
                "service_s": time.monotonic() - t0}
