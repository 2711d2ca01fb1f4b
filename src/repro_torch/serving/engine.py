"""The backends (port of ``repro.serving.engine``'s ``SimEngine``,
``RealEngine``, ``BatchedRealEngine`` and ``PagedBatchedEngine``).

* ``SimEngine`` -- a virtual-time serial backend: service seconds come
  from a ``ServiceTimeModel`` (the queueing runs of ``launch.serve``).
* ``RealEngine`` -- the serial backend: bucketed prefill, then fused
  greedy decode over a ring-buffer KV cache, one request in flight.
  Cancellation (``request_cancel`` or a ``cancel_cb``) stops the fused
  loop at the next segment boundary, where an attached
  ``serving.faults.FaultInjector`` is polled too (an injected crash
  raises ``EngineCrash`` out of ``generate`` there).
* ``BatchedRealEngine`` -- ``n_lanes`` concurrent requests under a KV
  byte budget (``serving/batching.py``), stepped together by
  ``serving.generate.LaneDecoder``; lanes retire and back-fill at
  segment boundaries.  Per-request greedy tokens equal serial runs.  At
  each boundary an attached injector is polled: a whole-engine crash
  raises out of ``run_lanes``, a lane crash evicts one lane (reported
  with ``crashed=True``).  An attached flight recorder gets per-lane
  ``prefill``, ``decode`` and ``decode_segment`` spans.
* ``PagedBatchedEngine`` -- the same lane loop over a block-paged pool
  with prefix reuse, page growth and preemption (``serving/paging.py``,
  ``serving.generate.PagedLaneDecoder``); decode reads the pool through
  K2.

Each real engine decodes draft-verify (speculative decoding) when given a
draft config and ``draft_k >= 1``: a draft ``LM`` (seeded with
``draft_seed``, or ``draft_state_dict``) proposes ``draft_k`` tokens a
round and the target verifies them in one W = K + 1 position forward
(``LM.verify_step``: K1 per position over a ring, K2 over the paged
pool).  Tokens equal plain greedy decode's; results and
``engine_stats()`` add the drafted and accepted counts and the accept
rate.  A lane's draft ring is charged to its budget (ring lanes: bytes;
paged lanes: overhead pages).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models.model import LM
from repro_torch.serving.batching import (KVBudget, LaneManager,
                                          kv_bytes_per_token)
from repro_torch.serving.generate import (FusedDecoder, LaneDecoder,
                                          PagedLaneDecoder,
                                          SpeculativeDecoder,
                                          SpeculativeLaneDecoder,
                                          SpeculativePagedLaneDecoder,
                                          bucket_for, geometric_buckets)
from repro_torch.serving.paging import (BlockAllocator, PagedLaneManager,
                                        pages_for)
from repro_torch.serving.service_time import ServiceTimeModel


class SimEngine:
    """Virtual-time serial backend: a clock (``busy_until``) and a
    ``ServiceTimeModel`` the server's virtual-time drains advance it by;
    ``execute`` serves one request on that clock."""

    def __init__(self, model: ServiceTimeModel, replica_id: int = 0):
        self.model = model
        self.replica_id = replica_id
        self.busy_until = 0.0
        self.served = 0

    def engine_stats(self) -> dict:
        """Wire-facing stats snapshot (sidecar /healthz, /metrics)."""
        return {"replica": self.replica_id, "served": self.served}

    def execute(self, start: float, prompt_tokens: int,
                output_tokens: int) -> tuple[float, float]:
        """Returns (ttft_s, service_s); advances the virtual clock."""
        service = self.model.service(prompt_tokens, output_tokens)
        ttft = self.model.overhead_s + prompt_tokens / self.model.prefill_tok_per_s
        self.busy_until = start + service
        self.served += 1
        return ttft, service


# Padded (bucketed) prefill is only used when every block's per-position
# state is causal-local; SSM recurrences fold pad tokens into their state
# and MoE capacity routing lets pad tokens evict real ones.
_BUCKET_SAFE_KINDS = ("attn",)


def _bucket_safe(cfg) -> bool:
    return all(k in _BUCKET_SAFE_KINDS for k in cfg.block_pattern)


class RealEngine:
    """An ``LM`` decoding on ``device`` (the card unless ``device='cpu'``).

    ``state_dict`` (e.g. from ``bridge.params_from_jax``) replaces the
    seeded initialisation; ``draft_state_dict`` likewise for the draft.
    With ``draft_cfg`` and ``draft_k >= 1`` it decodes draft-verify
    (``SpeculativeDecoder``); ``draft_k`` 0 keeps the plain fused path
    even with a draft config, as in JAX.  A stack with any block kind
    but ``attn`` prefills at exact length (no buckets) and refuses
    draft-verify, as the JAX engine does; the refusal comes before any
    weight is built.
    """

    def __init__(self, cfg, state_dict=None, replica_id: int = 0,
                 seed: int = 0, max_len: int = 256, segment_len: int = 16,
                 device=None, draft_cfg=None, draft_state_dict=None,
                 draft_k: int = 0, draft_seed: int = 0):
        self.cfg = cfg
        self._bucketing = _bucket_safe(cfg)
        if draft_cfg is not None and int(draft_k) > 0:
            if not self._bucketing:
                raise ValueError(
                    "speculative decoding needs a pure-attention stack "
                    f"(got pattern {cfg.block_pattern}): the verify "
                    "forward is an attention-cache operation")
            if not _bucket_safe(draft_cfg):
                raise ValueError(
                    "draft model needs a pure-attention stack "
                    f"(got pattern {draft_cfg.block_pattern})")
        self.lm = LM(cfg, device=device, seed=seed)
        if state_dict is not None:
            self.lm.load_state_dict(state_dict)
        self.device = self.lm.device
        self.draft_cfg = draft_cfg
        self.draft_k = int(draft_k)
        self.speculative = draft_cfg is not None and self.draft_k > 0
        self.draft_lm = None
        if self.speculative:
            self.draft_lm = LM(draft_cfg, device=self.device,
                               seed=draft_seed)
            if draft_state_dict is not None:
                self.draft_lm.load_state_dict(draft_state_dict)
            self._spec_decoder = SpeculativeDecoder(
                self.lm, self.draft_lm, max_len, self.draft_k)
        self.drafted_total = 0         # draft positions proposed
        self.accepted_total = 0        # draft positions accepted
        self.replica_id = replica_id
        self.max_len = max_len
        self.segment_len = segment_len
        self.busy_until = 0.0
        self.served = 0
        self._cancel = False
        self.buckets = geometric_buckets(max_len) if self._bucketing else ()
        # optional serving.faults.FaultInjector, polled at fused-decode
        # segment boundaries (the join points of cancellation)
        self.fault_injector = None
        # optional serving.observability.FlightRecorder, attached by the
        # server (the serial drain stamps spans from the server's clock)
        self.recorder = None

    # ---------------------------------------------------------------- admin
    def request_cancel(self) -> None:
        """Mid-generation disconnect: the fused loop stops at the next
        segment boundary."""
        self._cancel = True

    @property
    def accept_rate(self) -> Optional[float]:
        """Draft acceptance over the engine's requests (a lane engine:
        over its most recent run), or None before any draft position was
        proposed."""
        return self.accepted_total / self.drafted_total \
            if self.drafted_total else None

    def engine_stats(self) -> dict:
        """Wire-facing stats snapshot (sidecar /healthz, /metrics); a
        speculative engine adds its drafted/accepted counts and accept
        rate (the ``clairvoyant_speculative_accept_rate`` gauge)."""
        st = {"replica": self.replica_id, "served": self.served,
              "speculative": self.speculative}
        if self.speculative:
            st.update(drafted=self.drafted_total,
                      accepted=self.accepted_total,
                      accept_rate=self.accept_rate)
        return st

    # -------------------------------------------------------------- prefill
    def _bucket(self, n: int) -> int:
        """The prefill length of an ``n``-token prompt: its bucket, or
        ``n`` itself for a stack that prefills at exact length."""
        return bucket_for(n, self.buckets) if self._bucketing else n

    def _run_prefill(self, prompt_ids, lm=None):
        """Bucket-pad + prefill.  Returns (last logits (1, V), cache,
        prompt_len).  ``lm`` overrides the target model (the draft
        prefills through the same bucketing, so its cache rows lay out
        like the target's)."""
        ids = np.asarray(prompt_ids, np.int64).reshape(-1)
        plen = len(ids)
        if plen < 1:
            raise ValueError("empty prompt: prefill needs >= 1 token")
        toks = np.zeros((1, self._bucket(plen)), np.int64)
        toks[0, :plen] = ids
        logits, cache = (self.lm if lm is None else lm).prefill(
            torch.from_numpy(toks).to(self.device), pad_to=self.max_len,
            prompt_len=plen)
        return logits, cache, plen

    def _run_prefill_group(self, ids_list, pad_rows: Optional[int] = None,
                           pad_to: Optional[int] = None, lm=None):
        """One padded prefill for prompts sharing a bucket (lane admission
        groups).  Returns (last logits (k, V), cache with per-row fill
        levels, plens).  Rows are padded exactly as their solo bucketed
        prefill would be; callers group by bucket before calling.

        The batch axis is padded to ``pad_rows`` rows (dummy one-token
        rows, sliced off before returning).  The JAX engine pads to avoid
        a jit compile per group size; eager PyTorch compiles nothing, but
        the padding stays for another reason: cuBLAS picks its GEMM kernel
        by the row count, so a fixed count per bucket keeps each row's
        arithmetic independent of how many prompts share its group.  Ring
        and paged lanes, which admit in different groups, then prefill a
        prompt bit for bit alike on the card.  It costs at most
        ``pad_rows`` times a prefill of one prompt.  ``lm`` overrides the
        target model, as in :meth:`_run_prefill`."""
        ids_list = [np.asarray(i, np.int64).reshape(-1) for i in ids_list]
        plens = [len(i) for i in ids_list]
        if min(plens) < 1:
            raise ValueError("empty prompt in prefill group")
        buckets = {self._bucket(n) for n in plens}
        if len(buckets) != 1:
            raise ValueError(f"prefill group spans buckets {buckets}")
        bucket = buckets.pop()
        k = len(ids_list)
        kp = k if pad_rows is None else int(pad_rows)
        if k > kp:
            raise ValueError(f"group of {k} exceeds pad_rows {kp}")
        toks = np.zeros((kp, bucket), np.int64)
        for r, ids in enumerate(ids_list):
            toks[r, :len(ids)] = ids
        logits, cache = (self.lm if lm is None else lm).prefill(
            torch.from_numpy(toks).to(self.device), pad_to=pad_to,
            prompt_len=plens + [1] * (kp - k))
        if kp != k:
            logits = logits[:k]
            cache = cache.rows(k)
        return logits, cache, plens

    # ------------------------------------------------------------- generate
    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, cancel_cb=None,
                 segment_len: Optional[int] = None, on_segment=None) -> dict:
        """Fused greedy decode.  Returns {"tokens", "ttft_s", "service_s",
        "cancelled", "segments"}, plus {"drafted", "accepted",
        "accept_rate"} when speculative (the draft prefills after the
        target, through K3 too)."""
        self._cancel = False
        t0 = time.monotonic()
        logits, cache, plen = self._run_prefill(prompt_ids)
        tok = int(logits[0].argmax())
        ttft = time.monotonic() - t0

        def cancelled():
            if self.fault_injector is not None:
                # may raise EngineCrash: the crash lands at the segment
                # boundary, exactly where a cancel would
                self.fault_injector.poll_segment(self.replica_id)
            return self._cancel or (cancel_cb is not None and cancel_cb())

        if self.speculative:
            _, dcache, _ = self._run_prefill(prompt_ids, lm=self.draft_lm)
            out = self._spec_decoder.decode(
                cache, dcache, tok, plen, max_new_tokens, eos_id=eos_id,
                cancel_check=cancelled, on_segment=on_segment)
        else:
            dec = FusedDecoder(self.lm, self.max_len,
                               segment_len or self.segment_len)
            out = dec.decode(cache, tok, plen, max_new_tokens, eos_id=eos_id,
                             cancel_check=cancelled, on_segment=on_segment)
        self.served += 1
        self._cancel = False
        res = {"tokens": out["tokens"], "ttft_s": ttft,
               "service_s": time.monotonic() - t0,
               "cancelled": out["cancelled"], "segments": out["segments"]}
        if self.speculative:
            self.drafted_total += out["drafted"]
            self.accepted_total += out["accepted"]
            res["drafted"] = out["drafted"]
            res["accepted"] = out["accepted"]
            res["accept_rate"] = out["accepted"] / out["drafted"] \
                if out["drafted"] else None
        return res

    def generate_batch(self, prompts, max_new_tokens=32,
                       eos_id: Optional[int] = None) -> list:
        """Serial fallback so both engine classes share one batch API."""
        maxes = self._per_request_budgets(prompts, max_new_tokens)
        return [self.generate(ids, max_new_tokens=m, eos_id=eos_id)
                for ids, m in zip(prompts, maxes)]

    @staticmethod
    def _per_request_budgets(prompts, max_new_tokens) -> list:
        if np.isscalar(max_new_tokens):
            return [int(max_new_tokens)] * len(prompts)
        return [int(m) for m in max_new_tokens]

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


class BatchedRealEngine(RealEngine):
    """Bounded-concurrency real decode: ``n_lanes`` concurrent requests
    under a KV byte budget (``serving/batching.py``).

    The lanes share one ring cache with a (lanes,) fill level; one segment
    steps every live lane together (``LaneDecoder``), and segment
    boundaries are the join points where finished lanes retire and the
    manager back-fills from the caller's source by prefilling into the
    vacant lane.

    Equivalence contract: each request's greedy token sequence equals an
    independent serial run of the same prompt, back-filled requests
    included (tests/test_torch_batching.py, float32 on the CPU).  On the
    card a bf16 lane may round differently from a serial run: the GEMMs
    see M = n_lanes rows instead of one.

    Admission is memory-aware and strictly policy-ordered: the next item
    (in the order ``source`` yields them) is admitted only when its
    worst-case KV footprint -- ``min(max_len, prompt + max_new)`` ring
    slots at ``kv_bytes_per_token(cfg)`` -- fits the budget; a head that
    does not fit blocks until lanes retire.  ``budget_bytes=None`` sizes
    the budget to exactly ``n_lanes`` full rings.
    """

    def __init__(self, cfg, state_dict=None, replica_id: int = 0,
                 seed: int = 0, max_len: int = 256, segment_len: int = 16,
                 n_lanes: int = 4, budget_bytes: Optional[int] = None,
                 device=None, draft_cfg=None, draft_state_dict=None,
                 draft_k: int = 0, draft_seed: int = 0):
        super().__init__(cfg, state_dict=state_dict, replica_id=replica_id,
                         seed=seed, max_len=max_len, segment_len=segment_len,
                         device=device, draft_cfg=draft_cfg,
                         draft_state_dict=draft_state_dict, draft_k=draft_k,
                         draft_seed=draft_seed)
        self.n_lanes = int(n_lanes)
        self._bytes_per_token = kv_bytes_per_token(cfg)
        # a speculative lane carries the draft model's ring K/V beside the
        # target's: real memory, charged against the same budget
        self._draft_bytes_per_token = kv_bytes_per_token(draft_cfg) \
            if self.speculative else 0
        lane_bpt = self._bytes_per_token + self._draft_bytes_per_token
        self.budget_bytes = int(budget_bytes) if budget_bytes is not None \
            else self.n_lanes * max_len * max(1, lane_bpt)
        if self.speculative:
            self._lane_decoder = SpeculativeLaneDecoder(
                self.lm, self.draft_lm, max_len, self.n_lanes, segment_len,
                draft_k=self.draft_k)
            # paged growth must cover every verify position a segment can
            # write: rounds x (K+1) slots, against segment_len plain steps
            self._growth_span = self._lane_decoder.rounds * (self.draft_k
                                                             + 1)
        else:
            self._lane_decoder = LaneDecoder(self.lm, max_len, self.n_lanes,
                                             segment_len)
            self._growth_span = segment_len
        self.lane_manager = None       # the most recent run's manager/stats
        self.dead_steps = 0            # lane-steps burned on stopped lanes
        self._pending_items: list = []

    def take_pending(self) -> list:
        """Drain the popped-but-not-admitted work items of the most recent
        ``run_lanes`` call (if a run raised, these left the caller's queue
        but never reached a lane)."""
        items, self._pending_items = list(self._pending_items), []
        return items

    def engine_stats(self) -> dict:
        """Adds dead-step and speculation accounting and live lane
        occupancy."""
        st = super().engine_stats()
        mgr = self.lane_manager
        st.update(dead_steps=self.dead_steps, lanes=self.n_lanes,
                  lanes_busy=len(mgr.busy_lanes()) if mgr is not None
                  else 0, drafted=self.drafted_total,
                  accepted=self.accepted_total,
                  accept_rate=self.accept_rate)
        return st

    def _accumulate_spec(self, mgr, dec) -> None:
        """Post-segment speculation accounting: per-lane and aggregate
        drafted/accepted counts, and wasted draft positions (drafted -
        accepted) folded into ``dead_steps``, since they burn lane time as
        a stopped lane's masked compute does."""
        if not self.speculative:
            return
        drafted, accepted = dec.last_drafted, dec.last_accepted
        for lane in mgr.busy_lanes():
            st = mgr.lanes[lane]
            st.drafted += int(drafted[lane])
            st.accepted += int(accepted[lane])
        d, a = int(drafted.sum()), int(accepted.sum())
        self.drafted_total += d
        self.accepted_total += a
        self.dead_steps += d - a
        mgr.stats["drafted"] = self.drafted_total
        mgr.stats["accepted"] = self.accepted_total
        mgr.stats["accept_rate"] = self.accept_rate

    # ----------------------------------------------------------- batch API
    def generate_batch(self, prompts, max_new_tokens=32,
                       eos_id: Optional[int] = None) -> list:
        """Decode a request list through the lanes; results in input order.

        ``max_new_tokens`` is a scalar or per-request sequence.  Returns
        one dict per request: {"tokens", "ttft_s", "service_s",
        "cancelled", "admit_t", "finish_t", "lane", "evictions"}.
        """
        maxes = self._per_request_budgets(prompts, max_new_tokens)
        n = len(prompts)
        results: list = [None] * n
        cursor = {"i": 0}

        def source(k: int) -> list:
            out = []
            while k > 0 and cursor["i"] < n:
                i = cursor["i"]
                cursor["i"] += 1
                out.append({"req_id": i, "ids": prompts[i],
                            "max_new": maxes[i], "meta": {"i": i}})
                k -= 1
            return out

        def on_finish(state, res):
            results[state.meta["i"]] = res

        self.run_lanes(source, on_finish, eos_id=eos_id)
        return results

    # -------------------------------------------------- lane-loop hook points
    # The paged engine reuses the whole run_lanes loop and specialises only
    # these: manager construction, the admission check/commit, the
    # prefill-and-insert step, the pre-segment hook (page growth and
    # preemption) and the post-release hook (block-table scrub).
    def _new_manager(self):
        return LaneManager(self.n_lanes, KVBudget(self.budget_bytes),
                           self._bytes_per_token
                           + self._draft_bytes_per_token, self.max_len)

    def _head_fits(self, mgr, item, ids) -> bool:
        return mgr.can_admit(len(ids), item["max_new"])

    def _admit_item(self, mgr, lane: int, item, ids, t_admit, backfill: bool):
        return mgr.admit(lane, req_id=item["req_id"], prompt_len=len(ids),
                         max_new=item["max_new"],
                         tenant=item.get("tenant", "default"),
                         admit_t=t_admit, meta=item.get("meta"),
                         backfill=backfill)

    def _post_insert(self, group, first, plens, now, tok, plen, produced,
                     max_new, active) -> None:
        """Host bookkeeping once a claim group is prefilled and inserted:
        per-lane counters and the first (prefill) token."""
        for r, (st, lane, ids, mx) in enumerate(group):
            st.prompt_len = plens[r]
            st.ttft_s = now() - st.admit_t
            st.tokens = [int(first[r])]
            tok[lane] = int(first[r])
            plen[lane] = plens[r]
            produced[lane] = 1
            max_new[lane] = mx
            active[lane] = True

    def _insert_draft(self, dec, caches, lanes, ids_list):
        """Speculative only: prefill the draft model over the same ids (the
        same bucketing and row padding, through K3) and drop the rows into
        the lanes' draft rings.  Resumed and prefix-hit requests take this
        same full prefill: the draft has no prefix cache, and its state
        moves only the accept rate, never the emitted tokens."""
        if not self.speculative:
            return caches
        _, dcache, _ = self._run_prefill_group(
            ids_list, pad_rows=self.n_lanes, pad_to=self.max_len,
            lm=self.draft_lm)
        return dec.insert_draft(caches, lanes, dcache)

    def _prefill_claims(self, mgr, dec, caches, claims, now, tok, plen,
                        produced, max_new, active):
        """Prefill admitted claims per bucket group -- one prefill and one
        lane insert per group."""
        groups: dict = {}
        for claim in claims:
            groups.setdefault(self._bucket(len(claim[2])), []).append(claim)
        for group in groups.values():
            logits, pcache, plens = self._run_prefill_group(
                [ids for _, _, ids, _ in group], pad_rows=self.n_lanes,
                pad_to=self.max_len)
            first = logits.argmax(dim=-1).cpu().numpy()
            caches = dec.insert_lanes(
                caches, [lane for _, lane, _, _ in group], pcache)
            caches = self._insert_draft(
                dec, caches, [lane for _, lane, _, _ in group],
                [ids for _, _, ids, _ in group])
            self._post_insert(group, first, plens, now, tok, plen,
                              produced, max_new, active)
        return caches

    def _boundary_reset(self) -> None:
        """Start-of-segment-boundary hook (per outer loop iteration)."""

    def _pre_segment(self, mgr, dec, caches, tok, produced, plen, max_new,
                     active, dev, pending):
        """Hook before the segment launch.  Returns (caches, changed);
        ``changed`` means lanes were freed (the caller back-fills and
        re-runs the hook until it settles)."""
        return caches, False

    def _post_release(self, dec, caches, lanes):
        """Hook after lanes retire or are evicted (paged: scrub their block
        tables so the released pages never receive the lanes' dead
        writes)."""
        return caches

    def _result_tokens(self, state) -> list:
        return list(state.tokens)

    def _init_lanes(self, dec):
        """Lane caches for a run (paged: the previous run's pools, so the
        prefix cache keeps its contents)."""
        return dec.init_lanes()

    def _retain_caches(self, caches) -> None:
        """End-of-run hook: the paged engine keeps its pools for the next
        run; the ring engine lets them be collected."""

    def run_lanes(self, source, on_finish, *, eos_id: Optional[int] = None,
                  cancel_check=None, now_fn=None) -> None:
        """Drive the lanes until ``source`` and all lanes drain.

        ``source(k)`` returns up to ``k`` work items (dicts with
        ``req_id``/``ids``/``max_new`` and optional ``tenant``/``meta``) in
        dispatch order -- the server passes a closure over its policy
        queue.  ``on_finish(LaneState, result)`` fires as each request
        retires.  ``cancel_check(LaneState) -> bool`` is polled at segment
        boundaries; a cancelled lane is evicted and reported with
        ``cancelled=True``.  ``now_fn`` supplies admission and finish
        timestamps (default: the wall clock).  At each boundary an
        attached ``fault_injector`` is polled: ``poll_segment`` may raise
        a whole-engine crash out of this method (the caller recovers the
        lanes' requests and ``take_pending``), and each due lane crash
        evicts one busy lane, reported with ``crashed=True``.

        The host keeps exact lane arrays (last token, tokens produced,
        prompt length, budget, occupancy): every token reaches the host in
        the segment's one read, so the host mirrors never go stale.  The
        device copies persist across segments and are rebuilt only when
        admission or release changes the lane composition.
        """
        now = now_fn if now_fn is not None else time.monotonic
        rec = self.recorder
        ltrk = [f"replica{self.replica_id}/lane{i}"
                for i in range(self.n_lanes)]
        mgr = self._new_manager()
        self.lane_manager = mgr
        self.dead_steps = 0
        self.drafted_total = 0
        self.accepted_total = 0
        dec = self._lane_decoder
        C = self.n_lanes
        caches = self._init_lanes(dec)
        tok = np.zeros(C, np.int64)
        produced = np.zeros(C, np.int64)
        plen = np.ones(C, np.int64)
        max_new = np.zeros(C, np.int64)
        active = np.zeros(C, bool)
        eos = -1 if eos_id is None else int(eos_id)
        dev = {"d": None}               # (tok, produced, plen, max_new, act)
        pending: list = []              # popped but budget-blocked items
        self._pending_items = pending
        drained = {"source": False}

        def fill(backfill: bool = False) -> None:
            nonlocal caches
            free = mgr.free_lanes()
            # phase 1: claim admissible (item, lane) pairs under the
            # budget, in strict source order (a blocked head blocks all)
            claims = []
            while free:
                want = len(free) - len(pending)
                if want > 0 and not drained["source"]:
                    got = source(want)
                    if len(got) < want:
                        drained["source"] = True
                    pending.extend(got)
                if not pending:
                    break
                item = pending[0]
                ids = np.asarray(item["ids"], np.int64).reshape(-1)
                if not self._head_fits(mgr, item, ids):
                    mgr.stats["blocked_on_budget"] += 1
                    break
                pending.pop(0)
                lane = free.pop(0)
                st = self._admit_item(mgr, lane, item, ids, now(), backfill)
                claims.append((st, lane, ids, item["max_new"]))
            if not claims:
                return
            # phase 2: prefill + lane insert (paged: page scatter / extend)
            caches = self._prefill_claims(mgr, dec, caches, claims, now,
                                          tok, plen, produced, max_new,
                                          active)
            if rec is not None:
                for st, lane, _, _ in claims:
                    rec.span("prefill", st.req_id, st.admit_t,
                             st.admit_t + max(st.ttft_s, 0.0),
                             track=ltrk[lane])
            dev["d"] = None             # lane composition changed

        def finish(state, cancelled: bool, crashed: bool = False) -> None:
            t_fin = now()
            self.served += not cancelled
            if rec is not None:
                t0d = min(state.admit_t + max(state.ttft_s, 0.0), t_fin)
                rec.span("decode", state.req_id, t0d, t_fin,
                         track=ltrk[state.lane])
            res = {
                "tokens": self._result_tokens(state), "cancelled": cancelled,
                "crashed": crashed,
                "ttft_s": state.ttft_s, "admit_t": state.admit_t,
                "finish_t": t_fin, "service_s": t_fin - state.admit_t,
                "lane": state.lane, "evictions": state.evictions}
            if self.speculative:
                res["drafted"] = state.drafted
                res["accepted"] = state.accepted
                res["accept_rate"] = state.accept_rate
            on_finish(state, res)

        inj = self.fault_injector
        fill()
        # `pending` in the condition: growth preemption (paged) can empty
        # every lane while the just-preempted head sits deferred for the
        # boundary -- the next iteration lifts the deferral and re-admits
        while active.any() or pending:
            self._boundary_reset()
            # segment boundary: client disconnects and injected lane
            # crashes are evicted, then back-filled, in one pass
            evictions = []                  # (lane, crashed)
            if cancel_check is not None:
                evictions = [(lane, False) for lane in mgr.busy_lanes()
                             if cancel_check(mgr.lanes[lane])]
            if inj is not None:
                inj.poll_segment(self.replica_id)   # may raise EngineCrash
                spec = inj.lane_crash_due(self.replica_id)
                while spec is not None:
                    taken = {lane for lane, _ in evictions}
                    busy = [ln for ln in mgr.busy_lanes()
                            if ln not in taken]
                    if not busy:
                        break
                    victim = spec.lane if spec.lane in busy else busy[0]
                    evictions.append((victim, True))
                    spec = inj.lane_crash_due(self.replica_id)
            if evictions:
                for lane, crashed in evictions:
                    st = mgr.evict(lane)
                    active[lane] = False
                    finish(st, cancelled=True, crashed=crashed)
                dev["d"] = None
                caches = self._post_release(
                    dec, caches, [lane for lane, _ in evictions])
                fill(backfill=True)
                if not active.any():
                    continue
            # paged: grow block tables for the coming segment, preempting
            # the youngest lanes on pool exhaustion; each preemption frees
            # a lane, so back-fill and re-settle until stable
            while True:
                caches, changed = self._pre_segment(
                    mgr, dec, caches, tok, produced, plen, max_new,
                    active, dev, pending)
                if not changed:
                    break
                fill(backfill=True)
            if not active.any():
                fill(backfill=True)
                continue
            if dev["d"] is None:            # copies, never views: the
                dev["d"] = tuple(               # device arrays step alone
                    torch.tensor(a, device=self.device)
                    for a in (tok, produced, plen, max_new, active))
            steps = dec.segment_steps(tok, produced, plen, max_new, active,
                                      eos)
            t_seg0 = now() if rec is not None else 0.0
            buf, dead = dec.run_segment(caches, dev["d"], steps, eos)
            self.dead_steps += dead
            self._accumulate_spec(mgr, dec)
            mgr.stats["dead_steps"] = self.dead_steps
            if rec is not None:
                t_seg1 = now()
                for lane in mgr.busy_lanes():
                    rec.span("decode_segment", mgr.lanes[lane].req_id,
                             t_seg0, t_seg1, track=ltrk[lane])
            released = []
            for lane in mgr.busy_lanes():
                new = buf[lane][buf[lane] >= 0].tolist()
                st = mgr.lanes[lane]
                st.tokens.extend(new)
                produced[lane] += len(new)
                if new:
                    tok[lane] = new[-1]
                st.produced = int(produced[lane])
                live = tok[lane] != eos and \
                    plen[lane] + produced[lane] < self.max_len and \
                    produced[lane] < max_new[lane]
                if not live:
                    st = mgr.retire(lane)
                    active[lane] = False
                    released.append(lane)
                    finish(st, cancelled=False)
            if released:
                dev["d"] = None
                caches = self._post_release(dec, caches, released)
                fill(backfill=True)
        self._retain_caches(caches)


class PagedBatchedEngine(BatchedRealEngine):
    """Micro-batching over a block-paged KV pool with prefix reuse.

    Same lane loop, stop semantics and token contract as
    :class:`BatchedRealEngine`, with the memory subsystem swapped
    (``serving/paging.py``):

    * **Admission charges actual footprint** -- the prompt's pages, not
      the worst-case ring, so the same byte budget admits more lanes when
      memory binds.
    * **Prefix reuse** -- full prompt pages are content-addressed after
      prefill; a later prompt sharing the prefix re-acquires the cached
      pages and prefills only its suffix (an extend prefill through K3's
      ``q_offset``).
    * **Page growth + preemption** -- before each segment a lane gets the
      pages its writes can reach; on exhaustion the youngest lane is
      preempted, its pages freed and the request re-queued at the head of
      the pending list, resuming later by re-prefilling prompt +
      generated prefix.  The oldest lane is never preempted and the pool
      always holds one full sequence, so the loop cannot deadlock.

    The allocator and the pools persist across ``run_lanes`` calls, so the
    prefix cache survives between drains.
    """

    def __init__(self, cfg, state_dict=None, replica_id: int = 0,
                 seed: int = 0, max_len: int = 256, segment_len: int = 16,
                 n_lanes: int = 4, budget_bytes: Optional[int] = None,
                 page_size: int = 16, device=None, draft_cfg=None,
                 draft_state_dict=None, draft_k: int = 0,
                 draft_seed: int = 0):
        # refused before any weight is built (the JAX engine's message)
        if not _bucket_safe(cfg):
            raise ValueError("block-paged KV needs a pure-attention stack "
                             f"(got pattern {cfg.block_pattern})")
        super().__init__(cfg, state_dict=state_dict, replica_id=replica_id,
                         seed=seed, max_len=max_len, segment_len=segment_len,
                         n_lanes=n_lanes, budget_bytes=budget_bytes,
                         device=device, draft_cfg=draft_cfg,
                         draft_state_dict=draft_state_dict, draft_k=draft_k,
                         draft_seed=draft_seed)
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} not a multiple of "
                             f"page_size {page_size}")
        self.page_size = int(page_size)
        page_bytes = self.page_size * max(1, self._bytes_per_token)
        # a speculative lane's draft ring, in target pages (ceil):
        # anonymous pages the admission layer charges per lane
        self._overhead_pages = -(-max_len * self._draft_bytes_per_token
                                 // page_bytes) if self.speculative else 0
        # the same byte budget as the worst-case engine, in pages (floor);
        # never below one full sequence (plus its draft overhead), so a
        # solo lane always fits
        self.n_pages = max(pages_for(max_len, self.page_size)
                           + self._overhead_pages,
                           self.budget_bytes // page_bytes)
        self.allocator = BlockAllocator(self.n_pages, self.page_size)
        if self.speculative:
            self._lane_decoder = SpeculativePagedLaneDecoder(
                self.lm, self.draft_lm, max_len, self.n_lanes, segment_len,
                n_pages=self.n_pages + 1, page_size=self.page_size,
                draft_k=self.draft_k)
        else:
            self._lane_decoder = PagedLaneDecoder(
                self.lm, max_len, self.n_lanes, segment_len,
                n_pages=self.n_pages + 1, page_size=self.page_size)
        self._deferred: set = set()    # req_ids preempted at this boundary
        self._caches = None            # pools retained between runs

    def engine_stats(self) -> dict:
        """Adds the pool's page states and prefix-hit accounting."""
        st = super().engine_stats()
        st["pages"] = self.allocator.page_states()
        st["prefix_hits"] = self.allocator.stats["prefix_hits"]
        st["prefix_hit_pages"] = self.allocator.stats["prefix_hit_pages"]
        return st

    # ------------------------------------------------------------ lane hooks
    def _new_manager(self):
        self.allocator.reset_transient()   # drop refs an aborted run left
        self._deferred = set()
        return PagedLaneManager(self.n_lanes, self.allocator,
                                self._bytes_per_token, self.max_len,
                                overhead_pages=self._overhead_pages)

    def _init_lanes(self, dec):
        # reuse the previous run's pools: the LRU-parked prefix pages keep
        # their KV.  Without pools (first run, or an aborted one) the
        # content index must go with them.
        caches, self._caches = self._caches, None
        if caches is None:
            self.allocator.drop_cache()
            caches = dec.init_lanes()
        return caches

    def _retain_caches(self, caches) -> None:
        self._caches = caches

    def _boundary_reset(self) -> None:
        # a preempted request may be re-admitted at the NEXT boundary;
        # deferring it for the current one prevents admit/preempt churn
        self._deferred = set()

    def _head_fits(self, mgr, item, ids) -> bool:
        if item["req_id"] in self._deferred:
            return False
        # a preempted request re-admits on its FULL remaining footprint
        # (prefill + every growth page): admitting it into a pool that
        # cannot also hold its growth would just preempt it again
        eff_len = len(ids)
        if item.get("_evictions", 0) > 0:
            eff_len += int(item["max_new"])
        return mgr.can_admit(eff_len, item["max_new"], ids=ids)

    def _admit_item(self, mgr, lane: int, item, ids, t_admit, backfill: bool):
        st = mgr.admit(lane, req_id=item["req_id"], prompt_len=len(ids),
                       max_new=item["max_new"],
                       tenant=item.get("tenant", "default"),
                       admit_t=t_admit, meta=item.get("meta"),
                       backfill=backfill, ids=ids)
        st.evictions = item.get("_evictions", 0)
        st.meta["_ids"] = ids
        st.meta["_resume_tokens"] = list(item.get("_resume_tokens", ()))
        return st

    def _result_tokens(self, state) -> list:
        return list(state.meta.get("_resume_tokens", ())) \
            + list(state.tokens)

    def _prefill_claims(self, mgr, dec, caches, claims, now, tok, plen,
                        produced, max_new, active):
        ps = self.page_size
        P = self.max_len // ps
        cold = [c for c in claims if c[0].prefix_len == 0]
        warm = [c for c in claims if c[0].prefix_len > 0]
        # cold prompts: grouped full prefill (as the ring engine's), then
        # the prompt pages are scattered into the pool
        groups: dict = {}
        for claim in cold:
            groups.setdefault(bucket_for(len(claim[2]), self.buckets),
                              []).append(claim)
        for bucket, group in groups.items():
            logits, pcache, plens = self._run_prefill_group(
                [ids for _, _, ids, _ in group], pad_rows=self.n_lanes)
            first = logits.argmax(dim=-1).cpu().numpy()
            k = len(group)
            bt_rows = np.zeros((k, P), np.int32)
            tgt = np.zeros((k, -(-bucket // ps)), np.int32)
            for r, (st, lane, ids, mx) in enumerate(group):
                bt_rows[r, :len(st.pages)] = st.pages
                npp = pages_for(len(ids), ps)
                tgt[r, :npp] = st.pages[:npp]
            caches = dec.insert_paged(
                caches, [lane for _, lane, _, _ in group], pcache,
                bt_rows, tgt)
            caches = self._insert_draft(
                dec, caches, [lane for _, lane, _, _ in group],
                [ids for _, _, ids, _ in group])
            self._post_insert(group, first, plens, now, tok, plen,
                              produced, max_new, active)
            for st, lane, ids, _ in group:
                mgr.register_prompt(lane, ids)
        # prefix hits: gather the cached pages, prefill only the suffix
        for claim in warm:
            caches = self._extend_prefill(mgr, dec, caches, claim, now,
                                          tok, plen, produced, max_new,
                                          active)
        return caches

    def _extend_prefill(self, mgr, dec, caches, claim, now, tok, plen,
                        produced, max_new, active):
        st, lane, ids, mx = claim
        ps = self.page_size
        P = self.max_len // ps
        n_match = st.prefix_len // ps
        Bf = bucket_for(len(ids), self.buckets)
        nf = -(-Bf // ps)
        pre_pages = np.zeros(nf, np.int32)
        pre_pages[:n_match] = st.pages[:n_match]
        pre_cache = dec.gather_prefix(caches, pre_pages, st.prefix_len)
        Ls = len(ids) - st.prefix_len
        Bs = min(bucket_for(Ls, self.buckets), nf * ps - st.prefix_len)
        toks = np.zeros((1, Bs), np.int64)
        toks[0, :Ls] = ids[st.prefix_len:]
        logits, pcache = self.lm.prefill(
            torch.from_numpy(toks).to(self.device), prompt_len=Ls,
            cache=pre_cache, fill_to=len(ids))
        first = logits.argmax(dim=-1).cpu().numpy()
        npp = pages_for(len(ids), ps)
        bt_rows = np.zeros((1, P), np.int32)
        bt_rows[0, :len(st.pages)] = st.pages
        tgt = np.zeros((1, nf), np.int32)
        # only the NEW pages are scattered; the matched prefix already
        # lives in the pool (and may be shared -- it must not be rewritten)
        tgt[0, n_match:npp] = st.pages[n_match:npp]
        caches = dec.insert_paged(caches, [lane], pcache, bt_rows, tgt)
        caches = self._insert_draft(dec, caches, [lane], [ids])
        self._post_insert([claim], first, [len(ids)], now, tok, plen,
                          produced, max_new, active)
        mgr.register_prompt(lane, ids)
        return caches

    def _post_release(self, dec, caches, lanes):
        # scrub the released lanes' block tables: their dead writes (the
        # lane keeps stepping while inactive) must land on the trash page,
        # never on a page the allocator may hand to someone else
        rows = np.zeros((len(lanes), self.max_len // self.page_size),
                        np.int32)
        return dec.set_bt(caches, list(lanes), rows)

    def _pre_segment(self, mgr, dec, caches, tok, produced, plen, max_new,
                     active, dev, pending):
        ps = self.page_size
        P = self.max_len // ps
        # speculative segments write verify positions ahead of the fill
        # level (rounds x (K+1) slots); an unallocated page would route
        # those writes to the trash page and lose real K/V
        K = self._growth_span
        changed = False
        new_rows: dict = {}                   # lane -> block-table row
        order = sorted(mgr.busy_lanes(),
                       key=lambda ln: mgr.lanes[ln].meta["_admit_seq"])
        for lane in order:
            st = mgr.lanes[lane]
            if st is None:                    # preempted earlier this pass
                continue
            # pages for every slot the coming segment can write: the next
            # write lands at plen + produced - 1
            target = min(self.max_len,
                         int(plen[lane]) + int(produced[lane]) + K - 1)
            need = pages_for(target, ps)
            if need <= len(st.pages):
                continue
            while not mgr.grow(lane, need):
                seq = st.meta["_admit_seq"]
                younger = [ln for ln in mgr.busy_lanes()
                           if mgr.lanes[ln].meta["_admit_seq"] > seq]
                victim = max(younger, key=lambda ln:
                             mgr.lanes[ln].meta["_admit_seq"]) \
                    if younger else lane
                self._preempt_lane(mgr, victim, active, dev, pending)
                new_rows[victim] = np.zeros(P, np.int32)
                changed = True
                if victim == lane:
                    break
            if mgr.lanes[lane] is st:         # grown (not self-preempted)
                row = np.zeros(P, np.int32)
                row[:len(st.pages)] = st.pages
                new_rows[lane] = row
        if new_rows:
            idx = sorted(new_rows)
            caches = dec.set_bt(caches, idx,
                                np.stack([new_rows[i] for i in idx]))
        return caches, changed

    def _preempt_lane(self, mgr, lane, active, dev, pending) -> None:
        """Free a lane's pages mid-flight and requeue the request at the
        head of the pending list (it was admitted earliest).  The resume
        item re-prefills prompt + generated prefix, so the final token
        sequence matches an uninterrupted run."""
        dev["d"] = None
        st = mgr.preempt(lane)
        active[lane] = False
        meta = {k: v for k, v in st.meta.items()
                if k not in ("_admit_seq", "_ids", "_resume_tokens")}
        pending.insert(0, {
            "req_id": st.req_id,
            "ids": np.concatenate([
                np.asarray(st.meta["_ids"], np.int64).reshape(-1),
                np.asarray(st.tokens, np.int64)]),
            "max_new": st.max_new - len(st.tokens),
            "tenant": st.tenant, "meta": meta,
            "_evictions": st.evictions,
            "_resume_tokens": st.meta["_resume_tokens"] + list(st.tokens),
        })
        self._deferred.add(st.req_id)
