"""Fused greedy generation (port of ``repro.serving.generate.FusedDecoder``,
``LaneDecoder``, ``PagedLaneDecoder``, the speculative ``SpeculativeDecoder``
and the speculative lane decoders) and the prefill bucket helpers.

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

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.models.model import KVCache


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


def _first(mask):
    """Index of the first True along the last dim (0 if none): ``argmax``
    returns the first maximal index and takes no bool on CUDA."""
    return mask.to(torch.uint8).argmax(dim=-1)


def _check_draft(lm, draft_lm, draft_k: int) -> None:
    if draft_k < 1:
        raise ValueError("draft_k must be >= 1 (K=0 is the fused path)")
    if lm.cfg.vocab_size != draft_lm.cfg.vocab_size:
        raise ValueError(f"draft/target vocab mismatch: "
                         f"{draft_lm.cfg.vocab_size} vs {lm.cfg.vocab_size}")


class SpeculativeDecoder:
    """Serial draft-verify greedy decoder (speculative decoding, B=1).

    Each *round* runs the draft model ``draft_k`` steps to propose a token
    chain, scores the pending token plus the chain with ONE W = K + 1
    position target forward (``LM.verify_step``) and accepts the longest
    prefix of drafts that match the target's own greedy argmaxes.  Every
    emitted token is a target argmax conditioned on accepted context, so
    the tokens equal plain greedy decode's; speculation only changes how
    many target forwards they cost.

    Round semantics (the JAX decoder's):

    * verify feeds ``[pending, d_1..d_K]`` at fill levels ``t..t+K`` and
      takes the target argmaxes ``a_0..a_K``;
    * ``m`` = the longest prefix with ``d_i == a_{i-1}``; the round emits
      ``a_0..a_m`` (a full match emits K + 1 tokens, the last the *bonus*
      ``a_K``), cut by the serial stop rules in the oracle's order: EOS
      inside the block, then the ring capacity and the request budget;
    * commit is by fill level only, on both caches: rejected drafts roll
      back by not advancing ``t`` (stale K/V above it stays masked and is
      overwritten in order later);
    * after a full accept the draft cache is one token short (it never
      consumed ``d_K``): the next round's *catch-up step* feeds that tail
      first and resets the draft fill on the device.  Without a tail the
      step dummy-feeds the pending token: the fill reset voids it, the
      chain's first write overwrites its slot, and its logits are unused.

    A live round always emits at least one token, so all-rejected rounds
    still progress.  The round runs on the device; the host reads the
    emitted tokens and their count once per round, in one transfer, and
    knows the request budget left from them (the round's cap).
    """

    def __init__(self, lm, draft_lm, max_len: int, draft_k: int):
        _check_draft(lm, draft_lm, draft_k)
        self.lm = lm
        self.draft_lm = draft_lm
        self.max_len = max_len
        self.draft_k = int(draft_k)

    @torch.no_grad()
    def _round(self, cache, dcache, st, budget: int, eos: int):
        """One draft-verify-commit round on the device.  ``st`` holds the
        device carries: ``tok`` (1, 1) pending token, ``has_tail`` and
        ``tail`` (0-d) the draft catch-up state, all updated in place.
        ``budget`` caps the tokens the round may emit (the window and the
        request budget left).  Returns (emit (K+1,) -1-padded, n_emit)."""
        K = self.draft_k
        W = K + 1
        tok, has_tail, tail = st["tok"], st["has_tail"], st["tail"]
        # --- draft: catch-up step + K chained steps ---------------------
        d0 = dcache.t.clone()
        self.draft_lm.decode_step(
            dcache, torch.where(has_tail, tail, tok[0, 0]).view(1, 1))
        dcache.t.copy_(d0 + has_tail.to(torch.int32))
        cur, chain = tok, []
        for _ in range(K):
            cur = self.draft_lm.decode_step(dcache, cur).argmax(dim=-1) \
                .view(1, 1)
            chain.append(cur)
        d = torch.cat(chain, dim=1)[0]                     # (K,)
        # --- verify: one W-position target forward ----------------------
        base_t = cache.t.clone()
        a = self.lm.verify_step(cache, torch.cat([tok, d.view(1, K)], 1)) \
            [0].argmax(dim=-1)                             # (W,)
        # --- acceptance: longest matching prefix, oracle stop order -----
        m_chain = torch.cumprod((d == a[:K]).long(), 0).sum()
        cap = torch.clamp(m_chain + 1, max=budget)
        idx = torch.arange(W, device=a.device)
        is_eos = (a == eos) & (idx < cap)
        n_emit = torch.where(is_eos.any(), _first(is_eos) + 1, cap)
        # --- commit -----------------------------------------------------
        emit = torch.where(idx < n_emit, a, torch.full_like(a, -1))
        tok.copy_(a.gather(0, (n_emit - 1).view(1)).view(1, 1))
        cache.t.copy_(base_t + n_emit)
        dcache.t.copy_(base_t + torch.clamp(n_emit, max=K))
        full = n_emit == W
        has_tail.copy_(full)
        tail.copy_(d[K - 1])
        return emit, n_emit

    def decode(self, cache, dcache, first_token: int, prompt_len: int,
               max_new_tokens: int, eos_id: Optional[int] = None,
               cancel_check=None, on_segment=None) -> dict:
        """Greedy-decode from prefilled target and draft caches (updated
        in place).  Mirrors :meth:`FusedDecoder.decode` (same result keys,
        the same cancel and streaming join points: every round is a
        segment), plus ``drafted``/``accepted`` counters (``accepted /
        drafted`` is the observed acceptance rate)."""
        K = self.draft_k
        out = [int(first_token)]
        if on_segment is not None:
            on_segment([int(first_token)])
        dev = self.lm.device
        st = {"tok": torch.full((1, 1), int(first_token), dtype=torch.long,
                                device=dev),
              "has_tail": torch.zeros((), dtype=torch.bool, device=dev),
              "tail": torch.zeros((), dtype=torch.long, device=dev)}
        eos = -1 if eos_id is None else int(eos_id)
        cancelled = False
        rounds = drafted = accepted = 0

        def budget() -> int:
            return min(self.max_len - prompt_len - len(out),
                       max_new_tokens - len(out))

        # the oracle's stop order (EOS, window, request budget), checked
        # on the host: an already complete request runs zero rounds
        while out[-1] != eos and budget() > 0:
            if cancel_check is not None and cancel_check():
                cancelled = True
                break
            emit, n_emit = self._round(cache, dcache, st, budget(), eos)
            host = torch.cat([emit, n_emit.view(1)]).tolist()  # one read
            new = host[:host[-1]]
            rounds += 1
            drafted += K
            accepted += len(new) - 1
            out.extend(new)
            if on_segment is not None:
                on_segment(new)
        return {"tokens": out, "cancelled": cancelled, "segments": rounds,
                "cache": cache, "draft_cache": dcache, "drafted": drafted,
                "accepted": accepted}


class LaneDecoder:
    """Lane-batched segmented greedy decoder: ``n_lanes`` concurrent
    requests stepping together through one natively batched
    ``decode_step`` per token.

    The lanes share one ring ``KVCache`` whose fill level is a (lanes,)
    vector, so lanes prefilled at different prompt lengths write their
    next K/V at their own ring slots, take their own RoPE positions and
    attend their own windows (K1 reads ``t[b]`` per lane).  Per lane the
    arithmetic is the B=1 computation of the serial path; only the GEMMs
    see the lane batch.

    Segment semantics follow the JAX ``LaneDecoder``:

    * the per-lane stop predicate (EOS, ``max_len`` ring budget,
      ``max_new`` request budget) is evaluated on the device every step;
      a stopped lane keeps its token and count frozen while the others
      continue, and its cache receives dead writes that never reach
      another lane and that the back-fill prefill overwrites wholesale;
    * the host reads the per-lane token buffer once per segment;
    * segment boundaries are the join points where the engine retires
      finished lanes and back-fills vacant ones (:meth:`insert_lanes`).

    One difference: the JAX loop ends a segment on the device as soon as
    every lane has stopped.  Here the segment's length is fixed on the
    host before it launches, from the budgets the host knows
    (:meth:`segment_steps`: the longest live lane's remaining window and
    request budget, capped at ``segment_len``), and only EOS is left to
    the device mask.  A segment in which every lane meets EOS early
    therefore runs on to its planned end: tokens are unchanged (the
    masked lanes emit nothing).  ``dead_steps`` -- occupied lanes' steps
    taken while stopped -- counts only steps in which some lane is still
    live, so it equals the JAX loop's.
    """

    def __init__(self, lm, max_len: int, n_lanes: int, segment_len: int = 16):
        if segment_len < 1 or n_lanes < 1:
            raise ValueError("segment_len and n_lanes must be >= 1")
        self.lm = lm
        self.max_len = max_len
        self.n_lanes = n_lanes
        self.segment_len = segment_len

    # ------------------------------------------------------------ lane admin
    def init_lanes(self):
        """Zero ring caches for ``n_lanes`` sequences, with (lanes,) fill
        levels."""
        cache = self.lm.init_cache(self.n_lanes, self.max_len)
        cache.t = torch.zeros(self.n_lanes, dtype=torch.int32,
                              device=self.lm.device)
        return cache

    def insert_lanes(self, lanes, lane_idx, cache):
        """Drop a k-row prefill cache (padded to ``max_len`` slots, per-row
        fill levels) into lanes ``lane_idx``, in place: every slot of those
        lanes is overwritten, so a retired lane's dead writes are gone.
        The other layers' per-sequence states (Mamba, mLSTM, sLSTM, image
        K/V) of those lanes are replaced whole by the prefill's (the JAX
        ``tree.map`` insert)."""
        idx = torch.as_tensor(lane_idx, dtype=torch.long,
                              device=lanes.k.device)
        lanes.k.index_copy_(1, idx, cache.k)
        lanes.v.index_copy_(1, idx, cache.v)
        lanes.t.index_copy_(0, idx, cache.t.reshape(-1).to(torch.int32))
        for name, state in lanes.states():
            state.index_copy_(1, idx, getattr(cache, name))
        return lanes

    # -------------------------------------------------------------- segments
    def segment_steps(self, tok, produced, plen, max_new, active,
                      eos: int) -> int:
        """Steps the coming segment runs (host numpy lane arrays): the most
        any live lane may still take, capped at ``segment_len``; 0 when no
        lane is live.  Live is the serial oracle's predicate, in its
        order: not EOS, inside the window, inside the request budget."""
        live = active & (tok != eos) & (plen + produced < self.max_len) \
            & (produced < max_new)
        if not live.any():
            return 0
        left = np.minimum(self.max_len - plen - produced,
                          max_new - produced)[live]
        return int(min(self.segment_len, left.max()))

    @torch.no_grad()
    def run_segment(self, caches, dev, steps: int, eos: int):
        """Run ``steps`` decode steps across all lanes on the device.

        ``dev`` holds the device lane arrays (tok, produced, plen,
        max_new, active), all (C,); tok and produced advance in place for
        live lanes.  Returns (buf (C, steps) int64 host array with -1
        where a lane emitted nothing, dead lane-steps), read from the
        device in ONE transfer."""
        tok, produced, plen, max_new, active = dev
        C = self.n_lanes
        if steps == 0:
            return np.full((C, 0), -1, np.int64), 0
        buf = torch.empty((C, steps), dtype=torch.long, device=tok.device)
        dead = torch.zeros((), dtype=torch.long, device=tok.device)
        for i in range(steps):
            lv = active & (tok != eos) & (plen + produced < self.max_len) \
                & (produced < max_new)
            # a step counts its stopped lanes only while some lane is
            # live: the JAX loop ends the segment once none is
            dead += (active & ~lv).sum() * lv.any()
            logits = self.lm.decode_step(caches, tok.view(C, 1))
            tok.copy_(torch.where(lv, logits.argmax(dim=-1), tok))
            buf[:, i] = torch.where(lv, tok, torch.full_like(tok, -1))
            produced += lv
        out = torch.cat([buf.view(-1), dead.view(1)]).cpu().numpy()
        return out[:-1].reshape(C, steps), int(out[-1])


class PagedLaneDecoder(LaneDecoder):
    """Lane decoder over a block-paged KV pool (``serving/paging.py``).

    Same segment loop and stop semantics as :class:`LaneDecoder`, but the
    lanes share one ``PagedKVCache``: physical pools addressed through
    per-lane block tables.  Back-fill scatters a contiguous prefill cache
    into the lane's pages, a prefix hit gathers cached pages back into a
    contiguous buffer for an extend prefill, and page growth and release
    only rewrite block-table rows.  Decode reads the pool in place through
    K2.  Every logical slot holds the value the ring path holds, so
    per-lane tokens equal the ring lanes' (tests/test_torch_paging.py).
    """

    def __init__(self, lm, max_len: int, n_lanes: int, segment_len: int = 16,
                 *, n_pages: int, page_size: int):
        super().__init__(lm, max_len, n_lanes, segment_len)
        self.n_pages = int(n_pages)        # physical pool incl. trash page 0
        self.page_size = int(page_size)

    # ------------------------------------------------------------ lane admin
    def init_lanes(self):
        """Zero pools of ``n_pages`` pages plus per-lane block tables (all
        slots 0 = the pinned trash page)."""
        return self.lm.init_paged_cache(self.n_lanes, self.max_len,
                                        self.n_pages, self.page_size)

    def insert_paged(self, lanes, lane_idx, pcache, bt_rows, tgt):
        """Scatter a k-row contiguous prefill cache into the pool.

        ``pcache`` holds (layers, k, Bf, KV, hd) buffers (a bucketed group
        prefill or an extend prefill); ``bt_rows`` (k, P) is each lane's
        full block table; ``tgt`` (k, ceil(Bf / page)) maps each page-sized
        chunk to the physical page that receives it, 0 for pad chunks
        beyond the prompt and for prefix pages whose contents already live
        in the pool (possibly shared).  Chunks bound for page 0 are not
        written at all, so neither a pad chunk nor a duplicate index can
        touch a real page; the real pages are distinct and go in with one
        ``index_copy_`` per pool."""
        ps = self.page_size
        L, k, Bf, KV, hd = pcache.k.shape
        nchunk = -(-Bf // ps)
        tgt = np.asarray(tgt, np.int64).reshape(k, -1)[:, :nchunk]
        rows, chunks = np.nonzero(tgt)
        dev = lanes.k.device
        if len(rows):
            pages = torch.as_tensor(tgt[rows, chunks], device=dev)
            r = torch.as_tensor(rows, device=dev)
            c = torch.as_tensor(chunks, device=dev)
            for pool, buf in ((lanes.k, pcache.k), (lanes.v, pcache.v)):
                if nchunk * ps != Bf:
                    buf = Fn.pad(buf, (0, 0, 0, 0, 0, nchunk * ps - Bf))
                buf = buf.reshape(L, k, nchunk, ps, KV, hd)
                pool.index_copy_(1, pages, buf[:, r, c])
        idx = torch.as_tensor(lane_idx, dtype=torch.long, device=dev)
        lanes.t.index_copy_(0, idx, pcache.t.reshape(-1).expand(k)
                            .to(torch.int32))
        lanes.bt.index_copy_(0, idx, torch.as_tensor(
            np.asarray(bt_rows, np.int32).reshape(k, -1), device=dev))
        return lanes

    def gather_prefix(self, lanes, pages, prefix_len: int) -> KVCache:
        """Materialise cached pages as a contiguous (B=1) ring cache at fill
        level ``prefix_len`` -- the input of an extend prefill.  ``pages``
        (nf,) is the physical page per logical block; entries past the
        matched prefix may be 0 (trash): the extend prefill overwrites
        those slots before anything attends them."""
        dev = lanes.k.device
        idx = torch.as_tensor(np.asarray(pages, np.int64), device=dev)
        L, _, ps, KV, hd = lanes.k.shape
        n = len(pages) * ps
        return KVCache(k=lanes.k[:, idx].reshape(L, 1, n, KV, hd),
                       v=lanes.v[:, idx].reshape(L, 1, n, KV, hd),
                       t=torch.tensor(int(prefix_len), dtype=torch.int32,
                                      device=dev))

    def set_bt(self, lanes, lane_idx, bt_rows):
        """Rewrite block-table rows in place: page growth extends a busy
        lane's table; release zeroes it so the lane's dead writes land on
        the trash page instead of a reallocated page."""
        dev = lanes.bt.device
        idx = torch.as_tensor(lane_idx, dtype=torch.long, device=dev)
        lanes.bt.index_copy_(0, idx, torch.as_tensor(
            np.asarray(bt_rows, np.int32).reshape(len(lane_idx), -1),
            device=dev))
        return lanes


@dataclass
class SpecLanes:
    """The speculative lanes' state: the target caches in their own
    layout (a ring ``KVCache`` or a ``PagedKVCache``), the draft caches
    always as a per-lane ring, and each lane's catch-up state
    (``has_tail`` (C,) bool, ``tail`` (C,) int64)."""
    tgt: object
    dr: KVCache
    has_tail: torch.Tensor
    tail: torch.Tensor


class _SpecLaneMixin:
    """Draft-verify speculation over a lane decoder's segments (JAX
    ``_SpecLaneMixin``): a segment runs rounds of
    :class:`SpeculativeDecoder` semantics across all lanes at once, with
    one W-position target forward per round for every lane, and commits
    each lane's accepted prefix on its own.  Per lane the emitted tokens
    are target argmaxes on accepted context, so they equal the plain
    lanes' whatever each lane's acceptance.

    The lanes' state is a :class:`SpecLanes`.  Every admission operation
    (:meth:`insert_lanes`, :meth:`insert_paged`, :meth:`gather_prefix`,
    :meth:`set_bt`) acts on the target half; :meth:`insert_draft` drops
    the draft prefill in and clears the lanes' tails.  Rollback is by
    fill level only in both caches.  The draft's ring is charged to the
    engine's budget (or page pool) by the admission layer, but lives in
    buffers of its own.

    A segment runs up to ``rounds = max(1, segment_len // (draft_k + 1))``
    rounds, so it emits at most about ``segment_len`` tokens a lane.  The
    JAX loop ends a segment once no lane is live; here the host plans a
    segment's rounds before it launches (:meth:`segment_steps`: no more
    than the most tokens a live lane may still emit, since a live round
    emits at least one) and the device masks lanes that stop sooner.  A
    round counts W dead positions for each stopped but occupied lane
    only while some lane is live, so ``dead_steps`` equals the JAX
    loop's.  :meth:`run_segment` stashes per-lane ``last_drafted`` /
    ``last_accepted`` (host arrays) for the engine's acceptance
    accounting.
    """

    def _init_spec(self, draft_lm, draft_k: int):
        _check_draft(self.lm, draft_lm, draft_k)
        self.draft_lm = draft_lm
        self.draft_k = int(draft_k)
        self.rounds = max(1, self.segment_len // (self.draft_k + 1))
        self.last_drafted = np.zeros(self.n_lanes, np.int64)
        self.last_accepted = np.zeros(self.n_lanes, np.int64)

    # ------------------------------------------------------------ lane admin
    def init_lanes(self):
        dev = self.lm.device
        dr = self.draft_lm.init_cache(self.n_lanes, self.max_len)
        dr.t = torch.zeros(self.n_lanes, dtype=torch.int32, device=dev)
        return SpecLanes(
            tgt=super().init_lanes(), dr=dr,
            has_tail=torch.zeros(self.n_lanes, dtype=torch.bool, device=dev),
            tail=torch.zeros(self.n_lanes, dtype=torch.long, device=dev))

    def insert_lanes(self, lanes, lane_idx, cache):
        lanes.tgt = super().insert_lanes(lanes.tgt, lane_idx, cache)
        return lanes

    def insert_draft(self, lanes, lane_idx, cache):
        """Drop a k-row draft prefill (padded to ``max_len`` slots) into
        lanes ``lane_idx`` and clear their catch-up tails (a fresh request
        has no pending draft)."""
        LaneDecoder.insert_lanes(self, lanes.dr, lane_idx, cache)
        idx = torch.as_tensor(lane_idx, dtype=torch.long,
                              device=lanes.has_tail.device)
        lanes.has_tail.index_fill_(0, idx, False)
        return lanes

    def insert_paged(self, lanes, lane_idx, pcache, bt_rows, tgt):
        lanes.tgt = super().insert_paged(lanes.tgt, lane_idx, pcache,
                                         bt_rows, tgt)
        return lanes

    def gather_prefix(self, lanes, pages, prefix_len: int):
        return super().gather_prefix(lanes.tgt, pages, prefix_len)

    def set_bt(self, lanes, lane_idx, bt_rows):
        lanes.tgt = super().set_bt(lanes.tgt, lane_idx, bt_rows)
        return lanes

    # -------------------------------------------------------------- segments
    def segment_steps(self, tok, produced, plen, max_new, active,
                      eos: int) -> int:
        """Rounds the coming segment runs (host numpy lane arrays): at most
        ``rounds``, and no more than the most tokens any live lane may
        still emit; 0 when no lane is live."""
        live = active & (tok != eos) & (plen + produced < self.max_len) \
            & (produced < max_new)
        if not live.any():
            return 0
        left = np.minimum(self.max_len - plen - produced,
                          max_new - produced)[live]
        return int(min(self.rounds, left.max()))

    @torch.no_grad()
    def run_segment(self, caches, dev, steps: int, eos: int):
        """Run ``steps`` draft-verify rounds across all lanes on the
        device.  ``dev`` holds the device lane arrays (tok, produced,
        plen, max_new, active), all (C,); tok and produced advance in
        place for live lanes.  Returns (buf (C, steps * (K+1)) int64 host
        array, each lane's emitted tokens first and -1 after, dead
        positions), read from the device in ONE transfer together with
        the per-lane drafted/accepted counts (stashed on the decoder)."""
        tok, produced, plen, max_new, active = dev
        C, K = self.n_lanes, self.draft_k
        W = K + 1
        if steps == 0:
            self.last_drafted = np.zeros(C, np.int64)
            self.last_accepted = np.zeros(C, np.int64)
            return np.full((C, 0), -1, np.int64), 0
        tgt, dr = caches.tgt, caches.dr
        has_tail, tail = caches.has_tail, caches.tail
        d_ = tok.device
        idx_w = torch.arange(W, device=d_)
        buf = torch.full((C, steps * W), -1, dtype=torch.long, device=d_)
        wp = torch.zeros(C, dtype=torch.long, device=d_)
        dead = torch.zeros((), dtype=torch.long, device=d_)
        drafted = torch.zeros(C, dtype=torch.long, device=d_)
        accepted = torch.zeros(C, dtype=torch.long, device=d_)
        for _ in range(steps):
            lv = active & (tok != eos) & (plen + produced < self.max_len) \
                & (produced < max_new)
            lvi = lv.long()
            dead += W * (active & ~lv).sum() * lv.any()
            # --- draft: catch-up step + K chained steps ----------------
            dr_t0 = dr.t.clone()
            self.draft_lm.decode_step(
                dr, torch.where(has_tail, tail, tok).view(C, 1))
            dr.t.copy_(dr_t0 + has_tail.to(torch.int32))
            cur, chain = tok.view(C, 1), []
            for _ in range(K):
                cur = self.draft_lm.decode_step(dr, cur).argmax(dim=-1) \
                    .view(C, 1)
                chain.append(cur)
            d = torch.cat(chain, dim=1)                          # (C, K)
            # --- verify: one W-position target forward -----------------
            base_t = tgt.t.clone()                               # (C,)
            a = self.lm.verify_step(
                tgt, torch.cat([tok.view(C, 1), d], dim=1)).argmax(dim=-1)
            # --- acceptance: longest matching prefix, oracle stops -----
            m_chain = torch.cumprod((d == a[:, :K]).long(), 1).sum(1)
            cap = torch.minimum(m_chain + 1, torch.minimum(
                self.max_len - plen - produced, max_new - produced))
            is_eos = (a == eos) & (idx_w < cap[:, None])
            n_emit = torch.where(is_eos.any(1), _first(is_eos) + 1, cap)
            n_emit = n_emit * lvi
            # --- commit ------------------------------------------------
            # a lane's tokens go to buf[wp, wp + n_emit); the -1 written
            # past them lands on slots later rounds write or leave empty
            buf.scatter_(1, wp[:, None] + idx_w, torch.where(
                idx_w < n_emit[:, None], a, torch.full_like(a, -1)))
            wp += n_emit
            last = a.gather(1, torch.clamp(n_emit - 1, min=0)[:, None])[:, 0]
            tok.copy_(torch.where(lv, last, tok))
            produced += n_emit
            tgt.t.copy_(base_t + n_emit)
            # the draft keeps the accepted drafts only; stopped lanes get
            # their pre-round fill back (their chain steps were dead writes)
            dr.t.copy_(torch.where(lv, base_t + torch.clamp(n_emit, max=K),
                                   dr_t0))
            full = n_emit == W
            has_tail.copy_(torch.where(lv, full, has_tail))
            tail.copy_(torch.where(lv & full, d[:, K - 1], tail))
            drafted += K * lvi
            accepted += n_emit - lvi
        out = torch.cat([buf.view(-1), dead.view(1), drafted,
                         accepted]).cpu().numpy()
        n = C * steps * W
        self.last_drafted = out[n + 1:n + 1 + C]
        self.last_accepted = out[n + 1 + C:]
        return out[:n].reshape(C, steps * W), int(out[n])


class SpeculativeLaneDecoder(_SpecLaneMixin, LaneDecoder):
    """Ring-cache lane decoder with draft-verify speculation."""

    def __init__(self, lm, draft_lm, max_len: int, n_lanes: int,
                 segment_len: int = 16, *, draft_k: int):
        LaneDecoder.__init__(self, lm, max_len, n_lanes, segment_len)
        self._init_spec(draft_lm, draft_k)


class SpeculativePagedLaneDecoder(_SpecLaneMixin, PagedLaneDecoder):
    """Block-paged lane decoder with draft-verify speculation: the target
    K/V stays paged (verify reads the pool in place through K2); the
    draft K/V rides a per-lane ring whose footprint the paged admission
    layer charges as anonymous pages."""

    def __init__(self, lm, draft_lm, max_len: int, n_lanes: int,
                 segment_len: int = 16, *, n_pages: int, page_size: int,
                 draft_k: int):
        PagedLaneDecoder.__init__(self, lm, max_len, n_lanes, segment_len,
                                  n_pages=n_pages, page_size=page_size)
        self._init_spec(draft_lm, draft_k)


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
