"""Fused greedy generation (port of ``repro.serving.generate.FusedDecoder``,
``LaneDecoder`` and ``PagedLaneDecoder``) and the prefill bucket helpers.

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
        lanes is overwritten, so a retired lane's dead writes are gone."""
        idx = torch.as_tensor(lane_idx, dtype=torch.long,
                              device=lanes.k.device)
        lanes.k.index_copy_(1, idx, cache.k)
        lanes.v.index_copy_(1, idx, cache.v)
        lanes.t.index_copy_(0, idx, cache.t.reshape(-1).to(torch.int32))
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
