"""Block-paged KV cache: refcounted pages, block tables, prefix reuse (a
copy of ``repro.serving.paging``; the port imports nothing of the JAX
package).

* the KV pool is carved into fixed ``page_size``-token **pages** shared
  by all lanes; each lane owns a **block table** mapping logical slots
  ``t // page_size`` to physical pages;
* admission charges only the pages the prefill will fill
  (*charge-as-blocks-fill*); decode allocates pages as the sequence
  crosses page boundaries, and exhaustion preempts the youngest-admitted
  lane (its pages are freed, the request re-enters the engine's pending
  list and later resumes by re-prefilling prompt + generated prefix, so
  its tokens stay equal to an uninterrupted run);
* full pages whose KV was computed by prefill are **content-addressed**
  by a chained hash of their token ids; a page whose refcount drops to
  zero parks in an LRU *reclaimable* set instead of being scrubbed, so a
  later request with the same prompt prefix re-acquires the pages and
  prefills only its suffix.

Physical page 0 is reserved as the **trash page**: unallocated block-
table slots point at it, and the decode path routes the dead writes of
stopped lanes (which keep stepping until the segment ends) there, so a
masked lane can never clobber a shared page.

The device side lives in ``models/model.py`` (``PagedKVCache`` and the
paged decode step), ``kernels/paged_decode_attention.py`` (K2) and
``serving/generate.py`` (:class:`PagedLaneDecoder`); the engine
integration is ``serving.engine.PagedBatchedEngine``.  The code below the
imports is the JAX package's, line for line.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.batching import KVBudget, LaneManager, LaneState

TRASH_PAGE = 0


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache slots."""
    if n_tokens <= 0:
        return 0
    return -(-int(n_tokens) // int(page_size))


def chain_hashes(token_ids: Sequence[int], page_size: int) -> List[bytes]:
    """Content hash per *full* page, chained so a page's hash commits to
    every token before it (causal KV: the values inside page ``i`` depend
    on all tokens ``< (i+1) * page_size``, so equal chained hashes imply
    bitwise-equal page contents under greedy prefill)."""
    out: List[bytes] = []
    prev = b""
    n_full = len(token_ids) // page_size
    for i in range(n_full):
        chunk = token_ids[i * page_size:(i + 1) * page_size]
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(b",".join(str(int(t)).encode() for t in chunk))
        prev = h.digest()
        out.append(prev)
    return out


class PageError(RuntimeError):
    """Raised on allocation from an exhausted pool (engine bug: callers
    must check :meth:`BlockAllocator.can_allocate` / preempt first)."""


class BlockAllocator:
    """Refcounted fixed-size page pool with an LRU prefix cache.

    Every usable page is in exactly one of three states:

    * **free** — never registered (or content invalidated); in ``_free``;
    * **cached** — refcount 0 but content-addressed (hash registered);
      parked in the ``_lru`` OrderedDict, reclaimable in LRU order;
    * **held** — refcount >= 1, owned by one or more live sequences.

    ``n_pages`` counts usable pages; the trash page (physical id 0) is
    extra and permanently pinned, so physical ids run ``0..n_pages``.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise ValueError(f"need >= 1 usable page, got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # physical ids: 0 = trash (pinned), 1..n_pages usable
        self.refcount = [1] + [0] * self.n_pages
        self._free: deque = deque(range(1, self.n_pages + 1))
        self._lru: "OrderedDict[int, bytes]" = OrderedDict()  # page -> hash
        self._page_hash: Dict[int, bytes] = {}                # held+cached
        self._table: Dict[bytes, int] = {}                    # hash -> page
        self.stats = {"allocated": 0, "freed": 0, "prefix_queries": 0,
                      "prefix_hits": 0, "prefix_hit_pages": 0,
                      "cache_evictions": 0, "registered": 0, "peak_used": 0}

    # ------------------------------------------------------------- accounting
    @property
    def used_pages(self) -> int:
        """Pages held by live sequences (refcount >= 1, trash excluded)."""
        return self.n_pages - len(self._free) - len(self._lru)

    @property
    def reclaimable_pages(self) -> int:
        return len(self._free) + len(self._lru)

    def page_states(self) -> dict:
        """Pool occupancy by state: ``free`` (never/no-longer mapped),
        ``cached`` (LRU-parked prefix pages, reclaimable), ``held``
        (referenced by live sequences).  free+cached+held == total."""
        return {"total": self.n_pages, "free": len(self._free),
                "cached": len(self._lru), "held": self.used_pages}

    def can_allocate(self, n: int) -> bool:
        return n <= self.reclaimable_pages

    # ------------------------------------------------------------- allocation
    def _pop_page(self) -> int:
        if self._free:
            return self._free.popleft()
        # reclaim the least-recently-parked cached page; its content is
        # gone from the index, so future prefixes can no longer hit it
        page, h = self._lru.popitem(last=False)
        del self._table[h]
        del self._page_hash[page]
        self.stats["cache_evictions"] += 1
        return page

    def allocate(self, n: int) -> List[int]:
        """All-or-nothing grab of ``n`` fresh pages (refcount 1 each)."""
        if not self.can_allocate(n):
            raise PageError(f"out of pages: want {n}, "
                            f"reclaimable {self.reclaimable_pages}")
        pages = []
        for _ in range(n):
            p = self._pop_page()
            self.refcount[p] = 1
            pages.append(p)
        self.stats["allocated"] += n
        self.stats["peak_used"] = max(self.stats["peak_used"],
                                      self.used_pages)
        return pages

    def acquire(self, page: int) -> None:
        """Take one more reference on an existing page (prefix share);
        revives a cached (refcount-0) page out of the LRU."""
        if page == TRASH_PAGE:
            raise ValueError("cannot acquire the trash page")
        if self.refcount[page] == 0:
            if page not in self._lru:
                raise ValueError(f"page {page} is free, not cached")
            del self._lru[page]
        self.refcount[page] += 1
        self.stats["peak_used"] = max(self.stats["peak_used"],
                                      self.used_pages)

    def release(self, page: int) -> None:
        """Drop one reference; at zero the page parks in the LRU if its
        content is registered, else returns to the free list."""
        if page == TRASH_PAGE:
            raise ValueError("cannot release the trash page")
        if self.refcount[page] <= 0:
            raise ValueError(f"double free of page {page}")
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            h = self._page_hash.get(page)
            if h is not None:
                self._lru[page] = h
            else:
                self._free.append(page)
            self.stats["freed"] += 1

    def release_seq(self, pages: Sequence[int]) -> None:
        for p in pages:
            self.release(p)

    # ------------------------------------------------------------ prefix reuse
    def probe_prefix(self, hashes: Sequence[bytes]) -> int:
        """Longest registered prefix (in pages) — no refcount changes."""
        n = 0
        for h in hashes:
            if h not in self._table:
                break
            n += 1
        return n

    def match_prefix(self, token_ids: Sequence[int],
                     acquire: bool = True) -> Tuple[int, List[int]]:
        """Longest usable cached prefix of ``token_ids``.

        Returns ``(n_tokens, pages)``.  Only *full* pages match, and the
        hit is capped one token short of the prompt so a resumed prefill
        always has >= 1 suffix token to produce last-position logits.
        With ``acquire`` the pages are referenced (caller owns them).
        """
        self.stats["prefix_queries"] += 1
        cap = (len(token_ids) - 1) // self.page_size
        if cap <= 0:
            return 0, []
        hashes = chain_hashes(token_ids, self.page_size)[:cap]
        n = self.probe_prefix(hashes)
        if n == 0:
            return 0, []
        pages = [self._table[h] for h in hashes[:n]]
        if acquire:
            for p in pages:
                self.acquire(p)
        self.stats["prefix_hits"] += 1
        self.stats["prefix_hit_pages"] += n
        return n * self.page_size, pages

    def register(self, pages: Sequence[int], hashes: Sequence[bytes]) -> None:
        """Content-address held pages (after prefill computed their KV).
        A hash already registered to a *different* page keeps the first
        mapping (dedup of the index, not of storage)."""
        for p, h in zip(pages, hashes):
            if h in self._table:
                continue
            old = self._page_hash.get(p)
            if old is not None:
                # page re-used for new content under the same owner
                self._table.pop(old, None)
            self._table[h] = p
            self._page_hash[p] = h
            self.stats["registered"] += 1

    def invalidate(self, page: int) -> None:
        """Drop a held page's content address (its bytes are about to be
        overwritten with unrelated KV)."""
        h = self._page_hash.pop(page, None)
        if h is not None and self._table.get(h) == page:
            del self._table[h]

    def reset_transient(self) -> None:
        """Release every live reference (crash recovery between runs):
        registered pages park in the LRU — the prefix cache survives —
        and anonymous pages return to the free list."""
        for p in range(1, self.n_pages + 1):
            while self.refcount[p] > 0:
                self.release(p)

    def drop_cache(self) -> None:
        """Forget every cached (LRU-parked) prefix page.  The engine
        calls this whenever it rebuilds the device pools from scratch —
        the pages' contents no longer exist, so advertising their hashes
        would serve zeros to the next prefix hit."""
        while self._lru:
            p, _ = self._lru.popitem(last=False)
            self.invalidate(p)
            self._free.append(p)

    # --------------------------------------------------------------- checking
    def check(self) -> None:
        """Invariants (test hook): refcounts never negative, conservation
        (free + cached + held == n_pages), index consistency."""
        assert self.refcount[TRASH_PAGE] >= 1, "trash page unpinned"
        held = 0
        for p in range(1, self.n_pages + 1):
            rc = self.refcount[p]
            assert rc >= 0, f"negative refcount on page {p}: {rc}"
            held += rc > 0
        free, cached = len(self._free), len(self._lru)
        assert free + cached + held == self.n_pages, \
            (free, cached, held, self.n_pages)
        assert not (set(self._free) & set(self._lru)), "page in two states"
        for p in self._lru:
            assert self.refcount[p] == 0, f"cached page {p} is held"
        for h, p in self._table.items():
            assert self._page_hash.get(p) == h, f"index skew on page {p}"


class PagedLaneManager(LaneManager):
    """Lane occupancy with charge-as-blocks-fill admission.

    Same interface/stats as :class:`~repro.serving.batching.LaneManager`
    (the engine drives both through one code path) but memory accounting
    runs in pages through a shared :class:`BlockAllocator`:

    * :meth:`can_admit` asks whether the *prompt's* non-shared pages fit
      — not the worst case; decode growth is paid later, page by page
      (:meth:`grow`), with preemption on exhaustion;
    * admission takes references on cached prefix pages (prefix reuse)
      and allocates only the suffix;
    * retire/evict release the lane's pages — content-addressed ones
      park in the allocator's LRU and seed future prefix hits.

    The byte-denominated ``budget`` is kept in sync with the allocator
    (``used = used_pages * page_bytes``) so budget-style reporting
    (``peak_bytes``) stays comparable with the worst-case manager.
    """

    def __init__(self, n_lanes: int, allocator: BlockAllocator,
                 bytes_per_token: int, capacity: int,
                 overhead_pages: int = 0):
        page_bytes = allocator.page_size * max(1, int(bytes_per_token))
        budget = KVBudget(max(1, allocator.n_pages * page_bytes))
        super().__init__(n_lanes, budget, bytes_per_token, capacity)
        need_solo = pages_for(capacity, allocator.page_size) \
            + int(overhead_pages)
        if allocator.n_pages < need_solo:
            raise ValueError(
                f"pool of {allocator.n_pages} pages cannot hold one "
                f"full sequence of {capacity} tokens at page_size "
                f"{allocator.page_size} plus {overhead_pages} overhead "
                f"pages (need {need_solo})")
        self.allocator = allocator
        self.page_size = allocator.page_size
        self._page_bytes = page_bytes
        self._admit_seq = 0
        # fixed per-lane ANONYMOUS page charge (speculative decoding: the
        # draft model's ring KV is real memory the pool must account for,
        # even though it is never content-addressed or block-mapped)
        self.overhead_pages = int(overhead_pages)
        self._overhead: dict = {}            # lane -> anonymous pages
        self.stats["preemptions"] = 0

    # -------------------------------------------------------------- plumbing
    def _sync_budget(self) -> None:
        used = self.allocator.used_pages * self._page_bytes
        self.budget.used_bytes = used
        self.budget.peak_bytes = max(self.budget.peak_bytes, used)

    def footprint(self, prompt_len: int, max_new: int) -> int:
        """Bytes charged AT ADMISSION: the prompt's pages only."""
        tokens = min(self.capacity, int(prompt_len))
        return pages_for(tokens, self.page_size) * self._page_bytes

    # -------------------------------------------------------------- admission
    def can_admit(self, prompt_len: int, max_new: int,
                  ids: Optional[Sequence[int]] = None) -> bool:
        """Do the prompt's *non-shared* pages fit right now?  Cached
        prefix pages cost nothing extra (acquiring them removes them
        from the reclaimable set but they already hold the right KV).
        An idle manager admits unconditionally — the constructor
        guarantees the pool holds one full sequence."""
        if not self.busy_lanes():
            return True
        want = pages_for(min(self.capacity, int(prompt_len)), self.page_size)
        hit_pages = 0
        if ids is not None and len(ids):
            cap = (len(ids) - 1) // self.page_size
            if cap > 0:
                hashes = chain_hashes(ids, self.page_size)[:cap]
                hit_pages = self.allocator.probe_prefix(hashes)
        return self.allocator.can_allocate(
            max(0, want - hit_pages) + self.overhead_pages)

    def admit(self, lane: int, *, req_id: int, prompt_len: int,
              max_new: int, tenant: str = "default", admit_t: float = 0.0,
              meta: Optional[dict] = None, backfill: bool = False,
              ids: Optional[Sequence[int]] = None) -> LaneState:
        """Admit with prefix matching: reference the cached prefix pages,
        allocate pages for the rest of the prompt.  ``ids`` is the full
        prefill input (prompt + any resume prefix)."""
        if self.lanes[lane] is not None:
            raise ValueError(f"lane {lane} is occupied")
        n_tok = min(self.capacity, int(prompt_len))
        hit_tokens, pages = (0, [])
        if ids is not None and len(ids):
            hit_tokens, pages = self.allocator.match_prefix(ids)
        try:
            fresh = self.allocator.allocate(
                pages_for(n_tok, self.page_size) - len(pages))
        except PageError:
            self.allocator.release_seq(pages)
            raise
        try:
            self._overhead[lane] = self.allocator.allocate(
                self.overhead_pages)
        except PageError:
            self.allocator.release_seq(pages + fresh)
            raise
        pages = pages + fresh
        self._sync_budget()
        st = LaneState(lane=lane, req_id=req_id, prompt_len=int(prompt_len),
                       max_new=int(max_new), tenant=tenant,
                       footprint_bytes=(len(pages) + self.overhead_pages)
                       * self._page_bytes,
                       admit_t=admit_t, meta=dict(meta or {}))
        st.pages = pages
        st.prefix_len = hit_tokens
        self._admit_seq += 1
        st.meta["_admit_seq"] = self._admit_seq
        self.lanes[lane] = st
        self.stats["admitted"] += 1
        if backfill:
            self.stats["backfills"] += 1
        return st

    # ----------------------------------------------------------------- growth
    def grow(self, lane: int, need_pages: int) -> bool:
        """Extend a lane's block table to ``need_pages`` pages; False on
        exhaustion (caller preempts and retries)."""
        st = self.lanes[lane]
        extra = int(need_pages) - len(st.pages)
        if extra <= 0:
            return True
        if not self.allocator.can_allocate(extra):
            return False
        st.pages.extend(self.allocator.allocate(extra))
        st.footprint_bytes = len(st.pages) * self._page_bytes
        self._sync_budget()
        return True

    def youngest_busy(self) -> Optional[int]:
        """Preemption victim: the most recently admitted busy lane."""
        busy = self.busy_lanes()
        if not busy:
            return None
        return max(busy, key=lambda ln: self.lanes[ln].meta["_admit_seq"])

    def register_prompt(self, lane: int, ids: Sequence[int]) -> None:
        """Content-address the lane's full prompt pages (post-prefill)."""
        st = self.lanes[lane]
        hashes = chain_hashes(ids, self.page_size)
        self.allocator.register(st.pages[:len(hashes)], hashes)

    # ---------------------------------------------------------------- release
    def _release_lane(self, lane: int) -> LaneState:
        st = self.lanes[lane]
        if st is None:
            raise ValueError(f"lane {lane} is already free")
        self.lanes[lane] = None
        self.allocator.release_seq(st.pages)
        self.allocator.release_seq(self._overhead.pop(lane, []))
        self._sync_budget()
        return st

    def retire(self, lane: int) -> LaneState:
        st = self._release_lane(lane)
        self.stats["retired"] += 1
        return st

    def evict(self, lane: int) -> LaneState:
        st = self._release_lane(lane)
        st.evictions += 1
        self.stats["evictions"] += 1
        return st

    def preempt(self, lane: int) -> LaneState:
        """Memory preemption (page exhaustion): like :meth:`evict` but
        counted separately — the request is requeued inside the engine,
        not terminated."""
        st = self._release_lane(lane)
        st.evictions += 1
        self.stats["preemptions"] += 1
        return st
