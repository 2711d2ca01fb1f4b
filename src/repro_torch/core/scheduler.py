"""SJF admission queue with the starvation guard (port of
``repro.core.scheduler``: ``Request``, ``ArrayHeap`` and ``SJFQueue``).

The queue is an indexed struct-of-arrays binary min-heap keyed on
ascending ``(policy key, seq)``, plus:

* the starvation guard: before each dispatch, if the longest-waiting
  request has waited more than tau it is promoted to the head regardless
  of its key (tracked through an arrival-order FIFO);
* lazy cancellation: a cancelled entry is marked dead in O(1) and skipped
  at pop time; the heap compacts once the dead outnumber the live.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.policy import get_policy


@dataclass
class Request:
    """One admission-layer request."""
    req_id: int
    prompt: str = ""
    arrival: float = 0.0
    p_long: float = 0.0           # predictor score (priority key under sjf)
    true_service: float = 0.0     # oracle service time (sjf_oracle key)
    klass: str = ""               # "short" | "medium" | "long" (ground truth)
    tenant: str = "default"
    meta: dict = field(default_factory=dict)
    # filled by the dispatcher
    start: Optional[float] = None
    finish: Optional[float] = None
    promoted: bool = False
    cancelled: bool = False


class ArrayHeap:
    """Indexed SoA binary min-heap over ``(key, seq)`` with tombstones.

    Parallel numpy columns (float64 key / int64 seq / int64 id) instead of
    a list of tuples; a position map ``id -> slot`` is maintained through
    sifts so :meth:`kill` is O(1) — mark dead, no re-heapify.  Dead entries
    keep their ordering key, are skipped at pop, and once they outnumber
    the live ones the heap compacts in one vectorized lexsort pass (a
    key-sorted array is a valid binary heap) — amortized O(1) per
    tombstone.
    """

    _MIN_COMPACT = 32     # don't bother compacting tiny heaps

    def __init__(self, capacity: int = 16):
        capacity = max(capacity, 1)
        self._key = np.empty(capacity, np.float64)
        self._seq = np.empty(capacity, np.int64)
        self._id = np.empty(capacity, np.int64)
        self._dead = np.zeros(capacity, bool)
        self._pos: dict[int, int] = {}
        self._n = 0           # slots in use (live + dead)
        self._ndead = 0

    def __len__(self) -> int:
        return self._n - self._ndead

    def _less(self, a: int, b: int) -> bool:
        ka, kb = self._key[a], self._key[b]
        return bool(ka < kb or (ka == kb and self._seq[a] < self._seq[b]))

    def _swap(self, a: int, b: int) -> None:
        k, s, i, d = self._key, self._seq, self._id, self._dead
        k[a], k[b] = k[b], k[a]
        s[a], s[b] = s[b], s[a]
        i[a], i[b] = i[b], i[a]
        d[a], d[b] = d[b], d[a]
        self._pos[int(i[a])] = a
        self._pos[int(i[b])] = b

    def _grow(self) -> None:
        cap = self._key.shape[0] * 2
        for name in ("_key", "_seq", "_id", "_dead"):
            old = getattr(self, name)
            new = np.zeros(cap, old.dtype) if old.dtype == bool \
                else np.empty(cap, old.dtype)
            new[:self._n] = old[:self._n]
            setattr(self, name, new)

    def push(self, key: float, seq: int, item_id: int) -> None:
        slot = self._pos.get(item_id)
        if slot is not None:
            if not self._dead[slot]:
                raise ValueError(f"duplicate heap id {item_id}")
            # cancel-then-retry of the same id: evict the tombstone so the
            # position index stays one-to-one
            self._remove_at(slot)
            self._ndead -= 1
        if self._n == self._key.shape[0]:
            self._grow()
        c = self._n
        self._n += 1
        self._key[c] = key
        self._seq[c] = seq
        self._id[c] = item_id
        self._dead[c] = False
        self._pos[item_id] = c
        self._sift_up(c)

    def _sift_up(self, c: int) -> None:
        while c > 0:
            parent = (c - 1) >> 1
            if not self._less(c, parent):
                break
            self._swap(c, parent)
            c = parent

    def _sift_down(self, c: int) -> None:
        n = self._n
        while True:
            l, r = 2 * c + 1, 2 * c + 2
            smallest = c
            if l < n and self._less(l, smallest):
                smallest = l
            if r < n and self._less(r, smallest):
                smallest = r
            if smallest == c:
                return
            self._swap(c, smallest)
            c = smallest

    def _remove_at(self, slot: int) -> None:
        """Physically delete the entry at ``slot`` (swap-with-last)."""
        last = self._n - 1
        if slot != last:
            self._swap(slot, last)    # moves the victim's pos to `last`...
        self._n = last
        del self._pos[int(self._id[last])]   # ...so delete it afterwards
        if slot < last:
            self._sift_down(slot)
            self._sift_up(slot)

    def _remove_root(self):
        root = (float(self._key[0]), int(self._seq[0]), int(self._id[0]),
                bool(self._dead[0]))
        self._remove_at(0)
        return root

    def kill(self, item_id: int) -> bool:
        """O(1) tombstone; the entry stays in place until popped/compacted."""
        slot = self._pos.get(item_id)
        if slot is None or self._dead[slot]:
            return False
        self._dead[slot] = True
        self._ndead += 1
        if self._ndead > len(self) and self._n >= self._MIN_COMPACT:
            self.compact()
        return True

    def compact(self) -> None:
        """Drop all tombstones in one vectorized pass (sorted => heap)."""
        n = self._n
        live = ~self._dead[:n]
        order = np.lexsort((self._seq[:n][live], self._key[:n][live]))
        for name in ("_key", "_seq", "_id"):
            arr = getattr(self, name)
            arr[:order.shape[0]] = arr[:n][live][order]
        self._n = order.shape[0]
        self._ndead = 0
        self._dead[:self._n] = False
        self._pos = {int(i): s for s, i in enumerate(self._id[:self._n])}

    def pop(self):
        """Min live ``(key, seq, id)``; skips tombstones."""
        while self._n:
            key, seq, item_id, dead = self._remove_root()
            if dead:
                self._ndead -= 1
                continue
            return key, seq, item_id
        raise IndexError("pop from empty heap")

    def peek(self):
        """Min live ``(key, seq, id)`` WITHOUT removing it, or None.
        Dead roots encountered on the way are physically dropped (they
        were already logically deleted), so peek is amortized O(1)."""
        while self._n and self._dead[0]:
            self._remove_at(0)
            self._ndead -= 1
        if not self._n:
            return None
        return float(self._key[0]), int(self._seq[0]), int(self._id[0])


class SJFQueue:
    """Admission queue implementing the paper's dispatch rule."""

    def __init__(self, policy="sjf", tau: Optional[float] = None):
        self.policy_obj = get_policy(policy)
        self.policy = self.policy_obj.name
        self.tau = tau                    # None: no starvation guard
        self._heap = ArrayHeap()
        self._fifo: deque = deque()       # arrival order for starvation guard
        self._seq = itertools.count()
        self._live: dict[int, Request] = {}
        self.stats = {"promotions": 0, "cancellations": 0, "dispatched": 0}

    def __len__(self):
        return len(self._live)

    def push(self, req: Request) -> None:
        key = self.policy_obj.key(req)
        req.meta["queue_key"] = key
        self._live[req.req_id] = req
        self._heap.push(key, next(self._seq), req.req_id)
        self._fifo.append(req)

    def peek(self) -> Optional[tuple]:
        """Best queued ``(key, Request)`` without dispatching."""
        top = self._heap.peek()
        if top is None:
            return None
        key, _, req_id = top
        return key, self._live[req_id]

    def cancel(self, req_id: int) -> bool:
        """Client disconnect while queued: O(1) lazy heap deletion."""
        req = self._live.pop(req_id, None)
        if req is None:
            return False
        req.cancelled = True
        self._heap.kill(req_id)
        self.stats["cancellations"] += 1
        return True

    def remove(self, req_id: int) -> Optional[Request]:
        """Take a live request out without marking it cancelled."""
        req = self._live.pop(req_id, None)
        if req is not None:
            self._heap.kill(req_id)
        return req

    def _starving(self, now: float) -> Optional[Request]:
        if self.tau is None:
            return None
        # drop cancelled or already-dispatched entries from the front
        while self._fifo and (self._fifo[0].cancelled
                              or self._fifo[0].req_id not in self._live):
            self._fifo.popleft()
        if self._fifo and (now - self._fifo[0].arrival) > self.tau:
            return self._fifo[0]
        return None

    def pop(self, now: float) -> Optional[Request]:
        """Next request to dispatch at time ``now`` (None if empty)."""
        victim = self._starving(now)
        if victim is not None:
            # promote the longest-waiting request past the heap; its heap
            # entry becomes a tombstone
            self._fifo.popleft()
            del self._live[victim.req_id]
            self._heap.kill(victim.req_id)
            victim.promoted = True
            self.stats["promotions"] += 1
            self.stats["dispatched"] += 1
            return victim
        if len(self._heap):
            _, _, req_id = self._heap.pop()
            self.stats["dispatched"] += 1
            return self._live.pop(req_id)
        return None
