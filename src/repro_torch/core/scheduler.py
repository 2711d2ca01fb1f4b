"""SJF admission queue with starvation timeout (paper §3.4).

The queue is an **indexed struct-of-arrays binary min-heap**
(:class:`ArrayHeap`) keyed on ascending ``(P(Long), seq)``, plus:

* **starvation guard** — before each dispatch decision, if the longest-waiting
  request has waited more than tau, it is promoted to the head regardless of
  its predicted priority (tracked via an arrival-order FIFO);
* **lazy cancellation** — client disconnects (and guard promotions) mark
  heap entries dead in O(1) via the heap's position index; tombstones are
  skipped at pop time, and when they outnumber live entries the heap
  compacts in one vectorized pass — amortized O(1) per tombstone, never a
  per-element re-heapify;
* **policy pluggability** — the priority key comes from a first-class
  :class:`repro_torch.core.policy.Policy` (FCFS / SJF / oracle / SRPT / quantile /
  MLFQ / fair share are the same queue with different keys), which is how
  the benchmark ablations flip between conditions.  Preemptive policies
  additionally use :meth:`peek` (best queued key without dispatching) and
  :meth:`push_requeue` (re-admission of an evicted request with its
  policy-computed requeue key).

Medium requests get no discrete treatment: the continuous P(Long) score is
the key, producing the smooth ordering gradient described in the paper.

The simulation fast path (``core.sim_fast``) runs this same dispatch rule
over pure arrays in compiled code; this class is the serving-path
(one-request-at-a-time) form.  ``MinHeap`` is the seed tuple heap, kept
as the equivalence oracle.
"""

from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from repro_torch.core.policy import SEED_POLICIES, get_policy

#: Seed policy names (compat alias; the registry holds the full set).
POLICIES = SEED_POLICIES


@dataclass
class Request:
    """One admission-layer request."""
    req_id: int
    prompt: str = ""
    arrival: float = 0.0
    p_long: float = 0.0           # predictor score (priority key under sjf)
    true_service: float = 0.0     # oracle service time (sim / oracle policy)
    klass: str = ""               # "short" | "medium" | "long" (ground truth)
    tenant: str = "default"
    # predicted/observed draft acceptance rate under speculative decoding
    # (None = unknown; acceptance-aware policies fall back to their prior)
    accept_rate: Optional[float] = None
    meta: dict = field(default_factory=dict)
    # filled by the dispatcher / simulator
    start: Optional[float] = None
    finish: Optional[float] = None
    promoted: bool = False
    cancelled: bool = False

    @property
    def wait(self) -> float:
        """Queue wait; NaN (not None) before dispatch so aggregation and
        formatting never hit a ``NoneType``."""
        return (self.start - self.arrival) if self.start is not None \
            else float("nan")

    @property
    def sojourn(self) -> float:
        """Queue-to-completion time; NaN before completion."""
        return (self.finish - self.arrival) if self.finish is not None \
            else float("nan")


class MinHeap:
    """Array binary heap of (key, seq, item); seq breaks ties FIFO."""

    def __init__(self):
        self._a: list = []

    def __len__(self):
        return len(self._a)

    def push(self, key, seq, item):
        a = self._a
        a.append((key, seq, item))
        i = len(a) - 1
        while i > 0:
            parent = (i - 1) >> 1
            if a[parent] <= a[i]:
                break
            a[parent], a[i] = a[i], a[parent]
            i = parent

    def pop(self):
        a = self._a
        if not a:
            raise IndexError("pop from empty heap")
        top = a[0]
        last = a.pop()
        if a:
            a[0] = last
            i, n = 0, len(a)
            while True:
                l, r = 2 * i + 1, 2 * i + 2
                smallest = i
                if l < n and a[l] < a[smallest]:
                    smallest = l
                if r < n and a[r] < a[smallest]:
                    smallest = r
                if smallest == i:
                    break
                a[i], a[smallest] = a[smallest], a[i]
                i = smallest
        return top

    def peek(self):
        return self._a[0]

    def invariant_ok(self) -> bool:
        a = self._a
        return all(a[(i - 1) >> 1] <= a[i] for i in range(1, len(a)))


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

    def invariant_ok(self) -> bool:
        ok = all(not self._less(i, (i - 1) >> 1) for i in range(1, self._n))
        pos_ok = all(int(self._id[s]) == i and s < self._n
                     for i, s in self._pos.items())
        return ok and pos_ok and len(self._pos) == self._n


class SJFQueue:
    """Admission queue implementing the paper's dispatch rule."""

    def __init__(self, policy="sjf", tau: Optional[float] = None):
        # accepts a registry name or a Policy instance; stateful policies
        # (fair share) get a per-queue clone
        self.policy_obj = get_policy(policy).fresh()
        self.policy = self.policy_obj.name
        self.tau = self.policy_obj.aging.effective_tau(tau)
        self._heap = ArrayHeap()
        self._fifo: deque = deque()       # arrival order for starvation guard
        self._seq = itertools.count()
        self._live: dict[int, Request] = {}
        self.stats = {"promotions": 0, "cancellations": 0, "dispatched": 0,
                      "preemptions": 0, "requeues": 0}

    def __len__(self):
        return len(self._live)

    def _key(self, req: Request) -> float:
        return self.policy_obj.key(req)

    def push(self, req: Request) -> None:
        seq = next(self._seq)
        key = self._key(req)
        # preemptive consumers derive requeue keys from the admission key
        # and read the current key back for eligibility scans
        req.meta["policy_key0"] = key
        req.meta["queue_key"] = key
        self._live[req.req_id] = req
        self._heap.push(key, seq, req.req_id)
        self._fifo.append(req)

    def push_requeue(self, req: Request, key: float,
                     reason: str = "preempt") -> None:
        """Re-admit a preempted (``reason="preempt"``) or fault-requeued
        (``reason="fault"``, e.g. engine crash) request with an explicit
        requeue key.  It keeps its original arrival, so the starvation
        guard still sees its true wait; the new heap seq makes re-entries
        FIFO among equal keys."""
        seq = next(self._seq)
        req.meta["queue_key"] = key
        self._live[req.req_id] = req
        self._heap.push(key, seq, req.req_id)
        # re-insert at its arrival rank (a stale FIFO entry may survive from
        # the original push; drop it so the guard sees the request once).
        # The deque is already near-sorted by arrival, so Timsort makes
        # this effectively O(n) per eviction, not O(n log n).
        self._fifo = deque(sorted(
            [r for r in self._fifo if r.req_id != req.req_id] + [req],
            key=lambda r: (r.arrival, r.req_id)))
        self.stats["requeues" if reason == "fault" else "preemptions"] += 1

    def peek(self) -> Optional[tuple]:
        """Best queued ``(key, Request)`` without dispatching (preemption
        checks); skips cancellation tombstones."""
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
        """Take a live request out WITHOUT marking it cancelled — used when
        re-routing (hedged dispatch, failover) rather than disconnecting."""
        req = self._live.pop(req_id, None)
        if req is not None:
            self._heap.kill(req_id)
        return req

    def _prune_fifo(self) -> None:
        # drop cancelled or already-dispatched entries from the front
        while self._fifo and (self._fifo[0].cancelled
                              or self._fifo[0].req_id not in self._live):
            self._fifo.popleft()

    def _starving(self, now: float) -> Optional[Request]:
        if self.tau is None:
            return None
        self._prune_fifo()
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
            self.policy_obj.note_dispatch(victim.meta.get("queue_key", 0.0))
            return victim
        if len(self._heap):
            key, _, req_id = self._heap.pop()
            req = self._live.pop(req_id)
            self.stats["dispatched"] += 1
            self.policy_obj.note_dispatch(key)
            return req
        return None

    def pop_many(self, k: int, now: float) -> list:
        """Pop up to ``k`` requests for lane back-fill, applying the full
        dispatch rule — starvation check included — *between* pops.

        A naive batched back-fill (take the heap's top-k in one go) gets
        the ordering wrong whenever the guard matters: popping the best
        key can leave the FIFO-oldest waiter over tau, in which case the
        SECOND slot must go to the promoted waiter even though its key
        sorts last.  Each pop here re-evaluates the guard at ``now``, so
        ``pop_many(k, now)`` is exactly ``[pop(now) for _ in range(k)]``
        (tests/test_scheduler.py has the regression test against the
        naive top-k order)."""
        out = []
        for _ in range(int(k)):
            req = self.pop(now=now)
            if req is None:
                break
            out.append(req)
        return out

    def oldest_wait(self, now: float) -> float:
        self._prune_fifo()
        return (now - self._fifo[0].arrival) if self._fifo else 0.0

    def waiting(self) -> list:
        """Snapshot of the live queued requests (arrival order)."""
        return sorted(self._live.values(),
                      key=lambda r: (r.arrival, r.req_id))

    def live(self):
        """Unsorted view of the live queued requests (O(1); for hot-path
        scans that only need a min, not an ordering)."""
        return self._live.values()
