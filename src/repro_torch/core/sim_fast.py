"""Vectorized serial-backend DES: SoA request batches + compiled engine.

The seed simulator (kept as ``simulation.simulate_reference``) walks one
Python ``Request`` object per event through a tuple-heap — minutes of
interpreter time for the paper's sweep grids.  This module rebuilds that
stack around struct-of-arrays data:

* :class:`RequestBatch` — numpy columns (arrival / true_service / p_long /
  klass codes / tenant codes) for a whole arrival stream, with vectorized
  Poisson and burst generators replacing the per-object loops;
* :func:`simulate_arrays` / :func:`simulate_grid` — the event loop over
  those arrays.  The primary engine is ``_native.des_run_many``, a C loop
  (compiled once at first use) driving an index-based binary min-heap
  keyed on ``(key[i], i)`` with lazy tombstones for starvation
  promotions; ``simulate_grid`` runs G independent simulations
  (policy x tau x rho x seed cells) in ONE call so a whole sweep costs one
  FFI round trip;
* when no C compiler exists, a fallback runs the same per-event loop over
  plain floats with stdlib ``heapq`` (C-speed sifts) — slower than the
  native engine but still well ahead of the object/tuple-heap reference;
* :func:`simulate_grid_preempt` — the *preemptive* counterpart for
  policies with eviction semantics (``core.policy`` MODE_SRPT /
  MODE_QUANTUM): arrivals can evict the running request and re-enqueue
  its remaining service, quantum expiry demotes (MLFQ).  Also a C loop
  with a bitwise-identical heapq fallback;
* :func:`simulate_grid_servers` / :func:`simulate_batch_servers` — the
  *c-server* engine: bounded-concurrency decode lanes with a
  per-lane slowdown s(c), a memory-token admission budget and srpt lane
  eviction — the virtual-time mirror of ``serving/batching.py``.  At
  c=1 with unit slowdown it is bitwise trace-equivalent to the serial
  engines (both non-preemptive and srpt rows).

Priority keys come from the policy layer (``core.policy``): every
registered policy — seed fcfs/sjf/sjf_oracle plus srpt, sjf_quantile,
mlfq, fair_share — supplies its key in array form via
:func:`dispatch_key` / ``Policy.key_array``.

Both engines are trace-equivalent to the reference loop — same float64
clock accumulation, same ``(key, seq)`` tie-breaking, same strict
``wait > tau`` promotion rule — bitwise, not just allclose
(tests/test_simulation.py).

Usage::

    from repro_torch.core.sim_fast import RequestBatch, simulate_batch

    rng = np.random.default_rng(0)
    batch = RequestBatch.poisson(rng, n=2000, lam=0.12, short=S, long=L)
    res = simulate_batch(batch, policy="sjf", tau=10.5)
    res.percentile(50, klass="short")          # one cell

    from repro_torch.core.sweep import sweep_poisson
    sweep = sweep_poisson(                      # whole grid, one call
        conditions=[("fcfs", None), ("sjf", 10.5)],
        rhos=(0.5, 0.74, 0.85), seeds=range(5), n=2000,
        short=S, long=L)
    sweep.metric("short_p50")                   # (C, R, S) array

This module is a copy of ``repro.core.sim_fast`` (imports renamed), held
to it bit for bit by ``tests/test_torch_des.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import _native
from repro_torch.core.policy import (LEVEL_STRIDE, MODE_NONE, MODE_QUANTUM,
                               MODE_SRPT, Policy, get_policy)
from repro_torch.core.scheduler import POLICIES, Request

KLASSES = ("", "short", "medium", "long")
_KLASS_CODE = {k: i for i, k in enumerate(KLASSES)}


def _klass_codes(names: Sequence[str]) -> np.ndarray:
    return np.array([_KLASS_CODE.get(k, 0) for k in names], np.int8)


@dataclass
class RequestBatch:
    """Struct-of-arrays arrival stream (one row per request)."""

    arrival: np.ndarray        # (n,) float64
    true_service: np.ndarray   # (n,) float64
    p_long: np.ndarray         # (n,) float64
    klass: np.ndarray          # (n,) int8, index into KLASSES
    tenant: np.ndarray         # (n,) int32, index into ``tenants``
    req_id: np.ndarray         # (n,) int64
    tenants: Tuple[str, ...] = ("default",)

    def __len__(self) -> int:
        return self.arrival.shape[0]

    def __post_init__(self):
        self.arrival = np.ascontiguousarray(self.arrival, np.float64)
        self.true_service = np.ascontiguousarray(self.true_service,
                                                 np.float64)
        self.p_long = np.ascontiguousarray(self.p_long, np.float64)
        self.klass = np.ascontiguousarray(self.klass, np.int8)
        self.tenant = np.ascontiguousarray(self.tenant, np.int32)
        self.req_id = np.ascontiguousarray(self.req_id, np.int64)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_arrays(cls, arrival, true_service, p_long=None, klass=None,
                    req_id=None) -> "RequestBatch":
        n = len(arrival)
        if p_long is None:
            p_long = np.zeros(n)
        if klass is None:
            klass = np.zeros(n, np.int8)
        else:
            klass = np.asarray(klass)
            if klass.dtype.kind in "US":
                klass = _klass_codes(klass)
        if req_id is None:
            req_id = np.arange(n, dtype=np.int64)
        return cls(arrival=np.asarray(arrival, np.float64),
                   true_service=np.asarray(true_service, np.float64),
                   p_long=np.asarray(p_long, np.float64),
                   klass=np.asarray(klass, np.int8),
                   tenant=np.zeros(n, np.int32), req_id=req_id)

    @classmethod
    def from_requests(cls, requests: Sequence[Request]) -> "RequestBatch":
        tenants = tuple(dict.fromkeys(r.tenant for r in requests)) or \
            ("default",)
        tcode = {t: i for i, t in enumerate(tenants)}
        return cls(
            arrival=np.array([r.arrival for r in requests], np.float64),
            true_service=np.array([r.true_service for r in requests],
                                  np.float64),
            p_long=np.array([r.p_long for r in requests], np.float64),
            klass=_klass_codes([r.klass for r in requests]),
            tenant=np.array([tcode[r.tenant] for r in requests], np.int32),
            req_id=np.array([r.req_id for r in requests], np.int64),
            tenants=tenants)

    def to_requests(self) -> List[Request]:
        return [Request(req_id=int(self.req_id[i]),
                        arrival=float(self.arrival[i]),
                        true_service=float(self.true_service[i]),
                        p_long=float(self.p_long[i]),
                        klass=KLASSES[self.klass[i]],
                        tenant=self.tenants[self.tenant[i]])
                for i in range(len(self))]

    # -- vectorized workload generators -------------------------------------

    @classmethod
    def poisson(cls, rng, n: int, lam: float, short, long,
                mix_long: float = 0.5) -> "RequestBatch":
        """Open-loop Poisson arrivals, short/long service mix (one shot —
        no per-object loop; draw order differs from the seed generator)."""
        arrival = np.cumsum(rng.exponential(1.0 / lam, n))
        is_long = rng.random(n) < mix_long
        service = np.where(is_long, long.sample(rng, n),
                           short.sample(rng, n))
        klass = np.where(is_long, _KLASS_CODE["long"],
                         _KLASS_CODE["short"]).astype(np.int8)
        return cls.from_arrays(arrival, service,
                               p_long=is_long.astype(np.float64),
                               klass=klass)

    @classmethod
    def burst(cls, rng, n_short: int, n_long: int, short, long,
              window: float = 0.05) -> "RequestBatch":
        """All requests arrive within ``window`` seconds (§5.5 stress)."""
        total = n_short + n_long
        is_long = rng.permutation(total) >= n_short
        arrival = rng.uniform(0, window, total)
        service = np.where(is_long, long.sample(rng, total),
                           short.sample(rng, total))
        klass = np.where(is_long, _KLASS_CODE["long"],
                         _KLASS_CODE["short"]).astype(np.int8)
        return cls.from_arrays(arrival, service,
                               p_long=is_long.astype(np.float64),
                               klass=klass)


def dispatch_key(policy, arrival: np.ndarray, p_long: np.ndarray,
                 true_service: np.ndarray, tenant=None,
                 tenants: Sequence[str] = ("default",)) -> np.ndarray:
    """The queue priority key of each request, as an array.

    ``policy`` is a registry name or a :class:`~repro_torch.core.policy.Policy`;
    unknown names raise ``ValueError`` listing the registered policies
    (``get_policy``) — an exception, not an assert, so the check survives
    ``python -O``.  Rows must be arrival-sorted (stateful keys such as
    fair share accumulate in arrival order).
    """
    return get_policy(policy).key_array(arrival, p_long, true_service,
                                        tenant=tenant, tenants=tenants)


def speculative_service(true_service, accept_rate, draft_k: int,
                        draft_cost: float = 0.15) -> np.ndarray:
    """Per-request speculative service-rate modifier.

    Mirrors a draft-verify decode backend in the DES: each request's
    wall-clock service is its serial service divided by
    ``serving.service_time.expected_speedup`` of its draft acceptance
    rate.  NaN acceptance (unknown) is treated as 0.0 — the backend
    still pays the draft overhead it gets nothing back for.
    ``draft_k == 0`` returns the service values unchanged (the
    no-speculation identity, bitwise).
    """
    svc = np.ascontiguousarray(true_service, np.float64)
    if draft_k == 0:
        return svc
    from repro_torch.serving.service_time import expected_speedup
    a = np.asarray(accept_rate, np.float64)
    a = np.where(np.isnan(a), 0.0, a)
    return svc / expected_speedup(a, draft_k, draft_cost)


# ---------------------------------------------------------------------------
# Engines.  Contract: ``arrival`` ascending (ties broken by array index,
# which is the reference's (arrival, req_id) push order -> heap seq).
# ---------------------------------------------------------------------------

def _simulate_arrays_python(arrival, service, key, tau):
    """Fallback engine (no C compiler): the same per-event loop over plain
    floats, with stdlib ``heapq`` doing the (key, seq) sifts in C.  Bitwise
    trace-equivalent to the reference — identical float ops, identical
    tie-breaking, identical strict ``(now - arrival) > tau`` promotion."""
    import heapq
    n = arrival.shape[0]
    arr = arrival.tolist()
    svc = service.tolist()
    ks = key.tolist()
    start = np.zeros(n)
    finish = np.zeros(n)
    promoted = np.zeros(n, bool)
    done = [False] * n
    heap: list = []
    guard = tau is not None
    t = 0.0
    i_arr = 0
    oldest = 0
    promos = 0
    ndone = 0
    while ndone < n:
        if i_arr == ndone:                        # queue empty: jump
            a = arr[i_arr]
            if t < a:
                t = a
        while i_arr < n and arr[i_arr] <= t:
            heapq.heappush(heap, (ks[i_arr], i_arr))
            i_arr += 1
        while done[oldest]:
            oldest += 1
        if guard and (t - arr[oldest]) > tau:
            j = oldest                            # promote past the heap;
            promoted[j] = True                    # stale entry -> tombstone
            promos += 1
        else:
            while True:
                _, j = heapq.heappop(heap)
                if not done[j]:
                    break
        done[j] = True
        start[j] = t
        t += svc[j]
        finish[j] = t
        ndone += 1
    return start, finish, promoted, promos


def simulate_grid(arrival, service, key, tau, engine: str = "auto"):
    """G independent simulations in one call.

    ``arrival``/``service``/``key``: (G, n) float64, each row ascending in
    arrival; ``tau``: length-G sequence (None entries disable the guard).
    Returns ``(start, finish, promoted, promotions)`` with shapes
    ((G, n), (G, n), (G, n) bool, (G,) int64).
    """
    arrival = np.ascontiguousarray(arrival, np.float64)
    service = np.ascontiguousarray(service, np.float64)
    key = np.ascontiguousarray(key, np.float64)
    G, n = arrival.shape
    # NaN = guard disabled (None); any real tau — including negative, which
    # promotes every waiter — keeps the reference's strict wait > tau rule
    tau_arr = np.array([np.nan if t is None else float(t) for t in tau],
                       np.float64)
    if tau_arr.shape != (G,):
        raise ValueError(f"tau must have length {G}")
    start = np.empty((G, n))
    finish = np.empty((G, n))
    promoted_u8 = np.zeros((G, n), np.uint8)
    promotions = np.zeros(G, np.int64)
    if n == 0:
        return start, finish, promoted_u8.astype(bool), promotions
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    fn = _native.native_des() if engine in ("auto", "native") else None
    if engine == "native" and fn is None:
        raise RuntimeError("native DES engine unavailable")
    if fn is not None:
        import ctypes
        heap = np.empty(n, np.int32)
        done = np.empty(n, np.uint8)
        pd = ctypes.c_double
        fn(_native.as_ptr(arrival, pd), _native.as_ptr(service, pd),
           _native.as_ptr(key, pd), _native.as_ptr(tau_arr, pd), G, n,
           _native.as_ptr(start, pd), _native.as_ptr(finish, pd),
           _native.as_ptr(promoted_u8, ctypes.c_uint8),
           _native.as_ptr(promotions, ctypes.c_int64),
           _native.as_ptr(heap, ctypes.c_int32),
           _native.as_ptr(done, ctypes.c_uint8))
        return start, finish, promoted_u8.astype(bool), promotions
    promoted = np.zeros((G, n), bool)
    for g in range(G):
        tg = None if np.isnan(tau_arr[g]) else float(tau_arr[g])
        start[g], finish[g], promoted[g], promos = _simulate_arrays_python(
            arrival[g], service[g], key[g], tg)
        promotions[g] = promos
    return start, finish, promoted, promotions


def simulate_arrays(arrival, service, key, tau: Optional[float],
                    engine: str = "auto"):
    """One simulation over flat (n,) arrays; see :func:`simulate_grid`."""
    start, finish, promoted, promotions = simulate_grid(
        arrival[None], service[None], key[None], (tau,), engine=engine)
    return start[0], finish[0], promoted[0], int(promotions[0])


# ---------------------------------------------------------------------------
# Preemptive engine (policy.MODE_SRPT / MODE_QUANTUM).
#
# Service is sliced at *events*: an arrival whose key strictly beats the
# running request's current key evicts it (the remaining service is
# re-enqueued with the policy's requeue key), and in quantum mode a job
# that exhausts its level-0 budget is demoted (key + LEVEL_STRIDE) and
# re-enqueued.  The starvation guard applies at every dispatch decision,
# exactly like the non-preemptive engines.  ``start`` records the FIRST
# dispatch; ``finish`` the completion.
# ---------------------------------------------------------------------------

def _simulate_preempt_python(arrival, service, key, tau, mode, quanta):
    """One preemptive cell over plain floats + stdlib heapq.  The C engine
    (``_native.des_preempt_run_many``) runs the identical event sequence
    with identical float64 arithmetic — results match bitwise."""
    import heapq
    n = arrival.shape[0]
    INF = float("inf")
    arr = arrival.tolist()
    svc = service.tolist()
    k0 = key.tolist()
    curk = list(k0)
    budget = quanta.tolist() if (mode == MODE_QUANTUM and quanta is not None) \
        else [INF] * n
    start = np.zeros(n)
    finish = np.zeros(n)
    promoted = np.zeros(n, bool)
    started = [False] * n
    state = [0] * n           # 0 waiting, 1 queued, 2 running, 3 done
    used = [0.0] * n          # service received so far
    last_seq = [-1] * n
    heap: list = []
    guard = tau is not None
    seqc = 0
    t = 0.0
    i_arr = 0
    oldest = 0
    nq = 0                    # live queued entries
    ndone = 0
    promos = 0
    preempts = 0
    run = -1

    def push(j):
        nonlocal seqc, nq
        heapq.heappush(heap, (curk[j], seqc, j))
        last_seq[j] = seqc
        seqc += 1
        nq += 1

    def pop_valid():
        nonlocal nq
        while True:
            _, s, j = heapq.heappop(heap)
            if state[j] == 1 and s == last_seq[j]:
                nq -= 1
                return j

    def peek_valid_key():
        while heap:
            k, s, j = heap[0]
            if state[j] == 1 and s == last_seq[j]:
                return k
            heapq.heappop(heap)
        return None

    while ndone < n:
        if run < 0:
            if nq == 0 and t < arr[i_arr]:
                t = arr[i_arr]                    # idle: jump to next arrival
            while i_arr < n and arr[i_arr] <= t:
                state[i_arr] = 1
                push(i_arr)
                i_arr += 1
            while state[oldest] == 3:
                oldest += 1
            if guard and state[oldest] == 1 and (t - arr[oldest]) > tau:
                j = oldest                        # starvation promotion past
                promoted[j] = True                # the heap (entry -> stale)
                promos += 1
                nq -= 1
            else:
                j = pop_valid()
            state[j] = 2
            run = j
            if not started[j]:
                started[j] = True
                start[j] = t
        rem = svc[run] - used[run]
        t_fin = t + rem
        t_q = t + (budget[run] - used[run]) if budget[run] < INF else INF
        t_arr = arr[i_arr] if i_arr < n else INF
        if t_fin <= t_arr and t_fin <= t_q:
            t = t_fin                             # completion
            used[run] = svc[run]
            finish[run] = t
            state[run] = 3
            ndone += 1
            run = -1
        elif t_q <= t_arr:
            used[run] += t_q - t                  # quantum expiry: demote
            t = t_q
            budget[run] = INF
            curk[run] = curk[run] + LEVEL_STRIDE
            state[run] = 1
            push(run)
            run = -1
        else:
            used[run] += t_arr - t                # arrival event(s)
            t = t_arr
            while i_arr < n and arr[i_arr] <= t:
                state[i_arr] = 1
                push(i_arr)
                i_arr += 1
            bk = peek_valid_key()
            # SRPT remaining floored at 0 (policy.Policy.running_key): a
            # job past its predicted total keeps the minimal key instead
            # of going negative (unpreemptable + queue-jumping on requeue)
            rk = max(k0[run] - used[run], 0.0) if mode == MODE_SRPT \
                else curk[run]
            if bk is not None and bk < rk:
                if mode == MODE_SRPT:
                    curk[run] = rk
                state[run] = 1                    # evict the running request
                push(run)
                preempts += 1
                j = pop_valid()
                state[j] = 2
                run = j
                if not started[j]:
                    started[j] = True
                    start[j] = t
    return start, finish, promoted, promos, preempts


def simulate_grid_preempt(arrival, service, key, tau, mode, quanta=None,
                          engine: str = "auto"):
    """G independent *preemptive* simulations in one call.

    Same layout as :func:`simulate_grid` plus ``mode`` (length-G ints:
    ``policy.MODE_SRPT`` / ``MODE_QUANTUM``) and ``quanta`` ((G, n)
    level-0 service budgets; ignored for SRPT rows).  Returns
    ``(start, finish, promoted, promotions, preemptions)``.
    """
    arrival = np.ascontiguousarray(arrival, np.float64)
    service = np.ascontiguousarray(service, np.float64)
    key = np.ascontiguousarray(key, np.float64)
    G, n = arrival.shape
    tau_arr = np.array([np.nan if t is None else float(t) for t in tau],
                       np.float64)
    mode_arr = np.ascontiguousarray(mode, np.int8)
    if quanta is None:
        quanta = np.full((G, n), np.inf)
    quanta = np.ascontiguousarray(quanta, np.float64)
    if tau_arr.shape != (G,) or mode_arr.shape != (G,):
        raise ValueError(f"tau and mode must have length {G}")
    start = np.empty((G, n))
    finish = np.empty((G, n))
    promoted = np.zeros((G, n), bool)
    promotions = np.zeros(G, np.int64)
    preemptions = np.zeros(G, np.int64)
    if n == 0:
        return start, finish, promoted, promotions, preemptions
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}")
    fn = _native.native_des_preempt() if engine in ("auto", "native") else None
    if engine == "native" and fn is None:
        raise RuntimeError("native preemptive DES engine unavailable")
    if fn is not None:
        import ctypes
        cap = 4 * n                       # pushes <= arrivals+preempts+demotes
        hkey = np.empty(cap, np.float64)
        hseq = np.empty(cap, np.int64)
        hidx = np.empty(cap, np.int32)
        used = np.empty(n, np.float64)
        curk = np.empty(n, np.float64)
        budget = np.empty(n, np.float64)
        lastseq = np.empty(n, np.int64)
        st = np.empty(n, np.uint8)
        promoted_u8 = np.zeros((G, n), np.uint8)
        pd = ctypes.c_double
        fn(_native.as_ptr(arrival, pd), _native.as_ptr(service, pd),
           _native.as_ptr(key, pd), _native.as_ptr(tau_arr, pd),
           _native.as_ptr(quanta, pd),
           _native.as_ptr(mode_arr, ctypes.c_int8), G, n,
           _native.as_ptr(start, pd), _native.as_ptr(finish, pd),
           _native.as_ptr(promoted_u8, ctypes.c_uint8),
           _native.as_ptr(promotions, ctypes.c_int64),
           _native.as_ptr(preemptions, ctypes.c_int64),
           _native.as_ptr(hkey, pd), _native.as_ptr(hseq, ctypes.c_int64),
           _native.as_ptr(hidx, ctypes.c_int32),
           _native.as_ptr(used, pd), _native.as_ptr(curk, pd),
           _native.as_ptr(budget, pd),
           _native.as_ptr(lastseq, ctypes.c_int64),
           _native.as_ptr(st, ctypes.c_uint8))
        return start, finish, promoted_u8.astype(bool), promotions, \
            preemptions
    for g in range(G):
        tg = None if np.isnan(tau_arr[g]) else float(tau_arr[g])
        start[g], finish[g], promoted[g], promos, pre = \
            _simulate_preempt_python(arrival[g], service[g], key[g], tg,
                                     int(mode_arr[g]), quanta[g])
        promotions[g] = promos
        preemptions[g] = pre
    return start, finish, promoted, promotions, preemptions


# ---------------------------------------------------------------------------
# c-server engine (bounded-concurrency decode lanes, serving/batching.py's
# simulation mirror).
#
# The server has ``c`` lanes and a memory-token budget.  Admission follows
# the same dispatch rule as the serial engines — starvation guard, then the
# policy key — applied whenever a lane is free; the queue head is admitted
# only if its memory demand fits the remaining budget (strict order: a
# blocked head is never bypassed).  Lanes in service progress at a
# concurrency-dependent rate: with k busy lanes each lane's service is
# stretched by ``slowdown[k-1]`` (s(1) = 1; batched decode is not free —
# calibrate s(c) from the real engine, benchmarks/batching_bench.py), so
# remaining work is re-scaled whenever the busy count changes.
#
# Modes: MODE_NONE (key policies) and MODE_SRPT (an arrival whose key
# strictly beats the *worst* running lane's current remaining-key evicts
# that lane; eviction releases its memory reservation — resume re-prefills,
# the preemptive engine's machinery).  MODE_QUANTUM is rejected: per-lane quantum
# accounting under rate re-scaling is future work.
#
# Bitwise contract at c=1 with slowdown (1.0,): MODE_NONE rows reproduce
# ``_simulate_arrays_python`` (and therefore ``simulate_reference``) traces
# exactly — work advances only when the busy count changes, so a request
# admitted at ``t`` finishes at ``t + service*1.0`` with identical float
# ops; MODE_SRPT rows reproduce ``_simulate_preempt_python`` — work
# advances at every event, matching its incremental ``used += dt``
# accumulation (tests/test_batching.py fuzzes both).
# ---------------------------------------------------------------------------

def _simulate_cserver_python(arrival, service, key, tau, c, slowdown,
                             mem, mem_budget, mode):
    import heapq
    n = arrival.shape[0]
    INF = float("inf")
    arr = arrival.tolist()
    svc = service.tolist()
    k0 = key.tolist()
    curk = list(k0)
    s = list(slowdown)
    if len(s) < c:
        raise ValueError(f"slowdown needs >= {c} entries, got {len(s)}")
    srpt = mode == MODE_SRPT
    if mode not in (MODE_NONE, MODE_SRPT):
        raise ValueError("c-server engine supports key-based and srpt "
                         "policies only (quantum/MLFQ accounting under "
                         "rate re-scaling is not implemented)")
    memd = mem.tolist() if mem is not None else None
    start = np.zeros(n)
    finish = np.zeros(n)
    promoted = np.zeros(n, bool)
    started = [False] * n
    state = [0] * n            # 0 waiting, 1 queued, 2 running, 3 done
    used = [0.0] * n           # unscaled service received
    last_seq = [-1] * n
    heap: list = []
    guard = tau is not None
    seqc = 0
    t = 0.0
    last_t = 0.0               # time ``used`` was last advanced
    i_arr = 0
    oldest = 0
    running: list = []
    nq = 0
    ndone = 0
    promos = 0
    preempts = 0
    used_mem = 0.0

    def push(j):
        nonlocal seqc, nq
        heapq.heappush(heap, (curk[j], seqc, j))
        last_seq[j] = seqc
        seqc += 1
        nq += 1

    def heap_best():
        while heap:
            kk, sq, j = heap[0]
            if state[j] == 1 and sq == last_seq[j]:
                return kk, j
            heapq.heappop(heap)
        return None

    def pop_valid():
        nonlocal nq
        while True:
            _, sq, j = heapq.heappop(heap)
            if state[j] == 1 and sq == last_seq[j]:
                nq -= 1
                return j

    def advance(t_new):
        """Credit service progress up to ``t_new`` at the current busy
        count.  Called at every k change; additionally at every event in
        srpt mode (whose preemption key needs up-to-date ``used``)."""
        nonlocal last_t
        kcur = len(running)
        if kcur and t_new > last_t:
            d = (t_new - last_t) / s[kcur - 1]
            for j in running:
                used[j] += d
        last_t = t_new

    def next_completion():
        kcur = len(running)
        if not kcur:
            return INF, -1
        best_j, best_rem = -1, INF
        for j in running:
            r = svc[j] - used[j]
            if r < best_rem:
                best_rem, best_j = r, j
        return last_t + best_rem * s[kcur - 1], best_j

    def run_key(j):
        return max(k0[j] - used[j], 0.0) if srpt else curk[j]

    def fits(j):
        if memd is None:
            return True
        # idle override: all reservations are held by running lanes, so an
        # empty server admits even an over-budget head (it must run
        # eventually; memory pressure may serialize but never deadlock)
        return used_mem + memd[j] <= mem_budget or not running

    def dispatch(j, promo):
        nonlocal promos, used_mem
        advance(t)
        if promo:
            promoted[j] = True
            promos += 1
        state[j] = 2
        running.append(j)
        if memd is not None:
            used_mem += memd[j]
        if not started[j]:
            started[j] = True
            start[j] = t

    def admit_loop():
        nonlocal oldest, nq
        while len(running) < c and nq > 0:
            while state[oldest] == 3:
                oldest += 1
            o = oldest             # FIFO-oldest *queued* (skip running)
            while state[o] != 1:
                o += 1
            if guard and (t - arr[o]) > tau:
                j, promo = o, True
            else:
                j, promo = heap_best()[1], False
            if not fits(j):
                return             # memory-blocked head: no bypass
            if promo:
                nq -= 1            # heap entry goes stale via state change
            else:
                j = pop_valid()
            dispatch(j, promo)

    while ndone < n:
        if not running and nq == 0:
            a = arr[i_arr]
            if t < a:
                t = a
                last_t = t
        t_fin, j_fin = next_completion()
        t_arr = arr[i_arr] if i_arr < n else INF
        if t_fin <= t_arr:                        # completion event
            t = t_fin
            advance(t)
            running.remove(j_fin)
            used[j_fin] = svc[j_fin]
            finish[j_fin] = t
            state[j_fin] = 3
            ndone += 1
            if memd is not None:
                # clear float residue once nothing holds a reservation
                used_mem = max(0.0, used_mem - memd[j_fin]) if running \
                    else 0.0
            while i_arr < n and arr[i_arr] <= t:
                state[i_arr] = 1
                push(i_arr)
                i_arr += 1
            admit_loop()
        else:                                     # arrival event(s)
            if t_arr > t:          # after an idle jump t may already be past
                t = t_arr          # the next arrival; never rewind the clock
            if srpt:
                advance(t)
            while i_arr < n and arr[i_arr] <= t:
                state[i_arr] = 1
                push(i_arr)
                i_arr += 1
            if len(running) < c:
                admit_loop()
            elif srpt:
                best = heap_best()
                if best is not None:
                    victim = max(running, key=lambda j: (run_key(j), j))
                    vk = run_key(victim)
                    # eviction frees the victim's reservation (resume
                    # re-prefills); the candidate must fit what remains
                    fits_after = memd is None or (
                        used_mem - memd[victim] + memd[best[1]]
                        <= mem_budget) or used_mem - memd[victim] <= 0.0
                    if best[0] < vk and fits_after:
                        advance(t)
                        running.remove(victim)
                        if memd is not None:
                            used_mem = max(0.0,
                                           used_mem - memd[victim])
                        curk[victim] = vk
                        state[victim] = 1
                        push(victim)
                        preempts += 1
                        j = pop_valid()
                        dispatch(j, False)
    return start, finish, promoted, promos, preempts


def simulate_grid_servers(arrival, service, key, tau, n_servers: int,
                          slowdown=None, mem=None, mem_budget=None,
                          mode=None):
    """G independent c-server simulations in one call.

    Layout follows :func:`simulate_grid` — ``arrival``/``service``/``key``
    (G, n) float64, rows arrival-sorted; ``tau`` length-G (None = guard
    off) — plus:

    * ``n_servers``: lane count c (shared across rows);
    * ``slowdown``: per-lane service stretch ``s[k-1]`` at k busy lanes
      (default all 1.0 — ideal scaling);
    * ``mem`` (G, n) + ``mem_budget``: per-request memory-token demand
      and the shared budget (None = unconstrained);
    * ``mode``: length-G ints, ``MODE_NONE`` or ``MODE_SRPT`` per row.

    Returns ``(start, finish, promoted, promotions, preemptions)``.
    At c=1 with unit slowdown, MODE_NONE rows are bitwise equal to
    :func:`simulate_grid` and MODE_SRPT rows to
    :func:`simulate_grid_preempt`.
    """
    arrival = np.ascontiguousarray(arrival, np.float64)
    service = np.ascontiguousarray(service, np.float64)
    key = np.ascontiguousarray(key, np.float64)
    G, n = arrival.shape
    c = int(n_servers)
    if c < 1:
        raise ValueError(f"need >= 1 server, got {n_servers}")
    slowdown = tuple(float(x) for x in slowdown) if slowdown is not None \
        else (1.0,) * c
    if any(x <= 0 for x in slowdown):
        raise ValueError(f"slowdown factors must be positive: {slowdown}")
    tau_arr = np.array([np.nan if x is None else float(x) for x in tau],
                       np.float64)
    mode_arr = np.zeros(G, np.int8) if mode is None \
        else np.ascontiguousarray(mode, np.int8)
    if tau_arr.shape != (G,) or mode_arr.shape != (G,):
        raise ValueError(f"tau and mode must have length {G}")
    if mem is not None:
        mem = np.ascontiguousarray(mem, np.float64)
        if mem_budget is None:
            raise ValueError("mem given without mem_budget")
    start = np.empty((G, n))
    finish = np.empty((G, n))
    promoted = np.zeros((G, n), bool)
    promotions = np.zeros(G, np.int64)
    preemptions = np.zeros(G, np.int64)
    if n == 0:
        return start, finish, promoted, promotions, preemptions
    for g in range(G):
        tg = None if np.isnan(tau_arr[g]) else float(tau_arr[g])
        start[g], finish[g], promoted[g], promos, pre = \
            _simulate_cserver_python(
                arrival[g], service[g], key[g], tg, c, slowdown,
                None if mem is None else mem[g], mem_budget,
                int(mode_arr[g]))
        promotions[g] = promos
        preemptions[g] = pre
    return start, finish, promoted, promotions, preemptions


# ---------------------------------------------------------------------------
# Block-paged c-server engine (serving/paging.py's simulation mirror).
#
# Same event loop, dispatch rule and slowdown model as the c-server engine,
# with the worst-case memory reservation replaced by the page-granular
# model the paged engine implements:
#
# * admission charges the PROMPT's pages only (minus the shared-prefix
#   pages when the prefix is already registered — the prefix cache);
# * a running request's footprint grows linearly from its prompt pages to
#   its total pages as decode progresses (one page per page_size tokens,
#   smoothed to a rate — the DES doesn't model page-boundary staircase);
# * pool exhaustion preempts the YOUNGEST-dispatched lane (never a solo
#   lane): its pages are freed and it re-queues work-conserving under its
#   original key, but its re-admission demand is its full current
#   footprint (resume re-prefills prompt + generated, so the pages come
#   back at once).  No admission happens at the exhaustion instant —
#   the freed lane back-fills at the next arrival/completion event —
#   which breaks the release/re-admit livelock the same way the live
#   engine's per-boundary deferral does.
# * a request's shared-prefix group registers at its first dispatch
#   (the live engine registers right after prefill); later members admit
#   warm — their shared pages are free and ``prefill_saved`` seconds of
#   service (the skipped prefix prefill) are discounted.  Cache eviction
#   under pressure is not modeled (cached pages are reclaimable, so they
#   never block an allocation; dropping them early only loses hits).
#
# Bitwise contract at c=1: a solo lane is never preempted and idle-
# override admits every head, so the page model is inert — rows reproduce
# ``_simulate_cserver_python`` (and through it the serial engines) float
# op for float op.
# ---------------------------------------------------------------------------

def _simulate_paged_python(arrival, service, key, tau, c, slowdown, mode,
                           prompt_pages, total_pages, share_group,
                           shared_pages, prefill_saved, n_pages):
    import heapq
    n = arrival.shape[0]
    INF = float("inf")
    arr = arrival.tolist()
    svc = service.tolist()          # mutated: warm admits discount prefill
    k0 = key.tolist()
    curk = list(k0)
    s = list(slowdown)
    if len(s) < c:
        raise ValueError(f"slowdown needs >= {c} entries, got {len(s)}")
    srpt = mode == MODE_SRPT
    if mode not in (MODE_NONE, MODE_SRPT):
        raise ValueError("paged engine supports key-based and srpt "
                         "policies only")
    ppg = [min(float(x), float(n_pages)) for x in prompt_pages]
    tpg = [min(float(x), float(n_pages)) for x in total_pages]
    grp = share_group.tolist()
    spg = shared_pages.tolist()
    saved = prefill_saved.tolist()
    start = np.zeros(n)
    finish = np.zeros(n)
    promoted = np.zeros(n, bool)
    started = [False] * n
    state = [0] * n            # 0 waiting, 1 queued, 2 running, 3 done
    used = [0.0] * n           # unscaled service received
    last_seq = [-1] * n
    base_pg = [0.0] * n        # admission pages (fixed at first dispatch)
    rate = [0.0] * n           # pages per unit of credited service
    disp_seq = [-1] * n        # dispatch order (preemption picks youngest)
    heap: list = []
    guard = tau is not None
    seqc = 0
    dseq = 0
    t = 0.0
    last_t = 0.0
    i_arr = 0
    oldest = 0
    running: list = []
    nq = 0
    ndone = 0
    promos = 0
    preempts = 0
    prefix_hits = 0
    peak_pages = 0.0
    registered: set = set()

    def push(j):
        nonlocal seqc, nq
        heapq.heappush(heap, (curk[j], seqc, j))
        last_seq[j] = seqc
        seqc += 1
        nq += 1

    def heap_best():
        while heap:
            kk, sq, j = heap[0]
            if state[j] == 1 and sq == last_seq[j]:
                return kk, j
            heapq.heappop(heap)
        return None

    def pop_valid():
        nonlocal nq
        while True:
            _, sq, j = heapq.heappop(heap)
            if state[j] == 1 and sq == last_seq[j]:
                nq -= 1
                return j

    def advance(t_new):
        nonlocal last_t
        kcur = len(running)
        if kcur and t_new > last_t:
            d = (t_new - last_t) / s[kcur - 1]
            for j in running:
                used[j] += d
        last_t = t_new

    def next_completion():
        kcur = len(running)
        if not kcur:
            return INF, -1
        best_j, best_rem = -1, INF
        for j in running:
            r = svc[j] - used[j]
            if r < best_rem:
                best_rem, best_j = r, j
        return last_t + best_rem * s[kcur - 1], best_j

    def run_key(j):
        return max(k0[j] - used[j], 0.0) if srpt else curk[j]

    def held(j):
        return min(base_pg[j] + rate[j] * used[j], tpg[j])

    def pool():
        return sum(held(j) for j in running)

    def demand(j):
        """Pages the pool must produce to (re-)dispatch j."""
        if disp_seq[j] >= 0:                       # resume: re-prefills all
            return base_pg[j] + rate[j] * used[j]
        if grp[j] >= 0 and grp[j] in registered:   # warm admit
            return ppg[j] - spg[j]
        return ppg[j]

    def fits(j):
        # idle override, as in the c-server engine: an empty server
        # admits any head (capped demand always fits a full pool)
        return pool() + demand(j) <= n_pages or not running

    def next_exhaustion():
        kcur = len(running)
        if kcur <= 1:                              # solo lane never preempts
            return INF
        r_tot = sum(rate[j] for j in running if used[j] < svc[j])
        if r_tot <= 0.0:
            return INF
        head = n_pages - pool()
        if head <= 0.0:
            return last_t
        return last_t + head * s[kcur - 1] / r_tot

    def dispatch(j, promo):
        nonlocal promos, dseq, prefix_hits, peak_pages
        advance(t)
        if promo:
            promoted[j] = True
            promos += 1
        state[j] = 2
        if disp_seq[j] < 0:                        # first dispatch
            warm = grp[j] >= 0 and grp[j] in registered
            if warm:
                prefix_hits += 1
                base_pg[j] = ppg[j] - spg[j]
                svc[j] = max(svc[j] - saved[j], 1e-12)
            else:
                base_pg[j] = ppg[j]
            span = max(tpg[j] - (spg[j] if warm else 0.0) - base_pg[j], 0.0)
            rate[j] = span / svc[j] if svc[j] > 0 else 0.0
            if grp[j] >= 0:
                registered.add(grp[j])
        disp_seq[j] = dseq
        dseq += 1
        running.append(j)
        peak_pages = max(peak_pages, pool())
        if not started[j]:
            started[j] = True
            start[j] = t

    def admit_loop():
        nonlocal oldest, nq
        while len(running) < c and nq > 0:
            # fits() needs the pool at time t, not at the last credit
            # point; a no-op when running is empty, so the c=1 bitwise
            # contract (which never reaches here with busy lanes) holds
            advance(t)
            while state[oldest] == 3:
                oldest += 1
            o = oldest
            while state[o] != 1:
                o += 1
            if guard and (t - arr[o]) > tau:
                j, promo = o, True
            else:
                j, promo = heap_best()[1], False
            if not fits(j):
                return
            if promo:
                nq -= 1
            else:
                j = pop_valid()
            dispatch(j, promo)

    while ndone < n:
        if not running and nq == 0:
            a = arr[i_arr]
            if t < a:
                t = a
                last_t = t
        t_fin, j_fin = next_completion()
        t_arr = arr[i_arr] if i_arr < n else INF
        t_ex = next_exhaustion()
        if t_fin <= t_arr and t_fin <= t_ex:      # completion event
            t = t_fin
            advance(t)
            running.remove(j_fin)
            used[j_fin] = svc[j_fin]
            finish[j_fin] = t
            state[j_fin] = 3
            ndone += 1
            while i_arr < n and arr[i_arr] <= t:
                state[i_arr] = 1
                push(i_arr)
                i_arr += 1
            admit_loop()
        elif t_arr <= t_ex:                       # arrival event(s)
            if t_arr > t:
                t = t_arr
            if srpt:
                advance(t)
            while i_arr < n and arr[i_arr] <= t:
                state[i_arr] = 1
                push(i_arr)
                i_arr += 1
            if len(running) < c:
                admit_loop()
            elif srpt:
                best = heap_best()
                if best is not None:
                    victim = max(running, key=lambda j: (run_key(j), j))
                    vk = run_key(victim)
                    new_pool = pool() - held(victim)
                    fits_after = (new_pool + demand(best[1]) <= n_pages
                                  or new_pool <= 0.0)
                    if best[0] < vk and fits_after:
                        advance(t)
                        running.remove(victim)
                        curk[victim] = vk
                        state[victim] = 1
                        push(victim)
                        preempts += 1
                        j = pop_valid()
                        dispatch(j, False)
        else:                                     # pool exhaustion
            t = max(t, t_ex)
            advance(t)
            victim = max(running, key=lambda j: disp_seq[j])
            running.remove(victim)
            if not srpt:
                pass                              # key kept: ages from arrival
            else:
                curk[victim] = run_key(victim)
            state[victim] = 1
            push(victim)
            preempts += 1
            # no admit here: the freed lane back-fills at the next real
            # event (the live engine's per-boundary deferral)
    return (start, finish, promoted, promos, preempts, prefix_hits,
            peak_pages)


def simulate_grid_paged(arrival, service, key, tau, n_servers: int,
                        prompt_pages, total_pages, n_pages: int,
                        slowdown=None, mode=None, share_group=None,
                        shared_pages=None, prefill_saved=None):
    """G independent block-paged c-server simulations in one call.

    Layout follows :func:`simulate_grid_servers`, with the memory model
    swapped for pages: ``prompt_pages``/``total_pages`` (G, n) are each
    request's admission and completion footprints in pages, ``n_pages``
    the shared pool.  Optional prefix sharing: ``share_group`` (G, n)
    int (-1 = unshared) labels requests with a common prompt prefix,
    ``shared_pages`` (G, n) the pages that prefix covers and
    ``prefill_saved`` (G, n) the seconds of prefill a warm admission
    skips.  Returns ``(start, finish, promoted, promotions,
    preemptions, prefix_hits, peak_pages)``; the last two are length-G.
    """
    arrival = np.ascontiguousarray(arrival, np.float64)
    service = np.ascontiguousarray(service, np.float64)
    key = np.ascontiguousarray(key, np.float64)
    prompt_pages = np.ascontiguousarray(prompt_pages, np.float64)
    total_pages = np.ascontiguousarray(total_pages, np.float64)
    G, n = arrival.shape
    c = int(n_servers)
    if c < 1:
        raise ValueError(f"need >= 1 server, got {n_servers}")
    if int(n_pages) < 1:
        raise ValueError(f"need >= 1 page, got {n_pages}")
    slowdown = tuple(float(x) for x in slowdown) if slowdown is not None \
        else (1.0,) * c
    if any(x <= 0 for x in slowdown):
        raise ValueError(f"slowdown factors must be positive: {slowdown}")
    tau_arr = np.array([np.nan if x is None else float(x) for x in tau],
                       np.float64)
    mode_arr = np.zeros(G, np.int8) if mode is None \
        else np.ascontiguousarray(mode, np.int8)
    if tau_arr.shape != (G,) or mode_arr.shape != (G,):
        raise ValueError(f"tau and mode must have length {G}")
    share_group = np.full((G, n), -1, np.int64) if share_group is None \
        else np.ascontiguousarray(share_group, np.int64)
    shared_pages = np.zeros((G, n)) if shared_pages is None \
        else np.ascontiguousarray(shared_pages, np.float64)
    prefill_saved = np.zeros((G, n)) if prefill_saved is None \
        else np.ascontiguousarray(prefill_saved, np.float64)
    start = np.empty((G, n))
    finish = np.empty((G, n))
    promoted = np.zeros((G, n), bool)
    promotions = np.zeros(G, np.int64)
    preemptions = np.zeros(G, np.int64)
    prefix_hits = np.zeros(G, np.int64)
    peak_pages = np.zeros(G)
    if n == 0:
        return (start, finish, promoted, promotions, preemptions,
                prefix_hits, peak_pages)
    for g in range(G):
        tg = None if np.isnan(tau_arr[g]) else float(tau_arr[g])
        (start[g], finish[g], promoted[g], promos, pre, hits,
         peak) = _simulate_paged_python(
            arrival[g], service[g], key[g], tg, c, slowdown,
            int(mode_arr[g]), prompt_pages[g], total_pages[g],
            share_group[g], shared_pages[g], prefill_saved[g],
            float(n_pages))
        promotions[g] = promos
        preemptions[g] = pre
        prefix_hits[g] = hits
        peak_pages[g] = peak
    return (start, finish, promoted, promotions, preemptions,
            prefix_hits, peak_pages)


# ---------------------------------------------------------------------------
# Batch-level front end
# ---------------------------------------------------------------------------

@dataclass
class BatchSimResult:
    """Per-request outcomes aligned with the input batch's row order."""

    batch: RequestBatch
    start: np.ndarray          # (n,) float64 (first dispatch, preemptive)
    finish: np.ndarray         # (n,) float64
    promoted: np.ndarray       # (n,) bool
    promotions: int
    makespan: float
    preemptions: int = 0       # preemptive policies only
    prefix_hits: int = 0       # paged engine only (warm admissions)
    peak_pages: float = 0.0    # paged engine only (pool high-water mark)

    def _vals(self, klass: Optional[str], attr: str) -> np.ndarray:
        if attr == "sojourn":
            v = self.finish - self.batch.arrival
        elif attr == "wait":
            v = self.start - self.batch.arrival
        else:
            v = getattr(self, attr)
        if klass is not None:
            v = v[self.batch.klass == _KLASS_CODE[klass]]
        return v

    def percentile(self, q: float, klass: Optional[str] = None,
                   attr: str = "sojourn") -> float:
        v = self._vals(klass, attr)
        return float(np.percentile(v, q)) if len(v) else float("nan")

    def mean(self, klass: Optional[str] = None,
             attr: str = "sojourn") -> float:
        v = self._vals(klass, attr)
        return float(v.mean()) if len(v) else float("nan")


def simulate_batch(batch: RequestBatch, policy="sjf",
                   tau: Optional[float] = None,
                   engine: str = "auto") -> BatchSimResult:
    """Run the serial-server DES over a :class:`RequestBatch`.

    ``policy`` is a registry name or :class:`~repro_torch.core.policy.Policy`;
    preemptive policies route through :func:`simulate_grid_preempt`,
    key-based ones through the (bitwise seed-equivalent) non-preemptive
    engines.
    """
    pol = get_policy(policy)
    tau = pol.aging.effective_tau(tau)
    perm = np.lexsort((batch.req_id, batch.arrival))
    arrival = batch.arrival[perm]
    service = batch.true_service[perm]
    key = pol.key_array(arrival, batch.p_long[perm], service,
                        tenant=batch.tenant[perm], tenants=batch.tenants)
    preemptions = 0
    if pol.preemptive:
        quanta = pol.quantum_array(arrival, batch.p_long[perm], service)
        start_s, finish_s, promoted_s, promos, pre = simulate_grid_preempt(
            arrival[None], service[None], key[None], (tau,),
            (pol.mode,), None if quanta is None else quanta[None],
            engine=engine)
        start_s, finish_s, promoted_s = start_s[0], finish_s[0], promoted_s[0]
        promotions, preemptions = int(promos[0]), int(pre[0])
    else:
        start_s, finish_s, promoted_s, promotions = simulate_arrays(
            arrival, service, key, tau, engine=engine)
    n = len(batch)
    start = np.empty(n)
    finish = np.empty(n)
    promoted = np.empty(n, bool)
    start[perm] = start_s
    finish[perm] = finish_s
    promoted[perm] = promoted_s
    return BatchSimResult(batch=batch, start=start, finish=finish,
                          promoted=promoted, promotions=promotions,
                          makespan=float(finish.max()) if n else 0.0,
                          preemptions=preemptions)


def simulate_batch_servers(batch: RequestBatch, policy="sjf",
                           tau: Optional[float] = None, n_servers: int = 1,
                           slowdown=None, mem_tokens=None,
                           mem_budget=None) -> BatchSimResult:
    """Run the *c-server* DES over a :class:`RequestBatch`.

    ``n_servers`` decode lanes with per-lane slowdown ``slowdown[k-1]``
    at k busy lanes and an optional memory-token budget
    (``mem_tokens`` per request, aligned with the batch's row order).
    Key-based policies and srpt are supported; at ``n_servers=1`` with
    unit slowdown the trace is bitwise-equal to :func:`simulate_batch`.
    """
    pol = get_policy(policy)
    if pol.mode not in (MODE_NONE, MODE_SRPT):
        raise ValueError(f"policy {pol.name!r}: the c-server engine "
                         "supports key-based and srpt policies only")
    tau = pol.aging.effective_tau(tau)
    perm = np.lexsort((batch.req_id, batch.arrival))
    arrival = batch.arrival[perm]
    service = batch.true_service[perm]
    key = pol.key_array(arrival, batch.p_long[perm], service,
                        tenant=batch.tenant[perm], tenants=batch.tenants)
    mem = None
    if mem_tokens is not None:
        mem = np.asarray(mem_tokens, np.float64)[perm][None]
    start_s, finish_s, promoted_s, promos, pre = simulate_grid_servers(
        arrival[None], service[None], key[None], (tau,), n_servers,
        slowdown=slowdown, mem=mem, mem_budget=mem_budget,
        mode=(pol.mode,))
    n = len(batch)
    start = np.empty(n)
    finish = np.empty(n)
    promoted = np.empty(n, bool)
    start[perm] = start_s[0]
    finish[perm] = finish_s[0]
    promoted[perm] = promoted_s[0]
    return BatchSimResult(batch=batch, start=start, finish=finish,
                          promoted=promoted, promotions=int(promos[0]),
                          makespan=float(finish.max()) if n else 0.0,
                          preemptions=int(pre[0]))


def simulate_batch_paged(batch: RequestBatch, policy="sjf",
                         tau: Optional[float] = None, n_servers: int = 1,
                         slowdown=None, *, prompt_pages, total_pages,
                         n_pages: int, share_group=None, shared_pages=None,
                         prefill_saved=None) -> BatchSimResult:
    """Run the block-paged c-server DES over a :class:`RequestBatch`.

    Per-request arrays (``prompt_pages``/``total_pages`` and the optional
    prefix-sharing triple) are aligned with the batch's row order, like
    ``mem_tokens`` in :func:`simulate_batch_servers`.  At ``n_servers=1``
    with unit slowdown and no sharing the trace is bitwise-equal to
    :func:`simulate_batch_servers` (a solo lane never pages out).
    """
    pol = get_policy(policy)
    if pol.mode not in (MODE_NONE, MODE_SRPT):
        raise ValueError(f"policy {pol.name!r}: the paged engine "
                         "supports key-based and srpt policies only")
    tau = pol.aging.effective_tau(tau)
    perm = np.lexsort((batch.req_id, batch.arrival))
    arrival = batch.arrival[perm]
    service = batch.true_service[perm]
    key = pol.key_array(arrival, batch.p_long[perm], service,
                        tenant=batch.tenant[perm], tenants=batch.tenants)

    def _row(x, fill=0.0, dt=np.float64):
        if x is None:
            return None
        return np.asarray(x, dt)[perm][None]
    (start_s, finish_s, promoted_s, promos, pre, hits,
     peak) = simulate_grid_paged(
        arrival[None], service[None], key[None], (tau,), n_servers,
        _row(prompt_pages), _row(total_pages), int(n_pages),
        slowdown=slowdown, mode=(pol.mode,),
        share_group=_row(share_group, dt=np.int64),
        shared_pages=_row(shared_pages),
        prefill_saved=_row(prefill_saved))
    n = len(batch)
    start = np.empty(n)
    finish = np.empty(n)
    promoted = np.empty(n, bool)
    start[perm] = start_s[0]
    finish[perm] = finish_s[0]
    promoted[perm] = promoted_s[0]
    return BatchSimResult(batch=batch, start=start, finish=finish,
                          promoted=promoted, promotions=int(promos[0]),
                          makespan=float(finish.max()) if n else 0.0,
                          preemptions=int(pre[0]),
                          prefix_hits=int(hits[0]),
                          peak_pages=float(peak[0]))


# ---------------------------------------------------------------------------
# Fault-injected serial engine.
#
# The DES mirror of the serving-layer fault model (serving/faults.py): the
# single server goes DOWN for repair windows (crash + MTTR), runs SLOW
# inside stall windows, and the scheduler may SHED a request at dispatch
# when its queueing delay already exceeds its deadline budget.  A request
# in flight when the server goes down is requeued *work-conserving* — the
# service it already received is kept (``used``) and only the remainder
# runs after repair — under its ORIGINAL queue key and arrival (so the
# starvation guard still ages it from first arrival).
#
# Equivalence contract: with no fault windows and no deadline, the loop
# performs bitwise the same float ops as ``_simulate_arrays_python``
# (``svc - 0.0 == svc`` and ``rem * 1.0 == rem`` exactly in IEEE-754), so
# no-fault rows are trace-equivalent to every other engine and to the
# reference — the oracle the tests pin.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ServerFaults:
    """One server's fault timeline in virtual time.

    ``downs``: ((down_t, up_t), ...) sorted, non-overlapping — the server
    does no work inside a window.  ``slowdowns``: ((t0, t1, factor), ...) —
    service accrues at ``1/factor`` speed while inside (factors of
    overlapping windows multiply).  Empty tuples = a healthy server.
    """

    downs: Tuple[Tuple[float, float], ...] = ()
    slowdowns: Tuple[Tuple[float, float, float], ...] = ()

    def __post_init__(self):
        last = -float("inf")
        for d, u in self.downs:
            if not (d >= last and u > d):
                raise ValueError("downs must be sorted, non-overlapping "
                                 "windows with up > down")
            last = u
        for t0, t1, f in self.slowdowns:
            if not (t1 > t0 and f > 1.0):
                raise ValueError("slowdown windows need t1 > t0, factor > 1")

    @classmethod
    def random(cls, rng, horizon: float, *, mtbf: float = 0.0,
               mttr: float = 5.0, stall_mtbf: float = 0.0,
               stall_s: float = 10.0,
               stall_factor: float = 2.0) -> "ServerFaults":
        """Poisson crash/stall timelines over ``[0, horizon)``.

        ``mtbf``/``stall_mtbf`` of 0 disable that fault class.  Repair and
        stall durations are fixed (``mttr`` / ``stall_s``) so a sweep axis
        over repair time changes exactly one thing.  Windows drawn from one
        ``rng`` — share the generator across paired conditions.
        """
        downs: List[Tuple[float, float]] = []
        if mtbf > 0.0:
            t = rng.exponential(mtbf)
            while t < horizon:
                downs.append((t, t + mttr))
                t = t + mttr + rng.exponential(mtbf)
        slows: List[Tuple[float, float, float]] = []
        if stall_mtbf > 0.0:
            t = rng.exponential(stall_mtbf)
            while t < horizon:
                slows.append((t, t + stall_s, stall_factor))
                t = t + stall_s + rng.exponential(stall_mtbf)
        return cls(downs=tuple(downs), slowdowns=tuple(slows))


def _simulate_faults_python(arrival, service, key, tau, faults,
                            deadline=None, in_service_timeout=False):
    """Serial fault engine (see module comment above for the contract).

    Returns ``(start, finish, promoted, promos, shed, timeout,
    requeues)``; shed requests carry ``start = finish = NaN``.

    ``deadline`` alone keeps the queue-wait semantics: only
    undispatched work is shed, started work always completes.  With
    ``in_service_timeout=True`` the deadline bounds the whole sojourn —
    pre-dispatch expiry still sheds, but a request whose completion
    would land past ``arrival + deadline`` is abandoned AT the deadline
    instant (``timeout[j] = True``, the server is freed at expiry),
    mirroring the sidecar's ``deadline_mode="sojourn"``.
    """
    import heapq
    n = arrival.shape[0]
    arr = arrival.tolist()
    svc = service.tolist()
    ks = key.tolist()
    downs = faults.downs
    slows = faults.slowdowns
    start = np.zeros(n)
    finish = np.zeros(n)
    promoted = np.zeros(n, bool)
    shed = np.zeros(n, bool)
    timeout = np.zeros(n, bool)
    fin = [False] * n            # terminal (served or shed)
    used = [0.0] * n             # service already received (work-conserving)
    last_seq = [-1] * n          # validity stamp of the live heap entry
    heap: list = []              # (key, seq, i): seq breaks ties == index
    guard = tau is not None      # order when no requeue has happened
    t = 0.0
    i_arr = 0
    oldest = 0
    promos = 0
    requeues = 0
    nterm = 0
    nq = 0                       # live (non-tombstone) heap entries
    seq = 0

    def down_until(x):
        for d, u in downs:
            if d <= x < u:
                return u
        return None

    def factor_at(x):
        f = 1.0
        for t0, t1, fac in slows:
            if t0 <= x < t1:
                f *= fac
        return f

    def next_boundary(x):
        b = float("inf")
        for d, _u in downs:
            if x < d < b:
                b = d
        for t0, t1, _f in slows:
            if x < t0 < b:
                b = t0
            if x < t1 < b:
                b = t1
        return b

    while nterm < n:
        if nq == 0:                               # queue empty: jump
            a = arr[i_arr]
            if t < a:
                t = a
        if downs:                                 # never dispatch while down
            u = down_until(t)
            if u is not None:
                t = u
        while i_arr < n and arr[i_arr] <= t:
            heapq.heappush(heap, (ks[i_arr], seq, i_arr))
            last_seq[i_arr] = seq
            seq += 1
            nq += 1
            i_arr += 1
        while fin[oldest]:
            oldest += 1
        was_promo = False
        if guard and (t - arr[oldest]) > tau:
            j = oldest                            # promote past the heap;
            was_promo = True                      # stale entry -> tombstone
        else:
            while True:
                _, s, j = heapq.heappop(heap)
                if not fin[j] and s == last_seq[j]:
                    break
        nq -= 1
        if deadline is not None and used[j] == 0.0 \
                and (t - arr[j]) > deadline:
            shed[j] = True                        # shed at dispatch, never
            fin[j] = True                         # once service has begun
            start[j] = float("nan")
            finish[j] = float("nan")
            nterm += 1
            continue
        if was_promo:
            promoted[j] = True
            promos += 1
        if used[j] == 0.0:
            start[j] = t                          # FIRST dispatch
        # sojourn budget (in_service_timeout): completion past expiry
        # abandons the work at the deadline instant — guarded so the
        # deadline=None path performs zero extra float ops (the bitwise
        # no-fault trace contract)
        exp_j = (arr[j] + deadline) \
            if (in_service_timeout and deadline is not None) else None
        while True:                               # serve, event-sliced
            rem = svc[j] - used[j]
            f = factor_at(t)
            tb = next_boundary(t)
            tc = t + rem * f                      # == t + svc[j] bitwise
            if exp_j is not None and exp_j < tc and exp_j <= tb:
                t = max(t, exp_j)                 # expiry may have passed
                finish[j] = t                     # while the server was down
                timeout[j] = True
                fin[j] = True
                nterm += 1
                break
            if tc <= tb:                          # when no faults active
                t = tc
                finish[j] = t
                fin[j] = True
                nterm += 1
                break
            used[j] += (tb - t) / f               # accrue partial service
            t = tb
            u = down_until(t)
            if u is not None:                     # crash mid-service:
                last_seq[j] = seq                 # work-conserving requeue
                heapq.heappush(heap, (ks[j], seq, j))
                seq += 1
                nq += 1
                requeues += 1
                t = u
                break
    return start, finish, promoted, promos, shed, timeout, requeues


def simulate_grid_faults(arrival, service, key, tau, faults,
                         deadline=None, in_service_timeout=False):
    """G fault-injected simulations in one call (Python engine only —
    fault rows are rare relative to the clean grids the C engine runs).

    ``faults``: one :class:`ServerFaults` shared by every row, or a
    length-G sequence (one timeline per row — pair timelines across
    conditions the same way workloads are paired).  ``deadline``: scalar
    queueing-delay budget or length-G sequence (None disables shedding).
    ``in_service_timeout``: the deadline bounds the whole sojourn —
    mid-service expiry terminates as ``timeout`` instead of completing
    (pre-dispatch expiry stays ``shed``).  Returns ``(start, finish,
    promoted, promotions, shed, timeout, requeues)`` with shed/timeout
    (G, n) bool and requeues (G,) int64 appended to the
    :func:`simulate_grid` contract.
    """
    arrival = np.ascontiguousarray(arrival, np.float64)
    service = np.ascontiguousarray(service, np.float64)
    key = np.ascontiguousarray(key, np.float64)
    G, n = arrival.shape
    tau_arr = np.array([np.nan if t is None else float(t) for t in tau],
                       np.float64)
    if tau_arr.shape != (G,):
        raise ValueError(f"tau must have length {G}")
    if isinstance(faults, ServerFaults):
        faults = [faults] * G
    if len(faults) != G:
        raise ValueError(f"faults must have length {G}")
    if deadline is None or np.isscalar(deadline):
        deadline = [deadline] * G
    start = np.empty((G, n))
    finish = np.empty((G, n))
    promoted = np.zeros((G, n), bool)
    shed = np.zeros((G, n), bool)
    timeout = np.zeros((G, n), bool)
    promotions = np.zeros(G, np.int64)
    requeues = np.zeros(G, np.int64)
    if n == 0:
        return (start, finish, promoted, promotions, shed, timeout,
                requeues)
    for g in range(G):
        tg = None if np.isnan(tau_arr[g]) else float(tau_arr[g])
        (start[g], finish[g], promoted[g], promotions[g], shed[g],
         timeout[g], requeues[g]) = _simulate_faults_python(
            arrival[g], service[g], key[g], tg, faults[g], deadline[g],
            in_service_timeout)
    return start, finish, promoted, promotions, shed, timeout, requeues


# --------------------------------------------------------------------------
# observability bridge
# --------------------------------------------------------------------------
def record_batch_trace(recorder, *, arrival, start, finish, req_ids,
                       ttft=None, out_tokens=None, replica=None,
                       statuses=None, segment_tokens: int = 8,
                       max_segments: int = 4) -> None:
    """Replay a DES result as flight-recorder spans in virtual time.

    Pure post-processing over the result arrays — the C/heapq engines are
    untouched, so tracing a simulation costs nothing unless requested.
    The emitted span schema (request / queue_wait / prefill / decode /
    decode_segment) is identical to what the live drains record, which is
    what makes a sim run and a live drain comparable as flame traces
    (``serving.observability`` holds the shared emitter).
    """
    from repro_torch.serving.observability import record_des_trace
    record_des_trace(recorder, arrival, start, finish, req_ids,
                     ttft=ttft, out_tokens=out_tokens, replica=replica,
                     statuses=statuses, segment_tokens=segment_tokens,
                     max_segments=max_segments)
