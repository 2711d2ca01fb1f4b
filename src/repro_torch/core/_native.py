"""Runtime-compiled C loops of the discrete-event simulator (the DES half
of ``repro.core._native``; its GBDT host scorer is not copied: packed
scoring in the port is K5 on the card and its plain version on the CPU).

``des_run_many`` is the serial-backend DES inner loop (see
``core.sim_fast``): G independent simulations over struct-of-arrays
request batches, each driven by an index-based binary min-heap keyed on
``(key[i], i)`` with lazy tombstones for starvation promotions.  All
arithmetic is C ``double`` -- bitwise identical to the Python reference
loop (``simulation.simulate_reference``), which also accumulates the
clock in float64.  ``des_preempt_run_many`` is the preemptive engine
(SRPT eviction, MLFQ quanta), bitwise equal to its heapq fallback.

This is host code: the simulator decides dispatch order, it runs no
model.  Each loop is compiled on first use with the system C compiler
(``cc``, ``gcc`` or ``clang``) into ``build/repro_torch/`` at the
repository root (listed in ``.gitignore``), under a name that carries a
hash of the source, and loaded with ``ctypes``.  Compilation is cached
and thread-safe, and optional: any failure (no compiler, a read-only
checkout) degrades to ``core.sim_fast``'s bitwise-equal heapq loops.
``REPRO_NO_NATIVE=1`` forces the fallbacks, as in the JAX package.  The
exported functions release the GIL (ctypes).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

_DES_SOURCE = r"""
#include <stdint.h>

/* One serial-server simulation over struct-of-arrays requests, indices
 * pre-sorted by (arrival, req_id).  The admission queue is an indexed
 * binary min-heap over (key[i], i): the seq tiebreak of the Python
 * SJFQueue collapses to the request index because pushes happen in
 * arrival order.  The starvation guard promotes the FIFO-oldest live
 * request past the heap; its stale heap entry becomes a tombstone that
 * pop skips via the done[] flags (lazy deletion, no re-heapify). */
static void des_run_one(const double* arrival, const double* service,
                        const double* key, double tau, int64_t n,
                        double* start, double* finish, uint8_t* promoted,
                        int64_t* promotions,
                        int32_t* heap, uint8_t* done) {
    int64_t hs = 0;          /* heap size (live + tombstones)            */
    int64_t i_arr = 0;       /* next not-yet-admitted arrival            */
    int64_t oldest = 0;      /* FIFO head: min index admitted & undone   */
    int64_t ndone = 0;
    int64_t promos = 0;
    double t = 0.0;
    for (int64_t i = 0; i < n; i++) done[i] = 0;
    while (ndone < n) {
        if (i_arr == ndone) {
            /* queue empty (admitted == done): jump to the next arrival */
            if (t < arrival[i_arr]) t = arrival[i_arr];
        }
        while (i_arr < n && arrival[i_arr] <= t) {
            /* heap push of index i_arr */
            int64_t c = hs++;
            heap[c] = (int32_t)i_arr;
            while (c > 0) {
                int64_t p = (c - 1) >> 1;
                int32_t hc = heap[c], hp = heap[p];
                if (key[hp] < key[hc] ||
                    (key[hp] == key[hc] && hp < hc)) break;
                heap[p] = hc; heap[c] = hp;
                c = p;
            }
            i_arr++;
        }
        while (oldest < i_arr && done[oldest]) oldest++;
        int64_t j;
        /* NaN tau disables the guard (any comparison with NaN is false);
         * negative tau promotes every waiter, like the Python queue. */
        if ((t - arrival[oldest]) > tau) {
            j = oldest;               /* promote past the heap */
            promoted[j] = 1;
            promos++;
        } else {
            /* heap pop, skipping tombstones of promoted requests */
            for (;;) {
                int32_t top = heap[0];
                int64_t last = --hs;
                if (hs > 0) {
                    heap[0] = heap[last];
                    int64_t c = 0;
                    for (;;) {
                        int64_t l = 2 * c + 1, r = l + 1, m = c;
                        if (l < hs && (key[heap[l]] < key[heap[m]] ||
                            (key[heap[l]] == key[heap[m]] &&
                             heap[l] < heap[m]))) m = l;
                        if (r < hs && (key[heap[r]] < key[heap[m]] ||
                            (key[heap[r]] == key[heap[m]] &&
                             heap[r] < heap[m]))) m = r;
                        if (m == c) break;
                        int32_t tmp = heap[c]; heap[c] = heap[m];
                        heap[m] = tmp;
                        c = m;
                    }
                }
                if (!done[top]) { j = top; break; }
            }
        }
        done[j] = 1;
        start[j] = t;
        t += service[j];
        finish[j] = t;
        ndone++;
    }
    *promotions = promos;
}

/* G independent simulations of n requests each; arrays are (G, n)
 * row-major, tau is per-cell (NaN disables the guard).  heap and
 * done are caller-provided scratch of n int32 / n uint8. */
void des_run_many(const double* arrival, const double* service,
                  const double* key, const double* tau,
                  int64_t g, int64_t n,
                  double* start, double* finish, uint8_t* promoted,
                  int64_t* promotions,
                  int32_t* heap, uint8_t* done) {
    for (int64_t s = 0; s < g; s++) {
        int64_t off = s * n;
        des_run_one(arrival + off, service + off, key + off, tau[s], n,
                    start + off, finish + off, promoted + off,
                    promotions + s, heap, done);
    }
}
"""

_DES_PREEMPT_SOURCE = r"""
#include <stdint.h>
#include <math.h>

/* Preemptive serial-server DES (policy modes SRPT / QUANTUM; see
 * core/sim_fast.py _simulate_preempt_python for the reference event
 * sequence — this loop performs the identical float64 arithmetic in the
 * identical order, so results match the Python engine bitwise).
 *
 * The queue is a binary min-heap of (key, seq) entries; an entry is
 * valid iff its job is QUEUED and it is the job's latest push (lastseq),
 * which makes eviction/requeue O(log n) with lazy invalidation.  The
 * starvation guard (strict wait > tau, NaN disables) applies at every
 * dispatch decision, like the non-preemptive engine. */

#define ST_WAIT 0
#define ST_QUEUED 1
#define ST_RUNNING 2
#define ST_DONE 3
#define LEVEL_STRIDE 1e9
#define MODE_SRPT 1
#define MODE_QUANTUM 2

static void pre_push(double* hkey, int64_t* hseq, int32_t* hidx,
                     int64_t* hs, int64_t* seqc,
                     const double* curk, int64_t* lastseq, int64_t j) {
    int64_t c = (*hs)++;
    hkey[c] = curk[j];
    hseq[c] = *seqc;
    hidx[c] = (int32_t)j;
    lastseq[j] = *seqc;
    (*seqc)++;
    while (c > 0) {
        int64_t p = (c - 1) >> 1;
        if (hkey[p] < hkey[c] ||
            (hkey[p] == hkey[c] && hseq[p] < hseq[c])) break;
        double tk = hkey[p]; hkey[p] = hkey[c]; hkey[c] = tk;
        int64_t ts = hseq[p]; hseq[p] = hseq[c]; hseq[c] = ts;
        int32_t ti = hidx[p]; hidx[p] = hidx[c]; hidx[c] = ti;
        c = p;
    }
}

static void pre_drop_root(double* hkey, int64_t* hseq, int32_t* hidx,
                          int64_t* hs) {
    int64_t last = --(*hs);
    if (last > 0) {
        hkey[0] = hkey[last]; hseq[0] = hseq[last]; hidx[0] = hidx[last];
        int64_t c = 0;
        for (;;) {
            int64_t l = 2 * c + 1, r = l + 1, m = c;
            if (l < last && (hkey[l] < hkey[m] ||
                (hkey[l] == hkey[m] && hseq[l] < hseq[m]))) m = l;
            if (r < last && (hkey[r] < hkey[m] ||
                (hkey[r] == hkey[m] && hseq[r] < hseq[m]))) m = r;
            if (m == c) break;
            double tk = hkey[c]; hkey[c] = hkey[m]; hkey[m] = tk;
            int64_t ts = hseq[c]; hseq[c] = hseq[m]; hseq[m] = ts;
            int32_t ti = hidx[c]; hidx[c] = hidx[m]; hidx[m] = ti;
            c = m;
        }
    }
}

static void des_preempt_one(const double* arrival, const double* service,
                            const double* key, double tau,
                            const double* quanta, int8_t mode, int64_t n,
                            double* start, double* finish, uint8_t* promoted,
                            int64_t* promotions, int64_t* preemptions,
                            double* hkey, int64_t* hseq, int32_t* hidx,
                            double* used, double* curk, double* budget,
                            int64_t* lastseq, uint8_t* state) {
    const double INF = HUGE_VAL;
    int64_t hs = 0, seqc = 0;
    int64_t i_arr = 0, oldest = 0, nq = 0, ndone = 0;
    int64_t promos = 0, preempts = 0;
    int64_t run = -1;
    double t = 0.0;
    for (int64_t i = 0; i < n; i++) {
        state[i] = ST_WAIT;
        used[i] = 0.0;
        curk[i] = key[i];
        budget[i] = (mode == MODE_QUANTUM && quanta) ? quanta[i] : INF;
        lastseq[i] = -1;
        start[i] = -1.0;                 /* sentinel: not yet dispatched */
        promoted[i] = 0;
    }
    while (ndone < n) {
        if (run < 0) {
            if (nq == 0 && t < arrival[i_arr]) t = arrival[i_arr];
            while (i_arr < n && arrival[i_arr] <= t) {
                state[i_arr] = ST_QUEUED;
                pre_push(hkey, hseq, hidx, &hs, &seqc, curk, lastseq,
                         i_arr);
                nq++;
                i_arr++;
            }
            while (state[oldest] == ST_DONE) oldest++;
            int64_t j;
            if (state[oldest] == ST_QUEUED && (t - arrival[oldest]) > tau) {
                j = oldest;              /* promote past the heap */
                promoted[j] = 1;
                promos++;
                nq--;
            } else {
                for (;;) {               /* pop until valid */
                    int64_t s = hseq[0];
                    int32_t cand = hidx[0];
                    pre_drop_root(hkey, hseq, hidx, &hs);
                    if (state[cand] == ST_QUEUED && s == lastseq[cand]) {
                        j = cand;
                        nq--;
                        break;
                    }
                }
            }
            state[j] = ST_RUNNING;
            run = j;
            if (start[j] < 0.0) start[j] = t;    /* first dispatch */
        }
        double rem = service[run] - used[run];
        double t_fin = t + rem;
        double t_q = (budget[run] < INF)
            ? t + (budget[run] - used[run]) : INF;
        double t_arr = (i_arr < n) ? arrival[i_arr] : INF;
        if (t_fin <= t_arr && t_fin <= t_q) {
            t = t_fin;                   /* completion */
            used[run] = service[run];
            finish[run] = t;
            state[run] = ST_DONE;
            ndone++;
            run = -1;
        } else if (t_q <= t_arr) {
            used[run] += t_q - t;        /* quantum expiry: demote */
            t = t_q;
            budget[run] = INF;
            curk[run] = curk[run] + LEVEL_STRIDE;
            state[run] = ST_QUEUED;
            pre_push(hkey, hseq, hidx, &hs, &seqc, curk, lastseq, run);
            nq++;
            run = -1;
        } else {
            used[run] += t_arr - t;      /* arrival event(s) */
            t = t_arr;
            while (i_arr < n && arrival[i_arr] <= t) {
                state[i_arr] = ST_QUEUED;
                pre_push(hkey, hseq, hidx, &hs, &seqc, curk, lastseq,
                         i_arr);
                nq++;
                i_arr++;
            }
            /* peek best valid entry, dropping stale roots */
            while (hs > 0) {
                int32_t cand = hidx[0];
                if (state[cand] == ST_QUEUED && hseq[0] == lastseq[cand])
                    break;
                pre_drop_root(hkey, hseq, hidx, &hs);
            }
            if (hs > 0) {
                double bk = hkey[0];
                /* SRPT remaining floored at 0, matching the Python
                 * engine and Policy.running_key */
                double rk = curk[run];
                if (mode == MODE_SRPT) {
                    rk = key[run] - used[run];
                    if (rk < 0.0) rk = 0.0;
                }
                if (bk < rk) {
                    if (mode == MODE_SRPT) curk[run] = rk;
                    state[run] = ST_QUEUED;   /* evict the running request */
                    pre_push(hkey, hseq, hidx, &hs, &seqc, curk, lastseq,
                             run);
                    nq++;
                    preempts++;
                    int64_t j;
                    for (;;) {
                        int64_t s = hseq[0];
                        int32_t cand = hidx[0];
                        pre_drop_root(hkey, hseq, hidx, &hs);
                        if (state[cand] == ST_QUEUED && s == lastseq[cand]) {
                            j = cand;
                            nq--;
                            break;
                        }
                    }
                    state[j] = ST_RUNNING;
                    run = j;
                    if (start[j] < 0.0) start[j] = t;
                }
            }
        }
    }
    *promotions = promos;
    *preemptions = preempts;
}

void des_preempt_run_many(const double* arrival, const double* service,
                          const double* key, const double* tau,
                          const double* quanta, const int8_t* mode,
                          int64_t g, int64_t n,
                          double* start, double* finish, uint8_t* promoted,
                          int64_t* promotions, int64_t* preemptions,
                          double* hkey, int64_t* hseq, int32_t* hidx,
                          double* used, double* curk, double* budget,
                          int64_t* lastseq, uint8_t* state) {
    for (int64_t s = 0; s < g; s++) {
        int64_t off = s * n;
        des_preempt_one(arrival + off, service + off, key + off, tau[s],
                        quanta + off, mode[s], n,
                        start + off, finish + off, promoted + off,
                        promotions + s, preemptions + s,
                        hkey, hseq, hidx, used, curk, budget, lastseq,
                        state);
    }
}
"""

_lock = threading.Lock()
_cache: dict = {}


def _compile_lib(name: str, source: str):
    """Compile ``source`` into ``build/repro_torch/<name>-<hash>.so`` unless
    that library exists, and load it; None when no compiler succeeds."""
    tag = hashlib.sha1(source.encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"{name}-{tag}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = f"{name}-{tag}.{os.getpid()}.{threading.get_ident()}"
        src, tmp = BUILD_DIR / f"{stem}.c", BUILD_DIR / f"{stem}.so"
        src.write_text(source)
        try:
            for cc in ("cc", "gcc", "clang"):
                try:
                    r = subprocess.run([cc, "-O3", "-shared", "-fPIC",
                                        str(src), "-o", str(tmp)],
                                       capture_output=True, timeout=120)
                except (OSError, subprocess.TimeoutExpired):
                    continue
                if r.returncode == 0:
                    os.replace(tmp, lib)
                    break
            else:
                return None
        finally:
            src.unlink(missing_ok=True)
            tmp.unlink(missing_ok=True)
    return ctypes.CDLL(str(lib))


def _compile_des():
    dll = _compile_lib("des_run", _DES_SOURCE)
    if dll is None:
        return None
    fn = dll.des_run_many
    i64 = ctypes.c_int64
    p = ctypes.POINTER
    pd = p(ctypes.c_double)
    fn.argtypes = [pd, pd, pd, pd, i64, i64, pd, pd, p(ctypes.c_uint8),
                   p(ctypes.c_int64), p(ctypes.c_int32), p(ctypes.c_uint8)]
    fn.restype = None
    return fn


def _compile_des_preempt():
    dll = _compile_lib("des_preempt", _DES_PREEMPT_SOURCE)
    if dll is None:
        return None
    fn = dll.des_preempt_run_many
    i64 = ctypes.c_int64
    p = ctypes.POINTER
    pd = p(ctypes.c_double)
    p64 = p(ctypes.c_int64)
    fn.argtypes = [pd, pd, pd, pd, pd, p(ctypes.c_int8), i64, i64,
                   pd, pd, p(ctypes.c_uint8), p64, p64,
                   pd, p64, p(ctypes.c_int32),
                   pd, pd, pd, p64, p(ctypes.c_uint8)]
    fn.restype = None
    return fn


def _native_fn(name: str, build_fn):
    if name in _cache:
        return _cache[name]
    with _lock:
        if name not in _cache:
            if os.environ.get("REPRO_NO_NATIVE"):
                _cache[name] = None
            else:
                try:
                    _cache[name] = build_fn()
                except Exception:
                    _cache[name] = None
    return _cache[name]


def native_des():
    """The compiled DES engine (``des_run_many``), or None."""
    return _native_fn("des", _compile_des)


def native_des_preempt():
    """The compiled preemptive DES engine, or None."""
    return _native_fn("des_preempt", _compile_des_preempt)


def des_engine() -> str:
    """Which DES engine ``core.sim_fast`` runs here: ``"native"`` (the C
    loops) or ``"python"`` (the heapq fallback)."""
    return "native" if native_des() is not None \
        and native_des_preempt() is not None else "python"


def as_ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))
