"""Flight recorder, Prometheus metrics, and online ranking-fidelity monitor.

The paper's claims — 0.029 ms predictor latency, 62–96% ranking accuracy,
70–76% short-P50 wins — are measured offline.  This module makes them
observable on live traffic:

* :class:`FlightRecorder` — a lock-cheap ring buffer of *complete* spans
  (both endpoints known at emission time, so there is no open-span state
  to synchronise).  Appends are single ``deque.append`` calls, which are
  atomic under the GIL; worker threads (``InProcessBackend``) and the
  event loop share one recorder without locks.  Exports Chrome/Perfetto
  ``trace_event`` JSON and structured JSONL.
* :class:`MetricsRegistry` + :class:`Counter` / :class:`Gauge` /
  :class:`Histogram` — Prometheus text exposition (format 0.0.4).  Hot
  paths only append raw observations; bucketing happens at scrape time.
  Scrape-time *collector* callbacks export stats the stack already keeps
  (fault_stats, router stats, allocator page states) at zero hot-path
  cost.
* :class:`RankingMonitor` — windowed pairwise concordance of the
  predicted scheduling key against the observed service time (the online
  analogue of the paper's §4.2 pairwise ranking accuracy), plus a
  Long-class calibration-drift stat.  Proxy predictors degrade silently
  under distribution shift (the paper's 52–66% cross-distribution
  regime), so this is the alarm wire.

Span timeline per request (identical schema for live drains and the DES,
so a sim run and a live drain produce comparable flame traces):

    request            (async, per-request track: arrival -> terminal)
      queue_wait       (async: arrival -> dispatch)
      prefill          (replica/lane track)
      decode           (replica/lane track)
        decode_segment (replica/lane track, one per fused segment)

plus ``feature_extract`` / ``predict`` spans when a predictor is
attached and ``route`` instant events from the router.

Everything is stdlib + numpy; nothing here imports the serving stack, so
``core`` modules may call into it without import cycles.
"""

from __future__ import annotations

import json
import math
import re
from bisect import bisect_left
from collections import defaultdict, deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Span", "FlightRecorder", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "parse_prometheus", "RankingMonitor",
    "Observability", "record_service_spans", "record_des_trace",
]


# =====================================================================
# Flight recorder
# =====================================================================

# Span kinds: "X" spans live on an exclusive track (a replica or a lane)
# and must nest-or-disjoint; "async" spans (request, queue_wait, and the
# batch-level admission stages) overlap freely across requests and
# export as Perfetto async b/e pairs.
_ASYNC_NAMES = frozenset({"request", "queue_wait", "feature_extract",
                          "predict"})


class Span:
    """A completed span. Plain attribute bag, created only on export."""

    __slots__ = ("name", "req_id", "t0", "t1", "track", "args")

    def __init__(self, name, req_id, t0, t1, track, args):
        self.name = name
        self.req_id = req_id
        self.t0 = t0
        self.t1 = t1
        self.track = track
        self.args = args

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Span({self.name!r}, req={self.req_id}, "
                f"[{self.t0:.6f}, {self.t1:.6f}], track={self.track!r})")


class FlightRecorder:
    """Ring-buffered recorder of completed spans and instant events.

    ``span()`` / ``instant()`` are the only hot-path entry points: each
    is one tuple construction plus one ``deque.append`` (GIL-atomic; no
    locks).  The ring drops the oldest spans once ``capacity`` is
    reached and counts the drops.  Timestamps are caller-supplied
    seconds on whichever clock the drain runs (virtual for the DES and
    sim drains, wall for the sidecar) — the recorder never reads a
    clock, which is what lets sim and live traces share one schema.
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = int(capacity)
        self._spans: deque = deque(maxlen=self.capacity)
        self._instants: deque = deque(maxlen=self.capacity)
        self.dropped = 0
        # req_id -> latest child-span end; lets the root "request" span
        # cover stragglers (e.g. a requeued dispatch after a cancel).
        self._last_end: Dict[int, float] = {}

    # ------------------------------------------------------------ record
    def span(self, name: str, req_id: int, t0: float, t1: float,
             track: str = "replica0", args: Optional[dict] = None) -> None:
        buf = self._spans
        if len(buf) == buf.maxlen:
            self.dropped += 1
        buf.append((name, req_id, t0, t1, track, args))
        le = self._last_end
        if t1 > le.get(req_id, -math.inf):
            le[req_id] = t1

    def extend(self, spans: Iterable[tuple]) -> None:
        """Bulk append of ``(name, req_id, t0, t1, track, args)`` tuples."""
        buf = self._spans
        le = self._last_end
        for tup in spans:
            if len(buf) == buf.maxlen:
                self.dropped += 1
            buf.append(tup)
            rid, t1 = tup[1], tup[3]
            if t1 > le.get(rid, -math.inf):
                le[rid] = t1

    def instant(self, name: str, req_id: int, t: float,
                track: str = "replica0",
                args: Optional[dict] = None) -> None:
        buf = self._instants
        if len(buf) == buf.maxlen:
            self.dropped += 1
        buf.append((name, req_id, t, track, args))

    def request_span(self, req_id: int, t0: float, t1: float,
                     args: Optional[dict] = None) -> None:
        """Emit the root ``request`` span, stretched to cover any child
        span that outlived the nominal sojourn (requeue/cancel races)."""
        t_last = self._last_end.pop(req_id, t1)
        self.span("request", req_id, t0, max(t1, t_last),
                  track=f"req{req_id}", args=args)

    # ------------------------------------------------------------ access
    def __len__(self) -> int:
        return len(self._spans)

    def spans(self) -> List[Span]:
        return [Span(*tup) for tup in self._spans]

    def instants(self) -> List[tuple]:
        return list(self._instants)

    def spans_for(self, req_id: int) -> List[Span]:
        return [Span(*tup) for tup in self._spans if tup[1] == req_id]

    def span_tree(self, req_id: int) -> Dict[str, object]:
        """The request's span tree: root + children sorted by start."""
        spans = sorted(self.spans_for(req_id), key=lambda s: (s.t0, s.t1))
        roots = [s for s in spans if s.name == "request"]
        children = [s for s in spans if s.name != "request"]
        return {"req_id": req_id, "root": roots[0] if roots else None,
                "roots": roots, "children": children}

    def schema(self) -> List[str]:
        """Sorted set of span names present — the trace's vocabulary."""
        return sorted({tup[0] for tup in self._spans})

    def clear(self) -> None:
        self._spans.clear()
        self._instants.clear()
        self._last_end.clear()
        self.dropped = 0

    # ---------------------------------------------------------- validate
    def validate(self, terminal_ids: Iterable[int],
                 ok_ids: Iterable[int] = (),
                 eps: float = 1e-9) -> List[str]:
        """Trace lifecycle invariants; returns a list of problems.

        * every terminal request has exactly one root ``request`` span
          and every child span lies within the root's bounds (the trace
          mirror of the no-lost-requests terminal gate);
        * requests that finished ``ok`` carry queue_wait/prefill/decode;
        * spans on exclusive (non-async) tracks nest and never overlap.
        """
        problems: List[str] = []
        by_req: Dict[int, List[tuple]] = defaultdict(list)
        by_track: Dict[str, List[tuple]] = defaultdict(list)
        for tup in self._spans:
            by_req[tup[1]].append(tup)
            if tup[0] not in _ASYNC_NAMES:
                by_track[tup[4]].append(tup)

        ok_ids = set(ok_ids)
        for rid in terminal_ids:
            spans = by_req.get(rid, [])
            roots = [s for s in spans if s[0] == "request"]
            if len(roots) != 1:
                problems.append(f"req {rid}: {len(roots)} root spans")
                continue
            _, _, r0, r1, _, _ = roots[0]
            for name, _, t0, t1, _, _ in spans:
                if name == "request":
                    continue
                if t0 < r0 - eps or t1 > r1 + eps:
                    problems.append(
                        f"req {rid}: span {name} [{t0:.6f},{t1:.6f}] "
                        f"outside root [{r0:.6f},{r1:.6f}]")
            if rid in ok_ids:
                names = {s[0] for s in spans}
                for need in ("queue_wait", "prefill", "decode"):
                    if need not in names:
                        problems.append(f"req {rid}: ok but no {need} span")

        for track, spans in by_track.items():
            spans.sort(key=lambda s: (s[2], -s[3]))
            stack: List[tuple] = []           # open (t0, t1) intervals
            for name, rid, t0, t1, _, _ in spans:
                while stack and t0 >= stack[-1][1] - eps:
                    stack.pop()
                if stack and t1 > stack[-1][1] + eps:
                    problems.append(
                        f"track {track}: span {name} (req {rid}) "
                        f"[{t0:.6f},{t1:.6f}] overlaps "
                        f"[{stack[-1][0]:.6f},{stack[-1][1]:.6f}]")
                stack.append((t0, t1))
        return problems

    # ------------------------------------------------------------ export
    def to_perfetto(self) -> Dict[str, object]:
        """Chrome/Perfetto ``trace_event`` JSON (dict; json.dumps-able).

        Exclusive tracks become threads (complete ``"X"`` events);
        async spans become ``"b"``/``"e"`` pairs keyed by request id;
        instants become ``"i"`` events.  ``ts``/``dur`` are microseconds
        on the drain's clock.  Events are sorted by ``ts``.
        """
        tracks = sorted({tup[4] for tup in self._spans
                         if tup[0] not in _ASYNC_NAMES}
                        | {tup[3] for tup in self._instants})
        tid = {tr: i + 1 for i, tr in enumerate(tracks)}
        meta: List[dict] = [{
            "ph": "M", "pid": 0, "name": "process_name", "tid": 0,
            "args": {"name": "clairvoyant"}}]
        for tr, t in tid.items():
            meta.append({"ph": "M", "pid": 0, "tid": t,
                         "name": "thread_name", "args": {"name": tr}})
        events: List[dict] = []
        for name, rid, t0, t1, track, args in self._spans:
            a = dict(args) if args else {}
            a["req_id"] = rid
            if name in _ASYNC_NAMES:
                events.append({"ph": "b", "cat": "request", "id": rid,
                               "name": name, "pid": 0, "tid": 0,
                               "ts": round(t0 * 1e6, 3), "args": a})
                events.append({"ph": "e", "cat": "request", "id": rid,
                               "name": name, "pid": 0, "tid": 0,
                               "ts": round(t1 * 1e6, 3)})
            else:
                events.append({"ph": "X", "cat": "span", "name": name,
                               "pid": 0, "tid": tid[track],
                               "ts": round(t0 * 1e6, 3),
                               "dur": round((t1 - t0) * 1e6, 3),
                               "args": a})
        for name, rid, t, track, args in self._instants:
            a = dict(args) if args else {}
            a["req_id"] = rid
            events.append({"ph": "i", "cat": "event", "name": name,
                           "pid": 0, "tid": tid.get(track, 0), "s": "t",
                           "ts": round(t * 1e6, 3), "args": a})
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped}}

    def write_perfetto(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_perfetto(), f)

    def jsonl_lines(self) -> List[str]:
        lines = []
        for name, rid, t0, t1, track, args in self._spans:
            lines.append(json.dumps(
                {"type": "span", "name": name, "req_id": rid,
                 "t0": round(t0, 9), "t1": round(t1, 9), "track": track,
                 "args": args or {}}, separators=(",", ":")))
        for name, rid, t, track, args in self._instants:
            lines.append(json.dumps(
                {"type": "instant", "name": name, "req_id": rid,
                 "t": round(t, 9), "track": track, "args": args or {}},
                separators=(",", ":")))
        return lines

    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for line in self.jsonl_lines():
                f.write(line + "\n")


def record_service_spans(rec: FlightRecorder, req_id: int, *,
                         start: float, finish: float,
                         arrival: Optional[float] = None,
                         ttft: float = 0.0,
                         out_tokens: Optional[int] = None,
                         segment_tokens: int = 8,
                         max_segments: int = 4,
                         track: str = "replica0",
                         queue_wait: bool = True) -> None:
    """Emit the shared queue_wait/prefill/decode(/segments) span group.

    Used by every drain (DES, sim, real, batched is per-lane but keeps
    the same names), which is what guarantees sim and live traces share
    one schema.  Decode is subdivided into at most ``max_segments``
    synthetic ``decode_segment`` spans sized by ``segment_tokens``
    (live drains overwrite these with measured boundaries by passing
    ``max_segments=0`` and emitting their own).
    """
    spans = []
    if queue_wait and arrival is not None:
        spans.append(("queue_wait", req_id, arrival, start,
                      f"req{req_id}", None))
    t_pref = min(start + max(ttft, 0.0), finish)
    spans.append(("prefill", req_id, start, t_pref, track, None))
    spans.append(("decode", req_id, t_pref, finish, track, None))
    if max_segments > 0 and finish > t_pref:
        n = 1
        if out_tokens is not None and segment_tokens > 0:
            n = max(1, -(-int(out_tokens) // int(segment_tokens)))
        n = min(n, max_segments)
        dt = (finish - t_pref) / n
        t = t_pref
        for i in range(n):
            t2 = finish if i == n - 1 else t + dt
            spans.append(("decode_segment", req_id, t, t2, track,
                          {"seg": i} if i == 0 else None))
            t = t2
    rec.extend(spans)


def record_des_trace(rec: FlightRecorder,
                     arrival: Sequence[float], start: Sequence[float],
                     finish: Sequence[float], req_ids: Sequence[int],
                     *, ttft: Optional[Sequence[float]] = None,
                     out_tokens: Optional[Sequence[int]] = None,
                     replica: Optional[Sequence[int]] = None,
                     statuses: Optional[Sequence[str]] = None,
                     segment_tokens: int = 8,
                     max_segments: int = 4) -> None:
    """Replay a DES result (arrival/start/finish arrays) as spans in
    virtual time — the same schema a live drain records, with zero
    DES inner-loop cost (pure post-processing)."""
    n = len(req_ids)
    for i in range(n):
        rid = int(req_ids[i])
        st, fin = float(start[i]), float(finish[i])
        if not (math.isfinite(st) and math.isfinite(fin)):
            continue
        trk = f"replica{int(replica[i])}" if replica is not None \
            else "replica0"
        otok = out_tokens[i] if out_tokens is not None else None
        record_service_spans(
            rec, rid, arrival=float(arrival[i]), start=st, finish=fin,
            ttft=float(ttft[i]) if ttft is not None else 0.0,
            out_tokens=int(otok) if otok is not None else None,
            segment_tokens=segment_tokens, max_segments=max_segments,
            track=trk)
        status = statuses[i] if statuses is not None else "ok"
        rec.request_span(rid, float(arrival[i]), fin,
                         args={"status": status})


# =====================================================================
# Prometheus metrics (text exposition format 0.0.4)
# =====================================================================

_LABEL_ESC = {"\\": "\\\\", "\n": "\\n", '"': '\\"'}


def _esc(v: str) -> str:
    return "".join(_LABEL_ESC.get(c, c) for c in str(v))


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v)) if v != int(v) else str(int(v))


class Counter:
    """Monotone counter; ``inc`` is a dict add (hot-path safe) and
    ``set_total`` mirrors an externally-kept monotone stat at scrape."""

    kind = "counter"

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._vals: Dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        self._vals[key] = self._vals.get(key, 0.0) + amount

    def set_total(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        self._vals[key] = float(value)

    def value(self, **labels) -> float:
        return self._vals.get(tuple(sorted(labels.items())), 0.0)

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._vals):
            lines.append(f"{self.name}{_fmt_labels(key)} "
                         f"{_fmt_value(self._vals[key])}")
        return lines


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        self._vals[key] = float(value)


_DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 150.0, 600.0)


class Histogram:
    """Prometheus histogram with deferred bucketing.

    ``observe`` appends the raw value to a per-labelset list (one dict
    lookup + one list append — cheap enough for terminal-rate paths);
    cumulative buckets are folded at ``render`` time.
    """

    kind = "histogram"

    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._pending: Dict[tuple, list] = defaultdict(list)
        self._counts: Dict[tuple, List[int]] = {}
        self._sum: Dict[tuple, float] = {}
        self._n: Dict[tuple, int] = {}

    def observe(self, value: float, **labels) -> None:
        self._pending[tuple(sorted(labels.items()))].append(value)

    def _fold(self) -> None:
        # observe() may run concurrently from worker threads: snapshot
        # the key list and drain each list by pop() (GIL-atomic).
        nb = len(self.buckets)
        for key in list(self._pending.keys()):
            vals = self._pending[key]
            counts = self._counts.setdefault(key, [0] * (nb + 1))
            while vals:
                v = vals.pop()
                counts[bisect_left(self.buckets, v)] += 1
                self._sum[key] = self._sum.get(key, 0.0) + v
                self._n[key] = self._n.get(key, 0) + 1

    def count(self, **labels) -> int:
        self._fold()
        return self._n.get(tuple(sorted(labels.items())), 0)

    def render(self) -> List[str]:
        self._fold()
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._counts):
            cum = 0
            base = dict(key)
            for b, c in zip(self.buckets, self._counts[key]):
                cum += c
                lb = tuple(sorted({**base, "le": _fmt_value(b)}.items()))
                lines.append(f"{self.name}_bucket{_fmt_labels(lb)} {cum}")
            cum += self._counts[key][-1]
            lb = tuple(sorted({**base, "le": "+Inf"}.items()))
            lines.append(f"{self.name}_bucket{_fmt_labels(lb)} {cum}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                         f"{_fmt_value(self._sum.get(key, 0.0))}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} "
                         f"{self._n.get(key, 0)}")
        return lines


class MetricsRegistry:
    """Named metrics + scrape-time collector callbacks."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._collectors: List[Callable[[], None]] = []

    def counter(self, name: str, help_: str) -> Counter:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Counter(name, help_)
        return m

    def gauge(self, name: str, help_: str) -> Gauge:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Gauge(name, help_)
        return m

    def histogram(self, name: str, help_: str,
                  buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = Histogram(name, help_, buckets)
        return m

    def add_collector(self, fn: Callable[[], None]) -> None:
        self._collectors.append(fn)

    def render(self) -> str:
        for fn in self._collectors:
            fn()
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].render())
        return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{[^{}]*\})?"
    r" (NaN|[+-]?Inf|[-+]?[0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?)"
    r"( [0-9]+)?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, List[tuple]]:
    """Strict-ish parser for exposition format 0.0.4.

    Returns ``{family: [(name, labels_dict, value), ...]}``; raises
    ``ValueError`` on any malformed line (the CI scrape gate).
    """
    families: Dict[str, List[tuple]] = {}
    typed: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                if parts[1] == "TYPE":
                    if len(parts) < 4 or parts[3] not in (
                            "counter", "gauge", "histogram", "summary",
                            "untyped"):
                        raise ValueError(
                            f"line {lineno}: bad TYPE line: {line!r}")
                    typed[parts[2]] = parts[3]
                continue
            raise ValueError(f"line {lineno}: bad comment: {line!r}")
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: malformed sample: {line!r}")
        name, lab_s, val_s = m.group(1), m.group(2), m.group(3)
        labels = {}
        if lab_s:
            body = lab_s[1:-1].strip().rstrip(",")
            if body:
                consumed = 0
                for lm in _LABEL_RE.finditer(body):
                    labels[lm.group(1)] = lm.group(2)
                    consumed += len(lm.group(0))
                leftover = len(body) - consumed - body.count(",")
                if leftover > 0 or not labels:
                    raise ValueError(
                        f"line {lineno}: malformed labels: {lab_s!r}")
        fam = name
        for suf in ("_bucket", "_sum", "_count", "_total"):
            if name.endswith(suf) and name[:-len(suf)] in typed:
                fam = name[:-len(suf)]
                break
        if fam not in typed and name not in typed:
            raise ValueError(f"line {lineno}: sample {name!r} has no "
                             f"# TYPE declaration")
        val = float(val_s.replace("+Inf", "inf").replace("-Inf", "-inf")
                    .replace("Inf", "inf"))
        families.setdefault(fam, []).append((name, labels, val))
    return families


# =====================================================================
# Online ranking-fidelity monitor
# =====================================================================

class RankingMonitor:
    """Windowed pairwise concordance of predicted key vs observed service.

    Scheduling quality under SJF is bounded by how well the predicted
    key *ranks* requests ("Learning to Rank" framing): for every pair of
    completed requests in the window, does ``sign(key_i - key_j)`` agree
    with ``sign(service_i - service_j)``?  Ties in either dimension are
    excluded (the paper's §4.2 pairwise-accuracy convention).  A
    concordance collapse below ``alert_threshold`` — e.g. an inverted
    or drifted predictor — raises the alert within one window.

    ``record`` is two deque appends; the O(W²) concordance fold runs
    lazily, at most once per ``window // 8`` new samples.
    """

    def __init__(self, window: int = 512, alert_threshold: float = 0.6):
        self.window = int(window)
        self.alert_threshold = float(alert_threshold)
        self._key: deque = deque(maxlen=self.window)
        self._obs: deque = deque(maxlen=self.window)
        self._p_long: deque = deque(maxlen=self.window)
        self._is_long: deque = deque(maxlen=self.window)
        self.recorded = 0
        self._cached: Optional[dict] = None
        self._dirty = 0

    def record(self, key: float, observed_s: float,
               p_long: float = math.nan,
               is_long: Optional[bool] = None) -> None:
        self._key.append(key)
        self._obs.append(observed_s)
        self._p_long.append(p_long)
        self._is_long.append(bool(is_long) if is_long is not None
                             else math.nan)
        self.recorded += 1
        self._dirty += 1

    def concordance(self) -> float:
        """Pairwise agreement in [0, 1]; NaN with < 2 usable pairs."""
        n = len(self._key)
        if n < 2:
            return math.nan
        k = np.asarray(self._key, dtype=np.float64)
        s = np.asarray(self._obs, dtype=np.float64)
        dk = np.sign(k[:, None] - k[None, :])
        ds = np.sign(s[:, None] - s[None, :])
        iu = np.triu_indices(n, k=1)
        dk, ds = dk[iu], ds[iu]
        mask = (dk != 0) & (ds != 0)
        total = int(mask.sum())
        if total == 0:
            return math.nan
        return float((dk[mask] == ds[mask]).sum() / total)

    def long_calibration_drift(self) -> float:
        """|mean predicted P(Long) - observed Long fraction| in-window."""
        p = np.asarray(self._p_long, dtype=np.float64)
        y = np.asarray(self._is_long, dtype=np.float64)
        ok = np.isfinite(p) & np.isfinite(y)
        if not ok.any():
            return math.nan
        return float(abs(p[ok].mean() - y[ok].mean()))

    def snapshot(self) -> dict:
        """Recompute-and-cache; call from scrape paths."""
        conc = self.concordance()
        drift = self.long_calibration_drift()
        alert = bool(len(self._key) >= max(8, self.window // 8)
                     and math.isfinite(conc)
                     and conc < self.alert_threshold)
        self._cached = {
            "window": len(self._key),
            "recorded": self.recorded,
            "concordance": None if math.isnan(conc) else round(conc, 4),
            "long_calibration_drift":
                None if math.isnan(drift) else round(drift, 4),
            "alert": alert,
            "alert_threshold": self.alert_threshold,
        }
        self._dirty = 0
        return self._cached

    def snapshot_cached(self) -> dict:
        """Cheap read for per-response surfacing: refreshes at most
        every ``window // 8`` new samples."""
        if self._cached is None or self._dirty >= max(1, self.window // 8):
            return self.snapshot()
        return self._cached


# =====================================================================
# Bundle
# =====================================================================

class Observability:
    """Recorder + metrics + ranking monitor, passed around as one handle.

    Any component may be None; hot-path call sites gate on the component
    (``rec = obs.recorder; if rec is not None: ...``), so a disabled
    component costs one attribute read and one comparison.
    """

    def __init__(self, recorder: Optional[FlightRecorder] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 ranking: Optional[RankingMonitor] = None):
        self.recorder = recorder
        self.metrics = metrics
        self.ranking = ranking
        self._h_ttft = self._h_sojourn = self._h_wait = None
        self._h_tps = self._h_pred = self._h_accept = None
        self._c_admit = self._c_term = None
        if metrics is not None:
            self._c_admit = metrics.counter(
                "clairvoyant_admissions_total", "Requests admitted")
            self._c_term = metrics.counter(
                "clairvoyant_terminals_total",
                "Terminal responses by status/class")
            self._h_ttft = metrics.histogram(
                "clairvoyant_ttft_seconds", "Time to first token")
            self._h_sojourn = metrics.histogram(
                "clairvoyant_sojourn_seconds",
                "End-to-end sojourn by class")
            self._h_wait = metrics.histogram(
                "clairvoyant_queue_wait_seconds", "Queue wait")
            self._h_tps = metrics.histogram(
                "clairvoyant_tokens_per_second", "Decode throughput",
                buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000,
                         2500, 5000, 10000, 50000))
            self._h_pred = metrics.histogram(
                "clairvoyant_predictor_latency_seconds",
                "Per-request predictor latency (feature extraction "
                "+ GBDT scoring)",
                buckets=(1e-6, 5e-6, 1e-5, 2.9e-5, 5e-5, 1e-4, 5e-4,
                         1e-3, 5e-3, 0.05))
            self._h_accept = metrics.histogram(
                "clairvoyant_accept_rate",
                "Speculative draft acceptance rate",
                buckets=tuple(i / 10 for i in range(11)))

    @classmethod
    def default(cls, capacity: int = 65536, window: int = 512,
                tracing: bool = True) -> "Observability":
        return cls(recorder=FlightRecorder(capacity) if tracing else None,
                   metrics=MetricsRegistry(),
                   ranking=RankingMonitor(window=window))

    # ------------------------------------------------------- event hooks
    def observe_admission(self, n: int, policy: str) -> None:
        if self._c_admit is not None:
            self._c_admit.inc(n, policy=policy)

    def observe_predict(self, n: int, seconds: float) -> None:
        """Batched admission scored ``n`` requests in ``seconds``; the
        histogram gets one amortised sample per request so batch sizes
        weight the distribution correctly."""
        if self._h_pred is not None and n > 0:
            per = seconds / n
            for _ in range(n):
                self._h_pred.observe(per)

    def observe_terminal(self, resp, arrival: Optional[float]) -> None:
        """One call per terminal response — the `_finish` hook."""
        if self._c_term is not None:
            self._c_term.inc(status=resp.status, klass=resp.klass or "")
            self._h_wait.observe(resp.queue_wait_s)
            if resp.status == "ok":
                self._h_sojourn.observe(resp.sojourn_s,
                                        klass=resp.klass or "")
                if resp.ttft_s is not None:
                    self._h_ttft.observe(resp.ttft_s)
                if resp.service_s > 0 and resp.tokens_generated:
                    self._h_tps.observe(
                        resp.tokens_generated / resp.service_s)
                if resp.accept_rate is not None:
                    self._h_accept.observe(resp.accept_rate)
        mon = self.ranking
        if mon is not None and resp.status == "ok" and resp.service_s > 0:
            mon.record(key=resp.p_long, observed_s=resp.service_s,
                       p_long=resp.p_long,
                       is_long=(resp.klass == "long")
                       if resp.klass else None)
        rec = self.recorder
        if rec is not None and arrival is not None:
            sojourn = resp.queue_wait_s + resp.service_s
            rec.request_span(
                resp.request_id, arrival, arrival + sojourn,
                args={"status": resp.status, "klass": resp.klass,
                      "p_long": round(resp.p_long, 4),
                      "replica": resp.replica})

    # --------------------------------------------------- scrape collector
    def register_server(self, server) -> None:
        """Scrape-time export of stats the server already keeps."""
        if self.metrics is None:
            return
        reg = self.metrics
        g_q = reg.gauge("clairvoyant_queue_depth",
                        "Queued requests per replica")
        g_bk = reg.gauge("clairvoyant_predicted_backlog_seconds",
                         "Predicted-work backlog per replica")
        g_inf = reg.gauge("clairvoyant_inflight",
                          "Admitted, non-terminal requests")
        g_deg = reg.gauge("clairvoyant_degraded",
                          "1 when the predictor is in degraded fallback")
        c_fault = reg.counter("clairvoyant_faults_total",
                              "Fault-layer events by kind")
        c_route = reg.counter("clairvoyant_router_total",
                              "Router events by kind")
        g_rank = reg.gauge("clairvoyant_ranking_concordance",
                           "Windowed pairwise ranking concordance")
        g_rwin = reg.gauge("clairvoyant_ranking_window",
                           "Samples in the ranking window")
        g_ralert = reg.gauge("clairvoyant_ranking_alert",
                             "1 when ranking concordance is below "
                             "the alert threshold")
        g_drift = reg.gauge("clairvoyant_long_calibration_drift",
                            "|mean P(Long) - observed Long fraction|")
        g_drop = reg.gauge("clairvoyant_trace_dropped_spans",
                           "Spans dropped by the flight-recorder ring")

        def collect():
            for r in server.router.replicas:
                lab = {"replica": str(r.replica_id)}
                g_q.set(len(r.queue), **lab)
                g_bk.set(r.predicted_backlog, **lab)
            g_inf.set(len(server._inflight))
            g_deg.set(1.0 if server.degraded else 0.0)
            for k, v in server.fault_stats.items():
                c_fault.set_total(v, kind=k)
            for k, v in server.router.stats.items():
                c_route.set_total(v, kind=k)
            mon = self.ranking
            if mon is not None:
                snap = mon.snapshot()
                if snap["concordance"] is not None:
                    g_rank.set(snap["concordance"])
                g_rwin.set(snap["window"])
                g_ralert.set(1.0 if snap["alert"] else 0.0)
                if snap["long_calibration_drift"] is not None:
                    g_drift.set(snap["long_calibration_drift"])
            if self.recorder is not None:
                g_drop.set(self.recorder.dropped)

        reg.add_collector(collect)

    def register_engines(self, engines) -> None:
        """Export lane occupancy / dead steps / accept rate / page states
        from engine ``stats()`` dicts at scrape time."""
        if self.metrics is None:
            return
        reg = self.metrics
        g_lane = reg.gauge("clairvoyant_lane_occupancy",
                           "Busy decode lanes per replica")
        c_dead = reg.counter("clairvoyant_dead_steps_total",
                             "Lane-steps wasted on dead lanes")
        g_acc = reg.gauge("clairvoyant_speculative_accept_rate",
                          "Cumulative draft-token acceptance rate")
        g_pages = reg.gauge("clairvoyant_pages",
                            "KV pool pages by state (free/cached/held)")

        def collect():
            for eng in engines:
                stats_fn = getattr(eng, "engine_stats", None) \
                    or getattr(eng, "stats_dict", None)
                st = stats_fn() if callable(stats_fn) else {}
                if not isinstance(st, dict):
                    continue
                rid = str(st.get("replica", getattr(eng, "replica_id", 0)))
                lab = {"replica": rid}
                if "lanes_busy" in st:
                    g_lane.set(st["lanes_busy"], **lab)
                if "dead_steps" in st:
                    c_dead.set_total(st["dead_steps"], **lab)
                if st.get("accept_rate") is not None:
                    g_acc.set(st["accept_rate"], **lab)
                pages = st.get("pages")
                if isinstance(pages, dict):
                    for state in ("free", "cached", "held"):
                        if state in pages:
                            g_pages.set(pages[state], state=state, **lab)

        reg.add_collector(collect)

    def render_metrics(self) -> str:
        if self.metrics is None:
            return ""
        return self.metrics.render()
