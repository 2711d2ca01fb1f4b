"""The asyncio HTTP/SSE sidecar: Clairvoyant on a real wire (port of
``repro.serving.http_sidecar``).

A stdlib-only HTTP/1.1 server (``asyncio.start_server``) that fronts a
:class:`~repro_torch.serving.server.ClairvoyantServer` with one async
:class:`~repro_torch.serving.backends.Backend` per replica.  The embedded
server keeps what it is good at — predictive admission (features ->
GBDT -> p_long), routing, the SJF queues + starvation guard, the
``_finish`` terminal gate (no-lost-requests), retries/breakers and fault
stats — while the sidecar owns the wire: per-replica async dispatch
loops, SSE streaming at fused-decode segment boundaries, and the
robustness envelope the paper's proxy needs in production:

* **Deadlines** — ``X-Deadline-S`` header (or ``timeout_s`` in the
  body, or the server-wide default) bounds the whole sojourn: expiry
  before dispatch sheds (HTTP 429), expiry mid-generation stops the
  decode at the next segment boundary with terminal ``timeout``
  (HTTP 504) — the fault layer's in-service status, wired end to end.
* **Disconnect cancellation** — a per-connection EOF watcher maps a
  dropped client onto ``ClairvoyantServer.cancel``: queued requests
  terminate ``cancelled`` immediately, mid-generation ones drain at the
  next segment boundary (§3.4), freeing the serial slot within
  ``segment_len`` tokens.
* **Backpressure** — bounded admission: server-side queue overflow
  sheds with 429 + ``Retry-After``; a wire-level in-flight cap returns
  503 + ``Retry-After`` before any work is queued.
* **Per-tenant rate limiting** — a token bucket per ``X-Tenant``
  header (which also feeds the ``fair_share`` policy's tenant field);
  over-rate requests get 429 + ``Retry-After`` without touching the
  scheduler.
* **Slow-client guards** — header/body read timeouts and bounded
  ``drain()`` waits on every write; a stalled reader is treated as a
  disconnect (its request is cancelled, the connection closed).
* **Health** — ``/healthz`` (process liveness + fault counters +
  per-replica engine stats: dead steps, speculative accept rate, paged
  pool page states) and ``/readyz`` (503 while draining, when every
  replica's breaker is open, or no backend is eligible), both
  reporting predictor degradation and per-replica breaker state;
  ``/readyz`` additionally carries the online ranking-fidelity
  snapshot.
* **Metrics** — ``/metrics`` serves Prometheus text exposition
  (``serving/observability.py``): admission/terminal counters, sojourn
  / TTFT / queue-wait / predictor-latency histograms, queue-depth and
  page-state gauges, wire-level counters, and the ranking-fidelity
  monitor.  A metrics+ranking :class:`Observability` bundle is created
  automatically when the server has none; attach one with a recorder
  to also capture Perfetto-exportable span traces.
* **Graceful drain** — ``shutdown()`` stops accepting, serves what it
  can inside ``drain_s``, then force-terminates the rest (queued ->
  ``cancelled``/"server shutdown", mid-generation -> segment-boundary
  cancel) so the no-lost-requests invariant holds across SIGTERM: every
  admitted request still gets exactly one terminal status and every
  open connection a well-formed response.

A request's waiter lives in ``_waiters`` from admission until its
terminal status: ``_on_finish`` pops it as the request resolves, before
the connection handler writes the response.  So ``/healthz``
``inflight``, the ``clairvoyant_wire_inflight`` gauge and the
``max_inflight`` cap count pre-terminal requests only, and a client that
adds the responses it holds to ``inflight`` never counts one twice.

Wire shapes are OpenAI-compatible (``serving/openai_api.py``): POST
``/v1/chat/completions`` returns a ``chat.completion`` body (plus a
``clairvoyant`` extension block), or an SSE stream of
``chat.completion.chunk`` frames ending in ``data: [DONE]`` when
``"stream": true``.  Terminal statuses map to HTTP codes via
``HTTP_STATUS`` (ok 200 / shed 429 / failed 502 / timeout 504 /
cancelled 499).
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Dict, List, Optional

from repro_torch.serving.faults import EngineCrash, TransientBackendError
from repro_torch.serving.observability import Observability
from repro_torch.serving.openai_api import (HTTP_STATUS, CompletionRequest,
                                      CompletionResponse,
                                      chat_completion_body, chat_chunk_body,
                                      error_body)
from repro_torch.serving.server import ClairvoyantServer

#: Prometheus text exposition content type (format 0.0.4)
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 408: "Request Timeout",
            413: "Payload Too Large", 429: "Too Many Requests",
            499: "Client Closed Request", 500: "Internal Server Error",
            502: "Bad Gateway", 503: "Service Unavailable",
            504: "Gateway Timeout"}

_MAX_BODY = 1 << 20          # 1 MiB request-body cap


class TokenBucket:
    """Per-tenant rate limiter: ``rate`` tokens/s, burst ``burst``."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_last = None

    def allow(self, now: float):
        """Returns ``(allowed, retry_after_s)``; consumes one token when
        allowed."""
        if self.t_last is not None:
            self.tokens = min(self.burst,
                              self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True, 0.0
        return False, max(0.0, (1.0 - self.tokens) / self.rate)


class _Waiter:
    """Per-request rendezvous between the dispatch loop and the
    connection handler: streamed deltas and the terminal response."""

    __slots__ = ("queue", "resp", "done")

    def __init__(self):
        self.queue: asyncio.Queue = asyncio.Queue()
        self.resp: Optional[CompletionResponse] = None
        self.done = asyncio.Event()

    def push_delta(self, delta: str) -> None:
        if not self.done.is_set():
            self.queue.put_nowait(("delta", delta))

    def finish(self, resp: CompletionResponse) -> None:
        self.resp = resp
        self.done.set()
        self.queue.put_nowait(("done", resp))


class Sidecar:
    """The wire wrapper.  Construct with a ``ClairvoyantServer`` whose
    ``engines`` are :class:`~repro_torch.serving.backends.Backend` adapters
    (``deadline_mode="sojourn"`` — the wire semantics), then ``await
    start()``.
    """

    def __init__(self, server: ClairvoyantServer, *,
                 host: str = "127.0.0.1", port: int = 0,
                 model: str = "default",
                 max_inflight: int = 256,
                 tenant_rate: Optional[float] = None,
                 tenant_burst: float = 10.0,
                 header_timeout_s: float = 10.0,
                 write_timeout_s: float = 10.0,
                 drain_s: float = 30.0,
                 max_new_tokens: int = 64):
        if server.deadline_mode != "sojourn":
            raise ValueError("the sidecar requires deadline_mode='sojourn' "
                             "(in-service expiry must be enforceable)")
        self.server = server
        self.backends = list(server.engines)
        self.host = host
        self.port = port
        self.model = model
        self.max_inflight = int(max_inflight)
        self.tenant_rate = tenant_rate
        self.tenant_burst = float(tenant_burst)
        self.header_timeout_s = float(header_timeout_s)
        self.write_timeout_s = float(write_timeout_s)
        self.drain_s = float(drain_s)
        self.max_new_tokens = int(max_new_tokens)

        self._t0 = time.monotonic()
        self._srv: Optional[asyncio.base_events.Server] = None
        self._dispatchers: List[asyncio.Task] = []
        self._kick: List[asyncio.Event] = []
        self._waiters: Dict[int, _Waiter] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._conns: set = set()
        self._stopping = False
        self._hard_stop = False
        self._stopped = asyncio.Event()
        self.wire_stats = {"connections": 0, "requests": 0,
                           "rate_limited": 0, "rejected_busy": 0,
                           "disconnects": 0, "slow_clients": 0,
                           "bad_requests": 0}
        # terminal gate hook: resolve the wire waiter whenever ANY path
        # (admission shed, drain, cancel, shutdown) emits a terminal
        self._orig_finish = server._finish
        server._finish = self._on_finish
        # backends are not RealEngines, so the server's constructor did
        # not wire the injector/clock — the sidecar owns that
        for b in self.backends:
            if server.faults is not None:
                b.fault_injector = server.faults
            b.clock = self.now
        # observability: every sidecar is scrapeable.  When the caller
        # didn't attach a bundle, build the metrics + ranking default
        # (tracing stays opt-in: attach Observability.default() with a
        # recorder before constructing the sidecar to also get spans).
        if getattr(server, "obs", None) is None:
            server.attach_observability(Observability.default(tracing=False))
        self.obs = server.obs
        if self.obs.metrics is not None:
            self._register_wire_metrics()

    # ------------------------------------------------------------ plumbing
    def now(self) -> float:
        """The sidecar's virtual clock IS wall time since construction
        (arrivals, deadlines and fault windows share this axis)."""
        return time.monotonic() - self._t0

    def _register_wire_metrics(self) -> None:
        """Scrape-time export of the wire-level stats the sidecar keeps."""
        reg = self.obs.metrics
        c_wire = reg.counter("clairvoyant_wire_total",
                             "Wire-level events by kind")
        g_winf = reg.gauge("clairvoyant_wire_inflight",
                           "Open wire requests (pre-terminal waiters)")
        g_conn = reg.gauge("clairvoyant_wire_connections",
                           "Open TCP connections")

        def collect():
            for k, v in self.wire_stats.items():
                c_wire.set_total(v, kind=k)
            g_winf.set(len(self._waiters))
            g_conn.set(len(self._conns))

        reg.add_collector(collect)

    def _on_finish(self, resp: CompletionResponse) -> None:
        self._orig_finish(resp)
        w = self._waiters.pop(resp.request_id, None)   # terminal: not inflight
        if w is not None:
            w.finish(resp)

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        self._srv = await asyncio.start_server(self._handle_conn,
                                               self.host, self.port)
        if self.port == 0:
            self.port = self._srv.sockets[0].getsockname()[1]
        for rep, backend in zip(self.server.router.replicas, self.backends):
            self._kick.append(asyncio.Event())
            self._dispatchers.append(asyncio.create_task(
                self._dispatch_loop(rep, backend)))

    async def shutdown(self, drain_s: Optional[float] = None) -> None:
        """Graceful drain: stop accepting, serve in-flight work inside
        the budget, then force-terminate what remains — every admitted
        request still exits through the terminal gate."""
        self._stopping = True
        if self._srv is not None:
            # stop listening; open connections are drained and closed
            # below.  (Awaiting Server.wait_closed() here, as the JAX
            # sidecar does, blocks on Python >= 3.12 until every open
            # connection has closed, i.e. until all in-flight work is done,
            # so the drain budget could never cut anything.)
            self._srv.close()
        budget = self.drain_s if drain_s is None else float(drain_s)
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if not self.server._decoding and not any(
                    rep.queue.live() for rep in self.server.router.replicas):
                break
            await asyncio.sleep(0.005)
        # budget exhausted (or already drained): cancel mid-generation
        # work at the next segment boundary, terminate everything queued
        self._hard_stop = True
        for b in self.backends:
            b.request_cancel()
        for rep in self.server.router.replicas:
            for req in list(rep.queue.live()):
                rep.queue.remove(req.req_id)
                self.server.router.release(rep.replica_id, req)
                self.server._finish(CompletionResponse(
                    request_id=req.req_id, text="", tokens_generated=0,
                    queue_wait_s=max(0.0, self.now() - req.arrival),
                    service_s=0.0, replica=rep.replica_id,
                    p_long=req.p_long, klass=req.klass,
                    status="cancelled", error="server shutdown",
                    retries=req.meta.get("fault_retries", 0),
                    degraded=bool(req.meta.get("degraded"))))
        self._stopped.set()
        for ev in self._kick:
            ev.set()
        if self._dispatchers:
            await asyncio.gather(*self._dispatchers, return_exceptions=True)
        # connection handlers finish their final writes; then force-close
        for _ in range(100):                 # <=1 s of grace
            if not self._conns:
                break
            await asyncio.sleep(0.01)
        for w in list(self._conns):
            try:
                w.close()
            except Exception:
                pass
        self._conns.clear()
        if self._srv is not None:
            await self._srv.wait_closed()

    # --------------------------------------------------------- dispatching
    async def _dispatch_loop(self, rep, backend) -> None:
        """One replica's serial serve loop: pop (starvation guard applied
        per decision, like the virtual-time drains) -> serve -> repeat.
        Exits when shutdown has terminated the queue."""
        kick = self._kick[rep.replica_id]
        while True:
            req = rep.queue.pop(now=self.now())
            if req is None:
                if self._stopped.is_set():
                    return
                kick.clear()
                try:
                    await asyncio.wait_for(kick.wait(), timeout=0.05)
                except asyncio.TimeoutError:
                    pass
                continue
            try:
                await self._serve_one(rep, backend, req)
            except Exception as e:           # defensive: never lose a pop
                if req.req_id not in self.server._terminal:
                    self.server._retry_or_fail(rep, req, self.now(), e,
                                               charge_backoff=False)

    async def _serve_one(self, rep, backend, req) -> None:
        srv = self.server
        t = max(self.now(), req.arrival)
        if srv._maybe_shed(rep, req, t):
            return                           # pre-dispatch expiry: shed
        # injected transient at dispatch (same point as the drains)
        if srv.faults is not None:
            spec = srv.faults.transient_due(rep.replica_id, t)
            if spec is not None:
                nb = srv._retry_or_fail(rep, req, t,
                                        TransientBackendError(
                                            "injected transient backend "
                                            "error"))
                await asyncio.sleep(max(0.0, nb - t))    # serial backoff
                return
        if req.start is None:
            req.start = t
        rid = req.req_id
        creq = srv._inflight.get(rid)
        n_new = max(1, min(creq.max_tokens if creq else self.max_new_tokens,
                           req.meta.get("output_tokens",
                                        self.max_new_tokens)))
        dl = srv._deadline_of(req)
        deadline_hit = []

        def cancel_cb() -> bool:
            if self._hard_stop:
                return True
            if dl is not None and (self.now() - req.arrival) > dl:
                deadline_hit.append(True)
                return True
            return False

        w = self._waiters.get(rid)
        on_segment = w.push_delta if w is not None and creq is not None \
            and creq.stream else None
        rec = self.obs.recorder
        seg_marks: List[float] = []
        if rec is not None:
            # wrap the delta pusher so every segment boundary leaves a
            # timestamp mark (streamed or not) for decode_segment spans
            _push = on_segment

            def on_segment(delta, _p=_push, _m=seg_marks):
                _m.append(self.now())
                if _p is not None:
                    _p(delta)
        srv._decoding[rep.replica_id] = rid
        try:
            out = await backend.generate(req.prompt, max_new_tokens=n_new,
                                         on_segment=on_segment,
                                         cancel_cb=cancel_cb)
        except Exception as e:
            t_err = self.now()
            if isinstance(e, EngineCrash) and e.repair_s > 0:
                await asyncio.sleep(e.repair_s)          # replica down
                t_err = self.now()
            nb = srv._retry_or_fail(rep, req, t_err, e,
                                    charge_backoff=not isinstance(
                                        e, EngineCrash))
            await asyncio.sleep(max(0.0, nb - t_err))    # serial backoff
            return
        finally:
            srv._decoding.pop(rep.replica_id, None)
        t_end = self.now()
        backend.busy_until = t_end
        retries = req.meta.get("fault_retries", 0)
        common = dict(request_id=rid, tokens_generated=out["tokens"],
                      queue_wait_s=req.start - req.arrival,
                      service_s=out["service_s"] if retries == 0
                      else t_end - req.start,
                      ttft_s=req.start - req.arrival + out["ttft_s"],
                      promoted=req.promoted, replica=rep.replica_id,
                      p_long=req.p_long, klass=req.klass, retries=retries,
                      degraded=bool(req.meta.get("degraded")),
                      accept_rate=out.get("accept_rate"))
        req.finish = t_end
        if rec is not None:
            # spans land before _finish so the root "request" span (the
            # observe_terminal hook) stretches over them
            trk = f"replica{rep.replica_id}"
            t_gen0 = max(t, t_end - out["service_s"])
            t_pref = min(t_gen0 + max(out["ttft_s"], 0.0), t_end)
            rec.span("queue_wait", rid, req.arrival, t_gen0,
                     track=f"req{rid}")
            rec.span("prefill", rid, t_gen0, t_pref, track=trk)
            rec.span("decode", rid, t_pref, t_end, track=trk)
            edges = [t_pref]
            for m in seg_marks:           # measured segment boundaries
                if t_pref < m < t_end:
                    edges.append(max(m, edges[-1]))
            edges.append(t_end)
            for i in range(len(edges) - 1):
                if edges[i + 1] > edges[i]:
                    rec.span("decode_segment", rid, edges[i],
                             edges[i + 1], track=trk)
        if out["cancelled"]:
            if rid in srv._disconnected:
                srv._disconnected.discard(rid)
                srv._finish(CompletionResponse(
                    text=out["text"], status="cancelled",
                    error="client disconnect (mid-generation)", **common))
            elif deadline_hit:
                srv.fault_stats["timeouts"] += 1
                srv.router.release(rep.replica_id, req)
                srv._finish(CompletionResponse(
                    text=out["text"], status="timeout",
                    error="deadline expired in service", **common))
            else:                            # shutdown hard-stop
                srv.router.release(rep.replica_id, req)
                srv._finish(CompletionResponse(
                    text=out["text"], status="cancelled",
                    error="server shutdown", **common))
            return
        srv.router.on_dispatch(rep.replica_id, req, t_end,
                               service_estimate=out["service_s"])
        srv.router.record_success(rep.replica_id, t_end)
        srv._finish(CompletionResponse(text=out["text"], status="ok",
                                       **common))

    # ------------------------------------------------------------- the wire
    async def _handle_conn(self, reader, writer) -> None:
        self.wire_stats["connections"] += 1
        self._conns.add(writer)
        try:
            await self._handle_one(reader, writer)
        except (ConnectionError, asyncio.TimeoutError):
            pass
        except Exception:
            try:
                await self._respond(writer, 500,
                                    error_body("failed", "internal error"))
            except Exception:
                pass
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_one(self, reader, writer) -> None:
        try:
            line = await asyncio.wait_for(reader.readline(),
                                          self.header_timeout_s)
        except asyncio.TimeoutError:
            return
        if not line:
            return
        try:
            method, path, _ = line.decode("latin-1").split(None, 2)
        except ValueError:
            self.wire_stats["bad_requests"] += 1
            await self._respond(writer, 400,
                                error_body("failed", "malformed request"))
            return
        headers = {}
        while True:
            h = await asyncio.wait_for(reader.readline(),
                                       self.header_timeout_s)
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        path = path.split("?", 1)[0]
        if method == "GET" and path == "/healthz":
            await self._respond(writer, 200, self._health_doc())
            return
        if method == "GET" and path == "/readyz":
            ready, doc = self._ready_doc()
            await self._respond(writer, 200 if ready else 503, doc)
            return
        if method == "GET" and path == "/metrics":
            await self._respond_text(writer, 200,
                                     self.obs.render_metrics(),
                                     METRICS_CONTENT_TYPE)
            return
        if path != "/v1/chat/completions":
            await self._respond(writer, 404,
                                error_body("failed", f"no route {path}"))
            return
        if method != "POST":
            await self._respond(writer, 405,
                                error_body("failed", "POST required"))
            return
        await self._handle_chat(reader, writer, headers)

    async def _handle_chat(self, reader, writer, headers) -> None:
        srv = self.server
        self.wire_stats["requests"] += 1
        if self._stopping:
            await self._respond(writer, 503,
                                error_body("shed", "server draining"),
                                extra={"Retry-After": "1"})
            return
        if len(self._waiters) >= self.max_inflight:
            self.wire_stats["rejected_busy"] += 1
            await self._respond(writer, 503,
                                error_body("shed", "too many in-flight "
                                           "requests"),
                                extra={"Retry-After": "1"})
            return
        try:
            clen = int(headers.get("content-length", "0"))
            if clen > _MAX_BODY:
                await self._respond(writer, 413,
                                    error_body("failed", "body too large"))
                return
            raw = await asyncio.wait_for(reader.readexactly(clen),
                                         self.header_timeout_s)
            body = json.loads(raw) if raw else {}
            prompt = body.get("prompt")
            if prompt is None:
                msgs = body.get("messages") or []
                prompt = msgs[-1]["content"] if msgs else None
            if not prompt or not isinstance(prompt, str):
                raise ValueError("no prompt/messages content")
        except (asyncio.TimeoutError, asyncio.IncompleteReadError):
            self.wire_stats["bad_requests"] += 1
            await self._respond(writer, 408,
                                error_body("failed", "body read timeout"))
            return
        except Exception as e:
            self.wire_stats["bad_requests"] += 1
            await self._respond(writer, 400,
                                error_body("failed", f"bad request: {e}"))
            return
        tenant = headers.get("x-tenant") or body.get("user") or "default"
        # per-tenant token bucket: refusal happens BEFORE the scheduler
        # sees the request (rate-limited work is never admitted)
        if self.tenant_rate is not None:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                bucket = self._buckets[tenant] = TokenBucket(
                    self.tenant_rate, self.tenant_burst)
            okay, after = bucket.allow(self.now())
            if not okay:
                self.wire_stats["rate_limited"] += 1
                await self._respond(
                    writer, 429,
                    error_body("shed", f"tenant {tenant!r} over rate "
                               f"limit"),
                    extra={"Retry-After": f"{after:.3f}"})
                return
        stream = bool(body.get("stream"))
        dl = headers.get("x-deadline-s", body.get("timeout_s"))
        try:
            dl = None if dl is None else float(dl)
        except (TypeError, ValueError):
            await self._respond(writer, 400,
                                error_body("failed", "bad deadline"))
            return
        # pre-register the waiter so an admission-time shed (overflow)
        # resolves it synchronously inside submit()
        rid = srv.allocate_id()
        w = _Waiter()
        self._waiters[rid] = w
        creq = CompletionRequest(
            prompt=prompt, max_tokens=int(body.get("max_tokens", 1024)),
            model=body.get("model", self.model), tenant=tenant,
            stream=stream, request_id=rid)
        otoks = body.get("output_tokens")      # test/bench oracle override
        try:
            replica = srv.submit(
                creq, arrival=self.now(),
                true_output_tokens=None if otoks is None else int(otoks),
                klass=body.get("klass", ""), deadline_s=dl)
        except RuntimeError as e:              # e.g. every breaker open
            self._waiters.pop(rid, None)
            await self._respond(writer, 503,
                                error_body("shed", str(e), request_id=rid),
                                extra={"Retry-After": "1"})
            return
        if replica >= 0:
            self._kick[replica].set()
        watcher = asyncio.create_task(self._watch_disconnect(reader, rid))
        try:
            if stream:
                await self._stream_response(writer, rid, w)
            else:
                await w.done.wait()
                resp = w.resp
                await self._respond(
                    writer, HTTP_STATUS[resp.status],
                    chat_completion_body(resp, self.model,
                                         extra=self._clairvoyant_extra())
                    if resp.status == "ok"
                    else error_body(resp.status, resp.error or resp.status,
                                    request_id=rid),
                    extra={"Retry-After": "1"}
                    if resp.status == "shed" else None)
        finally:
            watcher.cancel()
            try:
                await watcher
            except (asyncio.CancelledError, Exception):
                pass
            self._waiters.pop(rid, None)

    async def _stream_response(self, writer, rid: int, w: _Waiter) -> None:
        """SSE writer: chunk frames at segment boundaries, a final frame
        carrying ``finish_reason`` (the terminal status), an error frame
        for non-ok terminals, then ``[DONE]``.  A pre-first-delta
        failure degrades to a plain JSON error response."""
        started = False
        while True:
            kind, payload = await w.queue.get()
            if kind == "delta":
                if not started:
                    head = ("HTTP/1.1 200 OK\r\n"
                            "Content-Type: text/event-stream\r\n"
                            "Cache-Control: no-cache\r\n"
                            "Connection: close\r\n\r\n")
                    writer.write(head.encode("ascii"))
                    started = True
                frame = "data: " + json.dumps(chat_chunk_body(
                    rid, self.model, payload)) + "\n\n"
                writer.write(frame.encode())
                await self._guarded_drain(writer, rid)
                continue
            resp: CompletionResponse = payload
            if not started:
                # nothing streamed yet: plain JSON is kinder to clients
                await self._respond(
                    writer, HTTP_STATUS[resp.status],
                    chat_completion_body(resp, self.model,
                                         extra=self._clairvoyant_extra())
                    if resp.status == "ok"
                    else error_body(resp.status, resp.error or resp.status,
                                    request_id=rid),
                    extra={"Retry-After": "1"}
                    if resp.status == "shed" else None)
                return
            finish = "stop" if resp.status == "ok" else resp.status
            frames = ["data: " + json.dumps(chat_chunk_body(
                rid, self.model, "", finish_reason=finish)) + "\n\n"]
            if resp.status != "ok":
                frames.append("data: " + json.dumps(error_body(
                    resp.status, resp.error or resp.status,
                    request_id=rid)) + "\n\n")
            frames.append("data: [DONE]\n\n")
            writer.write("".join(frames).encode())
            await self._guarded_drain(writer, rid, final=True)
            return

    async def _guarded_drain(self, writer, rid: int,
                             final: bool = False) -> None:
        """Bounded write: a client that cannot take bytes within
        ``write_timeout_s`` is a stalled reader — treat as disconnect
        (cancel the request) instead of wedging the connection handler."""
        try:
            await asyncio.wait_for(writer.drain(), self.write_timeout_s)
        except (asyncio.TimeoutError, ConnectionError):
            if not final:
                self.wire_stats["slow_clients"] += 1
                self._client_gone(rid)
            raise ConnectionError("slow or disconnected client")

    async def _watch_disconnect(self, reader, rid: int) -> None:
        """EOF watcher: the client closing (or resetting) its half of
        the connection cancels the request — queued or mid-generation."""
        try:
            await reader.read(1)             # EOF (or stray bytes) = gone
        except asyncio.CancelledError:
            raise
        except Exception:
            pass
        self._client_gone(rid)

    def _client_gone(self, rid: int) -> None:
        if rid in self.server._terminal:
            return
        self.wire_stats["disconnects"] += 1
        self.server.cancel(rid)

    # --------------------------------------------------------------- health
    def _clairvoyant_extra(self) -> Optional[dict]:
        """Extra keys for the response ``clairvoyant`` block: the online
        ranking-fidelity snapshot (cheap — cached between refreshes)."""
        mon = self.obs.ranking
        return {"ranking": mon.snapshot_cached()} if mon is not None \
            else None

    def _health_doc(self) -> dict:
        srv = self.server
        return {"status": "ok", "stopping": self._stopping,
                "degraded": srv.degraded,
                "inflight": len(self._waiters),
                "fault_stats": dict(srv.fault_stats),
                "wire_stats": dict(self.wire_stats),
                # per-replica engine detail: dead_steps, speculative
                # accept_rate, paged-pool page states, ... (whatever the
                # backend can report)
                "engines": [b.engine_stats() for b in self.backends
                            if hasattr(b, "engine_stats")],
                "replicas": self._replica_docs()}

    def _ready_doc(self):
        srv = self.server
        now = self.now()
        eligible = [r for r in srv.router.replicas
                    if srv.router.eligible(r.replica_id, now)]
        ready = not self._stopping and bool(eligible)
        mon = self.obs.ranking
        doc = {"ready": ready, "stopping": self._stopping,
               "degraded": srv.degraded,
               "eligible_replicas": len(eligible),
               "ranking": mon.snapshot_cached() if mon is not None
               else None,
               "replicas": self._replica_docs()}
        return ready, doc

    def _replica_docs(self) -> list:
        return [{"id": r.replica_id, "healthy": r.healthy,
                 "breaker": r.breaker.state if r.breaker is not None
                 else "none",
                 "queued": len(r.queue)}
                for r in self.server.router.replicas]

    async def _respond(self, writer, status: int, doc: dict,
                       extra: Optional[dict] = None) -> None:
        body = json.dumps(doc).encode()
        hdrs = {"Content-Type": "application/json",
                "Content-Length": str(len(body)),
                "Connection": "close"}
        if extra:
            hdrs.update(extra)
        head = f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}\r\n" \
            + "".join(f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n"
        writer.write(head.encode("ascii") + body)
        try:
            await asyncio.wait_for(writer.drain(), self.write_timeout_s)
        except (asyncio.TimeoutError, ConnectionError):
            pass

    async def _respond_text(self, writer, status: int, text: str,
                            content_type: str = "text/plain") -> None:
        """Plain-text response (the /metrics exposition body)."""
        body = text.encode("utf-8")
        head = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n")
        writer.write(head.encode("ascii") + body)
        try:
            await asyncio.wait_for(writer.drain(), self.write_timeout_s)
        except (asyncio.TimeoutError, ConnectionError):
            pass
