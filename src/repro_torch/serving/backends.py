"""Backend adapters: what the asyncio sidecar actually serves on (port of
``repro.serving.backends``).

The paper ships Clairvoyant as a *proxy* in front of serial LLM
backends (Ollama / llama.cpp-shaped processes).  The batch drains in
``serving/server.py`` talk to engines synchronously; the sidecar
(``serving/http_sidecar.py``) instead awaits a :class:`Backend`, one per
replica, behind a uniform async contract:

    out = await backend.generate(prompt, max_new_tokens=n,
                                 on_segment=push, cancel_cb=poll)
    # {"text", "tokens", "ttft_s", "service_s", "cancelled"}

* ``on_segment(delta: str)`` streams text out at fused-decode segment
  boundaries — the only points where tokens reach the host, hence the
  sidecar's SSE flush granularity.
* ``cancel_cb()`` is polled at the same boundaries; returning True (or a
  prior :meth:`Backend.request_cancel`) drains the request with
  ``cancelled=True`` — §3.4 semantics, now wire-triggerable by a client
  disconnect or a deadline expiry.
* injected faults surface as raises: :class:`EngineCrash` from the
  shared ``FaultInjector``'s segment polls, and
  :class:`TransientBackendError` from the HTTP adapter's connect/read
  timeouts — both feed the server's existing ``RetryPolicy`` /
  ``CircuitBreaker`` machinery unchanged.

Three adapters:

* :class:`SimTextBackend` — virtual service times from a
  ``ServiceTimeModel`` scaled by ``time_scale``, slept on the event loop
  and streamed as synthetic text.  The wire-level chaos tests and the
  ``launch.sidecar --backend sim`` demo run on this (hundreds of requests
  in seconds).
* :class:`InProcessBackend` — wraps a ``RealEngine``: the fused decode
  runs in a worker thread, segments marshal back to the loop.  The
  paper's single-binary deployment.
* :class:`HTTPBackend` — an external OpenAI-compatible HTTP backend
  (stdlib asyncio sockets only): POST /v1/chat/completions, optional SSE
  consumption, connect/read timeouts, and a ``probe()`` used for
  availability checks.  Fronts a real local-server process exactly as
  the paper describes — and doubles as the test/bench wire client
  against our own sidecar.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Callable, Optional

from repro_torch.data.tokenizer import approx_token_len
from repro_torch.serving.faults import TransientBackendError
from repro_torch.serving.service_time import ServiceTimeModel


def tokens_to_text(tokens) -> str:
    """Synthetic detokenization (the hash tokenizer is one-way): token
    ids render as ``t<id>`` words so wire responses carry *some* text
    whose word count equals the token count."""
    return " ".join(f"t{int(t)}" for t in tokens)


class Backend:
    """Async serial-backend contract (one in-flight request per replica).

    Subclasses implement :meth:`generate` and :meth:`probe`; the
    bookkeeping attributes (``busy_until``/``served``) let
    ``ClairvoyantServer`` treat a backend list as its ``engines=`` so
    routing, cancellation (``request_cancel``) and fault wiring
    (``fault_injector``) work unchanged.
    """

    def __init__(self, replica_id: int = 0):
        self.replica_id = replica_id
        self.busy_until = 0.0
        self.served = 0
        self.fault_injector = None
        #: virtual clock supplied by the sidecar (falls back to wall time
        #: from construction) — fault windows trigger against this
        self.clock: Optional[Callable[[], float]] = None
        self._t0 = time.monotonic()
        self._cancel = False

    def now(self) -> float:
        return self.clock() if self.clock is not None \
            else time.monotonic() - self._t0

    def request_cancel(self) -> None:
        """§3.4 mid-generation disconnect: observed at the next segment
        boundary."""
        self._cancel = True

    def _poll_cancel(self, cancel_cb) -> bool:
        """Shared segment-boundary poll: fault injector first (may raise
        EngineCrash — the crash lands exactly where a cancel would),
        then the engine flag, then the caller's callback."""
        if self.fault_injector is not None:
            self.fault_injector.poll_segment(self.replica_id)
        return self._cancel or (cancel_cb is not None and cancel_cb())

    async def generate(self, prompt: str, *, max_new_tokens: int = 32,
                       on_segment=None, cancel_cb=None) -> dict:
        raise NotImplementedError

    async def probe(self) -> bool:
        """Cheap availability check (half-open breaker probes, /readyz)."""
        return True

    def engine_stats(self) -> dict:
        """Uniform observability surface (mirrors the engines' method):
        whatever this backend can cheaply report about its serving state.
        Adapters that wrap a real engine delegate to it."""
        return {"replica": self.replica_id, "served": self.served}


class SimTextBackend(Backend):
    """Virtual-time backend: sleeps out a ``ServiceTimeModel`` service
    time (scaled by ``time_scale``) and streams synthetic text in
    segment-sized chunks.

    Service time is a function of the *request* (prompt tokens +
    ``max_new_tokens``), so SJF-vs-FCFS comparisons over the wire
    reproduce the virtual-time queueing results.  Injected stall windows
    stretch the sleeps; injected crashes raise out of the segment poll.
    """

    def __init__(self, model: Optional[ServiceTimeModel] = None,
                 replica_id: int = 0, *, time_scale: float = 1.0,
                 segment_tokens: int = 8):
        super().__init__(replica_id)
        self.model = model or ServiceTimeModel(prefill_tok_per_s=8000.0,
                                               decode_tok_per_s=60.0)
        self.time_scale = float(time_scale)
        self.segment_tokens = int(segment_tokens)

    async def generate(self, prompt: str, *, max_new_tokens: int = 32,
                       on_segment=None, cancel_cb=None) -> dict:
        self._cancel = False
        t0 = time.monotonic()
        ptoks = approx_token_len(prompt)
        n = max(1, int(max_new_tokens))
        full = self.model.service(ptoks, n) * self.time_scale
        prefill = (self.model.overhead_s
                   + ptoks / self.model.prefill_tok_per_s) * self.time_scale
        per_tok = max(0.0, full - prefill) / n
        await asyncio.sleep(prefill)
        ttft = time.monotonic() - t0
        tokens = [0]
        if on_segment is not None:
            on_segment(tokens_to_text(tokens))     # prefill token
        cancelled = False
        while len(tokens) < n:
            if self._poll_cancel(cancel_cb):       # may raise EngineCrash
                cancelled = True
                break
            k = min(self.segment_tokens, n - len(tokens))
            f = 1.0 if self.fault_injector is None \
                else self.fault_injector.stall_factor(self.replica_id,
                                                      self.now())
            await asyncio.sleep(per_tok * k * f)
            new = list(range(len(tokens), len(tokens) + k))
            tokens.extend(new)
            if on_segment is not None:
                on_segment(" " + tokens_to_text(new))
        self.served += not cancelled
        self._cancel = False
        return {"text": tokens_to_text(tokens), "tokens": len(tokens),
                "ttft_s": ttft, "service_s": time.monotonic() - t0,
                "cancelled": cancelled}


class InProcessBackend(Backend):
    """Wrap a ``RealEngine`` (fused on-device decode) behind the async
    contract: the blocking ``generate`` runs in a worker thread and
    segment callbacks marshal back to the event loop thread via
    ``call_soon_threadsafe`` (``on_segment`` always fires on the loop).
    """

    def __init__(self, engine, tokenizer=None):
        super().__init__(engine.replica_id)
        from repro_torch.data.tokenizer import HashTokenizer
        self.engine = engine
        self.tokenizer = tokenizer or HashTokenizer(engine.cfg.vocab_size)

    @property
    def fault_injector(self):
        return self.engine.fault_injector

    @fault_injector.setter
    def fault_injector(self, inj):
        # Backend.__init__ assigns None before self.engine exists
        if "engine" in self.__dict__:
            self.engine.fault_injector = inj

    def request_cancel(self) -> None:
        self.engine.request_cancel()

    async def generate(self, prompt: str, *, max_new_tokens: int = 32,
                       on_segment=None, cancel_cb=None) -> dict:
        loop = asyncio.get_running_loop()
        ids = self.tokenizer.encode(prompt)
        first = [True]

        def seg(new_tokens):
            # worker thread -> loop thread; deltas join with a space
            # except the very first
            delta = tokens_to_text(new_tokens)
            if first[0]:
                first[0] = False
            else:
                delta = " " + delta
            if on_segment is not None:
                loop.call_soon_threadsafe(on_segment, delta)

        out = await asyncio.to_thread(
            self.engine.generate, ids, max_new_tokens=max_new_tokens,
            cancel_cb=cancel_cb, on_segment=seg)
        self.served = self.engine.served
        res = {"text": tokens_to_text(out["tokens"]),
               "tokens": len(out["tokens"]), "ttft_s": out["ttft_s"],
               "service_s": out["service_s"],
               "cancelled": out["cancelled"]}
        if "accept_rate" in out:          # speculative engine
            res["accept_rate"] = out["accept_rate"]
        return res

    async def probe(self) -> bool:
        return True

    def engine_stats(self) -> dict:
        return self.engine.engine_stats()


class HTTPBackend(Backend):
    """External OpenAI-compatible HTTP backend over raw asyncio sockets.

    One connection per request (``Connection: close``), explicit
    connect/read timeouts, and SSE consumption when streaming.  Network
    failures and timeouts raise :class:`TransientBackendError` so the
    server's retry/breaker machinery treats a flaky upstream exactly
    like an injected transient.
    """

    def __init__(self, host: str, port: int, *,
                 path: str = "/v1/chat/completions", model: str = "default",
                 connect_timeout_s: float = 2.0,
                 read_timeout_s: float = 60.0,
                 probe_path: str = "/healthz", replica_id: int = 0):
        super().__init__(replica_id)
        self.host = host
        self.port = int(port)
        self.path = path
        self.model = model
        self.connect_timeout_s = float(connect_timeout_s)
        self.read_timeout_s = float(read_timeout_s)
        self.probe_path = probe_path

    # ----------------------------------------------------------- low level
    async def _connect(self):
        try:
            return await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port),
                self.connect_timeout_s)
        except Exception as e:
            raise TransientBackendError(
                f"connect {self.host}:{self.port} failed: "
                f"{type(e).__name__}: {e}") from e

    async def _read(self, coro):
        try:
            return await asyncio.wait_for(coro, self.read_timeout_s)
        except asyncio.TimeoutError as e:
            raise TransientBackendError(
                f"read timeout after {self.read_timeout_s}s from "
                f"{self.host}:{self.port}") from e
        except TransientBackendError:
            raise
        except Exception as e:
            raise TransientBackendError(
                f"read from {self.host}:{self.port} failed: "
                f"{type(e).__name__}: {e}") from e

    async def _request(self, method: str, path: str, body: bytes = b"",
                       headers: Optional[dict] = None):
        """Send one request, parse the status line + headers.  Returns
        (reader, writer, status:int, headers:dict)."""
        reader, writer = await self._connect()
        hdrs = {"Host": f"{self.host}:{self.port}",
                "Connection": "close",
                "Accept": "application/json, text/event-stream"}
        if body:
            hdrs["Content-Type"] = "application/json"
            hdrs["Content-Length"] = str(len(body))
        if headers:
            hdrs.update(headers)
        head = f"{method} {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n"
        try:
            writer.write(head.encode("ascii") + body)
            await self._read(writer.drain())
            status_line = await self._read(reader.readline())
            if not status_line:
                raise TransientBackendError(
                    f"{self.host}:{self.port} closed before responding")
            parts = status_line.decode("latin-1").split(None, 2)
            status = int(parts[1])
            resp_hdrs = {}
            while True:
                line = await self._read(reader.readline())
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin-1").partition(":")
                resp_hdrs[k.strip().lower()] = v.strip()
            return reader, writer, status, resp_hdrs
        except Exception:
            writer.close()
            raise

    @staticmethod
    def _close(writer) -> None:
        try:
            writer.close()
        except Exception:
            pass

    # ------------------------------------------------------------ generate
    async def generate(self, prompt: str, *, max_new_tokens: int = 32,
                       on_segment=None, cancel_cb=None,
                       extra: Optional[dict] = None,
                       headers: Optional[dict] = None) -> dict:
        self._cancel = False
        # stream whenever a consumer wants deltas at arrival OR might
        # cancel mid-flight: the buffered path can't observe either
        # until the upstream finishes
        stream = on_segment is not None or cancel_cb is not None
        payload = {"model": self.model,
                   "messages": [{"role": "user", "content": prompt}],
                   "max_tokens": int(max_new_tokens), "stream": stream}
        if extra:
            payload.update(extra)
        body = json.dumps(payload).encode()
        t0 = time.monotonic()
        reader, writer, status, hdrs = await self._request(
            "POST", self.path, body, headers)
        try:
            ctype = hdrs.get("content-type", "")
            if stream and status == 200 and "text/event-stream" in ctype:
                return await self._consume_sse(reader, on_segment,
                                               cancel_cb, t0)
            raw = await self._read(reader.read(-1))
            if status != 200:
                # upstream refusal/failure: retryable from this side
                raise TransientBackendError(
                    f"upstream {self.host}:{self.port} returned "
                    f"{status}: {raw[:200].decode('latin-1', 'replace')}")
            doc = json.loads(raw)
            text = doc["choices"][0]["message"]["content"] or ""
            toks = doc.get("usage", {}).get("completion_tokens",
                                            len(text.split()))
            extra_info = doc.get("clairvoyant", {})
            dt = time.monotonic() - t0
            return {"text": text, "tokens": int(toks),
                    "ttft_s": extra_info.get("ttft_s", dt),
                    "service_s": dt, "cancelled": False,
                    "accept_rate": extra_info.get("accept_rate")}
        finally:
            self._close(writer)

    async def _consume_sse(self, reader, on_segment, cancel_cb,
                           t0: float) -> dict:
        """Drain an SSE stream: forward deltas, honor cancellation
        between frames (close the upstream connection — our disconnect
        IS the cancel signal to a sidecar upstream)."""
        text_parts = []
        ttft = None
        finish = None
        cancelled = False
        while True:
            if self._poll_cancel(cancel_cb):
                cancelled = True
                break
            line = await self._read(reader.readline())
            if not line:
                break                       # upstream closed
            line = line.strip()
            if not line or not line.startswith(b"data:"):
                continue
            data = line[5:].strip()
            if data == b"[DONE]":
                break
            try:
                doc = json.loads(data)
            except ValueError:
                continue
            if "error" in doc:
                raise TransientBackendError(
                    f"upstream stream error: {doc['error'].get('message')}")
            choice = doc.get("choices", [{}])[0]
            delta = choice.get("delta", {}).get("content")
            if delta:
                if ttft is None:
                    ttft = time.monotonic() - t0
                text_parts.append(delta)
                if on_segment is not None:
                    on_segment(delta)
            if choice.get("finish_reason"):
                finish = choice["finish_reason"]
        dt = time.monotonic() - t0
        text = "".join(text_parts)
        return {"text": text, "tokens": len(text.split()),
                "ttft_s": ttft if ttft is not None else dt,
                "service_s": dt,
                "cancelled": cancelled or finish == "cancelled"}

    async def probe(self) -> bool:
        """GET the probe path; any 2xx within the timeouts = available."""
        try:
            reader, writer, status, _ = await self._request(
                "GET", self.probe_path)
        except Exception:
            return False
        try:
            await self._read(reader.read(-1))
        except Exception:
            pass
        self._close(writer)
        return 200 <= status < 300
