"""The port's sidecar stack against the JAX package's.

* The copied modules decide alike on the same events: every registered
  policy's queue order, ``FaultPlan``/``FaultInjector`` schedules,
  ``RetryPolicy`` backoffs, ``CircuitBreaker`` transitions, the
  ``PredictiveRouter``'s placements, and the flight recorder's spans and
  Prometheus text.
* The server's serial drain handles injected transients, segment-boundary
  crashes and deadlines as the JAX server does, on the same weights.
* The wire contracts of ``tests/test_sidecar.py`` hold for the port's
  ``Sidecar`` over ``InProcessBackend``s with reduced engines on the CPU:
  SSE framing, bodies, health, rate limits, the in-flight cap,
  deadlines, disconnects, ``/metrics``, crash retries and a graceful
  shutdown that holds work in flight on purpose (a gated backend), so
  "the drain cut someone" is a contract here, not a race.
* One loopback burst through the JAX ``Sidecar`` and the port's, on the
  same weights (``bridge.params_from_jax``), gives the same texts, HTTP
  codes and dispatch order under ``fcfs`` and ``sjf``.

Every asyncio run has its own ``asyncio.wait_for`` limit, so a hung
socket fails one test instead of the suite.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import asyncio
import dataclasses
import json
import time

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core import policy as jpolicy
from repro.core.gbdt import GBDTParams as JParams
from repro.core.predictor import Predictor as JPredictor
from repro.core.router import PredictiveRouter as JRouter
from repro.core.scheduler import Request as JRequest
from repro.core.scheduler import SJFQueue as JQueue
from repro.data.corpus import sample_dataset as jsample
from repro.serving import faults as jfaults
from repro.serving import observability as jobs
from repro.serving.backends import InProcessBackend as JInProcessBackend
from repro.serving.engine import RealEngine as JEngine
from repro.serving.http_sidecar import Sidecar as JSidecar
from repro.serving.openai_api import CompletionRequest as JCompletion
from repro.serving.openai_api import CompletionResponse as JResponse
from repro.serving.server import ClairvoyantServer as JServer
from repro_torch.configs import get_config
from repro_torch.core import policy
from repro_torch.core.gbdt import GBDTModel
from repro_torch.core.predictor import Predictor
from repro_torch.core.router import PredictiveRouter
from repro_torch.core.scheduler import Request, SJFQueue
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving import faults, observability
from repro_torch.serving.backends import (HTTPBackend, InProcessBackend,
                                          tokens_to_text)
from repro_torch.serving.engine import RealEngine
from repro_torch.serving.http_sidecar import Sidecar
from repro_torch.serving.openai_api import (HTTP_STATUS, STATUSES,
                                            CompletionRequest,
                                            CompletionResponse)
from repro_torch.serving.server import ClairvoyantServer

CFG = get_config("smollm-360m").reduced()
LIMIT_S = 60.0


def _run(coro, limit=LIMIT_S):
    async def bounded():
        return await asyncio.wait_for(coro, limit)
    return asyncio.run(bounded())


# ------------------------------------------------- copies decide alike
@pytest.mark.parametrize("name", jpolicy.registered_names())
def test_queue_order_equal_jax_for_every_policy(name):
    """A seeded push/pop/cancel sequence under each registered policy:
    the same pops, promotions and keys in both packages."""
    assert policy.registered_names() == jpolicy.registered_names()
    rng = np.random.default_rng(3)
    port, jq = SJFQueue(name, tau=1.5), JQueue(name, tau=1.5)
    now, next_id = 0.0, 0
    for _ in range(300):
        now += float(rng.exponential(0.1))
        op = rng.random()
        if op < 0.55:
            kw = dict(req_id=next_id, arrival=now,
                      p_long=float(rng.random()),
                      true_service=float(rng.exponential(2.0)),
                      tenant=f"t{int(rng.integers(3))}",
                      accept_rate=float(rng.random())
                      if rng.random() < 0.5 else None)
            port.push(Request(**kw))
            jq.push(JRequest(**kw))
            next_id += 1
        elif op < 0.9:
            a, b = port.pop(now), jq.pop(now)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.req_id, a.promoted, a.meta["queue_key"]) == \
                    (b.req_id, b.promoted, b.meta["queue_key"])
        else:
            victim = int(rng.integers(0, max(next_id, 1)))
            assert port.cancel(victim) == jq.cancel(victim)
    assert port.stats == jq.stats


def test_fault_plans_and_injector_schedules_equal_jax():
    kw = dict(crash_mtbf=3.0, crash_mttr=0.5, transient_rate=0.8,
              stall_mtbf=4.0, stall_s=1.0, predictor_mtbf=5.0,
              predictor_mttr=0.7, n_replicas=3)
    plan = faults.FaultPlan.random(11, 30.0, **kw)
    jplan = jfaults.FaultPlan.random(11, 30.0, **kw)
    assert [dataclasses.astuple(s) for s in plan] == \
        [dataclasses.astuple(s) for s in jplan]
    extra = [("crash", 4), ("crash", 9), ("lane_crash", 6)]
    inj = faults.FaultInjector(faults.FaultPlan(
        list(plan) + [faults.FaultSpec(kind=k, after_polls=n)
                      for k, n in extra]
        + [faults.FaultSpec(kind="overflow", at=2.0, duration=0.5)]))
    jinj = jfaults.FaultInjector(jfaults.FaultPlan(
        list(jplan) + [jfaults.FaultSpec(kind=k, after_polls=n)
                       for k, n in extra]
        + [jfaults.FaultSpec(kind="overflow", at=2.0, duration=0.5)]))

    def trace(inj, mod):
        out = []
        for step in range(300):
            t, r = step * 0.1, step % 3
            spec = inj.transient_due(r, t)
            crash = inj.crash_between(r, t, t + 0.1)
            try:
                inj.poll_segment(r)
                polled = None
            except mod.EngineCrash as e:
                polled = (str(e), e.repair_s)
            lane = inj.lane_crash_due(r)
            out.append((spec and spec.at, crash and crash.at, polled,
                        lane and lane.after_polls, inj.stall_factor(r, t),
                        inj.predictor_down(t), inj.overflow_active(t)))
        return out

    assert trace(inj, faults) == trace(jinj, jfaults)
    rp, jrp = faults.RetryPolicy(seed=4), jfaults.RetryPolicy(seed=4)
    assert [rp.backoff(i % 4) for i in range(20)] == \
        [jrp.backoff(i % 4) for i in range(20)]


def test_circuit_breaker_transitions_equal_jax():
    rng = np.random.default_rng(8)
    cb, jcb = faults.CircuitBreaker(2, 0.5), jfaults.CircuitBreaker(2, 0.5)
    now, seen = 0.0, set()
    for _ in range(400):
        now += float(rng.exponential(0.1))
        op = int(rng.integers(4))
        if op == 0:
            got, want = cb.allow(now), jcb.allow(now)
        elif op == 1:
            got, want = cb.would_allow(now), jcb.would_allow(now)
        elif op == 2:
            got, want = cb.record_failure(now), jcb.record_failure(now)
        else:
            got, want = cb.record_success(now), jcb.record_success(now)
        assert got == want
        assert (cb.state, cb.failures, cb.opened_at) == \
            (jcb.state, jcb.failures, jcb.opened_at)
        seen.add(cb.state)
    assert seen == {"open", "half_open", "closed"}


def _outcome(fn):
    """fn()'s result, or the type of the error it raised."""
    try:
        return fn()
    except RuntimeError as e:                  # no eligible replica
        return type(e).__name__


def test_router_placements_equal_jax():
    """Seeded routing with breakers, failures, dispatches, releases,
    hedging and a replica loss: the same choices and stats."""
    rng = np.random.default_rng(12)
    r = PredictiveRouter(3, policy="sjf", tau=2.0,
                         breaker=faults.CircuitBreaker(2, 0.4))
    jr = JRouter(3, policy="sjf", tau=2.0,
                 breaker=jfaults.CircuitBreaker(2, 0.4))
    now, next_id, reqs = 0.0, 0, {}
    for step in range(300):
        now += float(rng.exponential(0.05))
        op = rng.random()
        if op < 0.5:
            proba = rng.dirichlet(np.ones(3))
            kw = dict(req_id=next_id, arrival=now, p_long=float(proba[2]))
            a, b = Request(**kw), JRequest(**kw)
            assert _outcome(lambda: r.route(a, proba=proba, now=now)) == \
                _outcome(lambda: jr.route(b, proba=proba, now=now))
            reqs[next_id] = (a, b)
            next_id += 1
        elif op < 0.65:
            rep = int(rng.integers(3))
            r.record_failure(rep, now)
            jr.record_failure(rep, now)
        elif op < 0.8:
            rep = int(rng.integers(3))
            got = r.replicas[rep].queue.pop(now)
            want = jr.replicas[rep].queue.pop(now)
            assert (got and got.req_id) == (want and want.req_id)
            if got is not None:
                r.on_dispatch(rep, got, now)
                jr.on_dispatch(rep, want, now)
                r.record_success(rep, now)
                jr.record_success(rep, now)
        elif op < 0.9 and reqs:
            rid = int(rng.choice(list(reqs)))
            rep = reqs[rid][0].meta.get("replica")
            if rep is not None:
                r.release(rep, reqs[rid][0])
                jr.release(rep, reqs[rid][1])
        else:
            assert _outcome(lambda: [q.req_id for q in
                                     r.hedge_overdue(now, 1.0)]) == \
                _outcome(lambda: [q.req_id for q in
                                  jr.hedge_overdue(now, 1.0)])
        assert r.queue_lengths() == jr.queue_lengths()
        assert [x.predicted_backlog for x in r.replicas] == \
            [x.predicted_backlog for x in jr.replicas]
    now += 10.0                                 # every breaker recovers
    assert _outcome(lambda: [q.req_id for q in r.fail_replica(1, now)]) == \
        _outcome(lambda: [q.req_id for q in jr.fail_replica(1, now)])
    assert r.stats == jr.stats and r.stats["breaker_opens"] > 0


def test_recorder_and_prometheus_text_equal_jax():
    """The same admissions, predictor timings, terminals and spans give
    the same Prometheus exposition, the same parse and the same
    Perfetto trace in both packages."""
    outs = []
    for obs_mod, resp_cls in ((observability, CompletionResponse),
                              (jobs, JResponse)):
        obs = obs_mod.Observability.default(capacity=64, window=8)
        rng = np.random.default_rng(1)
        for rid in range(1, 21):
            arrival = rid * 0.25
            obs.observe_admission(1, "sjf")
            obs.observe_predict(1, 1e-4 * rid)
            obs_mod.record_service_spans(
                obs.recorder, rid, arrival=arrival, start=arrival + 0.1,
                finish=arrival + 0.9, ttft=0.05, max_segments=3,
                track="replica0")
            status = STATUSES[rid % len(STATUSES)]
            obs.observe_terminal(resp_cls(
                request_id=rid, text="", tokens_generated=rid % 7,
                queue_wait_s=0.1, service_s=0.8 if status == "ok" else 0.0,
                ttft_s=0.15, p_long=float(rng.random()), klass="short"
                if rid % 2 else "long", status=status), arrival)
        text = obs.render_metrics()
        outs.append((text, obs_mod.parse_prometheus(text),
                     json.dumps(obs.recorder.to_perfetto(), sort_keys=True),
                     obs.recorder.validate(range(1, 21))))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1] and outs[0][1]
    assert outs[0][2:] == outs[1][2:]


# ------------------------------------ the server's serial drain vs JAX
@pytest.fixture(scope="module")
def pair():
    """A JAX engine and the port's engine on the same weights."""
    jeng = JEngine(jax_config("smollm-360m").reduced(), max_len=160,
                   segment_len=8, seed=0)
    state = params_from_jax(jax.tree.map(np.asarray, jeng.params), CFG)
    return jeng, state


def _port_engine(state=None, pace_s=0.0, **kw):
    eng = RealEngine(CFG, state_dict=state, max_len=160,
                     segment_len=kw.pop("segment_len", 8), device="cpu",
                     **kw)
    if pace_s:
        eng.fault_injector = _Pacer(pace_s)
    return eng


class _Pacer:
    """Stands in for a fault injector: each segment-boundary poll sleeps,
    so a reduced CPU engine decodes at a wire-observable pace."""

    def __init__(self, seconds):
        self.seconds = seconds

    def poll_segment(self, replica):
        time.sleep(self.seconds)


def test_drain_real_faults_and_deadlines_match_jax(pair):
    """Transients at dispatch, crashes at segment boundaries (retried,
    then failed once retries run out) and a sojourn deadline: the same
    terminal statuses, retries, token counts and finish order as the
    JAX server on the same weights."""
    jeng, state = pair
    eng = _port_engine(state)
    specs = [("transient", dict(at=0.0)), ("crash", dict(after_polls=2)),
             ("crash", dict(after_polls=3)), ("crash", dict(after_polls=4)),
             ("crash", dict(after_polls=5))]
    results = []
    for mod, srv_cls, creq, engine in (
            (faults, ClairvoyantServer, CompletionRequest, eng),
            (jfaults, JServer, JCompletion, jeng)):
        engine.busy_until = 0.0
        srv = srv_cls(policy="fcfs", engines=[engine], seed=0,
                      fault_plan=mod.FaultPlan(
                          [mod.FaultSpec(kind=k, **v) for k, v in specs]),
                      retry=mod.RetryPolicy(max_retries=1, base_s=0.0),
                      deadline_mode="sojourn")
        for i in range(5):
            srv.submit(creq(prompt=f"drain request {i} " * (i + 1),
                            max_tokens=24), arrival=0.0,
                       true_output_tokens=24,
                       deadline_s=1e-4 if i == 4 else None)
        resp = srv.drain(max_new_tokens=24)
        engine.fault_injector = None
        results.append(([(r.request_id, r.status, r.retries,
                          r.tokens_generated) for r in resp],
                        dict(srv.fault_stats)))
    assert results[0] == results[1]
    statuses = {s for _, s, _, _ in results[0][0]}
    assert {"ok", "failed", "shed"} <= statuses


def test_max_queue_depth_sheds_at_admission():
    srv = ClairvoyantServer(policy="fcfs", engines=[_port_engine()],
                            max_queue_depth=2)
    got = [srv.submit(CompletionRequest(prompt=f"p{i}", max_tokens=4))
           for i in range(4)]
    assert got == [0, 0, -1, -1]
    assert [r.status for r in srv.responses] == ["shed", "shed"]
    srv.drain(max_new_tokens=4)
    assert sorted(srv._terminal) == [1, 2, 3, 4]
    assert srv.fault_stats["sheds"] == 2


def test_drain_serves_preemptive_policies():
    """The serial drain serves a preemptive policy (arrival-aware pops,
    eviction at segment boundaries): the request ends ``ok`` with its
    full budget."""
    srv = ClairvoyantServer(policy="srpt", engines=[_port_engine()])
    srv.submit(CompletionRequest(prompt="x", max_tokens=2),
               true_output_tokens=2)
    resp = srv.drain(max_new_tokens=2)
    assert [(r.status, r.tokens_generated) for r in resp] == [("ok", 2)]


# --------------------------------------------------------- wire helpers
def _make_sidecar(n_replicas=1, pace_s=0.0, backend_cls=InProcessBackend,
                  specs=None, **kw):
    backends = [backend_cls(_port_engine(replica_id=i, pace_s=pace_s))
                for i in range(n_replicas)]
    sidecar_kw = {k: kw.pop(k) for k in
                  ("max_inflight", "tenant_rate", "tenant_burst",
                   "drain_s") if k in kw}
    server = ClairvoyantServer(
        policy="sjf", tau=1.0, engines=backends, deadline_mode="sojourn",
        seed=0, fault_plan=faults.FaultPlan(specs) if specs else None,
        retry=faults.RetryPolicy(max_retries=2, base_s=0.01, seed=0), **kw)
    return Sidecar(server, port=0, **sidecar_kw)


def _parse_http(data: bytes):
    head, _, body = data.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    hdrs = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        hdrs[k.strip().lower()] = v.strip()
    return status, hdrs, body


def _parse_sse(body: bytes):
    frames = []
    for block in body.decode().split("\n\n"):
        block = block.strip()
        if block:
            assert block.startswith("data: "), f"bad SSE frame: {block!r}"
            frames.append(block[len("data: "):])
    return frames


async def _request(port, body=None, headers=None, method="POST",
                   path="/v1/chat/completions", disconnect_after=None):
    """One raw loopback HTTP exchange: ("json", status, obj), ("sse",
    status, frames), ("text", status, str) or ("disconnected", None,
    None)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        payload = b"" if body is None else json.dumps(body).encode()
        hdrs = {"Host": "loopback", "Connection": "close"}
        if payload:
            hdrs["Content-Type"] = "application/json"
            hdrs["Content-Length"] = str(len(payload))
        hdrs.update(headers or {})
        writer.write((f"{method} {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n"
        ).encode() + payload)
        await writer.drain()
        if disconnect_after is not None:
            await asyncio.sleep(disconnect_after)
            return "disconnected", None, None
        data = await asyncio.wait_for(reader.read(), timeout=30.0)
        status, rhdrs, rbody = _parse_http(data)
        ctype = rhdrs.get("content-type", "")
        if ctype.startswith("text/event-stream"):
            return "sse", status, _parse_sse(rbody)
        if ctype.startswith("text/plain"):
            return "text", status, rbody.decode()
        return "json", status, json.loads(rbody) if rbody else {}
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


def _no_leaked_tasks():
    cur = asyncio.current_task()
    return [t for t in asyncio.all_tasks() if t is not cur and not t.done()]


def _sse_text(frames):
    return "".join(json.loads(f)["choices"][0]["delta"].get("content", "")
                   for f in frames[:-1])


# ------------------------------------------------------ wire contracts
def test_sse_stream_and_json_body_carry_the_engine_tokens():
    async def run():
        sc = _make_sidecar()
        await sc.start()
        try:
            ids = sc.backends[0].tokenizer.encode("stream please")
            want = sc.backends[0].engine.generate(ids, max_new_tokens=24)
            kind, status, frames = await _request(sc.port, {
                "messages": [{"role": "user", "content": "stream please"}],
                "max_tokens": 64, "stream": True, "output_tokens": 24})
            assert (kind, status) == ("sse", 200) and frames[-1] == "[DONE]"
            chunks = [json.loads(f) for f in frames[:-1]]
            assert all(c["object"] == "chat.completion.chunk"
                       for c in chunks)
            assert len({c["id"] for c in chunks}) == 1
            assert _sse_text(frames) == tokens_to_text(want["tokens"])
            finals = [c["choices"][0]["finish_reason"] for c in chunks]
            assert finals[-1] == "stop" and set(finals[:-1]) == {None}
            kind, status, obj = await _request(sc.port, {
                "prompt": "stream please", "max_tokens": 24,
                "output_tokens": 24})
            assert (kind, status) == ("json", 200)
            assert obj["object"] == "chat.completion"
            assert obj["choices"][0]["message"]["content"] == \
                tokens_to_text(want["tokens"])
            cl = obj["clairvoyant"]
            assert cl["status"] == "ok" and cl["ttft_s"] is not None
            assert obj["usage"]["completion_tokens"] == 24
        finally:
            await sc.shutdown(drain_s=1.0)
        assert not _no_leaked_tasks()
    _run(run())


def test_health_ready_metrics_and_404():
    async def run():
        sc = _make_sidecar(n_replicas=2)
        await sc.start()
        try:
            await _request(sc.port, {"prompt": "warm", "max_tokens": 4})
            _, status, obj = await _request(sc.port, method="GET",
                                            path="/healthz")
            assert status == 200 and obj["status"] == "ok"
            assert len(obj["replicas"]) == 2 and len(obj["engines"]) == 2
            _, status, obj = await _request(sc.port, method="GET",
                                            path="/readyz")
            assert status == 200 and obj["ready"]
            sc._stopping = True
            _, status, obj = await _request(sc.port, method="GET",
                                            path="/readyz")
            assert status == 503 and not obj["ready"]
            sc._stopping = False
            kind, status, text = await _request(sc.port, method="GET",
                                                path="/metrics")
            assert (kind, status) == ("text", 200)
            fams = observability.parse_prometheus(text)
            assert fams["clairvoyant_admissions_total"]
            _, status, _ = await _request(sc.port, method="GET",
                                          path="/nope")
            assert status == 404
        finally:
            await sc.shutdown(drain_s=1.0)
    _run(run())


def test_standalone_metrics_server_serves_the_sidecar_registry():
    from repro_torch.serving.metrics_http import MetricsServer

    async def run():
        sc = _make_sidecar()
        ms = MetricsServer(sc.obs)
        await sc.start()
        await ms.start()
        try:
            await _request(sc.port, {"prompt": "scrape me", "max_tokens": 4})
            kind, status, text = await _request(ms.port, method="GET",
                                                path="/metrics")
            _, missing, _ = await _request(ms.port, method="GET",
                                           path="/other")
        finally:
            await ms.stop()
            await sc.shutdown(drain_s=1.0)
        assert (kind, status, missing) == ("text", 200, 404)
        fams = observability.parse_prometheus(text)
        assert fams["clairvoyant_terminals_total"]
    _run(run())


def test_tenant_rate_limit_429_never_reaches_scheduler():
    async def run():
        sc = _make_sidecar(tenant_rate=1.0, tenant_burst=1.0)
        await sc.start()
        try:
            body = {"prompt": "hi", "max_tokens": 4}
            _, status, _ = await _request(sc.port, body,
                                          headers={"X-Tenant": "acme"})
            assert status == 200
            _, status, obj = await _request(sc.port, body,
                                            headers={"X-Tenant": "acme"})
            assert status == 429 and obj["error"]["type"] == "shed"
            _, status, _ = await _request(sc.port, body,
                                          headers={"X-Tenant": "other"})
            assert status == 200
        finally:
            await sc.shutdown(drain_s=1.0)
        assert sorted(sc.server._terminal) == [1, 2]
        assert sc.wire_stats["rate_limited"] == 1
    _run(run())


def test_inflight_cap_returns_503_with_retry_after():
    async def run():
        sc = _make_sidecar(max_inflight=1, pace_s=0.02)
        await sc.start()
        try:
            slow = asyncio.create_task(_request(sc.port, {
                "prompt": "slow", "max_tokens": 120,
                "output_tokens": 120}))
            await asyncio.sleep(0.1)
            _, status, obj = await _request(sc.port, {"prompt": "x",
                                                      "max_tokens": 4})
            assert status == 503 and obj["error"]["type"] == "shed"
            assert (await slow)[1] == 200
        finally:
            await sc.shutdown(drain_s=2.0)
        assert sc.wire_stats["rejected_busy"] == 1
    _run(run())


def test_deadline_timeout_and_predispatch_shed():
    async def run():
        sc = _make_sidecar(pace_s=0.02)
        await sc.start()
        try:
            kind, status, obj = await _request(sc.port, {
                "prompt": "too slow", "max_tokens": 120,
                "output_tokens": 120, "timeout_s": 0.1})
            assert (kind, status) == ("json", 504)
            assert obj["error"]["type"] == "timeout"
            blocker = asyncio.create_task(_request(sc.port, {
                "prompt": "blocker", "max_tokens": 60,
                "output_tokens": 60}))
            await asyncio.sleep(0.1)
            _, status, obj = await _request(
                sc.port, {"prompt": "impatient", "max_tokens": 4},
                headers={"X-Deadline-S": "0.01"})
            assert status == 429 and obj["error"]["type"] == "shed"
            assert (await blocker)[1] == 200
        finally:
            await sc.shutdown(drain_s=2.0)
        st = sc.server._terminal
        assert (st[1], st[2], st[3]) == ("timeout", "ok", "shed")
        assert sc.server.fault_stats["timeouts"] == 1
    _run(run())


def test_disconnect_cancels_queued_and_midgeneration():
    async def run():
        sc = _make_sidecar(pace_s=0.02)
        await sc.start()
        try:
            a = asyncio.create_task(_request(
                sc.port, {"prompt": "a", "max_tokens": 120,
                          "output_tokens": 120, "stream": True},
                disconnect_after=0.3))
            await asyncio.sleep(0.1)
            b = asyncio.create_task(_request(
                sc.port, {"prompt": "b", "max_tokens": 8,
                          "output_tokens": 8},
                disconnect_after=0.05))
            assert (await b)[0] == "disconnected"
            assert (await a)[0] == "disconnected"
            for _ in range(400):
                if len(sc.server._terminal) == 2:
                    break
                await asyncio.sleep(0.01)
            st = dict(sc.server._terminal)
            _, status, _ = await _request(sc.port, {"prompt": "after",
                                                    "max_tokens": 4})
            assert status == 200
        finally:
            await sc.shutdown(drain_s=2.0)
        assert st == {1: "cancelled", 2: "cancelled"}
        by_id = {r.request_id: r for r in sc.server.responses}
        assert "mid-generation" in by_id[1].error
        assert 0 < by_id[1].tokens_generated < 120
        assert "queued" in by_id[2].error
        assert sc.wire_stats["disconnects"] == 2
    _run(run())


def test_engine_crash_at_segment_boundary_is_retried():
    """An injected crash at the third segment poll raises out of the
    engine in its worker thread; the request is retried and served."""
    async def run():
        sc = _make_sidecar(specs=[faults.FaultSpec(kind="crash",
                                                   after_polls=3)])
        await sc.start()
        try:
            _, status, obj = await _request(sc.port, {
                "prompt": "crash me", "max_tokens": 40, "output_tokens": 40})
            assert status == 200 and obj["clairvoyant"]["retries"] == 1
        finally:
            await sc.shutdown(drain_s=1.0)
        assert sc.server.fault_stats["crashes"] == 1
    _run(run())


class _GatedBackend(InProcessBackend):
    """Holds every request at its gate, polling cancellation as a real
    backend polls at segment boundaries, until the gate opens."""

    gate = None

    async def generate(self, prompt, *, max_new_tokens=32, on_segment=None,
                       cancel_cb=None):
        t0 = time.monotonic()
        while not self.gate.is_set():
            if self._cancel or (cancel_cb is not None and cancel_cb()):
                return {"text": "", "tokens": 0, "ttft_s": 0.0,
                        "service_s": time.monotonic() - t0,
                        "cancelled": True}
            await asyncio.sleep(0.005)
        return await super().generate(prompt, max_new_tokens=max_new_tokens,
                                       on_segment=on_segment,
                                       cancel_cb=cancel_cb)


def test_graceful_shutdown_under_load_loses_nothing():
    """Work held in flight past the drain budget is cut: the in-flight
    requests end ``cancelled`` at their next poll and the queued ones
    with "server shutdown"; every admitted request ends exactly once and
    every client that kept its socket reads a well-formed response."""
    async def run():
        sc = _make_sidecar(n_replicas=2, backend_cls=_GatedBackend)
        for b in sc.backends:
            b.gate = asyncio.Event()
        await sc.start()
        clients = [asyncio.create_task(_request(sc.port, {
            "prompt": f"req {i}", "max_tokens": 16, "stream": i % 2 == 0}))
            for i in range(10)]
        for _ in range(400):
            if sc.server._next_id == 11:
                break
            await asyncio.sleep(0.005)
        await sc.shutdown(drain_s=0.2)
        outcomes = await asyncio.gather(*clients, return_exceptions=True)
        srv = sc.server
        assert sorted(srv._terminal) == list(range(1, 11))
        assert len(srv.responses) == 10
        statuses = [r.status for r in srv.responses]
        assert statuses == ["cancelled"] * 10
        errors = sorted(r.error for r in srv.responses)
        assert errors.count("server shutdown") == 10
        for out in outcomes:
            assert not isinstance(out, Exception), out
            kind, status, frames = out
            if kind == "sse":
                assert frames[-1] == "[DONE]"
            else:
                assert status == HTTP_STATUS["cancelled"]
        assert not _no_leaked_tasks()
    _run(run())


def test_http_backend_streams_from_the_port_sidecar():
    """The port's HTTP adapter against the port's own sidecar: streamed
    deltas arrive in order and reassemble the engine's tokens."""
    async def run():
        sc = _make_sidecar()
        await sc.start()
        try:
            deltas = []
            out = await HTTPBackend("127.0.0.1", sc.port).generate(
                "upstream", max_new_tokens=20, on_segment=deltas.append)
            ids = sc.backends[0].tokenizer.encode("upstream")
            want = sc.backends[0].engine.generate(ids, max_new_tokens=20)
        finally:
            await sc.shutdown(drain_s=1.0)
        assert out["text"] == "".join(deltas) == \
            tokens_to_text(want["tokens"])
        assert not out["cancelled"] and len(deltas) > 1
    _run(run())


# ------------------------------------------- one burst through both
@pytest.fixture(scope="module")
def burst_setup(pair):
    ds = jsample("sharegpt", n=500, seed=42, balanced=True)
    jpred = JPredictor.train(ds.prompts, ds.lengths, JParams(num_rounds=12))
    m = jpred.model
    pred = Predictor(GBDTModel(m.feature, m.threshold, m.value, m.n_classes,
                               m.max_depth), device="cpu")
    pool = jsample("sharegpt", n=4000, seed=1)
    shorts = [i for i in range(len(pool)) if pool.lengths[i] < 120][:5]
    longs = [i for i in range(len(pool)) if pool.lengths[i] >= 1000][:3]
    reqs = [(pool.prompts[i], 24 if i in longs else 6) for i in
            longs + shorts]
    return pair, jpred, pred, reqs


def _gate(cls):
    class Gated(cls):
        gate = None
        log = None

        async def generate(self, prompt, **kw):
            await self.gate.wait()
            self.log.append(prompt)
            return await super().generate(prompt, **kw)
    return Gated


@pytest.mark.parametrize("policy", ["fcfs", "sjf"])
def test_burst_over_the_wire_matches_jax_sidecar(burst_setup, policy):
    """The same loopback burst (every admission held behind a gate until
    all have arrived, one deadline that expires in the queue, one stray
    path) through the JAX sidecar and the port's: equal texts, HTTP codes
    and dispatch order."""
    (jeng, state), jpred, pred, reqs = burst_setup
    eng = _port_engine(state)

    async def one(sc, backend):
        backend.gate, backend.log = asyncio.Event(), []
        await sc.start()
        try:
            tasks = []
            for j, (prompt, n) in enumerate(reqs):
                hdrs = {"X-Deadline-S": "0.02"} if j == 4 else None
                tasks.append(asyncio.create_task(_request(sc.port, {
                    "prompt": prompt, "max_tokens": n, "output_tokens": n,
                    "stream": j % 2 == 1}, headers=hdrs)))
                for _ in range(400):
                    if sc.server._next_id == j + 2:
                        break
                    await asyncio.sleep(0.005)
            await asyncio.sleep(0.05)
            backend.gate.set()
            outs = await asyncio.gather(*tasks)
            stray = await _request(sc.port, method="GET", path="/v2/none")
        finally:
            await sc.shutdown(drain_s=5.0)
        texts = [_sse_text(o[2]) if o[0] == "sse" else
                 o[2]["choices"][0]["message"]["content"]
                 if o[1] == 200 else o[2]["error"]["type"] for o in outs]
        return ([o[1] for o in outs] + [stray[1]], texts, backend.log,
                dict(sc.server._terminal))

    jeng.busy_until = 0.0
    jb = _gate(JInProcessBackend)(jeng)
    jsc = JSidecar(JServer(policy=policy, tau=None, engines=[jb],
                           predictor=jpred, deadline_mode="sojourn",
                           seed=0), port=0)
    pb = _gate(InProcessBackend)(eng)
    psc = Sidecar(ClairvoyantServer(policy=policy, tau=None, engines=[pb],
                                    predictor=pred, deadline_mode="sojourn",
                                    seed=0), port=0)
    want = _run(one(jsc, jb), limit=120.0)
    got = _run(one(psc, pb), limit=120.0)
    assert got == want
    codes, texts, order, terminal = got
    assert codes == [200] * 4 + [429] + [200] * 3 + [404]
    assert terminal[5] == "shed" and len(order) == 7
    if policy == "fcfs":
        assert order == [p for j, (p, _) in enumerate(reqs) if j != 4]
    else:
        p = {pr: pred.p_long(pr) for pr, _ in reqs}
        assert [p[x] for x in order[1:]] == sorted(p[x] for x in order[1:])
