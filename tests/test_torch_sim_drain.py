"""The port's virtual-time drains against the JAX server's.

``ClairvoyantServer`` without engines fronts ``SimEngine`` replicas that
serve from a ``ServiceTimeModel``: ``_drain_sim`` (non-preemptive, with
injected transients, stalls, crashes + repair, deadline shedding and
sojourn timeouts) and ``_drain_sim_preemptive`` (the replica's backlog
through the preemptive DES).  The same submissions, scores, models and
fault plans go into the JAX server and the port's; the responses (ids,
statuses, waits, service times, token counts, retries, replicas),
``fault_stats`` and the recorder's spans must be equal -- exactly, since
both run the same float64 arithmetic in the same order.  Also: the
admission's output-length draw, and ``SimTextBackend`` behind both
sidecars over loopback HTTP.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import asyncio
import json
import zlib

import numpy as np
import pytest

from repro.data.corpus import CLASS_NAMES
from repro.data.corpus import sample_dataset as jsample
from repro.serving import backends as jbackends
from repro.serving import faults as jfaults
from repro.serving import observability as jobs
from repro.serving.http_sidecar import Sidecar as JSidecar
from repro.serving.openai_api import CompletionRequest as JCompletion
from repro.serving.server import ClairvoyantServer as JServer
from repro.serving.service_time import ServiceTimeModel as JModel
from repro_torch.serving import backends, faults, observability
from repro_torch.serving.engine import SimEngine
from repro_torch.serving.http_sidecar import Sidecar
from repro_torch.serving.openai_api import CompletionRequest
from repro_torch.serving.server import ClairvoyantServer
from repro_torch.serving.service_time import (ServiceTimeModel,
                                              sample_output_tokens)

PORT = dict(server=ClairvoyantServer, creq=CompletionRequest,
            faults=faults, obs=observability, model=ServiceTimeModel,
            backends=backends, sidecar=Sidecar)
JAX = dict(server=JServer, creq=JCompletion, faults=jfaults, obs=jobs,
           model=JModel, backends=jbackends, sidecar=JSidecar)


class _Scores:
    """A deterministic stand-in predictor (numpy only, no device): P(Long)
    from a hash of the prompt, so both servers see the same scores."""

    def proba_batch(self, prompts):
        p = np.array([zlib.crc32(x.encode()) % 1000 / 1000.0
                      for x in prompts])
        return np.stack([0.6 * (1 - p), 0.4 * (1 - p), p], axis=1)


@pytest.fixture(scope="module")
def workload():
    ds = jsample("sharegpt", n=70, seed=3)
    rng = np.random.default_rng(5)
    arrivals = np.cumsum(rng.exponential(2.0, len(ds.prompts)))
    return [(ds.prompts[i], float(arrivals[i]),
             None if i % 4 == 0 else int(ds.lengths[i]),
             CLASS_NAMES[int(ds.classes[i])]) for i in range(len(ds))]


def _serve(pkg, workload, policy, chaos):
    kw = {}
    if chaos:
        kw = dict(fault_plan=pkg["faults"].FaultPlan.random(
            seed=11, horizon=4000.0, n_replicas=2, crash_mtbf=60.0,
            crash_mttr=6.0, transient_rate=0.05, stall_mtbf=90.0,
            predictor_mtbf=150.0, predictor_mttr=20.0),
            retry=pkg["faults"].RetryPolicy(max_retries=2, seed=0),
            deadline_s=90.0, deadline_mode="sojourn")
    srv = pkg["server"](policy=policy, tau=40.0, n_replicas=2,
                        predictor=_Scores(),
                        service_model=pkg["model"](9000.0, 55.0), seed=4,
                        **kw)
    srv.attach_observability(pkg["obs"].Observability.default(tracing=True))
    for prompt, arrival, n_out, klass in workload:
        srv.submit(pkg["creq"](prompt=prompt, max_tokens=512),
                   arrival=arrival, true_output_tokens=n_out, klass=klass)
    resp = srv.drain()
    rows = [(r.request_id, r.status, r.queue_wait_s, r.service_s,
             r.ttft_s, r.tokens_generated, r.retries, r.replica,
             r.promoted, r.degraded) for r in resp]
    spans = [(s.name, s.req_id, s.t0, s.t1, s.track)
             for s in srv.obs.recorder.spans()]
    stats = [rep.queue.stats for rep in srv.router.replicas]
    return rows, dict(srv.fault_stats), spans, stats, srv


@pytest.mark.parametrize("chaos", [False, True])
@pytest.mark.parametrize("policy", ["fcfs", "sjf", "srpt", "mlfq"])
def test_sim_drains_match_jax(workload, policy, chaos):
    want = _serve(JAX, workload, policy, chaos)
    got = _serve(PORT, workload, policy, chaos)
    assert got[0] == want[0]                    # responses
    assert got[1] == want[1]                    # fault_stats
    assert got[2] == want[2]                    # spans, in order
    assert got[3] == want[3]                    # queue stats
    srv = got[4]
    assert all(isinstance(e, SimEngine) for e in srv.engines)
    assert sorted(srv._terminal) == list(range(1, len(workload) + 1))
    statuses = {r[1] for r in got[0]}
    if chaos and not srv.policy_obj.preemptive:
        assert srv.fault_stats["crashes"] + srv.fault_stats["transients"] > 0
        assert statuses - {"ok"}                # a deadline did bind
    else:
        assert statuses == {"ok"}
    names = {s[0] for s in got[2]}
    assert {"queue_wait", "prefill", "decode"} <= names
    if srv.policy_obj.preemptive:
        assert sum(s["preemptions"] for s in got[3]) > 0


def test_preemptive_sim_drain_rescues_shorts():
    """A long at t=0 and shorts just after it: SRPT's short sojourns are
    far below FCFS's, and the long still finishes last."""
    out = {}
    for policy in ("fcfs", "srpt"):
        srv = ClairvoyantServer(policy=policy, predictor=_TwoClass(),
                                seed=0)
        srv.submit(CompletionRequest(prompt="long essay"), arrival=0.0,
                   true_output_tokens=1500, klass="long")
        for i in range(4):
            srv.submit(CompletionRequest(prompt=f"short q {i}"),
                       arrival=0.5 + i, true_output_tokens=30,
                       klass="short")
        srv.drain()
        out[policy] = srv
    assert out["srpt"].percentile(50, "short") \
        < 0.2 * out["fcfs"].percentile(50, "short")
    last = max(out["srpt"].responses, key=lambda r: r.sojourn_s)
    assert last.klass == "long"
    assert out["srpt"].router.replicas[0].queue.stats["preemptions"] >= 1


class _TwoClass:
    def proba_batch(self, prompts):
        return np.array([[0.0, 0.0, 1.0] if "long" in p else [1.0, 0.0, 0.0]
                         for p in prompts])


class _NoEngine:
    """An engine slot the test never drains."""


def test_admit_draws_output_lengths_like_jax():
    """Without ``true_output_tokens`` the admission draws a length for the
    request's class from the server's seeded RNG (``short`` when unknown),
    as the JAX server does; the request's ``max_tokens`` does not stand
    in.  Same draws, same oracle keys and service estimates."""
    rows = []
    for pkg in (JAX, PORT):
        srv = pkg["server"](policy="sjf_oracle", engines=[_NoEngine()],
                            seed=7)
        for i, klass in enumerate(["short", "long", "medium", "", "long"]):
            srv.submit(pkg["creq"](prompt=f"request {i} " * 5,
                                   max_tokens=64),
                       arrival=0.1 * i, klass=klass)
        rows.append(sorted((r.req_id, r.meta["output_tokens"],
                            r.true_service, r.meta["policy_key0"])
                           for r in srv.router.replicas[0].queue.live()))
    assert rows[0] == rows[1]
    rng = np.random.default_rng(7)
    assert [r[1] for r in rows[1]] == [
        sample_output_tokens(rng, k or "short")
        for k in ["short", "long", "medium", "", "long"]]
    assert any(r[1] > 64 for r in rows[1])      # not the max_tokens budget


# ------------------------------------------- SimTextBackend over the wire
async def _post(port, body, headers=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        payload = json.dumps(body).encode()
        hdrs = {"Host": "loopback", "Connection": "close",
                "Content-Type": "application/json",
                "Content-Length": str(len(payload)), **(headers or {})}
        writer.write(("POST /v1/chat/completions HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n").encode()
            + payload)
        await writer.drain()
        data = await asyncio.wait_for(reader.read(), timeout=30.0)
    finally:
        writer.close()
    return int(data.split(b" ", 2)[1])


@pytest.mark.parametrize("policy", ["fcfs", "sjf"])
def test_sim_text_backend_behind_both_sidecars(policy):
    """A burst behind ``SimTextBackend`` (one long holding the replica, a
    request whose deadline expires in the queue, shorts and longs, half
    streamed): the JAX sidecar and the port's answer with the same HTTP
    codes and terminal statuses."""
    reqs = [("write a long essay", 600, None)] + \
        [("quick one", 20, "0.02")] + \
        [(f"prompt number {i}", 30 if i % 2 else 200, None)
         for i in range(8)]

    async def run(pkg):
        model = pkg["model"](8000.0, 60.0)
        backend = pkg["backends"].SimTextBackend(model, time_scale=0.02)
        srv = pkg["server"](policy=policy, tau=None, engines=[backend],
                            predictor=_Scores(), service_model=model,
                            deadline_mode="sojourn", seed=0)
        sc = pkg["sidecar"](srv, port=0)
        await sc.start()
        try:
            first = asyncio.create_task(_post(sc.port, {
                "prompt": reqs[0][0], "max_tokens": reqs[0][1],
                "output_tokens": reqs[0][1]}))
            while srv._next_id < 2 or not srv._decoding:
                await asyncio.sleep(0.005)
            rest = [asyncio.create_task(_post(sc.port, {
                "prompt": p, "max_tokens": n, "output_tokens": n,
                "stream": j % 2 == 0},
                headers=None if dl is None else {"X-Deadline-S": dl}))
                for j, (p, n, dl) in enumerate(reqs[1:])]
            codes = await asyncio.gather(first, *rest)
        finally:
            await sc.shutdown(drain_s=5.0)
        terminal = dict(srv._terminal)
        assert sorted(terminal) == list(range(1, len(reqs) + 1))
        return codes, sorted(terminal.values())

    want = asyncio.run(asyncio.wait_for(run(JAX), 120.0))
    got = asyncio.run(asyncio.wait_for(run(PORT), 120.0))
    assert got == want
    codes, statuses = got
    assert codes[1] == 429
    assert statuses == ["ok"] * (len(reqs) - 1) + ["shed"]
