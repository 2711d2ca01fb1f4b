"""The port's entry points on the CPU: ``launch.serve`` (the queueing CLI)
and ``launch.sidecar`` (the HTTP/SSE CLI), plus the serving paths they
reach that the JAX package's tests pin down: the preemptive real drain
(a short arriving 1e-6 s after a long evicts it at a segment boundary,
and the long resumes to the uninterrupted tokens), the lane engine's
fault handling (a lane crash and a whole-engine crash), and the lane
loop's dead-step count.

Engines are the reduced smollm-360m in float32 on the CPU, with the JAX
engine's weights carried over (``bridge.params_from_jax``); greedy tokens
are compared exactly.  Arrivals are pinned, never left to wall-clock
timing.  Children started by a test are given a time limit and killed
if they outlive it.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import json
import os
import re
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.serving.engine import BatchedRealEngine as JBatched
from repro.serving.engine import RealEngine as JEngine
from repro.serving.faults import FaultPlan as JPlan
from repro.serving.faults import FaultSpec as JSpec
from repro.serving.openai_api import CompletionRequest as JCompletion
from repro.serving.server import ClairvoyantServer as JServer
from repro_torch.configs import get_config
from repro_torch.launch import serve, sidecar
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving.backends import (HTTPBackend, InProcessBackend,
                                          SimTextBackend)
from repro_torch.serving.engine import BatchedRealEngine, RealEngine
from repro_torch.serving.faults import FaultPlan, FaultSpec
from repro_torch.serving.openai_api import CompletionRequest
from repro_torch.serving.server import ClairvoyantServer

ROOT = Path(__file__).resolve().parents[1]
CFG = get_config("smollm-360m").reduced()


# ------------------------------------------------------------- launch.serve
@pytest.fixture(scope="module")
def served():
    """``launch.serve`` on the CPU under three policies, same burst."""
    return {p: serve.main(["--policy", p, "--requests", "80",
                           "--device", "cpu"])
            for p in ("fcfs", "sjf", "srpt")}


def test_serve_cli_runs_on_the_cpu(served, capsys):
    for policy, srv in served.items():
        assert len(srv.responses) == 80
        assert all(r.status == "ok" for r in srv.responses)
        assert srv.router.replicas[0].queue.tau is not None
    assert served["sjf"].percentile(50, "short") \
        < served["fcfs"].percentile(50, "short")
    assert served["srpt"].router.replicas[0].queue.stats["preemptions"] > 0
    srv = serve.main(["--policy", "sjf", "--requests", "40", "--rho", "0.74",
                      "--device", "cpu", "--speculative"])
    out = capsys.readouterr().out
    assert "calibrated tau = " in out and "speculative mirror" in out
    assert re.search(r"short\s+P50=\s*[\d.]+s P95=", out)
    assert len(srv.ok_responses) == 40


def test_serve_cli_needs_a_device_or_cpu(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--policy", "fcfs", "--requests", "4"])


def test_build_predictor_gives_jax_trees():
    """120 rounds over 6,000 balanced prompts: the same trees as the JAX
    ``build_predictor`` (host numpy trainer in both)."""
    from repro.launch.serve import build_predictor as jbuild
    want = jbuild().model
    got = serve.build_predictor(device="cpu").model
    for f in ("feature", "threshold", "value"):
        assert np.array_equal(np.asarray(getattr(want, f)),
                              np.asarray(getattr(got, f))), f
    assert want.n_classes == got.n_classes


# ----------------------------------------------------------- launch.sidecar
def _args(*extra):
    return sidecar.build_parser().parse_args(
        ["--port", "0", "--device", "cpu", "--no-predictor", *extra])


@pytest.mark.parametrize("backend", ["sim", "real", "http"])
def test_build_sidecar_backends(backend):
    extra = {"sim": [], "real": ["--reduced", "--replicas", "2"],
             "http": ["--upstream", "127.0.0.1:9"]}[backend]
    sc = sidecar.build_sidecar(_args("--backend", backend, *extra))
    cls = {"sim": SimTextBackend, "real": InProcessBackend,
           "http": HTTPBackend}[backend]
    assert all(isinstance(b, cls) for b in sc.backends)
    assert [b.replica_id for b in sc.backends] == \
        list(range(len(sc.backends)))
    assert sc.server.deadline_mode == "sojourn"
    assert sc.server.router.replicas[0].queue.tau > 0
    if backend == "real":
        eng = sc.backends[0].engine
        assert eng.cfg == CFG and eng.device.type == "cpu"
        assert sc.backends[1].engine.replica_id == 1


async def _post(port, body, path="/v1/chat/completions", method="POST"):
    """One loopback HTTP/1.1 exchange: (status, body bytes)."""
    import asyncio
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        data = b"" if body is None else json.dumps(body).encode()
        writer.write((f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                      "Connection: close\r\nContent-Type: application/json"
                      f"\r\nContent-Length: {len(data)}\r\n\r\n").encode()
                     + data)
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(), timeout=60.0)
    finally:
        writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), payload


def test_sidecar_real_full_width_and_speculative_refusal():
    """The real backend is full width by default.  ``--speculative
    --backend real`` (reduced, on the CPU) builds each replica's engine
    with a draft -- the target's own config seeded with ``--seed``, or
    ``--draft-model``, among them the reduced gemma3-4b-edge (GeGLU
    blocks, as the JAX CLI builds it) -- and serves ``ok`` over the wire
    with an accept rate in the response and in ``/metrics``.  Refused: a
    draft model of no known arch, and ``--backend http`` without
    ``--upstream``."""
    import asyncio
    args = _args("--backend", "real")
    assert not args.reduced                     # full width by default
    gemma = get_config("gemma3-4b-edge").reduced()
    for extra, draft in (([], CFG), (["--draft-model", "smollm-360m"], CFG),
                         (["--draft-model", "gemma3-4b-edge"], gemma)):
        sc = sidecar.build_sidecar(_args(
            "--backend", "real", "--reduced", "--speculative",
            "--draft-k", "3", "--policy", "fcfs", "--max-new-tokens", "12",
            *extra))
        eng = sc.backends[0].engine
        assert eng.speculative and eng.draft_k == 3
        assert eng.draft_cfg == draft and eng.device.type == "cpu"

        async def go():
            await sc.start()
            try:
                st, body = await _post(sc.port, {
                    "messages": [{"role": "user", "content": "tell me"}],
                    "max_tokens": 12})
                _, metrics = await _post(sc.port, None, path="/metrics",
                                         method="GET")
            finally:
                await sc.shutdown()
            return st, json.loads(body), metrics.decode()

        st, obj, metrics = asyncio.run(asyncio.wait_for(go(), 120.0))
        assert st == 200 and obj["clairvoyant"]["status"] == "ok"
        assert obj["usage"]["completion_tokens"] == 12
        rate = obj["clairvoyant"]["accept_rate"]
        assert rate is not None and 0.0 <= rate <= 1.0
        m = re.search(r"^clairvoyant_speculative_accept_rate\{[^}]*\} "
                      r"(\S+)$", metrics, re.M)
        assert m and float(m.group(1)) == eng.accept_rate
    with pytest.raises(KeyError, match="unknown arch"):
        sidecar.build_sidecar(_args("--backend", "real", "--reduced",
                                    "--speculative", "--draft-model",
                                    "no-such-arch"))
    with pytest.raises(SystemExit, match="--upstream"):
        sidecar.build_sidecar(_args("--backend", "http"))


def test_sidecar_child_drains_on_sigterm():
    """``python -m repro_torch.launch.sidecar --backend sim --port 0`` as a
    child: requests in flight when SIGTERM lands all get a terminal
    status, the child reports them and exits 0."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.sidecar", "--backend",
         "sim", "--port", "0", "--device", "cpu", "--policy", "fcfs",
         "--time-scale", "0.2", "--drain-s", "10"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = child.stdout.readline()
        addr = re.search(r"listening on (http://\S+)", line).group(1)
        codes = []

        def post(i):
            body = json.dumps({"prompt": f"req {i}", "max_tokens": 40,
                               "output_tokens": 40}).encode()
            req = urllib.request.Request(
                addr + "/v1/chat/completions", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                codes.append(r.status)

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        # SIGTERM once every request has reached the sidecar (each takes
        # ~0.14 s of wall time, one at a time, so most are still queued)
        for _ in range(3000):
            with urllib.request.urlopen(addr + "/healthz", timeout=10) as r:
                health = json.loads(r.read())
            if health["inflight"] + len(codes) >= 6:   # all admitted
                break
            threading.Event().wait(0.01)
        child.send_signal(signal.SIGTERM)
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        out, _ = child.communicate(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert child.returncode == 0, out
    assert "draining..." in out
    m = re.search(r"drained: (\d+) terminals \((\d+) ok\)", out)
    assert m and int(m.group(1)) == 6, out
    assert len(codes) == int(m.group(2))        # every ok reached its client


# ------------------------------------------------------------ engine pairs
@pytest.fixture(scope="module")
def weights():
    jeng = JEngine(jax_config("smollm-360m").reduced(), max_len=96,
                   segment_len=4, seed=0)
    return jeng, params_from_jax(jax.tree.map(np.asarray, jeng.params), CFG)


class _TwoClass:
    def proba_batch(self, prompts):
        return np.array([[0.0, 0.0, 1.0] if "long" in p else [1.0, 0.0, 0.0]
                         for p in prompts])


def test_real_engine_preemption_resumes_bitwise(weights):
    """The short (arriving 1e-6 s after the long) evicts the decoding long
    at a segment boundary; the long resumes by re-prefilling prompt +
    generated prefix, and its tokens equal an uninterrupted decode's --
    the port's and the JAX engine's on the same weights."""
    jeng, state = weights
    eng = RealEngine(CFG, state_dict=state, max_len=96, segment_len=4,
                     device="cpu")
    ids = np.arange(8) % CFG.vocab_size
    full = eng.generate(ids, max_new_tokens=16)["tokens"]
    assert full == list(jeng.generate(ids, max_new_tokens=16)["tokens"])
    polls = []

    def cancel_after_one_segment():
        polls.append(1)
        return len(polls) == 2

    out1 = eng.generate(ids, max_new_tokens=16,
                        cancel_cb=cancel_after_one_segment)
    assert out1["cancelled"] and 1 <= len(out1["tokens"]) < 16
    out2 = eng.generate(np.concatenate([ids, np.asarray(out1["tokens"])]),
                        max_new_tokens=16 - len(out1["tokens"]))
    assert list(out1["tokens"]) + list(out2["tokens"]) == full

    server = ClairvoyantServer(policy="srpt", predictor=_TwoClass(),
                               engines=[eng])
    long_req = CompletionRequest(prompt="long story please")
    short_req = CompletionRequest(prompt="quick question")
    server.submit(long_req, arrival=0.0, true_output_tokens=600,
                  klass="long")
    server.submit(short_req, arrival=1e-6, true_output_tokens=30,
                  klass="short")
    resp = server.drain(max_new_tokens=24)
    assert [r.status for r in resp] == ["ok", "ok"]
    assert server.router.replicas[0].queue.stats["preemptions"] >= 1
    assert resp[0].request_id == short_req.request_id
    by_id = {r.request_id: r for r in resp}
    long_resp = by_id[long_req.request_id]
    assert long_resp.tokens_generated == 24 and long_resp.service_s > 0
    prompt = server._tokenizer.encode(long_req.prompt)
    want = jeng.generate(np.asarray(prompt), max_new_tokens=24)["tokens"]
    assert long_resp.token_ids == list(want)


@pytest.mark.parametrize("policy", ["srpt", "mlfq"])
def test_preemptive_drain_matches_jax_server(weights, policy):
    """Pinned arrivals (longs at 0, shorts 1e-6 s later) through the JAX
    server's and the port's preemptive real drains: every request ends
    ``ok`` with its full budget, shorts first."""
    jeng, state = weights
    eng = RealEngine(CFG, state_dict=state, max_len=96, segment_len=4,
                     device="cpu")
    rows = []
    for srv_cls, creq, engine in ((JServer, JCompletion, jeng),
                                  (ClairvoyantServer, CompletionRequest,
                                   eng)):
        engine.busy_until = 0.0
        srv = srv_cls(policy=policy, predictor=_TwoClass(), engines=[engine])
        for i, (klass, n, t) in enumerate([("long", 600, 0.0),
                                           ("short", 20, 1e-6),
                                           ("short", 25, 2e-6)]):
            srv.submit(creq(prompt=f"{klass} request {i}"), arrival=t,
                       true_output_tokens=n, klass=klass)
        resp = srv.drain(max_new_tokens=20)
        rows.append(sorted((r.request_id, r.status, r.tokens_generated)
                           for r in resp))
        assert resp[-1].klass == "long"
    assert rows[0] == rows[1]


def _lane_pair(weights):
    jeng, state = weights
    jb = JBatched(jax_config("smollm-360m").reduced(), max_len=64,
                  segment_len=4, n_lanes=2, params=jeng.params)
    pb = BatchedRealEngine(CFG, state_dict=state, max_len=64, segment_len=4,
                           n_lanes=2, device="cpu")
    return jb, pb


def _fault_drain(pair, make_plan, n_out, prefix):
    out = []
    for eng, srv_cls, creq, mod in (
            (pair[0], JServer, JCompletion, (JPlan, JSpec)),
            (pair[1], ClairvoyantServer, CompletionRequest,
             (FaultPlan, FaultSpec))):
        server = srv_cls(policy="sjf_oracle", engines=[eng],
                         fault_plan=make_plan(*mod), seed=0)
        for i in range(4):
            server.submit(creq(prompt=f"{prefix} {i}"),
                          true_output_tokens=n_out, klass="short")
        resp = server.drain(max_new_tokens=n_out)
        out.append((sorted((r.request_id, r.status, r.retries,
                            r.tokens_generated) for r in resp),
                    dict(server.fault_stats), resp, server))
    return out


def _uninterrupted(server, eng, prompt, n):
    ids = server._tokenizer.encode(prompt)[:max(1, eng.max_len - n)]
    return eng.generate_reference(ids, n)["tokens"]


def test_batched_lane_crash_resumes_work_conserving(weights):
    pair = _lane_pair(weights)
    want, got = _fault_drain(
        pair, lambda P, S: P([S(kind="lane_crash", after_polls=1,
                                replica=0)]), 10, "lane req")
    assert got[0] == want[0] and got[1] == want[1]
    resp, server = got[2], got[3]
    assert len(resp) == 4 and all(r.status == "ok" for r in resp)
    assert server.fault_stats["crashes"] == 1
    victims = [r for r in resp if r.retries == 1]
    assert len(victims) == 1 and victims[0].tokens_generated == 10
    # the resume re-prefill is work-conserving: every request's tokens
    # equal an uninterrupted greedy decode, the victim's included
    for r in resp:
        assert r.token_ids == _uninterrupted(
            server, pair[1], f"lane req {r.request_id - 1}", 10)


def test_batched_whole_engine_crash_evicts_and_drains(weights):
    pair = _lane_pair(weights)
    want, got = _fault_drain(
        pair, lambda P, S: P([S(kind="crash", after_polls=1, replica=0,
                                repair_s=0.0)]), 8, "crash req")
    assert got[0] == want[0] and got[1] == want[1]
    resp, server = got[2], got[3]
    assert len(resp) == 4 and all(r.status == "ok" for r in resp)
    assert server.fault_stats["crashes"] >= 1
    for r in resp:
        assert r.token_ids == _uninterrupted(
            server, pair[1], f"crash req {r.request_id - 1}", 8)


def test_batched_fault_plan_matches_jax(weights):
    """A lane crash, a transient and a whole-engine crash in one plan: the
    port's lane drain gives the JAX server's statuses, retries, token
    counts and fault_stats.  Both leave the transient to the serial
    drains, so it never fires here."""
    pair = _lane_pair(weights)
    want, got = _fault_drain(
        pair, lambda P, S: P([S(kind="lane_crash", after_polls=2, replica=0),
                              S(kind="transient", at=0.0, replica=0),
                              S(kind="crash", after_polls=5, replica=0,
                                repair_s=0.0)]), 10, "plan req")
    assert got[0] == want[0] and got[1] == want[1]
    assert got[1]["crashes"] >= 2 and got[1]["transients"] == 0
    resp, server = got[2], got[3]
    for r in resp:
        assert r.token_ids == _uninterrupted(
            server, pair[1], f"plan req {r.request_id - 1}", 10)


class _VirtualClock:
    """Stands in for the ``time`` module of the server: the lane drain's
    clock moves only where the test moves it."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self) -> float:
        return self.t

    perf_counter = monotonic


def test_batched_faults_timeouts_and_spans(monkeypatch):
    """A lane crash, a whole-engine crash and a sojourn deadline on the
    lane drain, on a virtual clock that moves 50 ms a segment: request 2
    (deadline 80 ms, admitted at 0) expires in service at its second
    segment boundary, every request ends in exactly one terminal status,
    and the recorder holds the lane spans.  The plan's transient is left
    to the serial drains, as in the JAX lane drain."""
    import repro_torch.serving.server as server_mod
    from repro_torch.serving.observability import Observability
    clock = _VirtualClock()
    monkeypatch.setattr(server_mod, "time", clock)
    eng = BatchedRealEngine(CFG, max_len=64, segment_len=4, n_lanes=2,
                            device="cpu")
    run_segment = eng._lane_decoder.run_segment

    def paced(*a, **kw):
        clock.t += 0.05
        return run_segment(*a, **kw)

    eng._lane_decoder.run_segment = paced
    plan = FaultPlan([FaultSpec(kind="lane_crash", after_polls=2, replica=0),
                      FaultSpec(kind="transient", at=0.0, replica=0),
                      FaultSpec(kind="crash", after_polls=5, replica=0,
                                repair_s=0.0)])
    server = ClairvoyantServer(policy="fcfs", engines=[eng], fault_plan=plan,
                               deadline_mode="sojourn", seed=0)
    server.attach_observability(Observability.default(tracing=True))
    for i in range(6):
        server.submit(CompletionRequest(prompt=f"lane {i}"), arrival=0.0,
                      true_output_tokens=12, klass="short",
                      deadline_s=0.08 if i == 1 else None)
    resp = server.drain(max_new_tokens=12)
    assert sorted(r.request_id for r in resp) == list(range(1, 7))
    by_status = {r.request_id: r.status for r in resp}
    assert by_status[2] == "timeout"
    assert all(s == "ok" for k, s in by_status.items() if k != 2)
    # one lane crash, then one crash per request the engine crash evicted
    assert server.fault_stats["crashes"] >= 2
    assert server.fault_stats["transients"] == 0
    assert server.fault_stats["retries"] == server.fault_stats["crashes"]
    assert server.fault_stats["timeouts"] == 1
    names = {s.name for s in server.obs.recorder.spans()}
    assert {"queue_wait", "prefill", "decode", "decode_segment"} <= names
    assert server.obs.recorder.validate(server._terminal) == []


def test_dead_steps_match_jax_on_an_all_eos_segment(weights):
    """Both lanes stop early in a segment (one on its budget, one on EOS):
    the port counts dead lane-steps only while some lane is still live,
    as the JAX loop does, with equal tokens."""
    jb, pb = _lane_pair(weights)
    prompts = [np.arange(5) + 3, np.arange(7) + 11]
    probe = list(jb.generate_batch(prompts, [2, 30])[1]["tokens"])
    # the first token of lane 1 not emitted before it becomes EOS
    k = next(i for i in range(1, len(probe)) if probe[i] not in probe[:i])
    eos = int(probe[k])
    want = jb.generate_batch(prompts, [2, 30], eos_id=eos)
    got = pb.generate_batch(prompts, [2, 30], eos_id=eos)
    assert [list(r["tokens"]) for r in got] == \
        [list(r["tokens"]) for r in want]
    assert got[1]["tokens"] == probe[:k + 1]
    assert pb.dead_steps == jb.dead_steps
    assert pb.engine_stats()["dead_steps"] == jb.engine_stats()["dead_steps"]
