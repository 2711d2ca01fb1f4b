"""The port's serving example scripts held to the JAX package's on
carried weights (``bridge.params_from_jax``), float32 on the CPU:

* ``batched_serve.py``: both drains (4 lanes at the full budget, then at
  ~55% of its peak KV) give the JAX drains' tokens, in the same finish
  order, with the same admissions, back-fills, budget blocks and peak;
* ``speculative_serve.py``: on the JAX target and drafts (its own
  weights, and an independent draft of seed 7) the port prints the JAX
  script's lines: bitwise equality, drafted / accepted / dead-step
  counts and per-request accept rates;
* ``serve_sidecar.py`` in process: the n=8 dispatch order (classes and
  printed P(Long)) and each request's tokens equal the JAX script's, and
  so do the simulated-clock latency lines.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import re
from argparse import Namespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jconfig
from repro.models.model import LM as JLM
from repro.serving.engine import BatchedRealEngine as JBatched
from repro.serving.engine import RealEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving.engine import BatchedRealEngine, RealEngine
from test_torch_examples import load


def _carried(params, cfg):
    return params_from_jax(jax.tree.map(np.asarray, params), cfg)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _recording(engine, tokens):
    """Record every finished lane's tokens of ``engine``'s drains."""
    run_lanes = engine.run_lanes

    def run(source, on_finish, **kw):
        def rec(state, out):
            tokens.append(list(out["tokens"]))
            on_finish(state, out)
        return run_lanes(source, rec, **kw)
    engine.run_lanes = run


def test_batched_serve_drains_equal_jax(capsys):
    jmod, tmod = load("jax", "batched_serve"), load("port", "batched_serve")
    jcfg = jconfig("smollm-360m").reduced()
    lanes = dict(max_len=96, segment_len=8, n_lanes=4)
    assert tmod.LANES == lanes
    warm = [np.arange(p) % jcfg.vocab_size for p in (8, 16, 24, 40)]

    # the JAX script's two passes, its drains recorded
    jtokens = [[], []]
    jeng4 = JBatched(jcfg, **lanes)
    jeng4.generate_batch(warm, max_new_tokens=4)
    _recording(jeng4, jtokens[0])
    jserver, _ = jmod.drain(jeng4)
    jtight = JBatched(jcfg, params=jeng4.params, budget_bytes=int(
        0.55 * jeng4.lane_manager.budget.peak_bytes), **lanes)
    jtight.generate_batch(warm, max_new_tokens=4)
    _recording(jtight, jtokens[1])
    jserver_t, _ = jmod.drain(jtight)

    cfg = get_config("smollm-360m").reduced()
    sd = _carried(jeng4.params, cfg)
    out = tmod.serve(cfg, BatchedRealEngine(cfg, state_dict=sd,
                                            device="cpu", **lanes),
                     lambda budget: BatchedRealEngine(
                         cfg, state_dict=sd, budget_bytes=budget,
                         device="cpu", **lanes))
    assert out["same"]
    assert "token counts identical across budgets: True" in \
        capsys.readouterr().out
    for server, engine, jsrv, jeng, want in zip(
            out["servers"], out["engines"], (jserver, jserver_t),
            (jeng4, jtight), jtokens):
        assert [r.request_id for r in server.responses] == \
            [r.request_id for r in jsrv.responses]
        assert [r.token_ids for r in server.responses] == want
        assert len(want) == 10 and all(r.ok for r in server.responses)
        st, jst = engine.lane_manager.stats, jeng.lane_manager.stats
        for key in ("admitted", "backfills", "blocked_on_budget",
                    "retired"):
            assert st[key] == jst[key], key
        assert engine.budget_bytes == jeng.budget_bytes
        assert engine.lane_manager.budget.peak_bytes == \
            jeng.lane_manager.budget.peak_bytes
    assert out["engines"][1].lane_manager.stats["blocked_on_budget"] > 0


def test_speculative_serve_prints_the_jax_lines(capsys):
    jmod, tmod = load("jax", "speculative_serve"), \
        load("port", "speculative_serve")
    jmod.main()
    want = capsys.readouterr().out.splitlines()

    jcfg = jconfig("smollm-360m").reduced()
    cfg = get_config("smollm-360m").reduced()
    # the JAX script's weights: the target of seed 0, the draft of seed 7
    target = _carried(JLM(jcfg).init(jax.random.key(0)), cfg)
    draft = _carried(JLM(jcfg).init(jax.random.key(7)), cfg)
    kw = dict(seed=0, device="cpu", **tmod.LANES)
    spec = dict(draft_cfg=cfg, draft_k=tmod.DRAFT_K)
    ref = BatchedRealEngine(cfg, state_dict=target, **kw)
    engines = {
        "agreeing draft (target params)": BatchedRealEngine(
            cfg, state_dict=target, draft_state_dict=target, **spec, **kw),
        "independent draft (seed 7)": BatchedRealEngine(
            cfg, state_dict=target, draft_state_dict=draft, **spec, **kw),
    }
    out = tmod.compare(ref, engines, *tmod.workload(cfg))
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert all(r["equal"] for r in out.values())
    assert sum("bitwise-equal to fused reference: True" in line
               for line in got) == 2


def _strip_ms(lines):
    """The dispatch lines without their wall times."""
    return [re.sub(r" in \d+ ms \(ttft \d+ ms\)$", "", line)
            for line in lines]


def test_sidecar_in_process_dispatch_and_tokens_equal_jax(capsys,
                                                          monkeypatch):
    jmod, tmod = load("jax", "serve_sidecar"), load("port", "serve_sidecar")
    jcfg = jconfig("smollm-360m").reduced()
    jeng = JEngine(jcfg, max_len=tmod.MAX_LEN)
    jtokens = []
    generate = jeng.generate

    def recording(ids, **kw):
        out = generate(ids, **kw)
        jtokens.append(list(out["tokens"]))
        return out

    monkeypatch.setattr(jeng, "generate", recording)
    monkeypatch.setattr(jmod, "RealEngine", lambda cfg, max_len: jeng)
    jmod.main_inprocess(Namespace(rounds=80))
    want = _strip_ms(capsys.readouterr().out.splitlines())

    cfg = get_config("smollm-360m").reduced()
    pred = tmod.train_predictor(80, "cpu")
    served = tmod.dispatch(RealEngine(
        cfg, max_len=tmod.MAX_LEN, device="cpu",
        state_dict=_carried(jeng.params, cfg)), pred)
    p50 = tmod.latency(pred)
    got = _strip_ms(capsys.readouterr().out.splitlines())
    assert got == want
    assert [t for _, _, t in served] == jtokens and len(jtokens) == 8
    assert [k for k, _, _ in served][:4].count("short") >= 3
    assert p50["sjf"] < p50["fcfs"]
