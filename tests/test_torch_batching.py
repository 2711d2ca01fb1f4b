"""Decode lanes in the port against the JAX package: K1's plain version
with per-lane ``(B,)`` fill levels, K3's plain version in extend mode
(``q_offset``, Sq != Skv), the extend and per-row prefills of the LM, the
lane manager's admission order, ``BatchedRealEngine`` (greedy tokens equal
to the JAX lane engine's and to the port's own serial oracle, with
back-fill, EOS, window truncation, a tight budget and a mid-flight
cancel) and the server's batched drain (dispatch order and tokens equal to
the JAX server's under FCFS and SJF).

Float32 on the CPU in both packages (TF32 does not exist there).
Tolerances: kernels 2e-5 in float32 and 2e-2 in bfloat16, as in
tests/test_kernels.py; logits 1e-4 and cached K/V 1e-5, as in
tests/test_torch_model.py.  Tokens, dispatch order and manager decisions
are compared exactly.  Inputs are drawn with numpy and handed to both.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.gbdt import GBDTParams as JParams
from repro.core.predictor import Predictor as JPredictor
from repro.core.scheduler import Request as JRequest
from repro.core.scheduler import SJFQueue as JQueue
from repro.data.corpus import sample_dataset as jsample
from repro.kernels import ref as jref
from repro.models.attention import flash_attention as jflash
from repro.models.model import LM as JLM
from repro.serving import batching as jbatching
from repro.serving.engine import BatchedRealEngine as JBatched
from repro.serving.openai_api import CompletionRequest as JCompletion
from repro.serving.server import ClairvoyantServer as JServer
from repro_torch.configs import get_config as port_config
from repro_torch.core.gbdt import GBDTModel
from repro_torch.core.predictor import Predictor
from repro_torch.core.scheduler import Request, SJFQueue
from repro_torch.kernels import ops, ref
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.model import LM
from repro_torch.serving import batching
from repro_torch.serving.engine import BatchedRealEngine
from repro_torch.serving.openai_api import CompletionRequest
from repro_torch.serving.server import ClairvoyantServer

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
KV_TOL = dict(atol=1e-5, rtol=1e-5)


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ----------------------------------------------------------- K1, (B,) t
@pytest.mark.parametrize("B,KV,G,S,hd", [(4, 5, 3, 64, 64),
                                         (3, 2, 4, 128, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_plain_per_lane_t_matches_jax_ref(B, KV, G, S, hd, dtype):
    """Per-lane fill levels, one of them past the ring (wrapped): the
    port's plain K1 in the kernel and model layouts == the JAX ref."""
    rng = np.random.default_rng(B * 10 + S)
    qn = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    kn = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    vn = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    t = np.array([0, 17, S - 1, S + 40][:B] + [5] * max(0, B - 4),
                 np.int32)
    jdt, tdt = DTYPES[dtype]
    want = jref.decode_attention_ref(*(jnp.asarray(x, jdt)
                                       for x in (qn, kn, vn)),
                                     jnp.asarray(t))
    qt, kt, vt = (torch.from_numpy(x).to(tdt) for x in (qn, kn, vn))
    tt = torch.from_numpy(t)
    got = ref.decode_attention_ref(qt, kt, vt, tt)
    got_ops = ops.decode_attention(qt.reshape(B, 1, KV * G, hd),
                                   kt.transpose(1, 2), vt.transpose(1, 2), tt)
    for g in (got, got_ops.reshape(B, KV, G, hd)):
        np.testing.assert_allclose(_np(g), _np(want), **_tol(dtype))
    # a lane's row is the scalar-t computation for that lane, bit for bit
    for b in range(B):
        solo = ref.decode_attention_ref(qt[b:b + 1], kt[b:b + 1],
                                        vt[b:b + 1], tt[b])
        assert torch.equal(solo[0], got[b])


# -------------------------------------------------------- K3, extend mode
@pytest.mark.parametrize("prefix,suffix,extent", [(16, 16, 32), (48, 16, 64),
                                                  (64, 64, 128),
                                                  (96, 20, 128)])
def test_flash_plain_q_offset_matches_jax_flash(prefix, suffix, extent):
    """A suffix of ``suffix`` rows at ``q_offset = prefix`` over a key
    buffer of ``extent`` slots (keys past the suffix are pad garbage the
    causal mask must hide) == repro.models.attention.flash_attention."""
    rng = np.random.default_rng(prefix + suffix)
    B, H, KV, hd = 1, 15, 5, 64
    q = rng.normal(size=(B, suffix, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, extent, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, extent, KV, hd)).astype(np.float32)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True, q_offset=prefix)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True, q_offset=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    # the suffix rows equal those rows of a cold prefill of the buffer
    cold = ops.flash_attention(torch.from_numpy(
        np.concatenate([rng.normal(size=(B, prefix, H, hd)), q], axis=1)
        .astype(np.float32)), torch.from_numpy(k[:, :prefix + suffix]),
        torch.from_numpy(v[:, :prefix + suffix]))
    np.testing.assert_allclose(cold[:, prefix:].numpy(), got.numpy(),
                               atol=2e-5, rtol=2e-5)


# -------------------------------------------------------------- LM prefill
@pytest.fixture(scope="module")
def lm_pair():
    """3 layers, 2 KV heads: the jitted JAX prefill + params, and the
    port's LM on the same weights."""
    over = {"num_layers": 3, "num_kv_heads": 2}
    jcfg = dataclasses.replace(get_config("smollm-360m").reduced(), **over)
    tcfg = dataclasses.replace(port_config("smollm-360m").reduced(), **over)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.key(11))
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       tcfg))
    prefill = jax.jit(jlm.prefill, static_argnames=("pad_to",))
    return prefill, params, lm


def test_per_row_prompt_len_prefill_matches_jax(lm_pair):
    """Mixed prompt lengths in one padded batch ((B,) prompt_len): per-row
    logits, caches and (B,) fill levels as in the JAX LM."""
    prefill, params, lm = lm_pair
    rng = np.random.default_rng(3)
    plens = [5, 16, 1, 11]
    toks = np.zeros((4, 16), np.int32)
    for r, n in enumerate(plens):
        toks[r, :n] = rng.integers(0, 512, n)
    jl, jc = prefill(params, {"tokens": jnp.asarray(toks)}, pad_to=64,
                     prompt_len=jnp.asarray(plens, jnp.int32))
    tl, tc = lm.prefill(torch.from_numpy(toks.astype(np.int64)), pad_to=64,
                        prompt_len=plens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc[0]["k"]),
                               **KV_TOL)
    assert tc.t.tolist() == plens
    assert np.asarray(jc[0]["t"]).tolist() == [plens] * 3


@pytest.mark.parametrize("prefix,n_suffix,extent", [(16, 5, 32),
                                                    (24, 9, 48)])
def test_extend_prefill_matches_jax(lm_pair, prefix, n_suffix, extent):
    """A cached prefix of ``prefix`` slots plus a suffix prefill
    (``cache=``/``fill_to=``): logits, the whole buffer and the fill level
    equal the JAX LM's ``prefill(caches=, fill_to=)``, and the logits
    equal a cold prefill of prefix + suffix."""
    prefill, params, lm = lm_pair
    rng = np.random.default_rng(prefix)
    ids = rng.integers(0, 512, prefix + n_suffix)
    # the prefix cache, from a cold prefill of the prefix alone
    _, jc = prefill(params, {"tokens": jnp.asarray(ids[None, :prefix],
                                                   jnp.int32)},
                    pad_to=extent)
    _, tc = lm.prefill(torch.from_numpy(ids[None, :prefix]), pad_to=extent)
    bs = extent - prefix                    # suffix bucket, to the extent
    sfx = np.zeros((1, bs), np.int64)
    sfx[0, :n_suffix] = ids[prefix:]
    jl, jc = prefill(params, {"tokens": jnp.asarray(sfx, jnp.int32)},
                     prompt_len=jnp.asarray(n_suffix, jnp.int32),
                     caches=jc, fill_to=jnp.asarray(len(ids), jnp.int32))
    tl, tc = lm.prefill(torch.from_numpy(sfx), prompt_len=n_suffix,
                        cache=tc, fill_to=len(ids))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc[0]["k"]),
                               **KV_TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc[0]["v"]),
                               **KV_TOL)
    assert int(tc.t) == len(ids) == int(np.asarray(jc[0]["t"])[0])
    cold, _ = lm.prefill(torch.from_numpy(ids[None]), pad_to=extent)
    np.testing.assert_allclose(tl.numpy(), cold.numpy(), **LOGIT_TOL)
    assert int(tl.argmax()) == int(cold.argmax())


# ------------------------------------------------------------ LaneManager
def test_kv_bytes_per_token_matches_jax():
    for name in ("smollm-360m",):
        for reduce in (False, True):
            jc, tc = get_config(name), port_config(name)
            if reduce:
                jc, tc = jc.reduced(), tc.reduced()
            assert batching.kv_bytes_per_token(tc) == \
                jbatching.kv_bytes_per_token(jc)


def test_lane_manager_tight_budget_admission_order_matches_jax():
    """A seeded admit/retire/evict sequence under a tight budget: both
    managers make the same admission decisions, hold the same bytes and
    count the same stats after every op."""
    rng = np.random.default_rng(4)
    mk = [lambda m: m.LaneManager(3, m.KVBudget(150), bytes_per_token=1,
                                  capacity=64)]
    port, jm = mk[0](batching), mk[0](jbatching)
    queue = [(int(rng.integers(1, 60)), int(rng.integers(1, 40)))
             for _ in range(200)]
    rid = 0
    for _ in range(400):
        op = rng.random()
        free = port.free_lanes()
        assert free == jm.free_lanes()
        if op < 0.55 and free and rid < len(queue):
            plen, mx = queue[rid]
            fits = port.can_admit(plen, mx)
            assert fits == jm.can_admit(plen, mx)
            if fits:                     # strict order: a blocked head waits
                for m in (port, jm):
                    m.admit(free[0], req_id=rid, prompt_len=plen,
                            max_new=mx)
                rid += 1
        elif op < 0.85 and port.busy_lanes():
            lane = int(rng.choice(port.busy_lanes()))
            assert port.retire(lane).req_id == jm.retire(lane).req_id
        elif port.busy_lanes():
            lane = int(rng.choice(port.busy_lanes()))
            assert port.evict(lane).evictions == jm.evict(lane).evictions
        assert port.budget.used_bytes == jm.budget.used_bytes
        assert port.stats == jm.stats
    assert rid > 20 and port.budget.peak_bytes == jm.budget.peak_bytes


# ---------------------------------------------------------------- queue
def test_pop_many_and_live_match_jax():
    rng = np.random.default_rng(8)
    port, jq = SJFQueue("sjf", tau=0.3), JQueue("sjf", tau=0.3)
    now = 0.0
    for i in range(120):
        kw = dict(req_id=i, arrival=now, p_long=float(rng.random()))
        port.push(Request(**kw))
        jq.push(JRequest(**kw))
        now += 0.01
        if i % 7 == 6:
            k = int(rng.integers(1, 5))
            a, b = port.pop_many(k, now), jq.pop_many(k, now)
            assert [(r.req_id, r.promoted) for r in a] == \
                [(r.req_id, r.promoted) for r in b]
        assert sorted(r.req_id for r in port.live()) == \
            sorted(r.req_id for r in jq.live())
    assert port.stats["promotions"] == jq.stats["promotions"] > 0


# ------------------------------------------------------ BatchedRealEngine
@pytest.fixture(scope="module")
def engines():
    """The JAX lane engine of tests/test_batching.py (max_len 64, segment
    4, 3 lanes) and the port's on its weights."""
    cfg = get_config("smollm-360m").reduced()
    jeng = JBatched(cfg, max_len=64, segment_len=4, n_lanes=3, seed=0)
    tcfg = port_config("smollm-360m").reduced()
    sd = params_from_jax(jax.tree.map(np.asarray, jeng.params), tcfg)
    eng = BatchedRealEngine(tcfg, state_dict=sd, max_len=64, segment_len=4,
                            n_lanes=3, device="cpu")
    return jeng, eng, sd


def _prompts(sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n) for n in sizes]


def test_lanes_with_backfill_match_jax_and_serial(engines):
    """7 requests through 3 lanes, 4 of them back-filled: every sequence
    equals the JAX lane engine's and the port's serial oracle's."""
    jeng, eng, _ = engines
    prompts = _prompts((5, 11, 23, 7, 3, 15, 9), 1)
    maxes = [10, 25, 6, 18, 4, 12, 9]
    want = [r["tokens"] for r in jeng.generate_batch(prompts, maxes)]
    outs = eng.generate_batch(prompts, max_new_tokens=maxes)
    assert [o["tokens"] for o in outs] == want
    for out, ids, m in zip(outs, prompts, maxes):
        assert out["tokens"] == eng.generate_reference(ids, m)["tokens"]
        assert not out["cancelled"]
    st = eng.lane_manager.stats
    assert (st["backfills"], st["retired"]) == (4, 7)
    assert st == jeng.lane_manager.stats | {"dead_steps": st["dead_steps"]}
    assert eng.engine_stats()["lanes"] == 3


def test_lanes_eos_and_window_truncation_match_jax(engines):
    jeng, eng, _ = engines
    prompts = _prompts((10, 6, 14), 2)
    eos = eng.generate_reference(prompts[0], 24)["tokens"][5]
    want = jeng.generate_batch(prompts, 24, eos_id=eos)
    outs = eng.generate_batch(prompts, 24, eos_id=eos)
    assert [o["tokens"] for o in outs] == [w["tokens"] for w in want]
    for out, ids in zip(outs, prompts):
        assert out["tokens"] == eng.generate_reference(ids, 24,
                                                       eos_id=eos)["tokens"]
    assert outs[0]["tokens"][-1] == eos and len(outs[0]["tokens"]) < 24
    prompts = _prompts((eng.max_len - 4, 6), 3)
    outs = eng.generate_batch(prompts, 16)
    assert [o["tokens"] for o in outs] == \
        [w["tokens"] for w in jeng.generate_batch(prompts, 16)]
    assert len(outs[0]["tokens"]) == 4


def test_tight_budget_blocks_in_order_and_matches_jax(engines):
    """A budget of 1.2 full rings: admission blocks on memory, the peak
    stays inside the budget, and tokens equal the JAX engine's and the
    serial oracle's."""
    jeng, eng, sd = engines
    bpt = batching.kv_bytes_per_token(eng.cfg)
    budget = int(64 * bpt * 1.2)
    tight = BatchedRealEngine(eng.cfg, state_dict=sd, max_len=64,
                              segment_len=4, n_lanes=3, budget_bytes=budget,
                              device="cpu")
    jtight = JBatched(jeng.cfg, params=jeng.params, max_len=64,
                      segment_len=4, n_lanes=3, budget_bytes=budget)
    prompts = _prompts((40, 40, 40, 8), 4)
    outs = tight.generate_batch(prompts, 20)
    assert [o["tokens"] for o in outs] == \
        [w["tokens"] for w in jtight.generate_batch(prompts, 20)]
    for out, ids in zip(outs, prompts):
        assert out["tokens"] == eng.generate_reference(ids, 20)["tokens"]
    st = tight.lane_manager.stats
    assert st["blocked_on_budget"] == \
        jtight.lane_manager.stats["blocked_on_budget"] > 0
    assert tight.lane_manager.budget.peak_bytes <= budget


def test_lane_cancel_evicts_at_segment_boundary(engines):
    """A cancel observed between segments evicts only that lane, with a
    prefix of its full sequence; the other lanes finish unchanged."""
    _, eng, _ = engines
    prompts = _prompts((9, 13, 5), 5)
    seen = {"segments": 0}
    orig = eng._lane_decoder.run_segment

    def counting(*a, **kw):
        seen["segments"] += 1
        return orig(*a, **kw)

    results, cursor = {}, {"i": 0}

    def source(k):
        out = []
        while k > 0 and cursor["i"] < 3:
            i = cursor["i"]
            cursor["i"] += 1
            out.append({"req_id": i, "ids": prompts[i], "max_new": 30,
                        "meta": {"i": i}})
            k -= 1
        return out

    eng._lane_decoder.run_segment = counting
    try:
        eng.run_lanes(source, lambda st, out: results.update(
            {st.meta["i"]: out}), cancel_check=lambda st: st.meta["i"] == 1
            and seen["segments"] >= 2)
    finally:
        eng._lane_decoder.run_segment = orig
    assert results[1]["cancelled"] and results[1]["evictions"] == 1
    full = eng.generate_reference(prompts[1], 30)["tokens"]
    assert results[1]["tokens"] == full[:len(results[1]["tokens"])]
    assert 1 <= len(results[1]["tokens"]) < len(full)
    for i in (0, 2):
        assert not results[i]["cancelled"]
        assert results[i]["tokens"] == eng.generate_reference(
            prompts[i], 30)["tokens"]


def test_dead_steps_count_stopped_lanes():
    """Two lanes, budgets 2 and 9, segment 4: the short lane stops after
    one step of the first segment and idles 3 lane-steps, exactly as in
    the JAX loop (no EOS involved)."""
    cfg = port_config("smollm-360m").reduced()
    eng = BatchedRealEngine(cfg, max_len=64, segment_len=4, n_lanes=2,
                            device="cpu")
    eng.generate_batch(_prompts((6, 6), 6), [2, 9])
    assert eng.dead_steps == 3 == eng.lane_manager.stats["dead_steps"]


# ------------------------------------------------------- server, batched
@pytest.fixture(scope="module")
def burst():
    """12 requests with true budgets (long 24 / short 4 tokens) and a
    predictor trained on a small balanced draw, scored by both packages
    from the same trees."""
    ds = jsample("sharegpt", n=600, seed=42, balanced=True)
    jpred = JPredictor.train(ds.prompts, ds.lengths, JParams(num_rounds=15))
    m = jpred.model
    pred = Predictor(GBDTModel(m.feature, m.threshold, m.value, m.n_classes,
                               m.max_depth), device="cpu")
    pool = jsample("sharegpt", n=2000, seed=1)
    shorts = [i for i in range(len(pool)) if pool.lengths[i] < 120][:8]
    longs = [i for i in range(len(pool)) if pool.lengths[i] >= 1000][:4]
    order = longs[:2] + shorts[:4] + longs[2:] + shorts[4:]
    return {"jpred": jpred, "pred": pred,
            "prompts": [pool.prompts[i] for i in order],
            "true_output_tokens": [24 if i in longs else 4 for i in order],
            "klasses": ["long" if i in longs else "short" for i in order]}


@pytest.mark.parametrize("policy", ["fcfs", "sjf"])
def test_drain_batched_order_and_tokens_match_jax(burst, engines, policy):
    """The same burst through the JAX server and the port's, each with a
    3-lane engine on the same weights: lanes are filled in the same order
    (the queue's pop_many sequence), responses finish in the same order
    with the same tokens, and every response is ok."""
    jeng, eng, _ = engines
    popped = {"jax": [], "port": []}
    jax_tokens = []
    run_lanes = jeng.run_lanes

    def recording_run_lanes(source, on_finish, **kw):
        def rec(state, out):
            jax_tokens.append(list(out["tokens"]))
            on_finish(state, out)
        return run_lanes(source, rec, **kw)

    kw = {k: burst[k] for k in ("true_output_tokens", "klasses")}
    jserver = JServer(policy=policy, tau=None, engines=[jeng],
                      predictor=burst["jpred"] if policy == "sjf" else None)
    server = ClairvoyantServer(policy=policy, tau=None, engines=[eng],
                               predictor=burst["pred"] if policy == "sjf"
                               else None)
    jeng.run_lanes = recording_run_lanes
    try:
        for name, srv, mk, q in (
                ("jax", jserver, JCompletion,
                 jserver.router.replicas[0].queue),
                ("port", server, CompletionRequest, server.queue)):
            pop_many = q.pop_many

            def recording(k, now, _pop=pop_many, _name=name):
                got = _pop(k, now)
                popped[_name].extend(r.req_id for r in got)
                return got

            q.pop_many = recording
            srv.submit_many([mk(prompt=p) for p in burst["prompts"]], **kw)
            srv.drain(max_new_tokens=24)
    finally:
        del jeng.run_lanes
    resp, jresp = server.responses, jserver.responses
    assert popped["port"] == popped["jax"] and len(popped["port"]) == 12
    assert [r.request_id for r in resp] == [r.request_id for r in jresp]
    assert [r.token_ids for r in resp] == jax_tokens
    assert [r.tokens_generated for r in resp] == \
        [r.tokens_generated for r in jresp]
    assert all(r.ok for r in resp) and not server._inflight
    if policy == "fcfs":
        assert popped["port"] == list(range(1, 13))
    else:       # the predicted-short requests take the first lanes
        p = {r.request_id: r.p_long for r in resp}
        assert max(p[i] for i in popped["port"][:3]) <= \
            min(p[i] for i in popped["port"][3:])


def test_server_cancel_queued_and_in_flight(engines):
    """``cancel`` of a queued request terminates it at once; of a request
    in a lane, at the next segment boundary with a prefix of its tokens.
    Every request ends exactly once."""
    _, eng, _ = engines
    server = ClairvoyantServer(policy="fcfs", tau=None, engines=[eng])
    server.submit_many([CompletionRequest(prompt=f"note {i}")
                        for i in range(5)], true_output_tokens=[30] * 5)
    assert server.cancel(5)                          # still queued
    assert server.responses[-1].status == "cancelled"
    orig, calls = eng._lane_decoder.run_segment, {"n": 0}

    def cancel_two(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            assert server.cancel(2)                  # busy in a lane
        return orig(*a, **kw)

    eng._lane_decoder.run_segment = cancel_two
    try:
        resp = server.drain(max_new_tokens=30)
    finally:
        eng._lane_decoder.run_segment = orig
    by_id = {r.request_id: r for r in resp}
    assert sorted(by_id) == [1, 2, 3, 4, 5] and len(resp) == 5
    assert by_id[2].status == "cancelled" and by_id[5].status == "cancelled"
    assert 1 < by_id[2].tokens_generated < 30
    assert all(by_id[i].ok and by_id[i].tokens_generated == 30
               for i in (1, 3, 4))
    assert not server.cancel(2) and not server._disconnected
