"""The models the card serves whole, by one pattern repeat or cut by
depth (gemma-2b, qwen3-32b, llama4-maverick, granite-8b, dbrx-132b),
held to the JAX package's engines on the CPU.

Each config is the registry's ``reduced()`` one with the heads widened
back to its own group width: qwen3-32b 8 query heads over 1 KV head with
its QK-norm (G 8, as its 64 over 8), gemma-2b 8 over 1 (multi-query, its
own heads), llama4-maverick 10 over 2 (G 5, as its 40 over 8; the
pattern keeps a dense layer and a MoE layer of 4 experts, top-1),
granite-8b 8 over 2 (G 4, as its 32 over 8) and dbrx-132b 12 over 2
(G 6, as its 48 over 8; two MoE layers of 8 experts, top-4 as its own).
The JAX engines' weights come across through ``bridge.params_from_jax``,
float32 on both sides:

* ``RealEngine`` greedy tokens (and the per-token oracle) equal the JAX
  ``RealEngine``'s;
* ``BatchedRealEngine`` with back-fill equals the JAX lane engine (for
  the MoE stacks the bar is the JAX lanes, not the serial engine: MoE
  capacity is shared by a step's tokens);
* ``PagedBatchedEngine`` equals the JAX paged engine for qwen3, gemma-2b
  and granite, with a shared prefix cold then warm (the same prefix-hit
  pages) and the pool drained clean; llama4's and dbrx's stacks are
  refused by the paged and the speculative engines with the JAX
  messages;
* ``ClairvoyantServer`` under SJF dispatches qwen3's burst (2 longs of 24
  new tokens, then 4 shorts of 4: the card's) in the JAX server's order
  with its tokens;
* the sizes the card is given: qwen3, gemma-2b and granite whole, one
  llama4 repeat and dbrx at 8 of its 40 layers, their parameters, bf16
  bytes and KV bytes a token.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.core.gbdt import GBDTParams as JParams
from repro.core.predictor import Predictor as JPredictor
from repro.data.corpus import sample_dataset as jsample
from repro.serving import batching as jbatching
from repro.serving.engine import BatchedRealEngine as JBatched
from repro.serving.engine import PagedBatchedEngine as JPaged
from repro.serving.engine import RealEngine as JReal
from repro.serving.openai_api import CompletionRequest as JCompletion
from repro.serving.server import ClairvoyantServer as JServer
from repro_torch.configs import get_config
from repro_torch.core.gbdt import GBDTModel
from repro_torch.core.predictor import Predictor
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving import batching
from repro_torch.serving.engine import (BatchedRealEngine, PagedBatchedEngine,
                                        RealEngine)
from repro_torch.serving.openai_api import CompletionRequest
from repro_torch.serving.server import ClairvoyantServer

QWEN3, GEMMA2B, LLAMA4 = ("qwen3-32b", "gemma-2b",
                          "llama4-maverick-400b-a17b")
GRANITE, DBRX = "granite-8b", "dbrx-132b"
#: the MoE stacks: capacity is shared by a step's tokens
MOE = (LLAMA4, DBRX)
#: each reduced config's heads at its own group width (dbrx: two MoE
#: layers of 8 experts, top-4 as its own)
HEADS = {QWEN3: dict(num_heads=8, num_kv_heads=1),
         GEMMA2B: dict(num_heads=8, num_kv_heads=1),
         LLAMA4: dict(num_heads=10, num_kv_heads=2),
         GRANITE: dict(num_heads=8, num_kv_heads=2),
         DBRX: dict(num_heads=12, num_kv_heads=2, num_layers=2,
                    num_experts=8, experts_per_token=4)}
MAX_LEN, SEGMENT, LANES, PAGE = 64, 4, 3, 8


def _configs(name):
    """(JAX config, port config): ``reduced()`` at the group width."""
    return (dataclasses.replace(jax_config(name).reduced(), **HEADS[name]),
            dataclasses.replace(get_config(name).reduced(), **HEADS[name]))


@functools.lru_cache(maxsize=None)
def _engines(name):
    """The JAX serial and lane engines and the port's on their weights."""
    jcfg, cfg = _configs(name)
    jser = JReal(jcfg, max_len=MAX_LEN, segment_len=SEGMENT, seed=3)
    jlanes = JBatched(jcfg, params=jser.params, max_len=MAX_LEN,
                      segment_len=SEGMENT, n_lanes=LANES)
    sd = params_from_jax(jax.tree.map(np.asarray, jser.params), cfg)
    ser = RealEngine(cfg, state_dict=sd, max_len=MAX_LEN,
                     segment_len=SEGMENT, device="cpu")
    lanes = BatchedRealEngine(cfg, state_dict=sd, max_len=MAX_LEN,
                              segment_len=SEGMENT, n_lanes=LANES,
                              device="cpu")
    return jser, jlanes, ser, lanes, sd


def _prompts(sizes, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int64) for n in sizes]


@pytest.mark.parametrize("name,group,qk_norm", [(QWEN3, 8, True),
                                                (GEMMA2B, 8, False),
                                                (LLAMA4, 5, False),
                                                (GRANITE, 4, False),
                                                (DBRX, 6, False)])
def test_reduced_configs_keep_the_group_width(name, group, qk_norm):
    full = get_config(name)
    _, cfg = _configs(name)
    assert full.num_heads // full.num_kv_heads == group
    assert cfg.num_heads // cfg.num_kv_heads == group
    assert cfg.qk_norm == full.qk_norm == qk_norm
    assert cfg.block_pattern == full.block_pattern
    assert cfg.experts_per_token == full.experts_per_token
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_configs(name)[0])


@pytest.mark.parametrize("name", [QWEN3, GEMMA2B, LLAMA4, GRANITE, DBRX])
def test_serial_tokens_match_jax_engine(name):
    jser, _, ser, _, _ = _engines(name)
    for ids, m in zip(_prompts((7, 13, 3, 20), 5), (9, 12, 5, 16)):
        want = jser.generate(ids, max_new_tokens=m)["tokens"]
        assert ser.generate(ids, max_new_tokens=m)["tokens"] == want
        assert ser.generate_reference(ids, m)["tokens"] == want


@pytest.mark.parametrize("name", [QWEN3, GEMMA2B, LLAMA4, GRANITE, DBRX])
def test_lane_tokens_with_backfill_match_jax_engine(name):
    """Five requests through three lanes, two back-filled."""
    _, jlanes, ser, lanes, _ = _engines(name)
    prompts = _prompts((7, 7, 12, 5, 12), 6)
    maxes = [10, 6, 8, 12, 5]
    want = [r["tokens"] for r in jlanes.generate_batch(prompts, maxes)]
    assert [r["tokens"] for r in lanes.generate_batch(prompts, maxes)] \
        == want
    assert lanes.lane_manager.stats["backfills"] == \
        jlanes.lane_manager.stats["backfills"] > 0
    if name not in MOE:         # without MoE a lane is the serial engine
        assert want == [ser.generate(p, max_new_tokens=m)["tokens"]
                        for p, m in zip(prompts, maxes)]


@pytest.mark.parametrize("name", [QWEN3, GEMMA2B, GRANITE])
def test_paged_tokens_and_prefix_hits_match_jax_engine(name):
    """Six requests through three paged lanes (page 8), then eight after a
    shared 24-token prefix, cold and warm: tokens equal the JAX paged
    engine's and the port's serial engine's, the prefix-hit pages equal
    JAX's, and the pool drains clean after each drain."""
    jser, _, ser, _, sd = _engines(name)
    jpaged = JPaged(jser.cfg, params=jser.params, max_len=MAX_LEN,
                    segment_len=SEGMENT, n_lanes=LANES, page_size=PAGE)
    paged = PagedBatchedEngine(ser.cfg, state_dict=sd, max_len=MAX_LEN,
                               segment_len=SEGMENT, n_lanes=LANES,
                               page_size=PAGE, device="cpu")
    prefix = _prompts((24,), 8)[0]
    plain = _prompts((5, 17, 9, 23, 3, 12), 0)
    shared = [np.concatenate([prefix, p]) for p in _prompts((4,) * 8, 9)]
    for prompts, maxes in ((plain, [20, 8, 30, 12, 25, 16]),
                           (shared, [6, 9, 4, 12, 7, 5, 10, 8]),
                           (shared, [6, 9, 4, 12, 7, 5, 10, 8])):
        want = [r["tokens"] for r in jpaged.generate_batch(prompts, maxes)]
        got = [r["tokens"] for r in paged.generate_batch(prompts, maxes)]
        assert got == want
        assert got == [ser.generate(p, max_new_tokens=m)["tokens"]
                       for p, m in zip(prompts, maxes)]
        assert paged.allocator.stats == jpaged.allocator.stats
        assert paged.allocator.used_pages == 0
        paged.allocator.check()
    assert paged.allocator.stats["prefix_hit_pages"] > 0


def _refuses_paged_and_speculative_with_jax_messages(name):
    jser, _, ser, _, _ = _engines(name)
    cfg, jcfg = ser.cfg, jser.cfg
    draft, jdraft = (get_config("smollm-360m").reduced(),
                     jax_config("smollm-360m").reduced())
    for port_build, jax_build in (
            (lambda: PagedBatchedEngine(cfg, max_len=MAX_LEN, device="cpu"),
             lambda: JPaged(jcfg, params=jser.params, max_len=MAX_LEN)),
            (lambda: RealEngine(cfg, draft_cfg=draft, draft_k=2,
                                device="cpu"),
             lambda: JReal(jcfg, params=jser.params, draft_cfg=jdraft,
                           draft_k=2)),
            (lambda: BatchedRealEngine(cfg, draft_cfg=draft, draft_k=2,
                                       device="cpu"),
             lambda: JBatched(jcfg, params=jser.params, draft_cfg=jdraft,
                              draft_k=2))):
        with pytest.raises(ValueError) as mine:
            port_build()
        with pytest.raises(ValueError) as theirs:
            jax_build()
        assert str(mine.value) == str(theirs.value)


def test_llama4_refuses_paged_and_speculative_with_jax_messages():
    _refuses_paged_and_speculative_with_jax_messages(LLAMA4)


def test_dbrx_refuses_paged_and_speculative_with_jax_messages():
    _refuses_paged_and_speculative_with_jax_messages(DBRX)


@pytest.mark.parametrize("policy", ["fcfs", "sjf"])
def test_qwen3_burst_dispatch_order_matches_jax_server(policy, monkeypatch):
    """The card's qwen3 burst (2 longs of 24 new tokens, then 4 shorts of
    4) through both servers on the same weights (max_len 160): the same
    dispatch order and tokens, P(Long) within 1e-6."""
    ds = jsample("sharegpt", n=600, seed=42, balanced=True)
    jpred = JPredictor.train(ds.prompts, ds.lengths, JParams(num_rounds=20))
    m = jpred.model
    pred = Predictor(GBDTModel(m.feature, m.threshold, m.value, m.n_classes,
                               m.max_depth), device="cpu")
    pool = jsample("sharegpt", n=4000, seed=1)
    shorts = [i for i in range(len(pool)) if pool.lengths[i] < 120][:4]
    longs = [i for i in range(len(pool)) if pool.lengths[i] >= 1000][:2]
    order = longs + shorts
    kw = dict(arrivals=[j * 1e-4 for j in range(len(order))],
              true_output_tokens=[24 if i in longs else 4 for i in order],
              klasses=["long" if i in longs else "short" for i in order])
    jcfg, cfg = _configs(QWEN3)
    jeng = JReal(jcfg, max_len=160, segment_len=16, seed=0)
    eng = RealEngine(cfg, max_len=160, segment_len=16, device="cpu",
                     state_dict=params_from_jax(
                         jax.tree.map(np.asarray, jeng.params), cfg))
    jax_tokens = []
    generate = jeng.generate

    def recording_generate(ids, **kwargs):
        out = generate(ids, **kwargs)
        jax_tokens.append(out["tokens"])
        return out

    monkeypatch.setattr(jeng, "generate", recording_generate)
    jserver = JServer(policy=policy, tau=None, engines=[jeng],
                      predictor=jpred if policy == "sjf" else None)
    jserver.submit_many([JCompletion(prompt=pool.prompts[i])
                         for i in order], **kw)
    jserver.drain(max_new_tokens=64)
    server = ClairvoyantServer(policy=policy, tau=None, engines=[eng],
                               predictor=pred if policy == "sjf" else None)
    server.submit_many([CompletionRequest(prompt=pool.prompts[i])
                        for i in order], **kw)
    resp = server.drain(max_new_tokens=64)
    assert [r.request_id for r in resp] == \
        [r.request_id for r in jserver.responses]
    assert [r.token_ids for r in resp] == jax_tokens
    assert all(r.ok for r in resp) and len(resp) == len(order)
    assert [r.tokens_generated for r in resp] == [
        r.tokens_generated for r in jserver.responses]
    np.testing.assert_allclose([r.p_long for r in resp],
                               [r.p_long for r in jserver.responses],
                               atol=1e-6)
    if policy == "fcfs":
        assert [r.request_id for r in resp] == list(range(1, len(order) + 1))
    else:       # SJF serves the predicted-shortest request first
        assert resp[0].p_long <= min(r.p_long for r in resp)
        assert [r.request_id for r in resp] != list(range(1, len(order) + 1))


# -------------------------------------------------------------------- sizes
GIB = 2 ** 30
CARD_BYTES = 80e9               # the H100's 80 GB of HBM3


@pytest.mark.parametrize("name,layers,params,kv_bytes,stream_gb", [
    (QWEN3, 64, 32_762_123_264, 262_144, 65.52),
    (GEMMA2B, 18, 2_506_172_416, 18_432, 5.01),
    (LLAMA4, 2, 18_427_438_080, 8_192, 36.85),
    (GRANITE, 36, 8_254_689_280, 147_456, 16.51),
    (DBRX, 8, 27_305_809_920, 32_768, 54.61)])
def test_sizes_of_what_the_card_serves(name, layers, params, kv_bytes,
                                       stream_gb):
    """qwen3-32b, gemma-2b and granite-8b whole, llama4-maverick by one
    pattern repeat and dbrx-132b at 8 of its 40 layers (neither whole
    model fits one card): parameters, the bf16 weight stream a decode
    step reads, KV bytes a token, as JAX counts them."""
    full, jfull = get_config(name), jax_config(name)
    cfg = dataclasses.replace(full, num_layers=layers)
    jcfg = dataclasses.replace(jfull, num_layers=layers)
    assert cfg.param_count() == jcfg.param_count() == params
    assert round(params * 2 / 1e9, 2) == stream_gb
    assert batching.kv_bytes_per_token(cfg) == \
        jbatching.kv_bytes_per_token(jcfg) == kv_bytes
    assert params * 2 < CARD_BYTES


def test_qwen3_whole_fits_the_card_and_llama4_whole_does_not():
    qwen3, llama4 = get_config(QWEN3), get_config(LLAMA4)
    assert round(qwen3.param_count() * 2 / GIB, 2) == 61.02
    assert qwen3.param_count() * 2 / GIB < 79.0      # ~18 GiB left
    assert llama4.param_count() == 394_672_051_200
    assert round(llama4.param_count() * 2 / GIB) == 735
    assert batching.kv_bytes_per_token(llama4) == 196_608
    # one repeat in float32 (the card's kernels-vs-plain hold): 68.6 GiB
    one = dataclasses.replace(llama4, num_layers=len(llama4.block_pattern))
    assert round(one.param_count() * 4 / GIB, 1) == 68.6
    assert round(get_config(GEMMA2B).param_count() * 2 / GIB, 2) == 4.67
