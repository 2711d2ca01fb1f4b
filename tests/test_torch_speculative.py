"""Speculative draft-verify decode in the port against the JAX package:
the verify forward (``LM.verify_step``), the serial ``SpeculativeDecoder``
behind ``RealEngine``, and the speculative ring and paged lanes behind
``BatchedRealEngine`` and ``PagedBatchedEngine``.

Both packages get the same target and draft weights
(``bridge.params_from_jax``): an *agreeing* draft (the target's own
weights) and an *independent* one (another seed).  The invariant is the
JAX tests': accepted tokens are the target's own argmaxes, so every
speculative stream equals plain greedy decode whatever the draft; and
since both packages run the same rounds, the drafted/accepted counts
equal the JAX engines' too.

Float32 on the CPU in both packages.  Tolerances: logits 1e-4 and cached
K/V 1e-5 against JAX, as in tests/test_torch_model.py; a verify row
against a decode step of the port itself 1e-5 (the same arithmetic, but
the projections see B*W rows instead of B).  Tokens and counts are
compared exactly.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model import LM as JLM
from repro.serving.engine import BatchedRealEngine as JBatched
from repro.serving.engine import PagedBatchedEngine as JPaged
from repro.serving.engine import RealEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.model import LM, KVCache, PagedKVCache
from repro_torch.serving.batching import kv_bytes_per_token
from repro_torch.serving.engine import (BatchedRealEngine, PagedBatchedEngine,
                                        RealEngine)
from repro_torch.serving.generate import (SpeculativeDecoder,
                                          SpeculativeLaneDecoder,
                                          SpeculativePagedLaneDecoder)
from repro_torch.serving.paging import BlockAllocator, PagedLaneManager

CFG = get_config("smollm-360m").reduced()
JCFG = jax_config("smollm-360m").reduced()
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
KV_TOL = dict(atol=1e-5, rtol=1e-5)

# the 7-request / 3-lane workload of tests/test_speculative.py (4 back-fills)
_PLENS = (5, 11, 23, 7, 3, 15, 9)
_MAXES = [10, 25, 6, 18, 4, 12, 9]


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG.vocab_size, int(n)).tolist() for n in _PLENS]


@pytest.fixture(scope="module")
def w():
    """JAX target (seed 0) and independent draft (seed 7) params, and the
    port's state dicts of both."""
    tgt = JLM(JCFG).init(jax.random.key(0))
    ind = JLM(JCFG).init(jax.random.key(7))
    conv = lambda p: params_from_jax(jax.tree.map(np.asarray, p), CFG)  # noqa: E731
    return {"jt": tgt, "ji": ind, "pt": conv(tgt), "pi": conv(ind)}


def _drafts(w, which):
    """(JAX draft params, port draft state dict) of the named draft."""
    return (w["jt"], w["pt"]) if which == "agree" else (w["ji"], w["pi"])


@pytest.fixture(scope="module")
def serial(w):
    """Plain and speculative (K=3) serial engines of both packages."""
    kw = dict(max_len=64, seed=0)
    out = {"jref": JEngine(JCFG, params=w["jt"], **kw),
           "ref": RealEngine(CFG, state_dict=w["pt"], device="cpu", **kw)}
    for which in ("agree", "indep"):
        jd, pd = _drafts(w, which)
        out["j" + which] = JEngine(JCFG, params=w["jt"], draft_cfg=JCFG,
                                   draft_params=jd, draft_k=3, **kw)
        out[which] = RealEngine(CFG, state_dict=w["pt"], device="cpu",
                                draft_cfg=CFG, draft_state_dict=pd,
                                draft_k=3, **kw)
    return out


# ------------------------------------------------------------ verify forward
def _ring_pair(w, B, t, S=64, seed=0):
    """A JAX and a port ring cache holding the same random K/V, at fill
    level(s) ``t`` (an int: 0-d; a list: (B,))."""
    rng = np.random.default_rng(seed)
    shape = (CFG.num_layers, B, S, CFG.num_kv_heads, CFG.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    tn = np.asarray(t, np.int32)
    jt = np.broadcast_to(tn, (CFG.num_layers,) + tn.shape)
    jc = ({"k": jnp.asarray(k), "v": jnp.asarray(v), "t": jnp.asarray(jt)},)
    pc = KVCache(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
                 t=torch.from_numpy(tn.copy()))
    return jc, pc


@pytest.mark.parametrize("B,t", [(1, 9), (1, 61), (3, [0, 30, 62]),
                                 (2, [63, 70])])
def test_verify_step_ring_matches_jax(w, B, t):
    """Ring verify with a 0-d and a (B,) fill level, windows inside the
    ring and crossing or past its end (positions >= S are dropped, not
    wrapped): logits and the caches after the writes equal JAX's; the
    fill level is not advanced."""
    W = 4
    jc, pc = _ring_pair(w, B, t)
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (B, W))
    jlog, jc = JLM(JCFG).verify_step(w["jt"], jc,
                                     {"tokens": jnp.asarray(toks, jnp.int32)})
    lm = LM(CFG, device="cpu")
    lm.load_state_dict(w["pt"])
    t_before = pc.t.clone()
    plog = lm.verify_step(pc, torch.from_numpy(toks))
    assert plog.shape == (B, W, CFG.vocab_size)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    np.testing.assert_allclose(pc.k.numpy(), np.asarray(jc[0]["k"]), **KV_TOL)
    np.testing.assert_allclose(pc.v.numpy(), np.asarray(jc[0]["v"]), **KV_TOL)
    assert torch.equal(pc.t, t_before)


def test_verify_step_paged_matches_jax(w):
    """Paged verify: each lane writes its W K/Vs through its block table
    (a position past the window goes to trash page 0) and reads the pool
    in place; logits and pools equal JAX's (which gathers pool[bt])."""
    B, W, page, P, n_pages = 3, 4, 16, 4, 14
    rng = np.random.default_rng(3)
    shape = (CFG.num_layers, n_pages, page, CFG.num_kv_heads, CFG.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    bt = np.zeros((B, P), np.int32)
    bt[0, :2] = [5, 2]                         # t 20: a 2-page window
    bt[1] = [7, 1, 12, 3]                      # t 61: crosses the end
    bt[2, :3] = [9, 4, 13]                     # t 40
    t = np.array([20, 61, 40], np.int32)
    toks = rng.integers(0, CFG.vocab_size, (B, W))
    jc = ({"k": jnp.asarray(k), "v": jnp.asarray(v),
           "t": jnp.asarray(t[None]), "bt": jnp.asarray(bt[None])},)
    jlog, jc = JLM(JCFG).verify_step(w["jt"], jc,
                                     {"tokens": jnp.asarray(toks, jnp.int32)})
    lm = LM(CFG, device="cpu")
    lm.load_state_dict(w["pt"])
    pc = PagedKVCache(k=torch.from_numpy(k.copy()),
                      v=torch.from_numpy(v.copy()),
                      bt=torch.from_numpy(bt), t=torch.from_numpy(t.copy()))
    plog = lm.verify_step(pc, torch.from_numpy(toks))
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    live = np.ones(n_pages, bool)
    live[0] = False                            # trash: write order free
    np.testing.assert_allclose(pc.k.numpy()[:, live],
                               np.asarray(jc[0]["k"])[:, live], **KV_TOL)
    np.testing.assert_allclose(pc.v.numpy()[:, live],
                               np.asarray(jc[0]["v"])[:, live], **KV_TOL)
    assert pc.t.tolist() == t.tolist()


@pytest.mark.parametrize("paged", [False, True])
def test_verify_row_equals_decode_step_at_t_plus_w(w, paged):
    """Row w of the verify logits is what ``decode_step`` gives after
    consuming tokens 0..w from the same cache (fill level t + w)."""
    W = 5
    lm = LM(CFG, device="cpu")
    lm.load_state_dict(w["pt"])
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, CFG.vocab_size, (2, W)))

    def fresh():
        if not paged:
            return _ring_pair(w, 2, [11, 40])[1]
        c = lm.init_paged_cache(2, 64, 10, 16)
        c.k.normal_(generator=torch.Generator().manual_seed(0))
        c.v.normal_(generator=torch.Generator().manual_seed(1))
        c.bt.copy_(torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]]))
        c.t.copy_(torch.tensor([11, 40]))
        return c

    got = lm.verify_step(fresh(), toks)
    step = fresh()
    for i in range(W):
        want = lm.decode_step(step, toks[:, i:i + 1])
        np.testing.assert_allclose(got[:, i].numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-5)
        assert torch.equal(got[:, i].argmax(-1), want.argmax(-1))


# ------------------------------------------------------------ serial decoder
@pytest.mark.parametrize("plen", [1, 3, 9, 17, 40])
def test_serial_tokens_equal_greedy_and_jax_counts(serial, plen):
    """Agreeing and independent drafts give the plain greedy tokens (the
    JAX oracle's and the port's own), and each round's accepted count is
    JAX's: the drafted/accepted totals are equal."""
    rng = np.random.default_rng(plen)
    ids = rng.integers(0, CFG.vocab_size, plen).tolist()
    for max_new in (1, 7, 16):
        want = serial["jref"].generate_reference(
            ids, max_new_tokens=max_new)["tokens"]
        assert serial["ref"].generate_reference(
            ids, max_new_tokens=max_new)["tokens"] == want
        for which in ("agree", "indep"):
            got = serial[which].generate(ids, max_new_tokens=max_new)
            jgot = serial["j" + which].generate(ids, max_new_tokens=max_new)
            assert got["tokens"] == want, (which, max_new)
            assert (got["drafted"], got["accepted"], got["segments"]) == \
                (jgot["drafted"], jgot["accepted"], jgot["segments"])


@pytest.mark.parametrize("which", ["agree", "indep"])
def test_eos_inside_draft_block_truncates(serial, which):
    """An EOS that fires mid-stream, inside an accepted draft block or
    not: the speculative path stops at the oracle's token."""
    ids = list(range(5))
    free = serial["ref"].generate_reference(ids, max_new_tokens=16)["tokens"]
    assert len(free) > 3
    eos = free[len(free) // 2]
    want = serial["jref"].generate_reference(ids, max_new_tokens=16,
                                             eos_id=eos)["tokens"]
    assert len(want) < len(free)
    got = serial[which].generate(ids, max_new_tokens=16, eos_id=eos)
    assert got["tokens"] == want
    jgot = serial["j" + which].generate(ids, max_new_tokens=16, eos_id=eos)
    assert got["accepted"] == jgot["accepted"]


def test_accept_rate_reported(serial):
    eng = serial["agree"]
    before = eng.engine_stats()
    out = eng.generate(list(range(6)), max_new_tokens=16)
    assert out["drafted"] > 0
    assert out["accept_rate"] == out["accepted"] / out["drafted"]
    assert out["accept_rate"] > 0.5            # agreeing draft accepts most
    st = eng.engine_stats()
    assert st["speculative"] is True
    assert st["drafted"] - before["drafted"] == out["drafted"]
    assert st["accept_rate"] == st["accepted"] / st["drafted"]
    assert serial["ref"].engine_stats() == {
        "replica": 0, "served": serial["ref"].served, "speculative": False}


def test_all_rejected_still_progresses(serial):
    """The independent draft wastes nearly every proposal, yet each
    verify round commits at least the bonus token, so the output is the
    oracle's.  The contract stated here does not require zero accepts,
    as tests/test_speculative.py::test_all_rejected_still_progresses
    does: an independent draft can agree by chance (on the JAX reference
    it accepts 3 of its 24 proposals on this very prompt), and the same
    count is required of the port.  What must hold: tokens equal, drafts
    proposed, the accept rate is accepted / drafted and far below the
    agreeing draft's."""
    ids = list(range(8))
    want = serial["jref"].generate_reference(ids, max_new_tokens=12)["tokens"]
    got = serial["indep"].generate(ids, max_new_tokens=12)
    agree = serial["agree"].generate(ids, max_new_tokens=12)
    jgot = serial["jindep"].generate(ids, max_new_tokens=12)
    assert got["tokens"] == want == agree["tokens"]
    assert got["drafted"] > 0
    assert got["accept_rate"] == got["accepted"] / got["drafted"]
    assert got["accept_rate"] < 0.5 * agree["accept_rate"]
    assert (got["drafted"], got["accepted"]) == \
        (jgot["drafted"], jgot["accepted"])


def test_draft_k_zero_degenerates_to_fused(w, serial):
    """A draft config with draft_k 0 is not speculative: the plain fused
    path, no acceptance keys in the result."""
    eng = RealEngine(CFG, state_dict=w["pt"], max_len=64, device="cpu",
                     draft_cfg=CFG, draft_k=0)
    assert not eng.speculative and eng.draft_lm is None
    ids = list(range(7))
    out = eng.generate(ids, max_new_tokens=10)
    assert out["tokens"] == serial["ref"].generate_reference(
        ids, max_new_tokens=10)["tokens"]
    assert "accept_rate" not in out


@pytest.mark.parametrize("bad", ["k0", "vocab"])
def test_decoders_reject_bad_k_and_vocab_mismatch(serial, bad):
    lm = serial["ref"].lm
    draft = lm
    k = 3
    if bad == "k0":
        k = 0
    else:
        draft = LM(dataclasses.replace(CFG, vocab_size=CFG.vocab_size + 8),
                   device="cpu")
    with pytest.raises(ValueError):
        SpeculativeDecoder(lm, draft, max_len=64, draft_k=k)
    with pytest.raises(ValueError):
        SpeculativeLaneDecoder(lm, draft, 64, 2, draft_k=k)
    with pytest.raises(ValueError):
        SpeculativePagedLaneDecoder(lm, draft, 64, 2, n_pages=9,
                                    page_size=16, draft_k=k)
    if bad == "vocab":
        with pytest.raises(ValueError, match="vocab"):
            RealEngine(CFG, max_len=64, device="cpu",
                       draft_cfg=draft.cfg, draft_k=3)


# ------------------------------------------------------------- batched lanes
@pytest.fixture(scope="module")
def lane_want(serial):
    return [serial["jref"].generate_reference(p, max_new_tokens=m)["tokens"]
            for p, m in zip(_prompts(), _MAXES)]


def _lane_pair(w, which, paged=False, **kw):
    jd, pd = _drafts(w, which)
    base = dict(max_len=64, segment_len=4, n_lanes=3, seed=0, draft_k=3,
                **kw)
    if paged:
        base["page_size"] = 16
    jcls, pcls = (JPaged, PagedBatchedEngine) if paged \
        else (JBatched, BatchedRealEngine)
    return (jcls(JCFG, params=w["jt"], draft_cfg=JCFG, draft_params=jd,
                 **base),
            pcls(CFG, state_dict=w["pt"], device="cpu", draft_cfg=CFG,
                 draft_state_dict=pd, **base))


@pytest.mark.parametrize("which", ["agree", "indep"])
def test_batched_retire_backfill(w, lane_want, which):
    """7 requests through 3 speculative ring lanes (4 back-fills): tokens
    equal greedy decode; per-request and total drafted/accepted counts
    and dead steps equal the JAX lane engine's."""
    jeng, eng = _lane_pair(w, which)
    outs = eng.generate_batch(_prompts(), max_new_tokens=_MAXES)
    jouts = jeng.generate_batch(_prompts(), max_new_tokens=_MAXES)
    assert [o["tokens"] for o in outs] == [list(x) for x in lane_want]
    assert [(o["drafted"], o["accepted"]) for o in outs] == \
        [(o["drafted"], o["accepted"]) for o in jouts]
    st = eng.lane_manager.stats
    assert st["backfills"] == 4 and st["retired"] == 7
    assert st["drafted"] == eng.drafted_total == jeng.drafted_total > 0
    assert eng.accepted_total == jeng.accepted_total
    assert eng.dead_steps == jeng.dead_steps
    assert eng.engine_stats()["accept_rate"] == eng.accept_rate
    if which == "agree":
        assert eng.accept_rate > 0.5
    else:
        assert eng.accept_rate < 0.1
        # every wasted draft position lands in dead_steps
        assert eng.dead_steps >= eng.drafted_total - eng.accepted_total


def test_batched_eos(w, serial, lane_want):
    _, eng = _lane_pair(w, "agree")
    eos = lane_want[1][len(lane_want[1]) // 2]
    want = [serial["jref"].generate_reference(p, max_new_tokens=m,
                                              eos_id=eos)["tokens"]
            for p, m in zip(_prompts(), _MAXES)]
    assert any(len(a) < len(b) for a, b in zip(want, lane_want))
    outs = eng.generate_batch(_prompts(), max_new_tokens=_MAXES, eos_id=eos)
    assert [o["tokens"] for o in outs] == [list(x) for x in want]


def test_draft_kv_charged_to_budget(w):
    """Ring lanes charge target + draft bytes per token: the speculative
    default budget doubles, and the manager's rate includes the draft."""
    plain = BatchedRealEngine(CFG, state_dict=w["pt"], max_len=64,
                              segment_len=4, n_lanes=3, device="cpu")
    _, eng = _lane_pair(w, "agree")
    bpt = kv_bytes_per_token(CFG)
    assert eng._draft_bytes_per_token == bpt
    eng.generate_batch(_prompts()[:3], max_new_tokens=4)
    assert eng.lane_manager.bytes_per_token == 2 * bpt
    assert eng.budget_bytes == plain.budget_bytes * 2
    assert eng._growth_span == eng._lane_decoder.rounds * 4 == 4


# -------------------------------------------------------------- paged lanes
@pytest.mark.parametrize("which", ["agree", "indep"])
def test_paged_speculative(w, lane_want, which):
    jeng, eng = _lane_pair(w, which, paged=True)
    assert eng._overhead_pages == jeng._overhead_pages > 0
    assert eng.n_pages == jeng.n_pages
    outs = eng.generate_batch(_prompts(), max_new_tokens=_MAXES)
    jouts = jeng.generate_batch(_prompts(), max_new_tokens=_MAXES)
    assert [o["tokens"] for o in outs] == [list(x) for x in lane_want]
    assert [o["accepted"] for o in outs] == [o["accepted"] for o in jouts]
    assert eng.accepted_total == jeng.accepted_total
    eng.allocator.check()


def test_paged_tight_budget(w, lane_want):
    """A pool too small for 3 concurrent speculative lanes serialises
    admission but never changes tokens."""
    budget = 10 * 16 * kv_bytes_per_token(CFG)
    jeng, eng = _lane_pair(w, "agree", paged=True, budget_bytes=budget)
    assert eng.n_pages == jeng.n_pages == 10
    outs = eng.generate_batch(_prompts(), max_new_tokens=_MAXES)
    jeng.generate_batch(_prompts(), max_new_tokens=_MAXES)
    assert [o["tokens"] for o in outs] == [list(x) for x in lane_want]
    st, jst = eng.lane_manager.stats, jeng.lane_manager.stats
    assert st["blocked_on_budget"] == jst["blocked_on_budget"] > 0
    assert st.get("preemptions", 0) == jst.get("preemptions", 0)
    eng.allocator.check()


def test_paged_overhead_pages_accounting():
    """Admission reserves the draft ring as unmapped overhead pages and
    releases them at retire: the allocator balances."""
    alloc = BlockAllocator(n_pages=16, page_size=16)
    mgr = PagedLaneManager(n_lanes=2, allocator=alloc, bytes_per_token=4,
                           capacity=64, overhead_pages=3)
    assert alloc.can_allocate(16)
    mgr.admit(0, req_id=1, prompt_len=17, max_new=8, ids=list(range(17)))
    assert len(mgr._overhead[0]) == 3
    assert not alloc.can_allocate(12)          # 2 prompt + 3 overhead held
    assert alloc.can_allocate(11)
    assert mgr.can_admit(17, 8, ids=list(range(100, 117)))
    mgr.retire(0)
    assert 0 not in mgr._overhead
    assert alloc.can_allocate(16)
    alloc.check()
    with pytest.raises(ValueError):
        PagedLaneManager(n_lanes=1, allocator=BlockAllocator(5, 16),
                         bytes_per_token=4, capacity=64, overhead_pages=3)
