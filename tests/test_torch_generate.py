"""The port's serial engine: greedy tokens equal to the JAX ``RealEngine``
on the same weights, fused decode equal to the port's per-token oracle
bit for bit, and the cases of tests/test_generate.py (EOS early exit,
max_len truncation, ring wrap, bucketing, cancellation at a segment
boundary).  Float32 on the CPU; tokens are compared exactly."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.serving.engine import RealEngine as JaxEngine
from repro_torch.configs import get_config as port_config
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving.engine import RealEngine
from repro_torch.serving.generate import (FusedDecoder, bucket_for,
                                          geometric_buckets)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) with the JAX engine's weights carried
    across; max_len 96, segment_len 8 as in tests/test_generate.py."""
    jax_eng = JaxEngine(get_config("smollm-360m").reduced(), max_len=96,
                        segment_len=8)
    cfg = port_config("smollm-360m").reduced()
    sd = params_from_jax(jax.tree.map(np.asarray, jax_eng.params), cfg)
    return jax_eng, RealEngine(cfg, state_dict=sd, max_len=96,
                               segment_len=8, device="cpu")


@pytest.fixture(scope="module")
def engine(engines):
    return engines[1]


def _ids(seed, n, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, n)


# ---------------------------------------------------------------- equivalence
@pytest.mark.parametrize("plen", [1, 3, 8, 17, 33, 64])
def test_tokens_match_jax_engine(engines, plen):
    """Same weights, same prompt: the port's greedy tokens are the JAX
    engine's, and fused == the port's per-token oracle, token for token."""
    jax_eng, eng = engines
    ids = _ids(plen, plen)
    want = jax_eng.generate(ids, max_new_tokens=24)["tokens"]
    fused = eng.generate(ids, max_new_tokens=24)
    oracle = eng.generate_reference(ids, max_new_tokens=24)
    assert fused["tokens"] == want
    assert fused["tokens"] == oracle["tokens"]
    assert len(fused["tokens"]) == 24 and not fused["cancelled"]


def test_eos_early_exit(engine):
    ids = _ids(7, 10)
    eos = engine.generate_reference(ids, max_new_tokens=24)["tokens"][5]
    fused = engine.generate(ids, max_new_tokens=24, eos_id=eos)
    oracle = engine.generate_reference(ids, max_new_tokens=24, eos_id=eos)
    assert fused["tokens"] == oracle["tokens"]
    assert len(fused["tokens"]) < 24 and fused["tokens"][-1] == eos


def test_max_len_truncation_matches_jax(engines):
    """prompt + generated never exceeds max_len, exactly like the oracle
    and the JAX engine."""
    jax_eng, eng = engines
    ids = _ids(11, eng.max_len - 6)
    fused = eng.generate(ids, max_new_tokens=32)
    assert fused["tokens"] == eng.generate_reference(
        ids, max_new_tokens=32)["tokens"]
    want = jax_eng.generate(ids, max_new_tokens=32)["tokens"]
    assert fused["tokens"] == want
    assert len(fused["tokens"]) == 6


def test_single_token_budget(engine):
    ids = _ids(13, 5)
    fused = engine.generate(ids, max_new_tokens=1)
    assert fused["tokens"] == engine.generate_reference(
        ids, max_new_tokens=1)["tokens"]
    assert len(fused["tokens"]) == 1


def test_segment_length_does_not_change_tokens(engine):
    ids = _ids(17, 12)
    outs = [engine.generate(ids, max_new_tokens=20, segment_len=k)["tokens"]
            for k in (1, 4, 20)]
    assert outs[0] == outs[1] == outs[2]


def test_fused_cache_matches_sequential_decode(engine):
    """The fused loop's final ring cache == the same prefill followed by one
    decode_step per token, and its fill level advanced n_new - 1 steps."""
    ids = _ids(3, 9)
    n_new = 12
    logits_a, cache_a, plen = engine._run_prefill(ids)
    _, cache_b, _ = engine._run_prefill(ids)
    tok = int(logits_a[0].argmax())
    fused = FusedDecoder(engine.lm, engine.max_len, segment_len=5).decode(
        cache_a, tok, plen, n_new)
    seq_tok = tok
    for _ in range(n_new - 1):
        logits = engine.lm.decode_step(cache_b, torch.full((1, 1), seq_tok))
        seq_tok = int(logits[0].argmax())
    assert fused["cache"] is cache_a           # updated in place
    assert torch.equal(cache_a.k, cache_b.k) and torch.equal(cache_a.v,
                                                             cache_b.v)
    assert int(cache_a.t) == int(cache_b.t) == plen + n_new - 1


def test_decoding_past_the_ring_wraps(engines):
    """A decoder whose window is smaller than prompt + output keeps
    decoding on the wrapped ring, token for token with per-step decode."""
    _, eng = engines
    ids = _ids(19, 10)
    _, cache_a, plen = eng._run_prefill(ids)
    _, cache_b, _ = eng._run_prefill(ids)
    # a 16-slot ring holding the 10-token prompt, decoded 20 steps
    ring_a = eng.lm.init_cache(1, 16)
    ring_a.k.copy_(cache_a.k[:, :, :16])
    ring_a.v.copy_(cache_a.v[:, :, :16])
    ring_a.set_fill(plen)
    ring_b = eng.lm.init_cache(1, 16)
    ring_b.k.copy_(cache_b.k[:, :, :16])
    ring_b.v.copy_(cache_b.v[:, :, :16])
    ring_b.set_fill(plen)
    dec = FusedDecoder(eng.lm, max_len=64, segment_len=6)
    fused = dec.decode(ring_a, 7, plen, 21)
    tok, seq = 7, [7]
    for _ in range(20):
        tok = int(eng.lm.decode_step(ring_b, torch.full((1, 1), tok))[0]
                  .argmax())
        seq.append(tok)
    assert fused["tokens"] == seq
    assert int(ring_a.t) == plen + 20 > 16
    assert torch.equal(ring_a.k, ring_b.k)


# ----------------------------------------------------------------- bucketing
def test_geometric_buckets_cover_max_len():
    assert geometric_buckets(96) == (16, 32, 64, 96)
    assert geometric_buckets(512) == (16, 32, 64, 128, 256, 512)
    assert bucket_for(1, (16, 32)) == 16
    assert bucket_for(17, (16, 32)) == 32
    assert bucket_for(33, (16, 32)) == 33      # beyond last: exact


def test_bucketed_prefill_matches_exact(engine):
    """Right-padding to a bucket changes neither the last-position logits
    nor the fill level (causal attention keeps the pads dead)."""
    lm = engine.lm
    for plen in (3, 17, 30):
        ids = _ids(21 + plen, plen)
        exact_logits, exact = lm.prefill(torch.from_numpy(ids)[None],
                                         pad_to=engine.max_len)
        logits, cache, got_plen = engine._run_prefill(ids)
        assert got_plen == plen == int(cache.t)
        torch.testing.assert_close(logits, exact_logits, atol=1e-4,
                                   rtol=1e-4)
        assert int(logits.argmax()) == int(exact_logits.argmax())
        assert cache.k.shape == exact.k.shape


# -------------------------------------------------------------- cancellation
def test_mid_generation_cancellation(engine):
    """The cancel callback stops the fused loop at the next segment
    boundary with the tokens generated so far."""
    ids = _ids(23, 12)
    calls = {"n": 0}

    def cancel_after_two_segments():
        calls["n"] += 1
        return calls["n"] > 2

    out = engine.generate(ids, max_new_tokens=64,
                          cancel_cb=cancel_after_two_segments)
    assert out["cancelled"] and out["segments"] == 2
    assert len(out["tokens"]) == 1 + 2 * engine.segment_len
    out2 = engine.generate(ids, max_new_tokens=8)   # flag consumed
    assert not out2["cancelled"] and len(out2["tokens"]) == 8


def test_request_cancel_flag(engine):
    """A disconnect arriving mid-flight (request_cancel) is observed at the
    next segment boundary."""
    ids = _ids(29, 6)
    state = {"n": 0}

    def cb():
        state["n"] += 1
        if state["n"] == 1:
            engine.request_cancel()
        return False

    out = engine.generate(ids, max_new_tokens=64, cancel_cb=cb)
    assert out["cancelled"] and out["segments"] == 1
    assert len(out["tokens"]) == 1 + engine.segment_len


def test_on_segment_streams_every_token(engine):
    ids = _ids(31, 5)
    chunks = []
    out = engine.generate(ids, max_new_tokens=20, on_segment=chunks.append)
    assert [t for c in chunks for t in c] == out["tokens"]
    assert len(chunks[0]) == 1                 # the prefill token first
    assert engine.engine_stats()["served"] >= 1
