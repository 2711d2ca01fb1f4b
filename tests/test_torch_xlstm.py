"""The port's xLSTM blocks (``repro_torch.models.xlstm``) and xlstm-350m
through the serving engines, against the JAX package on the CPU.

* ``mlstm_chunked`` at S 1, 7, 256 (one full chunk) and 300 (a second,
  padded chunk) with its returned (C, n, m), from zero states and from a
  carried state; ``mlstm_step`` continuing a chunked prefill; the sLSTM
  block's prefill and its decode continuation (float32, 1e-4: the same
  arithmetic, with the einsums' sums over up to a 256-position chunk
  taken in another order);
* gradients through the chunked mLSTM and both blocks' parameters
  against ``jax.grad`` (1e-3, the bar of the whole-model gradients in
  tests/test_torch_arch.py: a sum of squares of the outputs has
  gradients up to ~30 here);
* reduced xlstm-350m through ``RealEngine`` (exact-length prefill, the
  engine's rule for a recurrent stack) and ``BatchedRealEngine``
  (back-fill included): greedy tokens equal the JAX engines';
* the block-paged engine and speculative decoding refuse the stack with
  the JAX engine's messages, before any weight is built;
* the train CLI trains reduced xlstm-350m on the CPU.

The JAX ``BatchedRealEngine`` cannot run xlstm as it stands: its sLSTM
``init_cache`` hands one zeros array to three state leaves, and the
lane insert donates its lane caches, so XLA refuses to donate one buffer
twice.  The comparison gives the JAX lane decoder caches with every leaf
copied (``jnp.copy``), which changes no value.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import xlstm as jx
from repro.serving.engine import BatchedRealEngine as JBatched
from repro.serving.engine import PagedBatchedEngine as JPaged
from repro.serving.engine import RealEngine as JReal
from repro_torch.configs import get_config
from repro_torch.models import xlstm as tx
from repro_torch.models.bridge import params_from_jax
from repro_torch.serving.engine import (BatchedRealEngine, PagedBatchedEngine,
                                        RealEngine)

NAME = "xlstm-350m"
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-3, rtol=1e-3)
B, H, HD = 2, 2, 8


def _qkvif(S, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return (f(B, S, H, HD) * 0.5, f(B, S, H, HD) * 0.5, f(B, S, H, HD),
            f(B, S, H), f(B, S, H) + 1.0)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("S", [1, 7, 256, 300])
def test_mlstm_chunked_matches_jax(S):
    args = _qkvif(S, S)
    out_j, st_j = jx.mlstm_chunked(*map(jnp.asarray, args))
    out_t, st_t = tx.mlstm_chunked(*map(torch.from_numpy, args))
    _close(out_t, out_j)
    for a, b in zip(st_t, st_j):
        _close(a, b)
    # and from the carried state, over a further 7 positions
    more = _qkvif(7, S + 1)
    out_j, st_j = jx.mlstm_chunked(*map(jnp.asarray, more), state=st_j)
    out_t, st_t = tx.mlstm_chunked(*map(torch.from_numpy, more), state=st_t)
    _close(out_t, out_j)
    for a, b in zip(st_t, st_j):
        _close(a, b)


def test_mlstm_step_continues_a_chunked_prefill():
    """Prefill 9 positions chunked, then 3 exact steps, each against JAX
    and against the chunked form over the whole 12 (the decode path must
    give what a longer prefill gives)."""
    args = _qkvif(12, 3)
    full, _ = tx.mlstm_chunked(*map(torch.from_numpy, args))
    _, st_j = jx.mlstm_chunked(*(jnp.asarray(a[:, :9]) for a in args))
    _, st_t = tx.mlstm_chunked(*(torch.from_numpy(a[:, :9]) for a in args))
    for s in range(9, 12):
        one = [a[:, s:s + 1] for a in args]
        o_j, st_j = jx.mlstm_step(*map(jnp.asarray, one), st_j)
        o_t, st_t = tx.mlstm_step(*map(torch.from_numpy, one), st_t)
        _close(o_t, o_j)
        _close(o_t[:, 0], full[:, s])
        for a, b in zip(st_t, st_j):
            _close(a, b)


@pytest.fixture(scope="module")
def blocks():
    """(JAX config, JAX sLSTM and mLSTM params as numpy, the port's
    blocks on them), reduced xlstm-350m in float32."""
    jcfg, cfg = jax_config(NAME).reduced(), get_config(NAME).reduced()
    keys = jax.random.split(jax.random.key(5), 2)
    jp = {"slstm": jax.tree.map(np.asarray,
                                jx.init_slstm(jcfg, keys[0])[0]),
          "mlstm": jax.tree.map(np.asarray,
                                jx.init_mlstm(jcfg, keys[1])[0])}
    gen = torch.Generator().manual_seed(0)
    tb = {"slstm": tx.SLSTMBlock(cfg, gen, "cpu"),
          "mlstm": tx.MLSTMBlock(cfg, gen, "cpu")}
    for kind, blk in tb.items():
        blk.load_state_dict({k: torch.from_numpy(np.array(v))
                             for k, v in jp[kind].items()})
    return jcfg, jp, tb


def _x(S, seed, d=64):
    return np.random.default_rng(seed).standard_normal((B, S, d),
                                                       dtype=np.float32)


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_block_prefill_then_decode_matches_jax(blocks, kind):
    """The block's prefill over 9 tokens (its states too), then 3 decode
    steps from the cached states, against ``slstm_block`` /
    ``mlstm_block``."""
    jcfg, jp, tb = blocks
    jfn = {"slstm": jx.slstm_block, "mlstm": jx.mlstm_block}[kind]
    names = {"slstm": ("c", "n", "h", "m"), "mlstm": ("C", "n", "m")}[kind]
    blk, x = tb[kind], _x(12, 9)
    y_j, c_j = jfn(jcfg, jp[kind], jnp.asarray(x[:, :9]), mode="prefill")
    with torch.no_grad():
        y_t, st = blk.mix(torch.from_numpy(x[:, :9]))
        y_t, _ = blk.channel_mix(y_t)
    _close(y_t, y_j)
    for n, s in zip(names, st):
        _close(s, c_j[n])
    for s in range(9, 12):
        y_j, c_j = jfn(jcfg, jp[kind], jnp.asarray(x[:, s:s + 1]),
                       mode="decode", cache=c_j)
        with torch.no_grad():
            y_t, st = blk.mix(torch.from_numpy(x[:, s:s + 1]), st)
            y_t, _ = blk.channel_mix(y_t)
        _close(y_t, y_j)
        for n, v in zip(names, st):
            _close(v, c_j[n])


@pytest.mark.parametrize("S", [7, 300])
def test_mlstm_chunked_gradients_match_jax(S):
    args = _qkvif(S, 40 + S)
    w = np.random.default_rng(S).standard_normal((B, S, H, HD),
                                                 dtype=np.float32)

    def jloss(*a):
        out, (C, n, m) = jx.mlstm_chunked(*a)
        return (out * w).sum() + C.sum() + n.sum()
    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out, (C, n, _) = tx.mlstm_chunked(*ts)
    ((out * torch.from_numpy(w)).sum() + C.sum() + n.sum()).backward()
    for t, g in zip(ts, want):
        _close(t.grad, g, **GRAD_TOL)


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_block_parameter_gradients_match_jax(blocks, kind):
    jcfg, jp, tb = blocks
    jfn = {"slstm": jx.slstm_block, "mlstm": jx.mlstm_block}[kind]
    x = _x(10, 11)
    want = jax.grad(lambda p: jnp.square(
        jfn(jcfg, p, jnp.asarray(x), mode="train")[0]).sum())(
            jax.tree.map(jnp.asarray, jp[kind]))
    blk = tb[kind]
    blk.requires_grad_(True)
    try:
        y, _ = blk(torch.from_numpy(x))
        y.square().sum().backward()
        for name, p in blk.named_parameters():
            _close(p.grad, want[name], **GRAD_TOL)
    finally:
        for p in blk.parameters():
            p.grad = None
        blk.requires_grad_(False)


# ------------------------------------------------------------------ engines
@pytest.fixture(scope="module")
def engines():
    """JAX serial and lane engines (max_len 64, segment 4, 3 lanes) and
    the port's on their weights."""
    jcfg, cfg = jax_config(NAME).reduced(), get_config(NAME).reduced()
    jser = JReal(jcfg, max_len=64, segment_len=4, seed=3)
    jlanes = JBatched(jcfg, params=jser.params, max_len=64, segment_len=4,
                      n_lanes=3)
    dec = jlanes._lane_decoder
    init = dec.init_lanes
    dec.init_lanes = lambda: jax.tree.map(jnp.copy, init())
    sd = params_from_jax(jax.tree.map(np.asarray, jser.params), cfg)
    ser = RealEngine(cfg, state_dict=sd, max_len=64, segment_len=4,
                     device="cpu")
    lanes = BatchedRealEngine(cfg, state_dict=sd, max_len=64,
                              segment_len=4, n_lanes=3, device="cpu")
    return jser, jlanes, ser, lanes


def _prompts(sizes, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in sizes]


def test_xlstm_prefills_at_exact_length_with_no_ring(engines):
    jser, _, ser, _ = engines
    assert not ser._bucketing and ser.buckets == () == jser.buckets
    for n in (1, 7, 23):
        _, cache, plen = ser._run_prefill(np.arange(n) % 500 + 1)
        assert plen == n and int(cache.t) == n
        assert cache.k.shape[0] == 0 and cache.mlstm_C is not None


def test_xlstm_serial_tokens_match_jax_engine(engines):
    jser, _, ser, _ = engines
    for ids, m in zip(_prompts((7, 13, 3), 5), (9, 12, 5)):
        want = jser.generate(ids, max_new_tokens=m)["tokens"]
        assert ser.generate(ids, max_new_tokens=m)["tokens"] == want
        assert ser.generate_reference(ids, m)["tokens"] == want


def test_xlstm_lane_tokens_with_backfill_match_jax_engine(engines):
    """Five requests through three lanes (two back-filled; two pairs of
    equal-length prompts share a prefill group): the JAX lane engine's
    tokens, which are also the serial engine's (no MoE here)."""
    jser, jlanes, ser, lanes = engines
    prompts = _prompts((7, 7, 12, 5, 12), 6)
    maxes = [10, 6, 8, 12, 5]
    want = [r["tokens"] for r in jlanes.generate_batch(prompts, maxes)]
    got = [r["tokens"] for r in lanes.generate_batch(prompts, maxes)]
    assert got == want
    assert got == [ser.generate(p, max_new_tokens=m)["tokens"]
                   for p, m in zip(prompts, maxes)]
    assert lanes.lane_manager.stats["backfills"] == \
        jlanes.lane_manager.stats["backfills"] > 0


def test_xlstm_paged_and_speculative_refuse_with_jax_messages(engines):
    jser, _, ser, _ = engines
    cfg, jcfg = ser.cfg, jser.cfg
    draft, jdraft = (get_config("smollm-360m").reduced(),
                     jax_config("smollm-360m").reduced())
    for port_build, jax_build in (
            (lambda: PagedBatchedEngine(cfg, max_len=64, device="cpu"),
             lambda: JPaged(jcfg, params=jser.params, max_len=64)),
            (lambda: RealEngine(cfg, draft_cfg=draft, draft_k=2,
                                device="cpu"),
             lambda: JReal(jcfg, params=jser.params, draft_cfg=jdraft,
                           draft_k=2))):
        with pytest.raises(ValueError) as mine:
            port_build()
        with pytest.raises(ValueError) as theirs:
            jax_build()
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="pure-attention"):
        ser.lm.init_paged_cache(2, 64, 9, 16)
    with pytest.raises(ValueError, match="pure-attention"):
        ser.lm.verify_step(ser.lm.init_cache(1, 64),
                           torch.zeros((1, 3), dtype=torch.long))
    with pytest.raises(ValueError, match="extend prefill"):
        ser.lm.prefill(torch.ones((1, 3), dtype=torch.long),
                       cache=ser.lm.init_cache(1, 64))


def test_train_cli_trains_reduced_xlstm():
    """``launch.train --arch xlstm-350m --reduced`` on the CPU, as the
    JAX CLI takes it: 12 steps, finite losses, the last below the
    first."""
    from repro_torch.launch import train
    losses = train.main(["--arch", NAME, "--reduced", "--steps", "12",
                         "--batch", "4", "--seq", "32", "--lr", "1e-2",
                         "--device", "cpu"])
    assert len(losses) == 12 and all(map(np.isfinite, losses))
    assert losses[-1] < losses[0] - 0.1, (losses[0], losses[-1])
