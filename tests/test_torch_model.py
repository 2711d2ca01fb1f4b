"""The port's LM against the JAX package's, on the same weights
(``bridge.params_from_jax``): bucketed prefill logits, decode-step logits
and the KV caches after both.

Float32 on the CPU in both packages.  Tolerance: atol/rtol 1e-4 on logits
(tests/test_generate.py's bucketed-vs-exact bar; sums run in another
order in each framework) and 1e-5 on cached K/V, which are one projection
and one rotation away from the embeddings.

``reduced()`` is one layer with H = KV = 4, so the 3-layer G = 2 variant
is held too: it exercises the per-layer unstacking and grouped heads.
gemma3-4b-edge's reduced config (GeGLU, RoPE theta 1e6) and a copy of it
with head width 256 (the full config's) are held at 1e-5 on logits; its
GeGLU MLP alone at 1e-6 against ``apply_mlp``.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.layers import apply_mlp
from repro.models.model import LM as JLM
from repro_torch.configs import get_config as port_config
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.layers import MLP
from repro_torch.models.model import LM

MAX_LEN = 64
KV_TOL = dict(atol=1e-5, rtol=1e-5)
VARIANTS = {"reduced": ("smollm-360m", {}),
            "3L-G2": ("smollm-360m", {"num_layers": 3, "num_kv_heads": 2}),
            "gemma3": ("gemma3-4b-edge", {}),
            "gemma3-hd256": ("gemma3-4b-edge", {"head_dim": 256})}


def _logit_tol(lm):
    """1e-4 for the smollm variants (tests/test_generate.py's bar), 1e-5
    for gemma3-4b-edge's."""
    tol = 1e-5 if lm.cfg.name.startswith("gemma3") else 1e-4
    return dict(atol=tol, rtol=tol)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    """(JAX LM, JAX params, port LM, jitted JAX prefill and decode step)
    sharing one set of weights."""
    arch, over = VARIANTS[request.param]
    jcfg = dataclasses.replace(get_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(port_config(arch).reduced(), **over)
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.key(3))
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       tcfg))
    prefill = jax.jit(lambda p, t, n: jlm.prefill(
        p, {"tokens": t}, pad_to=MAX_LEN, prompt_len=n))
    return jlm, params, lm, prefill, jax.jit(jlm.decode_step)


def _prefill_both(pair, ids, bucket):
    _, params, lm, prefill, _ = pair
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :len(ids)] = ids
    jl, jc = prefill(params, jnp.asarray(toks),
                     jnp.asarray(len(ids), jnp.int32))
    tl, tc = lm.prefill(torch.from_numpy(toks.astype(np.int64)),
                        pad_to=MAX_LEN, prompt_len=len(ids))
    return (jl, jc), (tl, tc)


def _assert_caches_close(jc, tc):
    cfg_layers = tc.k.shape[0]
    jk = np.asarray(jc[0]["k"])             # (layers, B, S, KV, hd)
    jv = np.asarray(jc[0]["v"])
    assert jk.shape == tuple(tc.k.shape) and jk.shape[0] == cfg_layers
    np.testing.assert_allclose(tc.k.numpy(), jk, **KV_TOL)
    np.testing.assert_allclose(tc.v.numpy(), jv, **KV_TOL)
    assert np.all(np.asarray(jc[0]["t"]) == int(tc.t))


@pytest.mark.parametrize("plen,bucket", [(1, 16), (5, 16), (16, 16),
                                         (17, 32), (30, 32)])
def test_bucketed_prefill_matches_jax(pair, plen, bucket):
    ids = np.random.default_rng(plen).integers(0, 512, plen)
    (jl, jc), (tl, tc) = _prefill_both(pair, ids, bucket)
    assert tl.shape == (1, 512) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               **_logit_tol(pair[2]))
    assert int(tl.argmax()) == int(jnp.argmax(jl))
    _assert_caches_close(jc, tc)
    assert int(tc.t) == plen


def test_decode_steps_match_jax(pair):
    """Prefill then five decode steps fed the same tokens: logits and the
    whole ring cache (including the fill level) agree after each step."""
    _, params, lm, _, step = pair
    ids = np.random.default_rng(7).integers(0, 512, 11)
    (jl, jc), (tl, tc) = _prefill_both(pair, ids, 16)
    for tok in np.random.default_rng(8).integers(0, 512, 5):
        jl, jc = step(params, jc, {"tokens": jnp.full((1, 1), tok,
                                                      jnp.int32)})
        tl = lm.decode_step(tc, torch.full((1, 1), int(tok)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               **_logit_tol(pair[2]))
        _assert_caches_close(jc, tc)


def test_ring_buffer_wraps_onto_oldest_slots():
    """Past capacity S, step t lands at slot t % S and the ring holds the
    K/V of the S most recent tokens (checked against a larger cache), the
    same as the JAX ring after the same steps."""
    cfg = port_config("smollm-360m").reduced()
    lm = LM(cfg, device="cpu", seed=0)
    S, T = 8, 13
    ring, big = lm.init_cache(1, S), lm.init_cache(1, 32)
    for tok in np.random.default_rng(5).integers(0, cfg.vocab_size, T):
        step = torch.full((1, 1), int(tok))
        lm.decode_step(ring, step)
        lm.decode_step(big, step)
    assert int(ring.t) == T
    for s in range(S):
        p = s + S if s + S < T else s        # latest write to this slot
        assert torch.equal(ring.k[0, 0, s], big.k[0, 0, p]), (s, p)
        assert torch.equal(ring.v[0, 0, s], big.v[0, 0, p]), (s, p)


def test_ring_wrap_matches_jax(pair):
    """The wrapped ring and the decode logits past capacity agree with the
    JAX package's ring of the same size."""
    jlm, params, lm, _, step = pair
    S = 8
    jc = jlm.init_cache(1, S)
    tc = lm.init_cache(1, S)
    for tok in np.random.default_rng(9).integers(0, 512, 13):
        jl, jc = step(params, jc, {"tokens": jnp.full((1, 1), tok,
                                                      jnp.int32)})
        tl = lm.decode_step(tc, torch.full((1, 1), int(tok)))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               **_logit_tol(pair[2]))
    _assert_caches_close(jc, tc)


def test_geglu_mlp_matches_jax():
    """The GeGLU MLP (``jax.nn.gelu``'s tanh form) with its residual, on
    the JAX init's weights, within 1e-6 of ``apply_mlp``."""
    import jax
    from repro.models.layers import init_mlp
    jcfg = get_config("gemma3-4b-edge").reduced()
    tcfg = port_config("gemma3-4b-edge").reduced()
    p, _ = init_mlp(jcfg, jax.random.key(1))
    mlp = MLP(tcfg, torch.Generator().manual_seed(0), "cpu")
    mlp.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in p.items()})
    x = np.random.default_rng(3).normal(
        size=(2, 5, tcfg.d_model)).astype(np.float32)
    want = apply_mlp(jcfg, p, jnp.asarray(x))
    got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


def test_seeded_init_is_reproducible_and_scaled():
    """The port's own init: one seed gives one set of weights, and the
    scales are the JAX init's (N(0, 1) * fan_in ** -0.5)."""
    cfg = port_config("smollm-360m").reduced()
    a, b = LM(cfg, device="cpu", seed=4), LM(cfg, device="cpu", seed=4)
    c = LM(cfg, device="cpu", seed=5)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["embed"], sc["embed"])
    wq = sa["blocks.0.attn.wq"]
    assert wq.shape == (cfg.d_model, cfg.attn_dim)
    scale = cfg.d_model ** -0.5
    assert abs(float(wq.std()) - scale) < 0.1 * scale


def test_no_card_and_no_device_raises(monkeypatch):
    """Entry points default to the card and never drift onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(port_config("smollm-360m").reduced())
