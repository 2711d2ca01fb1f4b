"""Cross-attention over image tokens (llama-3.2-vision-90b) and the audio
frontend (musicgen-large) in the port, against the JAX package on the
CPU, float32.

* ``CrossAttention`` prefill (K3's plain version, non-causal, Sq prompt
  rows over Skv image rows) and decode (K1's plain version at fill level
  T_img - 1 over the image cache) against ``xattn_block`` in its prefill
  and decode modes, with and without QK-norm (1e-5);
* the plain non-causal attention at Sq != Skv against the JAX
  ``flash_attention(causal=False)`` (1e-5);
* a reduced vision stack of two pattern repeats (10 layers, two
  cross-attention layers, so the image cache has two slots): logits,
  prefill and teacher-forced decode against the JAX LM (1e-4), the image
  K/V of each slot equal to JAX's cache;
* reduced musicgen on frame embeddings: prefill then teacher-forced
  decode against the JAX LM (1e-4); it has no embedding table and
  refuses tokens;
* ``frontends``: input specs and batch shapes equal JAX's;
* the train CLI refuses both multimodal archs with the JAX CLI's message.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import frontends as jfront
from repro.models.model import LM as JLM
from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.models import frontends
from repro_torch.models.attention import CrossAttention
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.model import LM

VISION, MUSIC = "llama-3.2-vision-90b", "musicgen-large"
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _f32(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("Skv", [16, 40])
@pytest.mark.parametrize("Sq", [1, 7, 16])
def test_plain_noncausal_attention_matches_jax(Sq, Skv):
    """GQA 4 query heads over 2 KV heads, hd 16."""
    rng = np.random.default_rng(Sq * 100 + Skv)
    q, k, v = _f32(rng, 2, Sq, 4, 16), _f32(rng, 2, Skv, 2, 16), \
        _f32(rng, 2, Skv, 2, 16)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                causal=False)
    _close(got, want)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attention_prefill_and_decode_match_xattn_block(qk_norm):
    """Prefill 7 text rows over 16 image rows (the image K/V land in the
    cache), then 3 decode steps that reuse the cache."""
    jcfg = dataclasses.replace(jax_config(VISION).reduced(), qk_norm=qk_norm)
    cfg = dataclasses.replace(get_config(VISION).reduced(), qk_norm=qk_norm)
    jp = jax.tree.map(np.asarray, jattn.init_attention(
        jcfg, jax.random.key(2), cross=True)[0])
    if qk_norm:     # non-trivial norm weights
        jp["q_norm"] = jp["q_norm"] * 1.5
        jp["k_norm"] = jp["k_norm"] * 0.5
    blk = CrossAttention(cfg, torch.Generator().manual_seed(0), "cpu")
    blk.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in jp.items()})
    rng = np.random.default_rng(1)
    T, KV, hd = cfg.num_image_tokens, cfg.num_kv_heads, cfg.head_dim
    img, x = _f32(rng, 2, T, cfg.d_model), _f32(rng, 2, 10, cfg.d_model)
    y_j, c_j = jattn.xattn_block(jcfg, jp, jnp.asarray(x[:, :7]),
                                 mode="prefill",
                                 image_embeds=jnp.asarray(img))
    ck, cv = torch.zeros(2, T, KV, hd), torch.zeros(2, T, KV, hd)
    with torch.no_grad():
        y_t = blk.prefill(torch.from_numpy(x[:, :7]), torch.from_numpy(img),
                          ck, cv)
    _close(y_t, y_j)
    _close(ck, c_j["k"])
    _close(cv, c_j["v"])
    for s in range(7, 10):
        y_j, c_j = jattn.xattn_block(jcfg, jp, jnp.asarray(x[:, s:s + 1]),
                                     mode="decode", cache=c_j)
        with torch.no_grad():
            y_t = blk.decode(torch.from_numpy(x[:, s:s + 1]), ck, cv)
        _close(y_t, y_j)


def _pair(name, repeats=1, seed=7):
    jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
    n = repeats * len(cfg.block_pattern)
    jcfg = dataclasses.replace(jcfg, num_layers=n)
    cfg = dataclasses.replace(cfg, num_layers=n)
    jlm = JLM(jcfg)
    params = jax.tree.map(np.asarray, jlm.init(jax.random.key(seed)))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(params, cfg))
    return jlm, params, lm


def _teacher_forced(jlm, params, lm, batch, key, S=16):
    """Prefill half the sequence (padded to S), then three teacher-forced
    decode steps: each against the JAX LM (1e-4) and the port's own
    training forward (2e-2).  Returns the caches (port, JAX)."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    seq = batch[key]
    prompt = dict(batch, **{key: seq[:, :S // 2]})
    with torch.no_grad():
        full = lm(remat=False, **tb)
        got, cache = lm.prefill(pad_to=S, **{k: torch.from_numpy(v)
                                             for k, v in prompt.items()})
    want, jc = jlm.prefill(params, jax.tree.map(jnp.asarray, prompt),
                           pad_to=S)
    want_full, _ = jlm.forward(params, jax.tree.map(jnp.asarray, batch),
                               remat=False)
    _close(full, want_full, **LOGIT_TOL)
    _close(got, want, **LOGIT_TOL)
    _close(got, full[:, S // 2 - 1], atol=2e-2)
    for t in range(S // 2, S // 2 + 3):
        step = {key: seq[:, t:t + 1]}
        want, jc = jlm.decode_step(params, jc, jax.tree.map(jnp.asarray,
                                                            step))
        got = lm.decode_step(cache, **{key: torch.from_numpy(v)
                                       for k, v in step.items()})
        _close(got, want, **LOGIT_TOL)
        _close(got, full[:, t], atol=2e-2)
    assert int(cache.t) == S // 2 + 3
    return cache, jc


def test_vision_two_repeats_match_jax():
    """10 layers (8 self-attention, 2 cross-attention): the ring holds 8
    layers, the image cache 2, each cross-attention layer's slot equal
    to JAX's image K/V of that repeat."""
    jlm, params, lm = _pair(VISION, repeats=2)
    assert lm.n_attn == 8 and lm.n_layers["xattn"] == 2
    rng = np.random.default_rng(3)
    cfg = lm.cfg
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)),
             "image_embeds": _f32(rng, 2, cfg.num_image_tokens,
                                  cfg.d_model)}
    cache, jc = _teacher_forced(jlm, params, lm, batch, "tokens")
    assert cache.xk.shape == (2, 2, cfg.num_image_tokens, cfg.num_kv_heads,
                              cfg.head_dim)
    pos = cfg.block_pattern.index("xattn")
    for r in range(2):
        _close(cache.xk[r], jc[pos]["k"][r])
        _close(cache.xv[r], jc[pos]["v"][r])
    with pytest.raises(ValueError, match="image_embeds"):
        lm.prefill(torch.from_numpy(batch["tokens"]))
    with pytest.raises(ValueError, match="extend prefill"):
        lm.prefill(torch.from_numpy(batch["tokens"][:, :2]), cache=cache,
                   image_embeds=torch.from_numpy(batch["image_embeds"]))


def test_musicgen_frames_match_jax():
    jlm, params, lm = _pair(MUSIC)
    assert not hasattr(lm, "embed") and "embed" not in params
    cfg = lm.cfg
    frames = _f32(np.random.default_rng(4), 2, 16, cfg.d_model)
    _teacher_forced(jlm, params, lm, {"frames": frames}, "frames")
    with pytest.raises(ValueError, match="frame embeddings"):
        lm.prefill(torch.zeros((1, 4), dtype=torch.long))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("name", [VISION, MUSIC, "xlstm-350m"])
def test_frontend_specs_match_jax(name, shape):
    cfg, jcfg = get_config(name), jax_config(name)
    mine = frontends.input_specs(cfg, SHAPES[shape])
    theirs = jfront.input_specs(jcfg, J_SHAPES[shape])
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in theirs.items()}
    assert frontends.batch_axes(cfg, SHAPES[shape]) == \
        jfront.batch_axes(jcfg, J_SHAPES[shape])
    small = cfg.reduced()
    batch = frontends.make_batch(small, SHAPES[shape],
                                 torch.Generator().manual_seed(0),
                                 batch_size=2, seq_len=8)
    want = jfront.make_batch(jcfg.reduced(), J_SHAPES[shape],
                             batch_size=2, seq_len=8)
    assert {k: tuple(v.shape) for k, v in batch.items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("name", [VISION, MUSIC])
def test_train_cli_refuses_multimodal_archs(name, monkeypatch):
    """The JAX CLI's refusal, before any weight is built."""
    from repro_torch.launch import train

    def no_weights(*a, **kw):
        raise AssertionError("weights built before the refusal")
    monkeypatch.setattr(train, "init_train_state", no_weights)
    for argv in (["--arch", name], ["--arch", name, "--reduced"]):
        with pytest.raises(SystemExit, match="drives text archs"):
            train.main(argv + ["--device", "cpu"])
