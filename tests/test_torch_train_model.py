"""The port's training forward, loss and gradients against the JAX
package's, on the same weights, and K3b's plain version against the JAX
flash attention's VJP and against autograd.

Float32 on the CPU in both packages, on ``reduced()`` (1 layer, H = KV =
4) and a 3-layer G = 2 variant.  Tolerances: logits atol 1e-5 (one
forward, sums in another order); loss rtol 1e-5; every parameter's
gradient atol 1e-5, rtol 1e-4 (the backward sums over batch and sequence
in another order); the attention backward atol 1e-5.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.attention import flash_attention as jax_flash
from repro.models.model import LM as JLM
from repro_torch.configs import get_config as port_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_plain
from repro_torch.models.bridge import params_from_jax, params_to_jax
from repro_torch.models.layers import matmul_f32
from repro_torch.models.model import LM

VARIANTS = {"reduced": {}, "3L-G2": {"num_layers": 3, "num_kv_heads": 2}}
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def pair(request):
    """(JAX LM, JAX params as numpy, port LM) sharing one set of weights."""
    over = VARIANTS[request.param]
    jcfg = dataclasses.replace(get_config("smollm-360m").reduced(), **over)
    tcfg = dataclasses.replace(port_config("smollm-360m").reduced(), **over)
    jlm = JLM(jcfg)
    params = jax.tree.map(np.asarray, jlm.init(jax.random.key(5)))
    lm = LM(tcfg, device="cpu")
    lm.load_state_dict(params_from_jax(params, tcfg))
    lm.requires_grad_(True)
    return jlm, params, lm


def _batch(vocab, B, S, seed, n_masked=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    if n_masked:
        labels[rng.integers(0, B, n_masked), rng.integers(0, S, n_masked)] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _torch_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [True, False])
def test_forward_logits_match_jax(pair, remat):
    jlm, params, lm = pair
    batch = _batch(512, 2, 24, 0)
    want, _ = jax.jit(lambda p, b: jlm.forward(p, b, remat=remat))(
        params, {"tokens": jnp.asarray(batch["tokens"])})
    got = lm(_torch_batch(batch)["tokens"], remat=remat)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 512)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("B,S,n_masked", [(2, 24, 0), (2, 24, 7),
                                          (1, 600, 0), (3, 530, 40)])
def test_loss_matches_jax(pair, B, S, n_masked):
    """Sequence lengths below, above and not a multiple of the 512-token
    loss chunk, with and without masked (-1) labels."""
    jlm, params, lm = pair
    batch = _batch(512, B, S, S + n_masked, n_masked)
    want = jax.jit(lambda p, b: jlm.loss(p, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = lm.loss(_torch_batch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("remat", [True, False])
def test_every_gradient_matches_jax_grad(pair, remat):
    jlm, params, lm = pair
    batch = _batch(512, 2, 40, 11, n_masked=5)
    want = jax.jit(jax.grad(lambda p, b: jlm.loss(p, b, remat=remat)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    for p in lm.parameters():
        p.grad = None
    lm.loss(_torch_batch(batch), remat=remat).backward()
    got = params_to_jax({n: p.grad for n, p in lm.named_parameters()},
                        lm.cfg)
    paths_w = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves_g = jax.tree.leaves(got)
    assert len(paths_w) == len(leaves_g)
    for (path, w), g in zip(paths_w, leaves_g):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_params_to_jax_inverts_params_from_jax(pair):
    _, params, lm = pair
    back = params_to_jax(lm.state_dict(), lm.cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_serving_parameters_stay_frozen():
    """A freshly built LM serves without gradients: every parameter is
    created with requires_grad False."""
    lm = LM(port_config("smollm-360m").reduced(), device="cpu")
    assert not any(p.requires_grad for p in lm.parameters())


def _attn_inputs(B, S, H, KV, hd, seed, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, do


def _vjp_pair(inputs, causal, round_dtype=None):
    """(``jax.vjp`` of the JAX flash attention (chunked, nested remat),
    K3b's plain version fed the plain forward's o and lse) on one set of
    inputs."""
    q, k, v, do = inputs
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal=causal,
                                               q_chunk=32, kv_chunk=64),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, causal=causal,
                                   return_lse=True)
    got = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, causal=causal,
                                    round_dtype=round_dtype)
    exact = flash_attention_bwd_plain(tq, tk, tv, o, tdo, lse, causal=causal)
    return [np.asarray(w) for w in want], got, exact


def _check_vjp(inputs, causal):
    want, got, _ = _vjp_pair(inputs, causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=0)


def _check_rounded_vjp(inputs, causal):
    want, got, exact = _vjp_pair(inputs, causal, torch.bfloat16)
    for g, w, x in zip(got, want, exact):
        np.testing.assert_allclose(g.numpy(), w,
                                   atol=2e-2 * np.abs(w).max(), rtol=0)
        assert not torch.equal(g, x)


CAUSAL_SHAPES = [(2, 37, 4, 2, 16), (1, 130, 6, 2, 32), (2, 64, 3, 3, 64),
                 (1, 70, 4, 2, 256)]
#: cross-attention's backward: full attention, Sq query rows over Skv
#: keys, G 1 and 4, head widths 32 and 256
CROSS_SHAPES = [(Sq, Skv, G, hd) for Sq, Skv in ((7, 16), (16, 40), (37, 130))
                for G in (1, 4) for hd in (32, 256)]


@pytest.mark.parametrize("B,S,H,KV,hd", CAUSAL_SHAPES)
def test_bwd_plain_matches_jax_vjp(B, S, H, KV, hd):
    """K3b's plain version (fed the plain forward's o and lse) against
    ``jax.vjp`` of the JAX flash attention (chunked, nested remat)."""
    _check_vjp(_attn_inputs(B, S, H, KV, hd, S), causal=True)


@pytest.mark.parametrize("Sq,Skv,G,hd", CROSS_SHAPES)
def test_bwd_plain_matches_jax_vjp_at_cross_lengths(Sq, Skv, G, hd):
    """As ``test_bwd_plain_matches_jax_vjp``, for the cross-attention
    layer's full attention at Sq != Skv (B 2, KV 2)."""
    _check_vjp(_attn_inputs(2, Sq, 2 * G, 2, hd, Sq * Skv, Skv=Skv),
               causal=False)


@pytest.mark.parametrize("B,S,H,KV,hd", CAUSAL_SHAPES)
def test_bwd_plain_rounded_matches_jax_vjp(B, S, H, KV, hd):
    """K3b's plain version rounding P and dS to bf16 where the bf16 kernel
    does (``round_dtype``) against ``jax.vjp`` of the JAX flash attention
    in f32, on ``test_bwd_plain_matches_jax_vjp``'s inputs: the rounding
    the kernel adds fits inside the bf16 bar, 2e-2 of max|JAX|; and it
    does round (the result differs from the f32 plain version's)."""
    _check_rounded_vjp(_attn_inputs(B, S, H, KV, hd, S), causal=True)


@pytest.mark.parametrize("Sq,Skv,G,hd", CROSS_SHAPES)
def test_bwd_plain_rounded_matches_jax_vjp_at_cross_lengths(Sq, Skv, G, hd):
    """As ``test_bwd_plain_rounded_matches_jax_vjp``, on
    ``test_bwd_plain_matches_jax_vjp_at_cross_lengths``'s inputs."""
    _check_rounded_vjp(_attn_inputs(2, Sq, 2 * G, 2, hd, Sq * Skv, Skv=Skv),
                       causal=False)


def test_bwd_plain_refuses_causal_at_cross_lengths():
    """Causal training attention has one length (query row i at key
    position i): the plain version refuses Sq != Skv when causal, with
    the message K3b's launcher and ``ops.flash_attention_train``'s card
    path give."""
    q, k, v, do = map(torch.from_numpy,
                      _attn_inputs(1, 8, 2, 2, 16, 0, Skv=12))
    o, lse = flash_attention_plain(q, k, v, causal=False, return_lse=True)
    with pytest.raises(ValueError, match="causal training attention needs "
                                         "Sq == Skv"):
        flash_attention_bwd_plain(q, k, v, o, do, lse, causal=True)


def test_bwd_cuda_refuses_cpu_tensors():
    """K3b's launcher never falls back to its plain version: CPU tensors
    are refused before any build or launch."""
    from repro_torch.kernels.flash_attention_bwd import \
        flash_attention_bwd_cuda
    q, k, v, do = map(torch.from_numpy, _attn_inputs(1, 16, 4, 2, 16, 0))
    o, lse = flash_attention_plain(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, k, v, o, do, lse)


@pytest.mark.parametrize("causal", [True, False])
def test_bwd_plain_matches_autograd_of_plain_forward(causal):
    """K3b's plain version against autograd of ``flash_attention_plain``,
    which is what ``ops.flash_attention_train`` runs on the CPU."""
    q, k, v, do = _attn_inputs(2, 45, 6, 3, 16, 1)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention_train(*leaves, causal=causal)
    out.backward(torch.from_numpy(do))
    o, lse = flash_attention_plain(*(x.detach() for x in leaves),
                                   causal=causal, return_lse=True)
    got = flash_attention_bwd_plain(*(x.detach() for x in leaves), o,
                                    torch.from_numpy(do), lse, causal=causal)
    for g, leaf in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=1e-5,
                                   rtol=0)


def test_plain_lse_is_logsumexp_of_scaled_masked_scores():
    q, k, v, _ = _attn_inputs(1, 20, 4, 2, 16, 2)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    _, lse = flash_attention_plain(tq, tk, tv, return_lse=True)
    s = np.einsum("qkgh,skh->kgqs", q[0].reshape(20, 2, 2, 16), k[0]) / 4.0
    s = np.where(np.tril(np.ones((20, 20), bool)), s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse[0].numpy(), want.reshape(4, 20),
                               atol=1e-5, rtol=0)


def test_matmul_f32_of_bf16_operands():
    """The bf16 head product: float32 logits equal to the float32 product
    of the bf16 values (no rounding to bf16 on the way), and gradients in
    bf16 within bf16 rounding (2^-8 relative) of float32 autograd's."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 32, generator=g).to(torch.bfloat16)
    w = torch.randn(32, 48, generator=g).to(torch.bfloat16)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = matmul_f32(xl, wl)
    assert out.dtype == torch.float32
    want = x.float() @ w.float()
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-6)
    ct = torch.randn(2, 5, 48, generator=g)
    out.backward(ct)
    xf, wf = x.float().requires_grad_(), w.float().requires_grad_()
    (xf @ wf).backward(ct)
    for got, ref in ((xl.grad, xf.grad), (wl.grad, wf.grad)):
        assert got.dtype == torch.bfloat16
        scale = float(ref.abs().max())
        np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                                   atol=2 ** -7 * scale, rtol=0)
