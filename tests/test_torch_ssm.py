"""The port's Mamba block against ``repro.models.ssm`` (``mamba_mix`` and
``mamba_block``), on the same weights and inputs, float32.

At S in {1, 7, 128, 200} (one chunk, a short chunk, exactly one full
chunk, and two chunks whose last is zero-padded): y, the conv state and
the SSM state within 1e-5 (the in-chunk scan is a Hillis-Steele loop in
the port and ``lax.associative_scan`` in JAX: the same products in
another association, so the last bits differ).  At S = 200 the JAX
state after the pad steps is (numerically) zero, where a token-by-token
recurrence is not: the port reproduces the reference's zero (exactly
0.0 with ``init_mamba``'s own parameters, below 1e-30 with a random dt
bias).  A decode
step continued from the prefill's states equals JAX's, and equals the
prefill of the longer sequence's last position where no pad intervenes.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config
from repro_torch.models.ssm import CHUNK, Mamba

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_config("jamba-v0.1-52b").reduced()
    cfg = get_config("jamba-v0.1-52b").reduced()
    p, _ = jssm.init_mamba(jcfg, jax.random.key(3))
    # a non-zero dt bias and D so every term of the recurrence matters
    rng = np.random.default_rng(1)
    p = dict(jax.tree.map(np.array, p))
    p["dt_bias"] = rng.standard_normal(p["dt_bias"].shape).astype(np.float32)
    p["D"] = rng.standard_normal(p["D"].shape).astype(np.float32)
    m = Mamba(cfg, torch.Generator().manual_seed(0), "cpu")
    m.load_state_dict({k: torch.from_numpy(np.asarray(v))
                       for k, v in p.items()})
    return jcfg, jax.tree.map(jnp.asarray, p), m


def _x(S, seed, d=64, B=2):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


def _recurrence(p, x):
    """Token-by-token reference: the SSM state after S real steps."""
    xz = np.asarray(x) @ np.asarray(p["in_proj"])
    di = xz.shape[-1] // 2
    xr = xz[..., :di]
    w = np.asarray(p["conv_w"])
    B, S, _ = xr.shape
    xp = np.concatenate([np.zeros((B, w.shape[0] - 1, di), np.float32), xr], 1)
    xc = sum(xp[:, i:i + S] * w[i] for i in range(w.shape[0]))
    xc = xc / (1 + np.exp(-xc))
    bcd = xc @ np.asarray(p["x_proj"])
    n = (bcd.shape[-1] - 1) // 2
    A = -np.exp(np.asarray(p["A_log"]))
    h = np.zeros((B, di, n), np.float64)
    for t in range(S):
        dt = np.logaddexp(bcd[:, t, -1:], 0)[:, :, None] \
            + np.logaddexp(np.asarray(p["dt_bias"]), 0)[None, :, None]
        h = np.exp(dt * A) * h + dt * bcd[:, t, None, :n] * xc[:, t, :, None]
    return h


@pytest.mark.parametrize("S", [1, 7, 128, 200])
def test_mix_matches_jax(pair, S):
    jcfg, p, m = pair
    x = _x(S, S)
    y, (conv, ssm) = jssm.mamba_mix(p, jnp.asarray(x))
    with torch.no_grad():
        ty, (tconv, tssm) = m.mix(torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(tconv.numpy(), np.asarray(conv), **TOL)
    np.testing.assert_allclose(tssm.numpy(), np.asarray(ssm), **TOL)
    if S > CHUNK and S % CHUNK:
        # the reference's padded last chunk decays the state to ~zero
        assert float(np.abs(np.asarray(ssm)).max()) < 1e-30
        assert float(tssm.abs().max()) < 1e-30
        assert np.abs(_recurrence(p, x)).max() > 1.0
    else:
        np.testing.assert_allclose(tssm.numpy(), _recurrence(p, x),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S", [100, 128, 200])
def test_reference_init_state_is_zero_after_a_padded_chunk(S):
    """With ``init_mamba``'s own parameters (dt bias 0): after a prefill
    of S = 200 (56 pad steps) both packages' SSM state is exactly 0.0,
    while a token-by-token recurrence holds max|h| > 1; at S = 100 and
    128 (no pad step) the states equal the recurrence's."""
    jcfg = jax_config("jamba-v0.1-52b").reduced()
    p, _ = jssm.init_mamba(jcfg, jax.random.key(0))
    m = Mamba(get_config("jamba-v0.1-52b").reduced(),
              torch.Generator().manual_seed(0), "cpu")
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in p.items()})
    x = _x(S, 0)
    _, (_, ssm) = jssm.mamba_mix(p, jnp.asarray(x))
    with torch.no_grad():
        _, (_, tssm) = m.mix(torch.from_numpy(x))
    tok = _recurrence(p, x)
    if S > CHUNK and S % CHUNK:                  # a padded last chunk
        assert np.abs(tok).max() > 1.0
        assert float(np.abs(np.asarray(ssm)).max()) == 0.0
        assert float(tssm.abs().max()) == 0.0
    else:
        np.testing.assert_allclose(tssm.numpy(), tok, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tssm.numpy(), np.asarray(ssm), **TOL)


@pytest.mark.parametrize("S", [1, 7, 128, 200])
def test_block_and_decode_continuation_match_jax(pair, S):
    """``mamba_block`` in prefill mode, then two decode steps from its
    cache, each within 1e-5 of JAX's."""
    jcfg, p, m = pair
    x = _x(S + 2, 100 + S)
    y, cache = jssm.mamba_block(jcfg, p, jnp.asarray(x[:, :S]),
                                mode="prefill")
    with torch.no_grad():
        ty, (conv, ssm) = m(torch.from_numpy(x[:, :S]))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    for t in (S, S + 1):
        y, cache = jssm.mamba_block(jcfg, p, jnp.asarray(x[:, t:t + 1]),
                                    mode="decode", cache=cache)
        with torch.no_grad():
            ty, (conv, ssm) = m(torch.from_numpy(x[:, t:t + 1]), conv, ssm)
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
        np.testing.assert_allclose(ssm.numpy(), np.asarray(cache["ssm"]),
                                   **TOL)
        np.testing.assert_allclose(conv.numpy(), np.asarray(cache["conv"]),
                                   **TOL)


def test_decode_equals_prefill_without_pads(pair):
    """Prefill of 7, then decode of the 8th, equals the prefill of all 8
    at its last position (no pad step inside one chunk of < 128)."""
    _, _, m = pair
    x = torch.from_numpy(_x(8, 5))
    with torch.no_grad():
        full, _ = m(x)
        _, (conv, ssm) = m(x[:, :7])
        step, _ = m(x[:, 7:8], conv, ssm)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, 7].numpy(),
                               atol=1e-5, rtol=1e-5)


def test_gradients_match_jax(pair):
    """d(sum(y * w)) of the block by its parameters and input over two
    chunks (S 200, the padded last one included), within 1e-4."""
    jcfg, p, m = pair
    x = _x(200, 7)
    wt = _x(200, 8)

    def f(params, xx):
        y, _ = jssm.mamba_block(jcfg, params, xx, mode="train")
        return jnp.sum(y * wt)
    gp, gx = jax.grad(f, argnums=(0, 1))(p, jnp.asarray(x))
    m.requires_grad_(True)
    try:
        xt = torch.from_numpy(x).requires_grad_(True)
        (m(xt)[0] * torch.from_numpy(wt)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                                   atol=1e-4, rtol=1e-4)
        for name, prm in m.named_parameters():
            np.testing.assert_allclose(prm.grad.numpy(),
                                       np.asarray(gp[name]), atol=1e-4,
                                       rtol=1e-4, err_msg=name)
    finally:
        m.requires_grad_(False)
