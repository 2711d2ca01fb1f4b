"""The port's kernels (K1 decode attention, K3 flash attention, K4 GBDT)
held against the JAX package: each plain PyTorch version against
``repro.kernels.ref`` on the shapes of tests/test_kernels.py and the
serving paths' head layouts (15 query heads over 5 KV heads, hd 64, and
gemma3-4b-edge's 8 over 4, hd 256), in
the kernel layout and through the model-layout ``ops`` wrappers; and
against the Pallas kernel in interpret mode where the JAX tests do not
already hold that kernel to ``ref`` (the serving heads, and one GBDT
batch).  Inputs are drawn with numpy and handed to both packages.

Tolerances are those of tests/test_kernels.py: 2e-5 in float32, 2e-2 in
bfloat16 (both frameworks round the same float32 inputs to the same bf16
values; the sums run in float32 in a different order).  GBDT margins are
held at atol 1e-4, as there.

The CUDA kernels themselves run only on a card: tests/test_torch_cuda.py
compares them with their plain versions there.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.gbdt import GBDTParams, train_gbdt
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_kernel
from repro.kernels.flash_attention import flash_attention_kernel
from repro.kernels.gbdt_infer import gbdt_margins_kernel
from repro.models.attention import decode_attention as jnp_decode
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.gbdt_infer import gbdt_margins_cuda

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=2e-2, rtol=2e-2) if name == "bf16" \
        else dict(atol=2e-5, rtol=2e-5)


def _pair(x, name):
    """One numpy float32 array as a JAX array and a torch tensor of the
    same dtype (identical values after the bf16 rounding)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------ K3 flash
@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 4, 4, 128, 64),     # MHA
    (2, 8, 2, 256, 64),     # GQA
    (1, 4, 1, 128, 128),    # MQA
    (2, 6, 2, 384, 32),     # non-pow2 heads, 3 kv blocks
    (1, 15, 5, 64, 64),     # the serving path's heads (smollm-360m)
    (1, 8, 4, 128, 256),    # gemma3-4b-edge's heads, hd 256
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas_and_ref(B, H, KV, S, hd, dtype,
                                                      causal):
    rng = np.random.default_rng(B * 1000 + S + hd)
    qn = rng.normal(size=(B, H, S, hd)).astype(np.float32)
    kn = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    vn = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (qn, kn, vn))
    want = [jref.flash_attention_ref(qj, kj, vj, causal=causal)]
    if H in (8, 15):  # test_kernels.py holds Pallas to ref on the others
        want.append(flash_attention_kernel(qj, kj, vj, causal=causal,
                                           block_q=64, block_kv=64,
                                           interpret=True))
    got = ref.flash_attention_ref(qt, kt, vt, causal=causal)
    # the model-layout wrapper takes (B, S, heads, hd) views
    got_ops = ops.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                                  vt.transpose(1, 2), causal=causal)
    assert got.dtype == DTYPES[dtype][1] and got_ops.shape == (B, S, H, hd)
    for g in (got, got_ops.transpose(1, 2)):
        for w in want:
            np.testing.assert_allclose(_np(g), _np(w), **_tol(dtype))


def test_flash_ops_matches_jax_ops_model_layout():
    """ops.flash_attention agrees with the JAX package's model-layout
    wrapper (which transposes into the Pallas kernel)."""
    rng = np.random.default_rng(2)
    B, S, H, KV, hd = 2, 128, 8, 2, 64
    q, k, v = (rng.normal(size=(B, S, n, hd)).astype(np.float32)
               for n in (H, KV, KV))
    want = jops.flash_attention(q, k, v, causal=True)
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# ----------------------------------------------------------------- K1 decode
@pytest.mark.parametrize("B,KV,G,S,hd,t", [
    (2, 4, 1, 256, 64, 255),
    (1, 2, 4, 512, 128, 300),   # partially filled cache
    (3, 1, 8, 256, 64, 17),     # MQA, mostly-empty cache
    (1, 5, 3, 64, 64, 40),      # the serving path's heads, t < S
    (1, 5, 3, 64, 64, 100),     # ... wrapped ring, t >= S
    (1, 4, 2, 256, 256, 127),   # gemma3-4b-edge's heads, hd 256
    (2, 4, 2, 128, 256, 300),   # ... wrapped ring
])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_plain_matches_pallas_and_ref(B, KV, G, S, hd, t,
                                                       dtype):
    rng = np.random.default_rng(B * 100 + S + t)
    qn = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    kn = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    vn = rng.normal(size=(B, KV, S, hd)).astype(np.float32)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(x, dtype) for x in (qn, kn, vn))
    want = [jref.decode_attention_ref(qj, kj, vj, t)]
    if KV in (4, 5):  # test_kernels.py holds Pallas to ref on the others
        want.append(decode_attention_kernel(qj, kj, vj, t, block_kv=128,
                                            interpret=True))
    tt = torch.tensor(t, dtype=torch.int32)
    got = ref.decode_attention_ref(qt, kt, vt, tt)
    # model layout: q (B, 1, H, hd), ring cache (B, S, KV, hd) read in place
    got_ops = ops.decode_attention(qt.reshape(B, 1, KV * G, hd),
                                   kt.transpose(1, 2), vt.transpose(1, 2), tt)
    for g in (got, got_ops.reshape(B, KV, G, hd)):
        for w in want:
            np.testing.assert_allclose(_np(g), _np(w), **_tol(dtype))


@pytest.mark.parametrize("t", [5, 63, 200])
def test_decode_ops_matches_jax_model_decode(t):
    """ops.decode_attention == the JAX model's decode attention (f32 cast
    path) on the engine's cache layout, before and after the ring wraps."""
    rng = np.random.default_rng(t)
    B, S, KV, H, hd = 1, 64, 5, 15, 64
    q = rng.normal(size=(B, 1, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    want = jnp_decode(q, k, v, jnp.asarray(t, jnp.int32))
    want_ops = jops.decode_attention(q, k, v, t)
    got = ops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               torch.tensor(t, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_ops), atol=2e-5,
                               rtol=2e-5)


# ------------------------------------------------------------------- K4 GBDT
@pytest.fixture(scope="module")
def toy_ensemble():
    rng = np.random.default_rng(0)
    B, F = 600, 19
    y = rng.integers(0, 3, B)
    X = rng.normal(0, 1, (B, F)).astype(np.float32)
    X[:, 0] += y * 1.2
    X[:, 3] += (y == 2) * 1.5
    return train_gbdt(X, y, GBDTParams(num_rounds=20)), X


@pytest.fixture(scope="module")
def jax_margins(toy_ensemble):
    """The JAX package's margins for the first 300 rows: numpy dense walk,
    jnp ref, and the Pallas kernel (interpret mode) on the first 128.
    Rows are scored independently, so a batch's margins are a slice."""
    model, X = toy_ensemble
    jargs = (jnp.asarray(model.feature), jnp.asarray(model.threshold),
             jnp.asarray(model.value))
    return [model.predict_margin_dense(X[:300]),
            np.asarray(jref.gbdt_margins_ref(jnp.asarray(X[:300]), *jargs)),
            np.asarray(gbdt_margins_kernel(jnp.asarray(X[:128]), *jargs,
                                           interpret=True))]


@pytest.mark.parametrize("batch", [1, 7, 128, 300])
def test_gbdt_plain_matches_pallas_ref_and_numpy(toy_ensemble, jax_margins,
                                                 batch):
    model, X = toy_ensemble
    targs = (torch.from_numpy(X[:batch]), torch.from_numpy(model.feature),
             torch.from_numpy(model.threshold), torch.from_numpy(model.value))
    got = ref.gbdt_margins_ref(*targs)
    got_ops = ops.gbdt_margins(*targs, n_classes=3)
    assert got_ops.shape == (batch, 3) and got_ops.dtype == torch.float32
    for g in (got, got_ops):
        for w in jax_margins:
            n = min(batch, len(w))
            np.testing.assert_allclose(g[:n].numpy(), w[:n], atol=1e-4)


# --------------------------------------------------- no silent CPU fallback
def test_cuda_launchers_refuse_cpu_tensors():
    """The launchers never fall back to the plain path: a tensor that is
    not on a CUDA device is refused before any build or launch."""
    q = torch.zeros(1, 1, 4, 16)
    c = torch.zeros(1, 8, 2, 16)
    t = torch.tensor(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        decode_attention_cuda(q, c, c, t)
    with pytest.raises(ValueError):
        flash_attention_cuda(torch.zeros(1, 8, 4, 16), c, c)
    with pytest.raises(ValueError):
        gbdt_margins_cuda(torch.zeros(2, 19),
                          torch.zeros(3, 7, dtype=torch.int32),
                          torch.zeros(3, 7), torch.zeros(3, 7))


def test_rows_aligned_reads_the_strides_that_address_rows():
    """The 16-byte row check the K1/K2/K3 launchers make before a launch:
    a view whose rows start off the boundary is refused; the stride of an
    axis of length 1 is ignored."""
    from repro_torch.kernels._build import rows_aligned
    x = torch.zeros(2, 8, 4, 64, dtype=torch.bfloat16)
    assert rows_aligned(x)
    assert not rows_aligned(x[..., 4:])                # offset 8 bytes
    assert rows_aligned(x[:, :, 1:], 16)               # offset 128 bytes
    assert not rows_aligned(torch.zeros(3, 12, dtype=torch.bfloat16))
    assert rows_aligned(torch.zeros(1, 1, 2, 8).as_strided(
        (1, 1, 2, 8), (3, 5, 8, 1)))
