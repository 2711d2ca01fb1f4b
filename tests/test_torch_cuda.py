"""The port's hand-written CUDA kernels on the card, against their plain
PyTorch versions, and the serving path running through them.

Every test here needs an NVIDIA GPU: a CUDA kernel has no CPU mode.  They
carry the ``cuda`` marker and skip where no card is present (the check
runs inside the fixture, never at import).  This file imports only the
port, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: 1e-4 in float32 and 2e-2 in bfloat16 between kernel and plain
version (the kernels accumulate in float32 in another order); GBDT
margins at 1e-4 and bitwise equal from run to run (no float atomics).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.gbdt import GBDTParams, train_gbdt
from repro_torch.kernels import ops, ref
from repro_torch.serving.engine import RealEngine

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,t", [(64, 0), (64, 40), (64, 100), (512, 300)])
def test_decode_kernel_matches_plain(cuda, dtype, S, t):
    g = torch.Generator(device=cuda).manual_seed(S + t)
    q = torch.randn(1, 1, 15, 64, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(1, S, 5, 64, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    tt = torch.tensor(t, dtype=torch.int32, device=cuda)
    before = ops.LAUNCHES["decode_attention"]
    got = ops.decode_attention(q, k, v, tt)
    assert ops.LAUNCHES["decode_attention"] == before + 1
    want = ref.decode_attention_ref(q.reshape(1, 5, 3, 64), k.transpose(1, 2),
                                    v.transpose(1, 2), tt)
    _close(got, want.reshape(got.shape), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [16, 96, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, dtype, S, causal):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn(1, S, 15, 64, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(1, S, 5, 64, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal)
    _close(got, want.transpose(1, 2), dtype)


@pytest.mark.cuda
def test_gbdt_kernel_matches_plain_and_is_deterministic(cuda):
    rng = np.random.default_rng(0)
    y = rng.integers(0, 3, 600)
    X = rng.normal(0, 1, (600, 19)).astype(np.float32)
    X[:, 0] += y * 1.2
    model = train_gbdt(X, y, GBDTParams(num_rounds=20))
    args = [torch.as_tensor(X, device=cuda), *model.tensors(cuda)]
    got = ops.gbdt_margins(*args)
    want = ref.gbdt_margins_ref(*args)
    _close(got, want, torch.float32)
    assert torch.equal(got, ops.gbdt_margins(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_on_card_fused_equals_oracle(cuda, dtype):
    """A 2-layer GQA model served on the card goes through K3 and K1 and
    its fused decode equals the per-token oracle token for token."""
    import dataclasses
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              num_layers=2, num_heads=6, num_kv_heads=2,
                              dtype=dtype)
    eng = RealEngine(cfg, max_len=96, segment_len=8, device=cuda)
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, 20)
    before = dict(ops.LAUNCHES)
    fused = eng.generate(ids, max_new_tokens=30)
    assert ops.LAUNCHES["flash_attention"] - before["flash_attention"] == 2
    assert ops.LAUNCHES["decode_attention"] - before["decode_attention"] \
        == 2 * 29
    assert fused["tokens"] == eng.generate_reference(
        ids, max_new_tokens=30)["tokens"]
