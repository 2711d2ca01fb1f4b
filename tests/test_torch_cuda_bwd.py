"""K3b's wgmma passes (bf16, head widths 64, 128 and 256) and K3's wgmma
body at head width 64 over ungrouped heads, on the card.

Every test here needs an NVIDIA GPU: a CUDA kernel has no CPU mode.  They
carry the ``cuda`` marker and skip where no card is present (the check
runs inside the fixture, never at import).  This file imports only the
port, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_bwd.py

Tolerances as in tests/test_torch_cuda.py: K3b within 2e-2 (bf16) of
max|plain| (gradients are not O(1)), against the plain version in f32
and against the one that rounds P and dS to bf16 where the kernel does;
K3 within 2e-2, its lse within 1e-3.  Bitwise: two K3b calls, a batch
row against that row alone (pass 2's split and fold depend on absolute
query chunks, not on the grid or the batch), K3's extend rows against the
cold prefill's.
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain,
                                                 wgmma_body)
from repro_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd_cuda, flash_attention_bwd_plain,
    flash_bwd_launch_plan)

#: (B, Sq, Skv, (H, KV, hd), causal): llama-3.2-vision-90b's self- and
#: cross-attention, gemma3-4b-edge's heads, a ragged cross length,
#: musicgen-large's and smollm-360m's hd-64 heads
SHAPES = [(2, 512, 512, (64, 8, 128), True), (2, 512, 512, (8, 4, 256), True),
          (2, 512, 1024, (64, 8, 128), False),
          (2, 45, 1000, (64, 8, 128), False),
          (2, 45, 1000, (8, 4, 256), False), (1, 200, 200, (6, 2, 256), True),
          (2, 512, 512, (32, 32, 64), True), (2, 1000, 1000, (15, 5, 64), True),
          (2, 37, 130, (15, 5, 64), False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _inputs(cuda, B, Sq, Skv, heads, causal, seed):
    H, KV, hd = heads
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(B, Sq, H, hd, generator=g, device=cuda).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, Skv, KV, hd, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    return q, k, v, o, do, lse


def _scaled_close(name, got, want):
    tol = 2e-2 * max(float(want.float().abs().max()), 1.0)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,heads,causal", SHAPES)
def test_wgmma_bwd_matches_plain_and_repeats(cuda, B, Sq, Skv, heads,
                                            causal):
    """K3b's wgmma passes (causal at hd 64, 128 and 256; full attention at
    Sq 512 over Skv 1024 and ragged Sq 45 and 37) against both
    plain versions within 2e-2 of max|plain|; two calls give the same
    bits; one launch counted per call."""
    args = _inputs(cuda, B, Sq, Skv, heads, causal, Sq + Skv)
    before = ops.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd_cuda(*args, causal=causal)
    again = flash_attention_bwd_cuda(*args, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == before + 2
    for rd in (None, torch.bfloat16):
        want = flash_attention_bwd_plain(*args, causal=causal, round_dtype=rd)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.dtype == torch.bfloat16 and a.shape == b.shape
            _scaled_close(f"{name} {rd}", a, b)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Skv,heads,causal", SHAPES[:4])
def test_wgmma_bwd_batch_row_equals_row_alone(cuda, B, Sq, Skv, heads,
                                             causal):
    """Each batch row's gradients equal that row's gradients from a call
    of its own, bit for bit: the split walk and its fold depend on
    absolute query chunks, not on the batch or the grid."""
    assert flash_bwd_launch_plan(B, Sq, Skv, *heads, causal)["split"] >= 1
    args = _inputs(cuda, B, Sq, Skv, heads, causal, 7 * Sq + Skv)
    got = flash_attention_bwd_cuda(*args, causal=causal)
    for b in range(B):
        alone = flash_attention_bwd_cuda(*(t[b:b + 1].contiguous()
                                           for t in args), causal=causal)
        for x, y in zip(got, alone):
            assert torch.equal(x[b:b + 1], y)


@pytest.mark.cuda
def test_wgmma_bwd_kernels_do_not_spill(cuda, tmp_path, monkeypatch):
    """Pass 2 and pass 3's wgmma instances at hd 64, 128 and 256 compile
    with no register spills, as ``_build.PTXAS_REPORT`` shows after a
    fresh build; K3's wgmma body at hd 64 too."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build.build(["flash_attention_bwd", "flash_attention"])
    for name, kernel, count in (
            ("flash_attention_bwd", "wgmma_kernel", 6),
            ("flash_attention", "flash_wgmma_kernelILi64E", 1)):
        entries = [e for e in _build.PTXAS_REPORT[name].split(
            "Compiling entry function '")[1:] if kernel in e.split("'")[0]]
        assert len(entries) == count, name
        for e in entries:
            assert "0 bytes spill stores, 0 bytes spill loads" in e, e


@pytest.mark.cuda
@pytest.mark.parametrize("S", [16, 45, 96, 300, 512])
@pytest.mark.parametrize("B", [1, 4])
def test_k3_hd64_ungrouped_matches_plain_with_lse(cuda, S, B):
    """K3 at musicgen-large's heads (32 over 32, hd 64: the wgmma body)
    within 2e-2 of the plain version, its lse within 1e-3; the output
    bitwise unchanged by asking for the lse and by a second launch."""
    assert wgmma_body(64, 1)
    g = torch.Generator(device=cuda).manual_seed(S + B)
    q = torch.randn(B, S, 32, 64, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(B, S, 32, 64, generator=g, device=cuda).bfloat16()
            for _ in range(2))
    o, lse = flash_attention_cuda(q, k, v, return_lse=True)
    want, want_lse = flash_attention_plain(q, k, v, return_lse=True)
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=1e-3, rtol=1e-3)
    assert torch.equal(o, flash_attention_cuda(q, k, v))
    assert torch.equal(o, flash_attention_cuda(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("prefix,suffix", [(48, 16), (64, 64), (200, 100),
                                           (256, 48), (500, 24), (700, 330)])
def test_k3_hd64_ungrouped_extend_equals_cold(cuda, prefix, suffix):
    """At G 1, hd 64, extend rows (q_offset over a longer, padded key
    buffer) equal the cold prefill's rows bit for bit, across 256-key
    chunk boundaries and split or whole walks; within 2e-2 of plain."""
    n = prefix + suffix
    g = torch.Generator(device=cuda).manual_seed(n)
    qf = torch.randn(1, n, 32, 64, generator=g, device=cuda).bfloat16()
    k, v = (torch.randn(1, n + 40, 32, 64, generator=g,
                        device=cuda).bfloat16() for _ in range(2))
    q = qf[:, prefix:]
    got = flash_attention_cuda(q, k, v, q_offset=prefix)
    np.testing.assert_allclose(
        got.float().cpu().numpy(),
        flash_attention_plain(q, k, v, q_offset=prefix).float().cpu().numpy(),
        atol=2e-2, rtol=2e-2)
    cold = flash_attention_cuda(qf, k[:, :n].contiguous(),
                                v[:, :n].contiguous())
    assert torch.equal(cold[:, prefix:], got)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv,heads,causal", [
    (128, 128, (32, 32, 64), True), (300, 300, (64, 8, 128), True),
    (200, 200, (8, 4, 256), True), (64, 1024, (64, 8, 128), False)])
def test_train_attention_reaches_k3_and_k3b_once(cuda, Sq, Skv, heads,
                                                 causal):
    """``ops.flash_attention_train`` on the card at musicgen's G 1 heads
    and on the wgmma backward's shapes: one K3 launch forward, one K3b
    launch backward, gradients equal to K3b on K3's own o and lse."""
    q, k, v, _, do, _ = _inputs(cuda, 2, Sq, Skv, heads, causal, 3)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(ops.LAUNCHES)
    out = ops.flash_attention_train(*leaves, causal=causal)
    out.backward(do)
    assert ops.LAUNCHES["flash_attention"] - before["flash_attention"] == 1
    assert (ops.LAUNCHES["flash_attention_bwd"]
            - before["flash_attention_bwd"]) == 1
    o, lse = flash_attention_cuda(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(out.detach(), o)
    for leaf, want in zip(leaves, flash_attention_bwd_cuda(
            q, k, v, o, do, lse, causal=causal)):
        assert torch.equal(leaf.grad, want)
