"""The architecture registry and the block-pattern stack of the port
against the JAX package's.

* Registry: every one of the eleven arch ids resolves to the JAX
  package's config, field for field (full and ``reduced()``); the
  parameter counts, the KV bytes per token and the service-time model's
  rates follow the JAX formulas exactly (the service-time model with the
  JAX module's peaks set to the port's H100 data-sheet peaks); each
  reduced config holds exactly ``param_count()`` parameters in the port.
* Models, per reduced config, all eleven (smollm-360m, gemma3-4b-edge,
  gemma-2b, granite-8b, qwen3-32b with QK-norm, dbrx-132b and
  llama4-maverick with MoE, jamba-v0.1-52b with Mamba + MoE + attention,
  xlstm-350m with sLSTM + mLSTM, llama-3.2-vision-90b with
  cross-attention over seeded image embeddings, musicgen-large with the
  audio frontend's seeded frame embeddings), on the JAX package's
  weights (``bridge.params_from_jax``), float32 on the CPU: training
  logits (atol 1e-4: the Mamba and mLSTM scans sum in another order),
  the loss with the MoE auxiliary term (rtol 1e-5), every parameter's
  gradient (atol/rtol 1e-3), and prefill then three teacher-forced
  decode steps, against the JAX LM's (1e-4) and against the port's own
  training forward (2e-2, the JAX smoke test's bar, with
  ``moe_capacity_factor = E`` so no token is dropped on either path).
  The same numpy inputs (tokens or frames, and image embeddings) go to
  both packages.
* Optimizer state over a pattern: three AdamW and Adafactor steps on
  reduced jamba, xlstm, vision and musicgen equal the JAX optimizer's
  (Adafactor's statistics are factored per pattern position, as the JAX
  stacked layout does).
* Engines: reduced jamba and dbrx prefill at exact length (no buckets)
  and their greedy tokens through ``RealEngine`` and ``BatchedRealEngine``
  (back-fill included) equal the JAX engines'; the block-paged engine and
  speculative decoding refuse such stacks with the JAX engine's messages.

MoE routing is float32 in both packages; ``torch.topk`` and
``jax.lax.top_k`` could order exact ties differently, and no tie occurs on
these inputs (probabilities of random weights agree to ~1e-7 and differ
from each other far more).
"""

import torch_threads  # noqa: F401  (first: caps torch threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCH_NAMES as J_ALL
from repro.configs import ARCH_NAMES as J_ARCH
from repro.configs import get_config as jax_config
from repro.configs import matrix_cells as j_cells
from repro.models.model import LM as JLM
from repro.serving import batching as jbatching
from repro.serving import service_time as jst
from repro.serving.engine import BatchedRealEngine as JBatched
from repro.serving.engine import PagedBatchedEngine as JPaged
from repro.serving.engine import RealEngine as JReal
from repro.training import optimizer as jopt
from repro_torch.configs import (ALL_ARCH_NAMES, ARCH_NAMES, get_config,
                                 matrix_cells)
from repro_torch.models.bridge import (opt_state_from_jax, params_from_jax,
                                       params_to_jax)
from repro_torch.models.model import LM
from repro_torch.models.transformer import attention_only
from repro_torch.serving import batching
from repro_torch.serving.engine import (BatchedRealEngine, PagedBatchedEngine,
                                        RealEngine)
from repro_torch.serving.service_time import H100_SXM_PEAKS, ServiceTimeModel
from repro_torch.training import optimizer as topt

PORTED = ["smollm-360m", "gemma3-4b-edge", "gemma-2b", "granite-8b",
          "qwen3-32b", "dbrx-132b", "llama4-maverick-400b-a17b",
          "jamba-v0.1-52b", "xlstm-350m", "llama-3.2-vision-90b",
          "musicgen-large"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=1e-3, rtol=1e-3)
B, S = 2, 16


# ----------------------------------------------------------------- registry
def test_registry_resolves_every_arch_as_jax_does():
    assert ALL_ARCH_NAMES == J_ALL and ARCH_NAMES == J_ARCH
    assert len(ALL_ARCH_NAMES) == 11
    assert list(matrix_cells()) == list(j_cells())
    assert list(matrix_cells(True)) == list(j_cells(True))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")


@pytest.mark.parametrize("name", ALL_ARCH_NAMES)
def test_config_fields_and_reduced_equal_jax(name):
    cfg, jcfg = get_config(name), jax_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(jcfg.reduced())
    assert cfg.reduced().num_layers == len(cfg.block_pattern)
    assert (cfg.pattern_repeats, cfg.subquadratic, cfg.d_inner) == \
        (jcfg.pattern_repeats, jcfg.subquadratic, jcfg.d_inner)


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("name", ALL_ARCH_NAMES)
def test_param_counts_equal_jax(name, reduce):
    cfg, jcfg = get_config(name), jax_config(name)
    if reduce:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("name", ALL_ARCH_NAMES)
def test_kv_bytes_and_service_model_equal_jax(name, reduce, monkeypatch):
    """``kv_bytes_per_token`` counts attention layers x repeats; the
    service-time model's rates equal the JAX formula's with the JAX
    module's peaks set to the port's H100 peaks (exact: same arithmetic
    in the same order)."""
    cfg, jcfg = get_config(name), jax_config(name)
    if reduce:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert batching.kv_bytes_per_token(cfg) == \
        jbatching.kv_bytes_per_token(jcfg)
    monkeypatch.setattr(jst, "PEAK_FLOPS", H100_SXM_PEAKS["bf16_flops"])
    monkeypatch.setattr(jst, "HBM_BW", H100_SXM_PEAKS["hbm_bytes_per_s"])
    for chips in (1, 4):
        mine = ServiceTimeModel.from_arch(cfg, chips=chips)
        theirs = jst.ServiceTimeModel.from_arch(jcfg, chips=chips)
        assert mine.prefill_tok_per_s == theirs.prefill_tok_per_s
        assert mine.decode_tok_per_s == theirs.decode_tok_per_s


def test_jamba_two_repeats_is_the_slice_the_card_serves():
    """The jamba slice ``chip_smoke.py`` serves: one pattern repeat (it
    served two until the last three archs joined the run)."""
    cfg = get_config("jamba-v0.1-52b")
    assert cfg.param_count() * 2 > 80e9          # bf16 does not fit a card
    one = dataclasses.replace(cfg, num_layers=len(cfg.block_pattern))
    assert one.param_count() == 13_265_874_944
    assert batching.kv_bytes_per_token(one) == 2 * 1 * 8 * 128 * 2


def test_vision_one_repeat_is_the_slice_the_card_serves():
    """llama-3.2-vision-90b at full width, one of its 20 pattern repeats:
    4 self-attention layers (the ring) and 1 cross-attention layer."""
    cfg = get_config("llama-3.2-vision-90b")
    assert cfg.param_count() * 2 > 80e9
    one = dataclasses.replace(cfg, num_layers=len(cfg.block_pattern))
    assert one.param_count() == 6_379_626_496
    assert batching.kv_bytes_per_token(one) == 2 * 4 * 8 * 128 * 2


def test_every_registered_arch_is_ported():
    assert sorted(PORTED) == sorted(ALL_ARCH_NAMES)


@pytest.mark.parametrize("name", PORTED)
def test_port_lm_holds_param_count(name):
    cfg = get_config(name).reduced()
    lm = LM(cfg, device="cpu")
    assert sum(p.numel() for p in lm.parameters()) == cfg.param_count()


# ------------------------------------------------------------------- models
@pytest.fixture(scope="module", params=PORTED)
def pair(request):
    """(JAX LM, JAX params as numpy, port LM) on one set of weights."""
    name = request.param
    jlm = JLM(jax_config(name).reduced())
    params = jax.tree.map(np.asarray, jlm.init(jax.random.key(7)))
    lm = LM(get_config(name).reduced(), device="cpu")
    lm.load_state_dict(params_from_jax(params, lm.cfg))
    return jlm, params, lm


def _batch(cfg, seed, n=B, s=S):
    """Seeded numpy inputs of ``cfg``: tokens (or, with the audio
    frontend, float32 frames) and next-token labels, plus image
    embeddings for a stack with cross-attention."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (n, s + 1)).astype(np.int32)
    out = {"labels": toks[:, 1:].copy()}
    if cfg.audio_frontend:
        out["frames"] = rng.standard_normal((n, s, cfg.d_model),
                                            dtype=np.float32)
    else:
        out["tokens"] = toks[:, :-1]
    if cfg.num_image_tokens:
        out["image_embeds"] = rng.standard_normal(
            (n, cfg.num_image_tokens, cfg.d_model), dtype=np.float32)
    return out


def _t(batch):
    """The port's tensors: int64 ids, float32 embeddings."""
    return {k: torch.from_numpy(v.astype(np.int64 if v.dtype == np.int32
                                         else v.dtype))
            for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _inputs(batch):
    """The model inputs of a batch (every entry but the labels)."""
    return {k: v for k, v in batch.items() if k != "labels"}


def test_bridge_round_trip(pair):
    _, params, lm = pair
    back = params_to_jax(lm.state_dict(), lm.cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_forward_logits_match_jax(pair):
    jlm, params, lm = pair
    batch = _inputs(_batch(lm.cfg, 0))
    want, _ = jlm.forward(params, _j(batch), remat=False)
    with torch.no_grad():
        got = lm(remat=False, **_t(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_loss_with_aux_matches_jax(pair):
    jlm, params, lm = pair
    batch = _batch(lm.cfg, 1)
    want = jlm.loss(params, _j(batch))
    _, aux = jlm.forward(params, _j(_inputs(batch)))
    assert (float(aux) > 0) == bool(lm.cfg.num_experts)
    with torch.no_grad():
        got = lm.loss(_t(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_every_gradient_matches_jax_grad(pair):
    jlm, params, lm = pair
    batch = _batch(lm.cfg, 2)
    want = jax.grad(lambda p: jlm.loss(p, _j(batch)))(params)
    lm.requires_grad_(True)
    try:
        for p in lm.parameters():
            p.grad = None
        lm.loss(_t(batch)).backward()
        got = params_to_jax({n: p.grad for n, p in lm.named_parameters()},
                            lm.cfg)
    finally:
        lm.requires_grad_(False)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = jax.tree.leaves(got)
    assert len(paths) == len(leaves)
    for (path, w), g in zip(paths, leaves):
        np.testing.assert_allclose(g, np.asarray(w), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", PORTED)
def test_prefill_then_decode_teacher_forced(name):
    """The JAX smoke test's check (tests/test_models_smoke.py): prefill
    half the sequence, then three teacher-forced decode steps, each
    against the JAX LM's logits (1e-4) and the port's own training
    forward (2e-2); MoE capacity = E so routing never drops."""
    jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
    if cfg.num_experts:
        jcfg = dataclasses.replace(
            jcfg, moe_capacity_factor=float(jcfg.num_experts))
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=float(cfg.num_experts))
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.key(0))
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                       cfg))
    batch = _inputs(_batch(cfg, 3))
    key = "frames" if cfg.audio_frontend else "tokens"
    seq = batch[key]
    prompt = dict(batch, **{key: seq[:, :S // 2]})
    with torch.no_grad():
        full = lm(remat=False, **_t(batch))
        got_p, cache = lm.prefill(pad_to=S, **_t(prompt))
    want_p, jc = jlm.prefill(params, _j(prompt), pad_to=S)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               **LOGIT_TOL)
    np.testing.assert_allclose(got_p.numpy(), full[:, S // 2 - 1].numpy(),
                               atol=2e-2)
    for t in range(S // 2, S // 2 + 3):
        step = {key: seq[:, t:t + 1]}
        want_d, jc = jlm.decode_step(params, jc, _j(step))
        got_d = lm.decode_step(cache, **_t(step))
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(got_d.numpy(), full[:, t].numpy(),
                                   atol=2e-2)
    assert int(cache.t) == S // 2 + 3


def _optimizer_matches_jax(name, kind):
    """Three steps on a reduced config's parameters and random gradients:
    parameters within 1e-6 and the carried-over JAX state equal to the
    port's (Adafactor statistics grouped per pattern position)."""
    jlm = JLM(jax_config(name).reduced())
    params = jax.tree.map(np.asarray, jlm.init(jax.random.key(1)))
    rng = np.random.default_rng(4)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), params)
    tcfg = get_config(name).reduced()
    period = len(tcfg.block_pattern)
    ocfg = dict(lr=1e-2, kind=kind, warmup_steps=2)
    jcfg, pcfg = jopt.OptConfig(**ocfg), topt.OptConfig(**ocfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init_opt_state(jp, jcfg)
    tp = {k: v.clone() for k, v in params_from_jax(params, tcfg).items()}
    tstate = topt.init_opt_state(tp, pcfg, period)
    tgrads = params_from_jax(grads, tcfg)
    for _ in range(3):
        jp, jstate, _ = jopt.apply_updates(
            jp, jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        tp, tstate, _ = topt.apply_updates(tp, tgrads, tstate, pcfg, period)
    for a, b in zip(jax.tree.leaves(params_to_jax(tp, tcfg)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)
    want = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    for mine, theirs in ((tstate.m, want.m), (tstate.v, want.v)):
        assert sorted(mine) == sorted(theirs)
        for n in mine:
            np.testing.assert_allclose(mine[n].numpy(), theirs[n].numpy(),
                                       atol=1e-6, rtol=1e-5, err_msg=n)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_over_a_pattern_matches_jax(kind):
    """Reduced jamba (an 8-block pattern)."""
    _optimizer_matches_jax("jamba-v0.1-52b", kind)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("name", ["xlstm-350m", "llama-3.2-vision-90b",
                                  "musicgen-large"])
def test_optimizer_state_of_xlstm_xattn_and_audio_matches_jax(name, kind):
    """The xLSTM leaves (float32 gates, the (4, H, hd, hd) recurrent
    gates), the cross-attention block's and a model without an
    embedding carry over both ways."""
    _optimizer_matches_jax(name, kind)


# ------------------------------------------------------------------ engines
@pytest.fixture(scope="module", params=["jamba-v0.1-52b", "dbrx-132b"])
def hybrid(request):
    """JAX serial and lane engines (max_len 64, segment 4, 3 lanes) and
    the port's on their weights."""
    name = request.param
    jcfg, cfg = jax_config(name).reduced(), get_config(name).reduced()
    jser = JReal(jcfg, max_len=64, segment_len=4, seed=3)
    jlanes = JBatched(jcfg, params=jser.params, max_len=64, segment_len=4,
                      n_lanes=3)
    sd = params_from_jax(jax.tree.map(np.asarray, jser.params), cfg)
    ser = RealEngine(cfg, state_dict=sd, max_len=64, segment_len=4,
                     device="cpu")
    lanes = BatchedRealEngine(cfg, state_dict=sd, max_len=64,
                              segment_len=4, n_lanes=3, device="cpu")
    return jser, jlanes, ser, lanes


def _prompts(sizes, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in sizes]


def test_hybrid_stacks_prefill_at_exact_length(hybrid):
    jser, _, ser, _ = hybrid
    assert not ser._bucketing and ser.buckets == () == jser.buckets
    for n in (1, 7, 23):
        logits, cache, plen = ser._run_prefill(np.arange(n) % 500 + 1)
        assert plen == n and int(cache.t) == n


def test_serial_tokens_match_jax_engine(hybrid):
    jser, _, ser, _ = hybrid
    for ids, m in zip(_prompts((7, 13, 3), 5), (9, 12, 5)):
        want = jser.generate(ids, max_new_tokens=m)["tokens"]
        assert ser.generate(ids, max_new_tokens=m)["tokens"] == want
        assert ser.generate_reference(ids, m)["tokens"] == want


def test_lane_tokens_with_backfill_match_jax_engine(hybrid):
    """Five requests through three lanes (two back-filled; two pairs of
    equal-length prompts share a prefill group).  MoE capacity is shared
    by a step's tokens, so the bar is the JAX lane engine's tokens, not
    the serial engine's."""
    _, jlanes, _, lanes = hybrid
    prompts = _prompts((7, 7, 12, 5, 12), 6)
    maxes = [10, 6, 8, 12, 5]
    want = [r["tokens"] for r in jlanes.generate_batch(prompts, maxes)]
    got = [r["tokens"] for r in lanes.generate_batch(prompts, maxes)]
    assert got == want
    assert lanes.lane_manager.stats["backfills"] == \
        jlanes.lane_manager.stats["backfills"] > 0


def test_paged_and_speculative_refuse_with_jax_messages(hybrid):
    jser, _, ser, _ = hybrid
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
    if not attention_only(cfg):     # the LM's own attention-cache refusals
        with pytest.raises(ValueError, match="pure-attention"):
            ser.lm.init_paged_cache(2, 64, 9, 16)
        with pytest.raises(ValueError, match="pure-attention"):
            ser.lm.verify_step(ser.lm.init_cache(1, 64),
                               torch.zeros((1, 3), dtype=torch.long))


# --------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("name", ALL_ARCH_NAMES)
def test_serve_cli_prices_every_registered_arch(name, capsys):
    """``launch.serve --arch`` takes every arch the JAX CLI takes: the
    service-time model prices it (no weights are built), FCFS on the
    CPU."""
    from repro_torch.launch import serve
    srv = serve.main(["--arch", name, "--policy", "fcfs", "--requests", "20",
                      "--device", "cpu"])
    assert len(srv.responses) == 20 and all(r.ok for r in srv.responses)
    assert "calibrated tau" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["dbrx-132b", "jamba-v0.1-52b"])
def test_train_cli_trains_a_reduced_moe_or_hybrid_stack(name):
    """``launch.train --reduced`` trains reduced dbrx (MoE) and jamba
    (Mamba + MoE + attention) on the CPU, as the JAX CLI does: 25 steps,
    finite losses, the last below the first by > 0.2."""
    from repro_torch.launch import train
    losses = train.main(["--arch", name, "--reduced", "--steps", "25",
                         "--batch", "8", "--seq", "64", "--lr", "1e-2",
                         "--device", "cpu"])
    assert len(losses) == 25 and all(map(np.isfinite, losses))
    assert losses[-1] < losses[0] - 0.2, (losses[0], losses[-1])


def test_train_state_bytes_counts_weights_grads_and_moments():
    from repro_torch.launch.train import train_state_bytes
    cfg = get_config("jamba-v0.1-52b")
    assert train_state_bytes(cfg) == cfg.param_count() * 12
    assert train_state_bytes(cfg.reduced()) == \
        cfg.reduced().param_count() * 16
